"""Milliseconds a page in the reading-order sort of the merged regions,
panel detection over the page included (the program's ``merge.sort``
spans), over the window."""
from ..program_trace import ms_a_page


def read(run):
    return ms_a_page(run, 'merge.sort')
