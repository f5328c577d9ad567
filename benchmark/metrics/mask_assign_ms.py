"""Milliseconds a page in mask refinement's assignment of connected
components to text lines on the host (the program's ``mask.assign``
spans), over the window."""
from ..program_trace import ms_a_page


def read(run):
    return ms_a_page(run, 'mask.assign')
