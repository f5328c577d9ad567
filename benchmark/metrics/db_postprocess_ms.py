"""Milliseconds a page in the host DB postprocess of the default detector
(the program's ``detect.postprocess`` spans), over the window."""
from ..program_trace import ms_a_page


def read(run):
    return ms_a_page(run, 'detect.postprocess')
