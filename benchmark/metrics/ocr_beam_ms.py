"""Milliseconds a page in the OCR's beam searches and their readbacks,
their own time only (the self time of the program's ``ocr.beam`` spans:
the graph captures and, on the 32px path, the encoder nested in them left
out), over the window."""
from ..program_trace import ms_a_page


def read(run):
    return ms_a_page(run, 'ocr.beam', self_time=True)
