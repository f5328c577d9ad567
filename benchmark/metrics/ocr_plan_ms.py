"""Milliseconds a page in the OCR's plan (the program's ``ocr.plan``
spans: text directions, the width sort, the crop plans, and the 32px
OCR's host crops), over the window."""
from ..program_trace import ms_a_page


def read(run):
    return ms_a_page(run, 'ocr.plan')
