"""The share of the OCR beam's work spent on real lines still reading, in
%: 100 x the program's ``ocr.tokens`` (each real line's best sequence up
to its END) over its ``ocr.line_steps`` (the rows of each search, padding
included, times the steps the loop ran), summed over the window."""
from ..program_trace import counter, pages


def read(run):
    window = pages(run)
    if window is None:
        return None
    steps = counter(window, 'ocr.line_steps')
    if steps <= 0:
        return None
    return 100 * counter(window, 'ocr.tokens') / steps
