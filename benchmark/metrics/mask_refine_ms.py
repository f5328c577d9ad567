"""Milliseconds a page in the program's ``mask_refine`` stage, over the
window."""
from . import stage_ms


def read(run):
    return stage_ms(run, 'mask_refine')
