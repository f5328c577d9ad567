"""Milliseconds a page in the program's ``textline_merge`` stage, over the
window."""
from . import stage_ms


def read(run):
    return stage_ms(run, 'textline_merge')
