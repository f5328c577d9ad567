"""Milliseconds a page in the program's ``translate`` stage, over the
window."""
from . import stage_ms


def read(run):
    return stage_ms(run, 'translate')
