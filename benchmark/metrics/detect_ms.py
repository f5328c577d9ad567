"""Milliseconds a page in the program's ``detect`` stage, over the
window."""
from . import stage_ms


def read(run):
    return stage_ms(run, 'detect')
