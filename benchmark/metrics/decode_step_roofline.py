"""Kernel ``decode_step``'s share of its roofline over the window, in %."""
from . import roofline


def read(run):
    return roofline(run, 'decode_step')
