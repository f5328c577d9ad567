"""Kernel ``charhead``'s share of its roofline over the window, in %."""
from . import roofline


def read(run):
    return roofline(run, 'charhead')
