"""Milliseconds a page spent capturing CUDA graphs of the decode loops
(the program's ``graph.capture`` spans), over the window; 0 where every
graph the window replays was captured before it."""
from ..program_trace import ms_a_page


def read(run):
    return ms_a_page(run, 'graph.capture')
