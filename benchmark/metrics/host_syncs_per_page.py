"""Times a page the host waited for the device (the program's
``host_syncs`` counter: the stage timer's synchronises, the decode loops'
flag reads and stream synchronises, each read of a device tensor into host
memory), over the window."""
from ..program_trace import counter, pages


def read(run):
    window = pages(run)
    if window is None:
        return None
    return counter(window, 'host_syncs') / len(window)
