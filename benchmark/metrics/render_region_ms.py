"""Mean milliseconds the renderer spends on one region (the program's
``render.region`` spans), over the window."""
from ..program_trace import pages, spans


def read(run):
    window = pages(run)
    found = spans(window, 'render.region') if window else []
    if not found:
        return None
    return sum(sp.t1 - sp.t0 for sp in found) / 1e6 / len(found)
