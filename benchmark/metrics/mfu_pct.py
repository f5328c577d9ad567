"""The whole page's share of the card's peak: the sum over the window's
network calls of each call's model FLOPs over the peak of the precision
it runs in, over the traced window, in %."""
from ..work import PEAK, module


def read(run):
    if run.trace is None or not run.trace['window_s']:
        return None
    seconds = 0.0
    for name, spec in run.config['networks'].items():
        seconds += sum(f / PEAK[p] for f, p in module(name).flops(
            run.rec.calls, spec))
    if seconds <= 0:
        return None
    return 100 * seconds / run.trace['window_s']
