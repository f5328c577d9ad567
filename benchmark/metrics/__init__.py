"""Per-layer metrics, one reader each (``<name>.py`` with ``read(run)``),
found by the name ``BENCHMARK.json`` gives them. A reader returns a
number, or None where the run has nothing for it to read (the harness
then leaves the metric out of the line). ``run`` is ``harness.Run``: the
window's page latencies and stage seconds, the trace's reduction, the
recorder's work counts and the configuration.
"""
from __future__ import annotations


def stage_ms(run, stage: str):
    """A stage's milliseconds a page over the window (the program's stage
    timer, synchronised at each stage edge)."""
    if not run.stages or not any(stage in s for s in run.stages):
        return None
    return 1000 * sum(s.get(stage, 0.0) for s in run.stages) / len(
        run.stages)


def roofline(run, kernel: str):
    """A kernel's share of its roofline over the window: the sum over its
    launches of the least time each could take, over its device time in
    the trace, in %."""
    from ..work import kernels, least_seconds
    if run.trace is None:
        return None
    vocab = run.config['networks'].get('ocr48', {}).get('vocab', 0)
    work = kernels.launches(run.rec, vocab)[kernel]
    device_s = sum(s for name, s in run.trace['kernels'].items()
                   if kernels.in_trace(kernel, name))
    if not work or device_s <= 0:
        return None
    return 100 * sum(least_seconds(*w) for w in work) / device_s
