"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to what the per-layer metrics read.

* ``busy_s``: the union of the intervals in which a kernel, a copy or a
  fill ran on the device; ``window_s``: the traced window's length;
* ``kernels``: device seconds by kernel name (summed over launches, graph
  replays included);
* ``gaps``: every interval with nothing on the device, named by the
  pipeline stage the host was in at its middle (``entry`` outside every
  stage).

The device's clock and the host's are aligned by a marker: a sleeping
kernel launched right after a synchronise at the start of the window
starts about when the host's clock says it was launched.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

import torch

DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')
MARKER_CYCLES = 100_000


def _device_type_is_cuda(ev) -> bool:
    dt = ev.device_type()
    return 'CUDA' in str(dt) or getattr(dt, 'name', '') == 'CUDA'


def _ns(ev, what):
    fn = getattr(ev, f'{what}_ns', None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f'{what}_us')() * 1000)


class Trace:
    """Device activity only: recording every host operation as well made
    a traced window of ~110 art pages take 300-350 s to reduce."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0_host = None

    def __enter__(self):
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0_host = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1_host = time.perf_counter_ns()
        self.prof.__exit__(*exc)
        return False

    def intervals(self) -> List[Tuple[int, int, str]]:
        """(start ns, end ns, name) of every device activity, on the
        host's clock."""
        events = self.prof.profiler.kineto_results.events()
        dev = [(_ns(e, 'start'), _ns(e, 'start') + _ns(e, 'duration'),
                e.name()) for e in events if _device_type_is_cuda(e)]
        dev.sort()
        marker = next((s for s, _, n in dev if 'sleep' in n.lower()
                       or 'spin' in n.lower()), dev[0][0] if dev else 0)
        shift = self.t0_host - marker
        return [(s + shift, e + shift, n) for s, e, n in dev]


def reduce(trace: Trace, spans: List[tuple]) -> dict:
    ivs = trace.intervals()
    t0, t1 = trace.t0_host, trace.t1_host
    kernels: Dict[str, float] = collections.defaultdict(float)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, name in ivs:
        kernels[name] += (e - s) / 1e9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > t0:
                gaps.append((t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < t1:
            gaps.append((cur_e, t1))
    named = collections.defaultdict(float)
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [s0 for _, s0, _ in spans]
    for a, b in gaps:
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        inside = k >= 0 and spans[k][1] <= mid <= spans[k][2]
        named[spans[k][0] if inside else 'entry'] += (b - a) / 1e9
    return {'busy_s': busy / 1e9, 'window_s': (t1 - t0) / 1e9,
            'kernels': dict(kernels), 'idle_by_stage': dict(named),
            'n_device_ops': len(ivs)}
