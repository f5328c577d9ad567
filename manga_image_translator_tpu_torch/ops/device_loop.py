"""Device-resident decode loops: a beam search's steps replayed as CUDA
graphs.

Counterpart of the JAX package's ``jax.lax.while_loop`` around its two
beam searches (``models/ocr48.run_beam``,
``translators/ct2_model._beam_decode``): there the whole loop is one device
program, and the decoder kernel takes its step as a scalar in device memory
(``ops/pallas_decode.py``, ``step_ref``). Here a loop's step is a
fixed-shape ``body(variant)`` that reads all of its state, its position
included (a 0-d int64 tensor), from buffers that persist across steps, and
updates them in place. ``DeviceLoop.run`` drives such a body over a range
of steps:

* on the card, the first step of each variant runs eagerly (the warm-up:
  kernel attributes, grid-barrier buffers, library handles and workspaces
  are made then, outside any capture); the next step of that variant is
  captured as a CUDA graph, and every later step of it replays the graph.
  A graph holds one step: its capture and instantiation cost more than an
  eager step of host time (3.4 ms for a 48px step, ~14 ms for a Sugoi
  step on the H100), which a block of several steps would multiply, while
  a replay costs one graph launch against the ~0.5 ms (48px) or ~4 ms
  (Sugoi) the step takes on the card. The graphs of a loop share one
  memory pool and live as long as the loop object: a caller that keeps
  the loop (and the buffers its body updates) replays them in its next
  run without capturing again. The loop holds no reference to its body
  between runs, so an object that keeps the loop of its own body is
  freed by reference counting, its graphs with it;
* on the CPU, the body runs step by step.

Steps run in blocks aligned to multiples of ``block``: after a block that
does not end the range, the loop reads ``finished()`` (a 0-d bool tensor)
back to the host, once, and stops if it is true. So the steps that run are
the same on both devices, with or without graphs.

``eager()`` (a context) makes the loops of the calling thread run the body
eagerly on the card too: the card-only tests and the smoke hold graph
replay against it. Nothing falls back to it: a capture or a replay that
fails raises.

Kernel wrappers called during a capture count their launches in the
capturing thread's own tally (``cuda_build.capture_tally``), not in
``cuda_build.LAUNCHES``; the loop adds that tally to ``LAUNCHES`` at every
replay, so launches other threads make meanwhile are counted once.

For the tracer (``utils.profiling``), each capture is a ``graph.capture``
span, timed as ``LoopStats.capture_ms`` is, and each flag read and the
side stream's synchronise count in ``host_syncs``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Hashable, Optional

import torch

from ..utils.profiling import HOST_SYNCS, add_span, count, count_sync
from . import cuda_build

_local = threading.local()

# the last loops' LoopStats, newest last (capture times for the smoke)
history: collections.deque = collections.deque(maxlen=64)


@contextlib.contextmanager
def eager():
    """Inside the block, this thread's loops run every step eagerly, on the
    card too (no graph)."""
    prev = getattr(_local, 'eager', False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = prev


def replays_graphs(device) -> bool:
    """Whether a loop on ``device`` run by this thread now replays CUDA
    graphs (on the card, outside ``eager()``)."""
    return (torch.device(device).type == 'cuda'
            and not getattr(_local, 'eager', False))


@dataclasses.dataclass
class LoopStats:
    device: str
    graphs: bool
    start: int = 0
    stop: int = 0                 # the step the loop stopped at
    eager_steps: int = 0
    replays: int = 0
    flag_reads: int = 0
    capture_ms: Dict[Hashable, float] = dataclasses.field(
        default_factory=dict)    # variant -> capture + instantiate ms


class DeviceLoop:
    """Runs ``body(variant)`` step by step, or as replayed CUDA graphs on
    the card (see the module note). ``body`` must update its state in
    place, including its step counter, must not read anything back to
    the host, and must be the same at every run of one loop (its graphs
    replay the body they captured)."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.stats = LoopStats(str(self.device), False)
        self._graphs: Dict[Hashable, tuple] = {}
        self._warm: set = set()
        self._pool = None
        self._side = None

    def run(self, body: Callable[[Hashable], None], start: int, stop: int,
            block: int, finished: Callable[[], torch.Tensor],
            variant: Optional[Callable[[int, int], Hashable]] = None) -> int:
        """Steps ``start .. stop - 1`` in blocks aligned to multiples of
        ``block``; ``variant(block_start, block_end)`` picks the body's
        variant for a block (None: one variant). Returns the step at which
        the loop stopped."""
        if block < 1:
            raise ValueError(f'block must be >= 1, got {block}')
        graphs = replays_graphs(self.device)
        self.stats = LoopStats(str(self.device), graphs, start=start)
        history.append(self.stats)
        if not graphs:
            return self._blocks(body, start, stop, block, finished, variant)
        if self._side is None:     # a capture needs a side stream
            self._side = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        try:
            with torch.cuda.stream(self._side):
                return self._blocks(body, start, stop, block, finished,
                                    variant)
        finally:
            cur.wait_stream(self._side)
            # the graphs may be freed with the loop once this returns
            count(HOST_SYNCS)
            self._side.synchronize()

    def _blocks(self, body, start, stop, block, finished, variant) -> int:
        step = start
        while step < stop:
            end = min(stop, (step // block + 1) * block)
            v = None if variant is None else variant(step, end)
            for _ in range(end - step):
                self._step(body, v)
            step = end
            if step < stop:
                self.stats.flag_reads += 1
                count_sync(self.device)
                if bool(finished()):
                    break
        self.stats.stop = step
        return step

    def _step(self, body, v: Hashable) -> None:
        if not self.stats.graphs or v not in self._warm:
            self._warm.add(v)
            body(v)
            self.stats.eager_steps += 1
            return
        entry = self._graphs.get(v)
        if entry is None:
            entry = self._graphs[v] = self._capture(body, v)
        graph, launches = entry
        graph.replay()
        for name, n in launches.items():
            cuda_build.LAUNCHES[name] += n
        self.stats.replays += 1

    def _capture(self, body, v: Hashable) -> tuple:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter_ns()
        with cuda_build.capture_tally() as launches:
            graph.capture_begin(pool=self._pool,
                                capture_error_mode='thread_local')
            try:
                body(v)
            finally:
                graph.capture_end()
        t1 = time.perf_counter_ns()
        self.stats.capture_ms[v] = (t1 - t0) / 1e6
        add_span('graph.capture', t0, t1)
        return graph, dict(launches)
