"""Tracing / profiling.

* ``StageTimer``: per-stage wall timers collected into
  ``Context.stage_durations`` and reported on the progress-hook channel as
  ``stage-time:{name}:{ms}``; with ``sync`` set, the device is
  synchronised at each stage edge so a stage's time includes its queued
  kernels. Each stage is also the top span of the tracer.
* the tracer: ``span(name)`` times a step of the host inside a stage and
  ``count(name, n)`` adds to a counter of the page. A page (``page()``) is
  one ``translate`` call: its spans and counters share its id, kept in a
  ``contextvars`` variable, so concurrent calls stay apart. A span records
  its name, its parent span, its page and its start and end in
  ``time.perf_counter_ns()``. The tracer is on while a ``torch.profiler``
  session is active, or everywhere with ``MIT_TPU_TRACE=1``; off, ``span``
  returns one shared null context and ``count`` returns at once. It never
  waits for the device and never reads device memory; the last
  ``PAGES_KEPT`` pages stay in ``PAGES``.
* the exporter: with ``MIT_TPU_PROFILE_DIR`` set, each ``translate`` call
  runs under a ``torch.profiler`` session of device activity only, and its
  Chrome trace is written there with the page's spans on a host track and
  its counters as counter events, on the profiler's clock.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from .log import get_logger

logger = get_logger('profiling')

PROFILE_DIR = os.environ.get('MIT_TPU_PROFILE_DIR')
PAGES_KEPT = 4096
HOST_SYNCS = 'host_syncs'

# the last pages recorded, oldest first
PAGES: collections.deque = collections.deque(maxlen=PAGES_KEPT)

# > 0: on whether or not a profiler session is active (MIT_TPU_TRACE=1,
# ``forced()``, an exporter session without a card)
_forced = int(os.environ.get('MIT_TPU_TRACE', '0') == '1')
_autograd_profiler = torch.autograd.profiler
_lock = threading.Lock()     # counters and ``_forced``: read-modify-writes
_NULL = contextlib.nullcontext()
_page_ids = itertools.count(1)
_page: contextvars.ContextVar = contextvars.ContextVar('mit_trace_page',
                                                       default=None)
_current: contextvars.ContextVar = contextvars.ContextVar('mit_trace_span',
                                                          default=None)


def tracing() -> bool:
    """Whether the tracer records: the one flag check of ``span`` and
    ``count``."""
    return bool(_forced or _autograd_profiler._is_profiler_enabled)


@contextlib.contextmanager
def forced():
    """Inside the block the tracer is on, without a profiler session."""
    _force(1)
    try:
        yield
    finally:
        _force(-1)


def _force(n: int) -> None:
    global _forced
    with _lock:
        _forced += n


class Page:
    """One ``translate`` call: its spans in the order they started, its
    counters, and its start and end (ns)."""

    __slots__ = ('id', 'spans', 'counters', 't0', 't1')

    def __init__(self, page_id: int, t0: int = 0):
        self.id = page_id
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.t0, self.t1 = t0, None


class Span:
    """A named interval of the host, inside its parent span (None for a
    stage) and its page."""

    __slots__ = ('name', 'parent', 'page', 't0', 't1', '_token')

    def __init__(self, name: str, page: Page, parent: Optional['Span'],
                 t0: Optional[int] = None, t1: Optional[int] = None):
        self.name, self.page, self.parent = name, page, parent
        self.t0, self.t1 = t0, t1
        page.spans.append(self)

    def __enter__(self):
        self._token = _current.set(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        _current.reset(self._token)
        return False

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


def span(name: str):
    """A context manager that records the host's time in ``name`` as a
    child of the span it runs in; outside a page, or with the tracer off,
    the shared null context."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _NULL
    page = _page.get()
    if page is None:
        return _NULL
    return Span(name, page, _current.get())


def add_span(name: str, t0: int, t1: int) -> None:
    """Record a finished span of ``name`` from ``t0`` to ``t1``
    (``perf_counter_ns``), timed by its caller, as a child of the current
    span."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    page = _page.get()
    if page is not None:
        Span(name, page, _current.get(), t0, t1)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the page's counter ``name``: a host value that already
    exists."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    page = _page.get()
    if page is not None:
        with _lock:
            page.counters[name] = page.counters.get(name, 0) + n


def count_sync(device) -> None:
    """Count one host wait for ``device`` in ``host_syncs`` (none on the
    CPU)."""
    if torch.device(device).type == 'cuda':
        count(HOST_SYNCS)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``; from the card the host waits for it (``host_syncs``)."""
    if t.is_cuda:
        count(HOST_SYNCS)
    return t.cpu()


def self_ns(sp: Span) -> int:
    """``sp``'s duration less the part of it its children cover."""
    kids = sorted((max(c.t0, sp.t0), min(c.t1, sp.t1))
                  for c in sp.page.spans if c.parent is sp)
    covered, end = 0, sp.t0
    for a, b in kids:
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return sp.ns - covered


@contextlib.contextmanager
def page(export: Optional[str] = None):
    """One page of the tracer (yields its ``Page``, or None with the tracer
    off). With ``export`` and ``MIT_TPU_PROFILE_DIR`` set, the page runs
    under an exporter session (``Export``) named ``export``."""
    session = Export(export) if export and PROFILE_DIR else None
    if session is not None:
        session.start()
    p = None
    try:
        if tracing():
            p = Page(next(_page_ids), time.perf_counter_ns())
            PAGES.append(p)
            page_token, span_token = _page.set(p), _current.set(None)
        try:
            yield p
        finally:
            if p is not None:
                p.t1 = time.perf_counter_ns()
                _current.reset(span_token)
                _page.reset(page_token)
    finally:
        if session is not None:
            session.write(p)


class Export:
    """A ``torch.profiler`` session of device activity only (none without
    a card), written with a page's spans and counters as one Chrome trace
    ``<MIT_TPU_PROFILE_DIR>/<name>-<ms>.json``.

    The profiler stamps device events in wall-clock ns
    (``time.time_ns``); the spans are in ``perf_counter_ns``. The two
    clocks are read together when the session starts, and every span is
    moved by their difference, so that a gap on the device lies under the
    span the host was in."""

    def __init__(self, name: str):
        os.makedirs(PROFILE_DIR, exist_ok=True)
        self.path = os.path.join(PROFILE_DIR,
                                 f'{name}-{int(time.time() * 1000)}.json')
        self.prof = None
        self.offset = 0

    def start(self) -> None:
        if torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        else:
            _force(1)
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        self.offset = wall - (a + b) // 2

    def write(self, page: Optional[Page]) -> None:
        trace = {'traceEvents': []}
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            part = self.path + '.part'
            self.prof.export_chrome_trace(part)
            with open(part) as f:
                trace = json.load(f)
            os.remove(part)
        else:
            _force(-1)
        if page is not None:
            shift = self.offset - int(trace.get('baseTimeNanoseconds', 0))
            trace['traceEvents'].extend(chrome_events(page, shift))
        with open(self.path, 'w') as f:
            json.dump(trace, f)
        logger.info(f'device trace written to {self.path}')


def chrome_events(page: Page, shift_ns: int) -> List[dict]:
    """The page's spans as complete events on a host track of their own
    and its counters as counter events at the page's end; a time ``t``
    (``perf_counter_ns``) is at ``(t + shift_ns) / 1000`` us."""
    pid, tid = os.getpid(), 1_000_000_000 + page.id

    def us(t):
        return (t + shift_ns) / 1000

    index = {id(sp): i for i, sp in enumerate(page.spans)}
    events = [{'ph': 'M', 'name': 'thread_name', 'pid': pid, 'tid': tid,
               'args': {'name': f'spans of page {page.id}'}}]
    for i, sp in enumerate(page.spans):
        if sp.t1 is None:
            continue
        events.append({
            'ph': 'X', 'cat': 'span', 'name': sp.name, 'pid': pid,
            'tid': tid, 'ts': us(sp.t0), 'dur': sp.ns / 1000,
            'args': {'page': page.id, 'span': i,
                     'parent': (None if sp.parent is None
                                else index.get(id(sp.parent))),
                     'self_us': self_ns(sp) / 1000}})
    end = page.t1 if page.t1 is not None else time.perf_counter_ns()
    for name, value in sorted(page.counters.items()):
        events.append({'ph': 'C', 'name': name, 'pid': pid,
                       'ts': us(end), 'args': {name: value}})
    return events


class StageTimer:
    """Accumulates per-stage wall-clock durations for one pipeline run;
    each stage is a span of the tracer (sub-spans never enter
    ``durations``)."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.durations: Dict[str, float] = {}
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        try:
            with span(name):
                try:
                    yield
                finally:
                    if self.sync is not None:
                        self.sync()
        finally:
            dt = time.perf_counter() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt

    def report(self) -> Dict[str, float]:
        return dict(self.durations)

    def summary(self) -> str:
        total = sum(self.durations.values())
        parts = [f'{k}: {v * 1000:.1f}ms' for k, v in self.durations.items()]
        return f'{" | ".join(parts)} | total {total * 1000:.1f}ms'

