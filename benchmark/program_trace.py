"""What the program's own tracer (``utils/profiling`` of the port)
recorded in the window: its pages, each with its spans and counters. The
profiler of a ``--trace 1`` run turns the tracer on, so the pages of the
warm-up are not recorded; the pages read are those that end after the
window's first stage begins. A program without the tracer, or a run
without the profiler, has no pages: the readers then read nothing."""
from __future__ import annotations

from typing import List, Optional


def pages(run) -> Optional[list]:
    """The finished pages the tracer kept that reach into the window, or
    None."""
    try:
        from manga_image_translator_tpu_torch.utils import profiling
    except ImportError:
        return None
    kept = getattr(profiling, 'PAGES', None)
    if not kept:
        return None
    start = min((t0 for _, t0, _ in run.rec.spans), default=None)
    window = [p for p in kept if p.t1 is not None
              and (start is None or p.t1 > start)]
    return window or None


def spans(window: list, name: str) -> list:
    return [sp for p in window for sp in p.spans
            if sp.name == name and sp.t1 is not None]


def self_ns(sp) -> int:
    """A span's duration less the union of its children's intervals."""
    kids = sorted((max(c.t0, sp.t0), min(c.t1, sp.t1))
                  for c in sp.page.spans
                  if c.parent is sp and c.t1 is not None)
    covered, end = 0, sp.t0
    for a, b in kids:
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return (sp.t1 - sp.t0) - covered


def ms_a_page(run, name: str, self_time: bool = False):
    """Milliseconds a page in spans called ``name`` (their self time with
    ``self_time``), over the window's pages; 0 where none ran."""
    window = pages(run)
    if window is None:
        return None
    found = spans(window, name)
    ns = sum(self_ns(sp) if self_time else sp.t1 - sp.t0 for sp in found)
    return ns / 1e6 / len(window)


def counter(window: List, name: str) -> int:
    return sum(p.counters.get(name, 0) for p in window)
