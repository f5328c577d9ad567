"""The readers of the program's own spans and counters
(``program_trace.py``) on a synthetic window: pages built with the
program's tracer types, one of them a warm-up page that ends before the
window's first stage."""
import collections
import importlib
import json
import os

import pytest

from benchmark import harness, seams
from manga_image_translator_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000           # ns


def page(page_id, t0, spans, counters):
    """A finished page from ``(name, parent index or None, t0 ms, t1 ms)``
    rows, its times offset by ``t0`` ms."""
    p = profiling.Page(page_id, t0 * MS)
    made = []
    for name, parent, a, b in spans:
        made.append(profiling.Span(name, p, None if parent is None
                                   else made[parent], (t0 + a) * MS,
                                   (t0 + b) * MS))
    p.counters.update(counters)
    p.t1 = (t0 + max(b for *_, b in spans) + 1) * MS
    return p


def window_pages():
    warm = page(1, 0, [('ocr', None, 0, 50), ('ocr.beam', 0, 0, 40)],
                {'ocr.tokens': 9, 'ocr.line_steps': 9, 'host_syncs': 99})
    a = page(2, 100, [
        ('detect', None, 0, 10), ('detect.postprocess', 0, 2, 6),
        ('ocr', None, 10, 60), ('ocr.plan', 2, 10, 14),
        ('ocr.beam', 2, 20, 40), ('graph.capture', 4, 22, 25),
        ('ocr.encode', 4, 30, 34), ('ocr.beam', 2, 40, 50),
        ('textline_merge', None, 60, 70), ('merge.sort', 8, 62, 69),
        ('mask_refine', None, 70, 80), ('mask.assign', 10, 70, 73),
        ('render', None, 80, 90), ('render.region', 12, 80, 82),
        ('render.region', 12, 82, 86)],
        {'ocr.tokens': 30, 'ocr.line_steps': 160, 'host_syncs': 40})
    b = page(3, 200, [
        ('detect', None, 0, 10), ('detect.postprocess', 0, 1, 3),
        ('ocr', None, 10, 30), ('ocr.plan', 2, 10, 12),
        ('ocr.beam', 2, 12, 20),
        ('textline_merge', None, 30, 35), ('merge.sort', 5, 30, 34),
        ('mask_refine', None, 35, 40), ('mask.assign', 7, 35, 36),
        ('render', None, 40, 50), ('render.region', 9, 40, 46)],
        {'ocr.tokens': 10, 'ocr.line_steps': 40, 'host_syncs': 20})
    return [warm, a, b]


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(profiling, 'PAGES', collections.deque(
        window_pages(), maxlen=profiling.PAGES_KEPT))
    config = json.load(open(os.path.join(HERE, 'configs', 'default.json')))
    rec = seams.Recorder()
    # the benchmark's own stage spans: the window opens at 100 ms
    rec.spans = [('detect', 100 * MS, 110 * MS), ('ocr', 110 * MS,
                                                  160 * MS)]
    return harness.Run(config, {}, rec)


def read(name, run):
    return importlib.import_module(f'benchmark.metrics.{name}').read(run)


@pytest.mark.parametrize('name,want', [
    ('db_postprocess_ms', (4 + 2) / 2),
    ('ocr_plan_ms', (4 + 2) / 2),
    # self time: page 2's beams 20 + 10 less the capture (3) and the
    # encoder (4) nested in the first; page 3's 8
    ('ocr_beam_ms', (20 - 3 - 4 + 10 + 8) / 2),
    ('merge_sort_ms', (7 + 4) / 2),
    ('mask_assign_ms', (3 + 1) / 2),
    ('graph_capture_ms', 3 / 2),
    ('render_region_ms', (2 + 4 + 6) / 3),
    ('ocr_decode_fill_pct', 100 * 40 / 200),
    ('host_syncs_per_page', (40 + 20) / 2),
])
def test_program_span_readers(run, name, want):
    assert read(name, run) == pytest.approx(want)


def test_a_span_no_page_ran_reads_zero(run):
    """A span no page ran reads 0 a page; a mean of no regions, or a share
    of no beam steps, reads nothing."""
    for p in profiling.PAGES:
        p.spans = [sp for sp in p.spans if sp.name != 'graph.capture']
    assert read('graph_capture_ms', run) == 0.0
    for p in profiling.PAGES:
        p.spans = [sp for sp in p.spans if sp.name != 'render.region']
        p.counters['ocr.line_steps'] = 0
    assert read('render_region_ms', run) is None
    assert read('ocr_decode_fill_pct', run) is None


NAMES = ['db_postprocess_ms', 'ocr_plan_ms', 'ocr_beam_ms',
         'ocr_decode_fill_pct', 'merge_sort_ms', 'mask_assign_ms',
         'render_region_ms', 'graph_capture_ms', 'host_syncs_per_page']


@pytest.mark.parametrize('name', NAMES)
def test_readers_without_the_tracer_read_nothing(run, monkeypatch, name):
    """A program without the tracer (the parent of the change that added
    it), or a window in which it recorded nothing, reads None and does not
    raise."""
    monkeypatch.setattr(profiling, 'PAGES', collections.deque())
    assert read(name, run) is None
    monkeypatch.delattr(profiling, 'PAGES')
    assert read(name, run) is None


def test_every_new_metric_is_listed():
    bench = json.load(open(os.path.join(os.path.dirname(HERE),
                                        'BENCHMARK.json')))
    listed = {m['name']: m for m in bench['per_layer']}
    cells = [w['name'] for w in bench['workloads']]
    for name in NAMES:
        m = listed[name]
        assert m['source'] == 'program_span' and m['moves'] == 'page_p90_s'
        assert m['workloads'] == cells
