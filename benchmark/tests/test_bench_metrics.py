"""Each per-layer metric's reader on a synthetic window and trace."""
import importlib
import json
import os

import pytest

from benchmark import harness, seams, trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class FakeTrace:
    """Device intervals (ns) on the host's clock, as ``Trace.intervals``
    gives them."""

    def __init__(self, t0, t1, ivs):
        self.t0_host, self.t1_host, self._ivs = t0, t1, ivs

    def intervals(self):
        return self._ivs


def synthetic_run():
    config = json.load(open(os.path.join(HERE, 'configs', 'default.json')))
    rec = seams.Recorder()
    rec.calls['k.bilateral'] = [((1, 2048, 1448, 3), 8)]
    rec.calls['ocr48.decoder'] = [(24, 5, 100, 17, 24 * 5 * 60)]
    rec.calls['k.conv_stream'] = [((1, 262, 262, 4), (7, 7, 4, 64), 2, 2)]
    rec.calls['k.fourier_unit'] = [((1, 32, 32, 192), 4)]
    rec.calls['dbnet'] = [(1, 256, 256, 3)]
    rec.calls['lama'] = [(1, 64, 64, 3)]
    rec.calls['sugoi.encoder'] = [(10, 40)]
    rec.calls['sugoi.decoder'] = [(10, 5, 40, 32)]
    rec.calls['ocr48.encoder'] = [(24, 48, 256, 3)]
    run = harness.Run(config, {}, rec)
    run.latencies = [2.0, 3.0]
    run.stages = [{'detect': 0.5, 'ocr': 0.5, 'render': 0.25},
                  {'detect': 0.75, 'ocr': 0.25, 'render': 0.5}]
    spans = [('detect', 0, 400), ('render', 600, 1000)]
    ivs = [(0, 100, 'void bilateral_kernel<8>(...)'),
           (150, 250, 'decode_step_persistent(Params)'),
           (200, 300, 'char_topk_persistent(Params)'),
           (700, 800, 'void conv_stream_tc<2>(...)'),
           (800, 900, 'fu_gemm_tf32x3<float, float>(Gemm)')]
    run.trace = trace.reduce(FakeTrace(0, 1000, ivs), spans)
    return run


def test_trace_reduction():
    t = synthetic_run().trace
    assert t['window_s'] == pytest.approx(1e-6)
    # busy: 0-100, 150-300, 700-900
    assert t['busy_s'] == pytest.approx(450e-9)
    assert t['idle_by_stage'] == pytest.approx(
        {'detect': 50e-9, 'entry': 400e-9, 'render': 100e-9})


def read(name, run):
    return importlib.import_module(f'benchmark.metrics.{name}').read(run)


def test_stage_and_entry_readers():
    run = synthetic_run()
    assert read('detect_ms', run) == pytest.approx(625.0)
    assert read('ocr_ms', run) == pytest.approx(375.0)
    assert read('render_ms', run) == pytest.approx(375.0)
    assert read('entry_ms', run) == pytest.approx(
        1000 * ((2.0 - 1.25) + (3.0 - 1.5)) / 2)
    assert read('upscale_ms', run) is None            # no such stage


def test_device_readers():
    run = synthetic_run()
    assert read('device_idle_pct', run) == pytest.approx(55.0)
    assert read('mfu_pct', run) > 0


@pytest.mark.parametrize('kernel', ['bilateral', 'decode_step', 'charhead',
                                    'conv_stream', 'fourier_unit'])
def test_roofline_readers(kernel):
    from benchmark.work import kernels, least_seconds
    run = synthetic_run()
    got = read(f'{kernel}_roofline', run)
    work = kernels.launches(run.rec, 7935)[kernel]
    assert got == pytest.approx(100 * sum(least_seconds(*w) for w in work)
                                / 100e-9)


def test_readers_without_a_trace_read_nothing():
    run = synthetic_run()
    run.trace = None
    for name in ('device_idle_pct', 'mfu_pct', 'bilateral_roofline'):
        assert read(name, run) is None


def test_every_per_layer_metric_has_a_reader():
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    for m in bench['per_layer']:
        assert hasattr(importlib.import_module(
            f'benchmark.metrics.{m["name"]}'), 'read')


def test_loop_rate_reader():
    run = synthetic_run()
    assert read('loop_pages_per_s', run) is None      # no window yet
    run.window_s = 5.0
    assert read('loop_pages_per_s', run) == pytest.approx(0.4)


def test_every_cell_reports_what_its_metrics_move():
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    cells = [w['name'] for w in bench['workloads']]

    def reported(m, cell):
        return cell in m.get('workloads', cells)

    for cell in cells:
        e2e = {m['name'] for m in bench['end_to_end'] if reported(m, cell)}
        assert 'setup_s' in e2e and len(e2e) >= 2
        layer = [m for m in bench['per_layer'] if reported(m, cell)]
        assert layer
        for m in layer:
            assert m['moves'] in e2e, (cell, m['name'])
