"""A run with the timed path broken underneath comes out not correct: the
harness, without its look for a card, drives the tiny cell on the CPU
with each fault this kind of cell can have (a token or an answer altered
where it is produced, pixels written outside the mask or the text), and
once without a fault."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(scope='module')
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp('bench_work'))


def drive(fault, work):
    out = subprocess.run(
        [sys.executable, '-m', 'benchmark.tests.fault_run', fault, work],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, OMP_NUM_THREADS='4'))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sound_run_is_correct(work):
    res = drive('none', work)
    assert res['correct'], res['checked']


@pytest.mark.parametrize('fault,number', [
    ('ocr_token', 'ocr48_logprob_gap'),
    ('sugoi_token', 'sugoi_logprob_gap'),
    ('lama_pixels', 'lama_masked_rms'),
    ('outside_mask', 'inpaint_outside_mask_px'),
    ('render_spill', 'page_outside_text_px')])
def test_fault_is_not_correct(work, fault, number):
    res = drive(fault, work)
    assert not res['correct']
    got = res['checked'][number]
    assert got['value'] > got['limit']


def test_control_is_not_correct(work):
    """The control judged by the run's own comparison (``--control 1``):
    at the tiny size every network's number lies past its limit."""
    res = drive('control', work)
    assert not res['correct']
    over = [k for k, v in res['checked'].items()
            if v['value'] is None or not v['value'] <= v['limit']]
    assert over, res['checked']
