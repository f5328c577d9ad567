"""The control comes out not correct: on the card, at each cell's own size,
the plain reference computed one precision below the one the
configuration states (``control`` in the configuration file) is put in the
program's place, and the run's own comparison (``run.py --control 1``)
finds at least one of the cell's numbers past its limit and reports
``correct`` false, on three seeds. The result's ``program`` holds the
program's own readings of the same run.

    python -m pytest benchmark/tests/test_bench_control.py
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w['name'] for w in json.load(open(os.path.join(
    ROOT, 'BENCHMARK.json')))['workloads']]

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def card():
    """The card, or a skip: decided here, not at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda', 0)


@pytest.mark.parametrize('seed', [7000000001, 7000000002, 7000000003])
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_a_limit(card, cell, seed):
    seconds = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))[
        'run_seconds']
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', cell, '--seed',
         str(seed), '--seconds', str(seconds), '--trace', '0',
         '--control', '1'], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert not result['correct'], (result['checked'], result['program'])
    served = result['checked']['sampled_pages_served']
    assert served['value'] == served['limit'], served
    over = [k for k, v in result['checked'].items()
            if v['value'] is None or not v['value'] <= v['limit']]
    assert over, result['checked']
