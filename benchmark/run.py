"""Runs one cell of the benchmark on the card and prints its result line.

    python3 benchmark/run.py --workload default.text_heavy --seed 1 \
        --seconds 30 --trace 0

Where the checkout lacks the cell's weights, a process of its own writes
them first (``prepare.py``), and the set-up clock starts when it is done.
See ``harness.py`` for what a run does and ``BENCHMARK.json`` for the
cells.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host stages' thread pools (OpenMP,
# BLAS, OpenCV, PyTorch's intra-op pool) take 4 of the machine's cores
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[_var] = '4'

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import cell  # noqa: E402


def prepare(argv) -> int:
    """Writes the cell's weights in a child process if the checkout lacks
    them: -1 if nothing had to be written, else the child's exit code. A
    cell that cannot be read is left to the harness to report."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument('--workload')
    known, _ = ap.parse_known_args(argv)
    try:
        _, _, config, _ = cell.load_cell(known.workload)
    except (OSError, ValueError, KeyError, StopIteration, SystemExit):
        return -1
    if cell.weights_ready(config):
        return -1
    return subprocess.run(
        [sys.executable, '-m', 'benchmark.prepare', '--workload',
         known.workload], cwd=cell.ROOT).returncode


if __name__ == '__main__':
    rc = prepare(sys.argv[1:])
    if rc > 0:
        sys.exit(rc)
    if rc == 0:
        T_START = time.time()
    from benchmark import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
