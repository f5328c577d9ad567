"""Writes a cell's weights into the checkout once, in a process of its
own, before the timed process starts (``run.py``): drawing them is the
benchmark's work, not the program's, so it stays out of ``setup_s`` and
out of the timed process's memory.

    python3 -m benchmark.prepare --workload default.text_heavy
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    args = ap.parse_args(argv)
    from . import cell, harness
    _, spec, config, _ = cell.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(spec['chips']):
        print('benchmark: no CUDA device to write the weights on',
              file=sys.stderr)
        return 2
    t0 = time.time()
    mdir = harness.model_dir(config)
    written = harness.ensure_weights(config, mdir, 'cuda')
    print(f'benchmark: weights {written or "present"} in {mdir}, '
          f'{time.time() - t0:.1f} s', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
