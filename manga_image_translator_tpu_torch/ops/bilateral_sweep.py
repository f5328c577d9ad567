"""Time variants of K1 (``csrc/bilateral.cu``) on the card: the strip
height S, the warps per block NY, the blocks per SM that
``__launch_bounds__`` asks of the r = 8 instance and SFU_EVERY (which
outputs take their colour weights from the special-function unit rather
than the table), each variant compiled from the source with those
constants replaced.

Run on a machine with the card, from the root of a checkout:

    python -m manga_image_translator_tpu_torch.ops.bilateral_sweep

For each variant it prints one JSON line: ptxas's registers and spills of
the r = 8 instance, its static SASS count (total and by opcode; with every
column unrolled that is what one thread issues for its S outputs, less the
staging and table loops' repeats), the max abs error against the plain
version (gray levels), and the device time (ms) at the 2048x2048
page-like canvas and on uniform random bytes, measured as
``chip_smoke.py`` measures kernels. The checked-in constants are the
first variant.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import bilateral, cuda_build, sass_count

# (S, NY, blocks per SM of the r = 8 instance, SFU_EVERY)
VARIANTS = [(8, 8, 3, 2), (8, 8, 3, 1), (8, 8, 3, 3), (8, 8, 3, 4),
            (8, 8, 2, 2), (16, 4, 2, 2), (16, 4, 3, 2), (8, 4, 5, 2)]


def variant_source(src: str, s: int, ny: int, min_blocks: int,
                   sfu_every: int) -> str:
    out = re.sub(r'constexpr int S = \d+;', f'constexpr int S = {s};', src)
    out = re.sub(r'constexpr int NY = \d+;', f'constexpr int NY = {ny};', out)
    out = re.sub(r'RR > 0 \? \d+ : 2\)', f'RR > 0 ? {min_blocks} : 2)', out)
    out = re.sub(r'constexpr int SFU_EVERY = \d+;',
                 f'constexpr int SFU_EVERY = {sfu_every};', out)
    return out


def main() -> int:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke
    src = (cuda_build.CSRC / cuda_build.SOURCES['bilateral']).read_text()
    inputs = {at: chip_smoke.k1_inputs(h, w, kind)[None].contiguous()
              for at, (h, w, kind) in chip_smoke.K1_INPUTS.items()
              if at != 'page_1448x2048'}
    refs = {at: bilateral.bilateral_filter_ref(img)
            for at, img in inputs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        builds = []            # every variant compiled at once
        for v in VARIANTS:
            cu = Path(tmp) / ('k1_' + '_'.join(map(str, v)) + '.cu')
            cu.write_text(variant_source(src, *v))
            so = cu.with_suffix('.so')
            builds.append((v, so, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-Xptxas', '-v',
                 '-o', str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for (s, ny, mb, se), so, proc in builds:
            _, err = proc.communicate()
            row = {'S': s, 'NY': ny, 'blocks_per_sm': mb, 'SFU_EVERY': se}
            if proc.returncode != 0:
                row['error'] = err[-2000:]
                print(json.dumps(row), flush=True)
                continue
            row['ptxas'] = {k: v for k, v in sass_count.ptxas_info(err).items()
                            if 'ILi8EE' in k}    # the r = 8 instance
            # its static SASS: with every column unrolled, all but the
            # staging and table loops run once per thread (S outputs)
            sass = subprocess.run([str(Path(cuda_build._nvcc()).with_name(
                'cuobjdump')), '-sass', str(so)], capture_output=True,
                text=True).stdout
            for k, ops in sass_count.opcode_counts(sass).items():
                if 'ILi8EE' in k:
                    row['sass_total'] = sum(ops.values())
                    row['sass_top'] = dict(ops.most_common(24))
            fn = ctypes.CDLL(str(so)).mit_bilateral_u8
            fn.restype = ctypes.c_int
            fn.argtypes = cuda_build.ENTRY_POINTS['bilateral'][2]

            def run(img):
                out = torch.empty_like(img)
                n, h, w, _ = img.shape
                cuda_build.check(fn(cuda_build.ptr(img), cuda_build.ptr(out),
                                    n, h, w, 8, 80.0, 80.0,
                                    cuda_build.current_stream(img.device)),
                                 'bilateral variant')
                return out
            for at, img in inputs.items():
                got = run(img)
                torch.cuda.synchronize()
                row[f'{at}.err'] = int((got.int() - refs[at].int()).abs()
                                       .max())
                row[f'{at}.ms'] = chip_smoke.cuda_ms(lambda: run(img))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
