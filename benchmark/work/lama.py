"""The LaMa generator per crop batch (N, H, W): the convolutions' FLOPs
counted on the meta device (bf16), and the Fourier units' (18 blocks, two
each, 192 channels at an eighth of the crop): the spectral 1x1 conv and
the FFT-minimal cost, float32-accurate (K4's 3xTF32)."""
from __future__ import annotations

import functools
import math

from . import counted_flops


@functools.lru_cache(maxsize=None)
def _build(n_blocks):
    def build():
        from ..reference import lama
        model = lama.LamaGenerator(n_blocks).eval()

        def fn(x):
            return model(x[..., :3], x[..., 3:])
        return fn
    return build


def fourier_flops(n, h, w, n_blocks, c=192):
    h8, w8 = h // 8, w // 8
    k = w8 // 2 + 1
    per = n * (2 * (2 * c) ** 2 * h8 * k
               + 2 * 2.5 * h8 * w8 * math.log2(h8 * w8) * c)
    return 2 * n_blocks * per


def flops(calls, spec):
    n_blocks = spec['blocks']
    out = []
    for n, h, w, _ in calls['lama']:
        convs = counted_flops(_build(n_blocks), (n, h, w, 4))
        fu = fourier_flops(n, h, w, n_blocks)
        # the meta count includes the spectral 1x1 convs: take them out
        # of the bf16 share, they run in K4
        spectral = 2 * n_blocks * n * 2 * 384 ** 2 * (h // 8) * (
            (w // 8) // 2 + 1)
        out += [(convs - spectral, 'bf16'), (fu, 'f32x3')]
    return out
