"""ESRGAN RRDBNet: the convolutions' FLOPs of each forward's tile batch,
counted on the meta device; cuDNN runs them in TF32."""
from __future__ import annotations

import functools
from . import counted_flops


@functools.lru_cache(maxsize=None)
def _build(nb):
    def build():
        from ..reference import esrgan
        model = esrgan.RRDBNet(nb).eval()
        return lambda x: esrgan.forward(model, x)
    return build


def flops(calls, spec):
    return [(counted_flops(_build(spec['blocks']), shape), 'tf32')
            for shape in calls['esrgan']]
