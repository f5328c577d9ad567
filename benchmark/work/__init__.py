"""Work counts: the operations and bytes each kernel launch and each
network call needs, from the shapes the hooks recorded, and the published
peaks of one H100 SXM they are held against (NVIDIA's data sheet, dense,
at the 700 W limit).

``kernels.py`` holds the five hand-written kernels' (bytes, operations,
peak) per launch; each network's module (``dbnet.py``, ``ocr48.py``, ...)
gives ``flops(calls, spec)``: a list of (model FLOPs, peak of the
precision the call runs in) for the network's recorded calls.
"""
from __future__ import annotations

import functools
import importlib

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK = {'bf16': 989e12, 'tf32': 495e12, 'f32': 67e12,
        # float32-accurate products as three TF32 passes (K4)
        'f32x3': 495e12 / 3}


def module(name: str):
    """The work module of network ``name``."""
    return importlib.import_module(f'{__name__}.{name}')


def least_seconds(nbytes: float, ops: float, peak: str) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the peak of their type, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK[peak])


@functools.lru_cache(maxsize=256)
def counted_flops(build, shape) -> float:
    """The matrix-product FLOPs of ``build()(x)`` for an input of
    ``shape``, counted by ``torch.utils.flop_counter`` on the meta device
    (no memory, no arithmetic)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device('meta'):
        fn = build()
        x = torch.empty(shape)
        with FlopCounterMode(display=False) as counter:
            fn(x)
    return float(counter.get_total_flops())
