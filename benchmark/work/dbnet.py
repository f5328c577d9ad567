"""DBNet-ResNet34: the convolutions' FLOPs at the recorded canvas, counted
on the meta device; cuDNN runs them in TF32."""
from __future__ import annotations

from . import counted_flops


def _build():
    from ..reference import dbnet
    model = dbnet.DBNet().eval()
    return lambda x: dbnet.logits(model, x)


def flops(calls, spec):
    return [(counted_flops(_build, shape), 'tf32')
            for shape in calls['dbnet']]
