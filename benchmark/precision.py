"""The arithmetic the plain references compute in.

The references run in float32 with TF32 off. A control computes the same
reference one precision below the one the configuration states for that
network: the operands of every product (weights and activations of each
convolution and linear layer, and the inputs of the attention products)
are rounded to the lower format, the products accumulate in float32, as
the tensor cores do. ``bf16`` and ``tf32`` round the float32 mantissa to 7
and 10 bits (round to nearest even); ``fp8`` casts to float8 e4m3 after
scaling each tensor so that its largest magnitude is the format's largest
(per-tensor scaling, as fp8 inference uses).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

MANTISSA_BITS = {'bf16': 7, 'tf32': 10}
FP8_MAX = 448.0

_mode = 'float32'


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    shift = 23 - bits
    b = x.float().contiguous().view(torch.int32)
    lsb = (b >> shift) & 1
    b = (b + ((1 << (shift - 1)) - 1) + lsb) & ~((1 << shift) - 1)
    return b.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    amax = xf.abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return xf
    scale = amax / FP8_MAX
    return (xf / scale).to(torch.float8_e4m3fn).float() * scale


def round_to(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == 'float32' or not x.is_floating_point():
        return x
    if mode == 'fp8':
        return round_fp8(x).to(x.dtype)
    return round_mantissa(x, MANTISSA_BITS[mode]).to(x.dtype)


def r(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the current mode (the identity in float32)."""
    return round_to(x, _mode)


@contextlib.contextmanager
def computing(mode: str):
    """Products inside run with operands in ``mode``; TF32 stays off so
    that float32 means float32."""
    global _mode
    old = (_mode, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    _mode = mode
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (_mode, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


_PRODUCTS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def lowered(model: nn.Module, mode: str) -> nn.Module:
    """``model`` with every convolution's and linear layer's weight
    rounded to ``mode`` in place and its input rounded at each call."""
    if mode == 'float32':
        return model
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _PRODUCTS):
                m.weight.copy_(round_to(m.weight, mode))
                m.register_forward_pre_hook(
                    lambda _m, args: (round_to(args[0], mode),) + args[1:])
    return model


def compute_dtype(mode: str) -> torch.dtype:
    """The element type of a plain elementwise reference in ``mode``."""
    return torch.bfloat16 if mode == 'bf16' else torch.float32
