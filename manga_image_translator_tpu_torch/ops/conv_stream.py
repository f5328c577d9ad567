"""Streaming stride-1 VALID NHWC convolution — kernel K5.

Counterpart of the JAX package's ``ops/pallas_conv.conv2d_stream``: a
stride-1 VALID convolution over an NHWC input that the caller has already
padded, HWIO weights, f32 accumulation, with bias, ReLU and the cast to the
output dtype fused into the epilogue. The LaMa generator runs its stem and
final conv through it.

* ``conv2d_stream_ref``: the plain PyTorch version (``F.conv2d`` in f32 on
  permuted views; cuDNN's TF32 is switched off for the call, so on the card
  it is an f32 reference too).
* ``conv2d_stream``: the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches ``csrc/conv_stream.cu`` or raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

KERNEL = 'conv_stream'
KERNEL_WIDTHS = (1, 3, 5, 7)       # KW the kernel is built for
MAX_KH = 7
MAX_GRID_Z = 65535     # images x output-channel groups of 16
# (input dtype, output dtype) pairs the kernel serves
DTYPES = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)}


def conv2d_stream_ref(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      relu: bool = False,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           out_dtype: torch.dtype) -> None:
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f'conv2d_stream: x {tuple(x.shape)} and HWIO w '
                         f'{tuple(w.shape)} do not fit')
    kh, kw, _, cout = w.shape
    if kw not in KERNEL_WIDTHS or not 1 <= kh <= MAX_KH:
        raise ValueError(f'conv2d_stream: kernel {kh}x{kw}: the kernel is '
                         f'built for KH <= {MAX_KH}, KW in {KERNEL_WIDTHS}')
    if x.shape[1] < kh or x.shape[2] < kw:
        raise ValueError(f'conv2d_stream: input {tuple(x.shape)} smaller '
                         f'than the {kh}x{kw} window')
    if x.shape[0] * -(-cout // 16) > MAX_GRID_Z:
        raise ValueError(f'conv2d_stream: batch {x.shape[0]} too large for '
                         f'one launch')
    if (x.dtype, out_dtype) not in DTYPES:
        raise TypeError(f'conv2d_stream: {x.dtype} -> {out_dtype} is not '
                        f'served')
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f'conv2d_stream: bias {tuple(bias.shape)} for '
                         f'{cout} outputs')
    for t in (w, bias):
        if t is not None and t.device != x.device:
            raise ValueError('conv2d_stream: weights and input on different '
                             'devices')


def conv2d_stream(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, relu: bool = False,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (N, H, W, Cin) padded, w (KH, KW, Cin, Cout) →
    (N, H-KH+1, W-KW+1, Cout) in ``out_dtype`` (default x's dtype)."""
    if x.device.type == 'cpu':
        return conv2d_stream_ref(x, w, bias, relu, out_dtype)
    if x.device.type != 'cuda':
        raise ValueError(f'conv2d_stream: unsupported device {x.device}')
    out_dtype = out_dtype or x.dtype
    _check(x, w, bias, out_dtype)
    n, hp, wp, cin = x.shape
    kh, kw, _, cout = w.shape
    x = x.contiguous()
    w32 = w.float().contiguous()
    b32 = bias.float().contiguous() if bias is not None else None
    out = torch.empty((n, hp - kh + 1, wp - kw + 1, cout), dtype=out_dtype,
                      device=x.device)
    p = cuda_build.ptr
    status = cuda_build.entry(KERNEL)(
        p(x), p(w32), p(b32) if b32 is not None else None, p(out),
        n, hp, wp, cin, kh, kw, cout, int(relu),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        cuda_build.current_stream(x.device))
    cuda_build.check(status, 'conv_stream kernel')
    cuda_build.LAUNCHES[KERNEL] += 1
    return out
