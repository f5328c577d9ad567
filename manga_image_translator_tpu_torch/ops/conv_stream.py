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

Two routes in the kernel's library. A bf16 input runs the tensor-core
implicit GEMM on bf16 weights in the kernel's own layout: ``pack_weights``
has the C side round and pack them (the layout and the tile geometry live
in ``csrc/conv_stream.cu`` only), a caller that runs one weight set many
times keeps the result and passes it as ``packed`` (the LaMa generator
does), and a call without it packs for itself. Its reference is therefore
the f32 conv of the same bf16 input with the bf16-rounded weights. It
serves the shapes its C entry points take (the LaMa stem and final conv
among them) and refuses others. An f32 input runs the f32 CUDA-core body
on the f32 weights.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

KERNEL = 'conv_stream'
KERNEL_WIDTHS = (1, 3, 5, 7)       # KW the kernel is built for
MAX_KH = 7
MAX_GRID_Z = 65535     # images x output-channel groups of 16 (CUDA cores)
# (input dtype, output dtype) pairs the kernel serves: f32 on the CUDA
# cores, bf16 (the shapes mit_conv_stream_tc takes) on the tensor cores
DTYPES = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)}


def conv2d_stream_ref(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      relu: bool = False,
                      out_dtype: Optional[torch.dtype] = None,
                      packed: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The wrapper's arguments; ``packed`` is not read (the plain version
    multiplies ``w`` as given)."""
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


def pack_weights(w: torch.Tensor) -> Optional[torch.Tensor]:
    """HWIO weights rounded to bf16 and packed for the tensor-core route
    (one launch of the C side's pack kernel), or None for weights off the
    card, which the plain version takes as they are. Raises ValueError for
    a shape the route does not serve."""
    if w.device.type != 'cuda':
        return None
    kh, kw, cin, cout = w.shape
    elems = cuda_build.entry('conv_stream_tc_packed_elems')(cin, kh, kw, cout)
    if elems < 0:
        raise ValueError(f'conv2d_stream: bf16 conv {kh}x{kw}, {cin} -> '
                         f'{cout} is outside the tensor-core route')
    w32 = w.detach().float().contiguous()
    wpk = torch.empty(elems, dtype=torch.bfloat16, device=w.device)
    cuda_build.check(cuda_build.entry('conv_stream_tc_pack')(
        cuda_build.ptr(w32), cuda_build.ptr(wpk), cin, kh, kw, cout,
        cuda_build.current_stream(w.device)), 'conv_stream weight packing')
    return wpk


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
                  out_dtype: Optional[torch.dtype] = None,
                  packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, H, W, Cin) padded, w (KH, KW, Cin, Cout) →
    (N, H-KH+1, W-KW+1, Cout) in ``out_dtype`` (default x's dtype).
    ``packed``: ``pack_weights(w)`` of these weights, kept by the caller;
    only the tensor-core route reads it."""
    if x.device.type == 'cpu':
        return conv2d_stream_ref(x, w, bias, relu, out_dtype)
    if x.device.type != 'cuda':
        raise ValueError(f'conv2d_stream: unsupported device {x.device}')
    out_dtype = out_dtype or x.dtype
    _check(x, w, bias, out_dtype)
    n, hp, wp, cin = x.shape
    kh, kw, _, cout = w.shape
    x = x.contiguous()
    if x.data_ptr() % 16:           # the kernel's copies are 16-byte
        x = x.clone()
    b32 = bias.float().contiguous() if bias is not None else None
    out = torch.empty((n, hp - kh + 1, wp - kw + 1, cout), dtype=out_dtype,
                      device=x.device)
    p = cuda_build.ptr
    stream = cuda_build.current_stream(x.device)
    if x.dtype == torch.bfloat16:
        wpk = packed if packed is not None else pack_weights(w)
        status = cuda_build.entry('conv_stream_tc')(
            p(x), p(wpk), p(b32) if b32 is not None else None, p(out),
            n, hp, wp, cin, kh, kw, cout, int(relu),
            int(out_dtype == torch.bfloat16), stream)
        if status == cuda_build.REFUSED:
            raise ValueError(f'conv2d_stream: bf16 conv {kh}x{kw}, {cin} -> '
                             f'{cout} is outside the tensor-core route')
    else:
        if n * -(-cout // 16) > MAX_GRID_Z:
            raise ValueError(f'conv2d_stream: batch {n} too large for one '
                             f'launch')
        w32 = w.float().contiguous()
        status = cuda_build.entry(KERNEL)(
            p(x), p(w32), p(b32) if b32 is not None else None, p(out),
            n, hp, wp, cin, kh, kw, cout, int(relu), stream)
    cuda_build.check(status, 'conv_stream kernel')
    cuda_build.count_launch(KERNEL)
    return out
