"""LaMa FourierUnit — kernel K4.

Counterpart of the JAX package's ``models/lama._fourier_unit`` and of the
Pallas kernels ``ops/pallas_spectral.fourier_unit_cm`` and
``fourier_unit_cm3`` (the same function; cm3 only splits f32 products into
bf16 passes for the TPU's matrix unit):

    out = irfft2(relu(conv1x1(rfft2(x, 'ortho')) + b), s=(H, W), 'ortho')

over axes (1, 2) of a channels-last ``(N, H, W, C)`` tensor. The 1×1 conv
maps the 2C interleaved spectrum channels (``2c`` = re of ``c``, ``2c+1`` =
im of ``c``) to 2C in the same order; ``w_spec`` is its ``(2C, 2C)``
(out, in) matrix with BN folded in, ``b_spec`` the folded ``(2C,)`` bias.
Everything inside runs in f32 (the reference's fp32 island); the result
takes x's dtype.

* ``fourier_unit_ref``: the plain PyTorch version (``torch.fft`` + einsum).
* ``fourier_unit``: the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches ``csrc/fourier_unit.cu`` or raises.

The kernel computes the transforms as dense DFTs against twiddle tables
(``dft_tables``: built in float64 on the host once per (H, W), cached on
the device) and keeps every spectrum in the layout ``(N, H, K, 2C)`` with
the real parts in channels ``[0, C)`` and the imaginary parts in
``[C, 2C)``. The 1×1 conv's weights are de-interleaved into that order once
per weight set (``spectral_weights``). Every product runs on the tensor
cores as 3xTF32 (each f32 operand split into two TF32 parts, three
passes), which keeps f32 accuracy; C must be a multiple of 8 on the card.
"""
from __future__ import annotations

import weakref
from typing import Dict, Tuple

import numpy as np
import torch

from . import cuda_build

KERNEL = 'fourier_unit'
MAX_ROWS = 1024        # longest contraction the kernel's row table holds
MAX_GRID_Z = 65535     # batch of one DFT stage: N * H or N * (W // 2 + 1)


def fourier_unit_ref(x: torch.Tensor, w_spec: torch.Tensor,
                     b_spec: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    spec = torch.fft.rfft2(x.float(), dim=(1, 2), norm='ortho')
    # interleave re/im per channel: (N, H, K, C, 2) -> (N, H, K, 2C)
    inter = torch.view_as_real(spec).reshape(n, h, w // 2 + 1, 2 * c)
    y = torch.relu(torch.einsum('nhki,oi->nhko', inter, w_spec.float())
                   + b_spec.float())
    y = torch.view_as_complex(y.reshape(n, h, w // 2 + 1, c, 2)
                              .contiguous())
    out = torch.fft.irfft2(y, s=(h, w), dim=(1, 2), norm='ortho')
    return out.to(x.dtype)


def dft_tables(h: int, w: int) -> Dict[str, np.ndarray]:
    """Real f32 matrices that realise the ortho rfft2 / irfft2 over (H, W)
    as four products (K = W // 2 + 1; the norm 1/sqrt(HW) rides on the
    H stages):

    * ``fwd_w`` (2K, W): rows [0, K) cos, rows [K, 2K) -sin;
    * ``fwd_h`` (2H, 2H): [[cos, sin], [-sin, cos]] * norm over the stacked
      (re; im) H axis;
    * ``inv_h`` (2H, 2H): [[cos, -sin], [sin, cos]] * norm;
    * ``inv_w`` (W, 2K): [fold * cos | -fold * sin], fold = 1 at the DC bin
      (and the Nyquist bin of an even W), else 2. The sine column of each
      of those bins is exactly 0, so the c2r transform ignores their
      imaginary parts, as ``irfft2`` does.
    """
    k = w // 2 + 1
    norm = 1.0 / np.sqrt(h * w)
    ang_w = 2 * np.pi * np.outer(np.arange(k), np.arange(w)) / w   # (K, W)
    cos_w, sin_w = np.cos(ang_w), np.sin(ang_w)
    sin_w[0] = 0.0
    if w % 2 == 0:
        sin_w[k - 1] = 0.0
    ang_h = 2 * np.pi * np.outer(np.arange(h), np.arange(h)) / h   # (H, H)
    cos_h, sin_h = np.cos(ang_h), np.sin(ang_h)
    fold = np.full((k, 1), 2.0)
    fold[0] = 1.0
    if w % 2 == 0:
        fold[k - 1] = 1.0
    return {
        'fwd_w': np.concatenate([cos_w, -sin_w]).astype(np.float32),
        'fwd_h': (np.block([[cos_h, sin_h], [-sin_h, cos_h]]) * norm
                  ).astype(np.float32),
        'inv_h': (np.block([[cos_h, -sin_h], [sin_h, cos_h]]) * norm
                  ).astype(np.float32),
        'inv_w': np.concatenate([fold * cos_w, -fold * sin_w]).T
        .astype(np.float32).copy(),
    }


_TABLES: Dict[Tuple[int, int, torch.device], Dict[str, torch.Tensor]] = {}


def _device_tables(h: int, w: int, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """``dft_tables`` on the device, each row zero-padded to a multiple of
    4 floats (the kernel's 16-byte copies; it takes lda = that width)."""
    key = (h, w, device)
    tabs = _TABLES.get(key)
    if tabs is None:
        tabs = {name: torch.from_numpy(np.pad(
                    arr, ((0, 0), (0, -arr.shape[1] % 4)))).to(device)
                for name, arr in dft_tables(h, w).items()}
        _TABLES[key] = tabs
    return tabs


def spectral_weights(w_spec: torch.Tensor, b_spec: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2C, 2C) interleaved (out, in) + (2C,) → the (2C_in, 2C_out) f32
    matrix and (2C,) bias in the kernel's [re | im] channel order."""
    c = w_spec.shape[0] // 2
    wt = w_spec.detach().float()
    wq = torch.empty((2 * c, 2 * c), dtype=torch.float32, device=wt.device)
    wq[:c, :c] = wt[0::2, 0::2].t()     # re in -> re out
    wq[:c, c:] = wt[1::2, 0::2].t()     # re in -> im out
    wq[c:, :c] = wt[0::2, 1::2].t()     # im in -> re out
    wq[c:, c:] = wt[1::2, 1::2].t()     # im in -> im out
    bt = b_spec.detach().float()
    return wq.contiguous(), torch.cat([bt[0::2], bt[1::2]]).contiguous()


def _check_weights(c: int, w_spec: torch.Tensor, b_spec: torch.Tensor,
                   device: torch.device) -> None:
    if tuple(w_spec.shape) != (2 * c, 2 * c) or tuple(b_spec.shape) != (2 * c,):
        raise ValueError(f'fourier_unit: weights {tuple(w_spec.shape)} / '
                         f'{tuple(b_spec.shape)} do not fit C={c}')
    if w_spec.device != device or b_spec.device != device:
        raise ValueError('fourier_unit: weights and input on different '
                         'devices')


# id(w_spec) -> (w_spec ref, its state, b_spec ref, b_spec state, packed
# weights); an entry leaves with its w_spec
_PACKED: Dict[int, tuple] = {}


def _state(t: torch.Tensor) -> Tuple[int, int]:
    """Storage and in-place version of ``t`` (inference tensors keep no
    version counter)."""
    return t.data_ptr(), (-1 if t.is_inference() else t._version)


def _packed(w_spec: torch.Tensor, b_spec: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``spectral_weights`` once per weight set (checked when packed)."""
    key = id(w_spec)
    hit = _PACKED.get(key)
    if (hit is not None and hit[0]() is w_spec and hit[1] == _state(w_spec)
            and hit[2]() is b_spec and hit[3] == _state(b_spec)):
        return hit[4]
    _check_weights(w_spec.shape[0] // 2, w_spec, b_spec, w_spec.device)
    packed = spectral_weights(w_spec, b_spec)
    if hit is None or hit[0]() is not w_spec:
        weakref.finalize(w_spec, _PACKED.pop, key, None)
    _PACKED[key] = (weakref.ref(w_spec), _state(w_spec), weakref.ref(b_spec),
                    _state(b_spec), packed)
    return packed


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f'fourier_unit: expected (N, H, W, C), got '
                         f'{tuple(x.shape)}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'fourier_unit: expected float32 or bfloat16, got '
                        f'{x.dtype}')
    n, h, w, c = x.shape
    if (max(2 * h, w, 2 * (w // 2 + 1), 2 * c) > MAX_ROWS or c % 8
            or n * max(h, w // 2 + 1) > MAX_GRID_Z):
        raise ValueError(f'fourier_unit: shape {tuple(x.shape)} outside the '
                         f'kernel\'s limits (2H, W, 2C <= {MAX_ROWS}; C a '
                         f'multiple of 8; N * max(H, K) <= {MAX_GRID_Z})')


# (shape, dtype, device) -> (spectra shape, their half in bytes, the
# launch's table pointers and sizes): what a call needs beyond its tensors
_PLANS: Dict[tuple, tuple] = {}


def _plan(x: torch.Tensor) -> tuple:
    key = (x.shape, x.dtype, x.device)
    plan = _PLANS.get(key)
    if plan is None:
        _check(x)
        n, h, w, c = x.shape
        k = w // 2 + 1
        tabs = _device_tables(h, w, x.device)
        plan = ((2, n, h, k, 2 * c), n * h * k * 2 * c * 4,
                tuple(tabs[t].data_ptr()
                      for t in ('fwd_w', 'fwd_h', 'inv_h', 'inv_w')),
                (n, h, w, c, int(x.dtype == torch.bfloat16)))
        _PLANS[key] = plan
    return plan


def fourier_unit(x: torch.Tensor, w_spec: torch.Tensor,
                 b_spec: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → (N, H, W, C) in x's dtype; one counted call (the
    kernel runs as five launches of its 3xTF32 tensor-core GEMM). Per
    call the host looks up the shape's plan and the packed weights,
    allocates the output and the spectra, and calls the kernel."""
    if x.device.type == 'cpu':
        return fourier_unit_ref(x, w_spec, b_spec)
    if x.device.type != 'cuda':
        raise ValueError(f'fourier_unit: unsupported device {x.device}')
    spectra_shape, half, tables, dims = _plan(x)
    x = x.contiguous()
    if x.data_ptr() % 16:           # the kernel's copies are 16-byte
        x = x.clone()
    wq, bq = _packed(w_spec, b_spec)
    if wq.shape[0] != 2 * dims[3] or wq.device != x.device:
        _check_weights(dims[3], w_spec, b_spec, x.device)
    out = torch.empty_like(x)
    # the spectra, (N, H, K, 2C) f32 each, in one buffer; the stages
    # ping-pong between its halves
    s0 = torch.empty(spectra_shape, dtype=torch.float32,
                     device=x.device).data_ptr()
    status = cuda_build.entry(KERNEL)(
        x.data_ptr(), out.data_ptr(), wq.data_ptr(), bq.data_ptr(), *tables,
        s0, s0 + half, *dims, cuda_build.current_stream(x.device))
    cuda_build.check(status, 'fourier_unit kernel')
    cuda_build.count_launch(KERNEL)
    return out
