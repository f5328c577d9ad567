"""Bilateral filter (cv2.bilateralFilter semantics) — kernel K1.

Counterpart of the JAX package's ``ops/bilateral.py`` and of the Pallas
kernel ``ops/pallas_bilateral.bilateral_filter_pallas`` (the TPU default):
circular window of radius d//2, L1 colour distance over the 3 channels,
Gaussian space and colour weights, edge-replicated borders, float32 sums,
then round-half-even and clip to uint8.

* ``bilateral_filter_ref``: the plain PyTorch version (one shifted view of
  the edge-padded image per window offset).
* ``bilateral_filter`` / ``bilateral_filter_batch``: the wrappers. A CPU
  tensor takes the plain version; a CUDA tensor launches the hand-written
  kernel ``csrc/bilateral.cu`` or raises. Its C entry point picks the
  kernel's instance by the radius and sigmas: the one unrolled for r = 8
  with equal sigmas (the main path's d = 17, 80, 80), else the generic one
  (1 <= r <= 16); the space weights travel in the launch's parameters.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

KERNEL = 'bilateral'
MAX_RADIUS = 16


def window_offsets(radius: int) -> List[Tuple[int, int]]:
    """Offsets (dy, dx) of the cv2 circular window, centre included."""
    return [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= radius * radius]


def bilateral_filter_ref(img: torch.Tensor, d: int = 17,
                         sigma_color: float = 80.0,
                         sigma_space: float = 80.0) -> torch.Tensor:
    """Plain version over (H, W, C) or (N, H, W, C)."""
    batched = img.dim() == 4
    x = img if batched else img[None]
    radius = d // 2
    n, h, w, c = x.shape
    xf = x.to(torch.float32)
    pad = F.pad(xf.permute(0, 3, 1, 2), (radius,) * 4,
                mode='replicate').permute(0, 2, 3, 1)
    gauss_color = -1.0 / (2.0 * sigma_color ** 2)
    acc = torch.zeros_like(xf)
    norm = torch.zeros((n, h, w, 1), dtype=torch.float32, device=x.device)
    for dy, dx in window_offsets(radius):
        sw = float(np.float32(np.exp(-(dy * dy + dx * dx)
                                     / (2.0 * sigma_space ** 2))))
        shifted = pad[:, radius + dy:radius + dy + h,
                      radius + dx:radius + dx + w]
        cdiff = (shifted - xf).abs().sum(dim=-1, keepdim=True)
        wt = sw * torch.exp(gauss_color * cdiff * cdiff)
        acc += wt * shifted
        norm += wt
    out = acc / norm.clamp_min(1e-8)
    if not img.dtype.is_floating_point:
        out = out.round().clamp(0, 255)
    out = out.to(img.dtype)
    return out if batched else out[0]


def _launch(x: torch.Tensor, out: torch.Tensor, radius: int,
            sigma_color: float, sigma_space: float) -> None:
    n, h, w, _ = x.shape
    status = cuda_build.entry(KERNEL)(cuda_build.ptr(x), cuda_build.ptr(out), n, h, w, radius,
                float(sigma_color), float(sigma_space),
                cuda_build.current_stream(x.device))
    cuda_build.check(status, 'bilateral kernel')
    cuda_build.count_launch(KERNEL)


def bilateral_filter_batch(imgs: torch.Tensor, d: int = 17,
                           sigma_color: float = 80.0,
                           sigma_space: float = 80.0) -> torch.Tensor:
    """(N, H, W, 3) uint8 → (N, H, W, 3) uint8, one launch for the batch."""
    if imgs.device.type == 'cpu':
        return bilateral_filter_ref(imgs, d, sigma_color, sigma_space)
    if imgs.device.type != 'cuda':
        raise ValueError(f'bilateral: unsupported device {imgs.device}')
    if imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f'bilateral: expected (N, H, W, 3), got '
                         f'{tuple(imgs.shape)}')
    if imgs.dtype != torch.uint8:
        raise TypeError(f'bilateral: expected uint8, got {imgs.dtype}')
    radius = d // 2
    if not 0 < radius <= MAX_RADIUS:
        raise ValueError(f'bilateral: radius {radius} outside 1..{MAX_RADIUS}')
    x = imgs.contiguous()
    out = torch.empty_like(x)
    _launch(x, out, radius, sigma_color, sigma_space)
    return out


def bilateral_filter(img: torch.Tensor, d: int = 17,
                     sigma_color: float = 80.0,
                     sigma_space: float = 80.0) -> torch.Tensor:
    """(H, W, 3) uint8 → (H, W, 3) uint8."""
    if img.device.type == 'cpu':
        return bilateral_filter_ref(img, d, sigma_color, sigma_space)
    return bilateral_filter_batch(img[None], d, sigma_color, sigma_space)[0]
