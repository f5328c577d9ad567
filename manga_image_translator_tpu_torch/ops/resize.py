"""Linear image resize with ``jax.image.resize(method='linear')`` semantics.

Separable triangle-kernel resampling, antialiased when downscaling (the
kernel widens by the inverse scale; ``antialias=False`` keeps it at one
pixel), half-pixel centres, weights normalised
per output sample and zeroed for samples outside the input — the weight
matrices are built exactly as JAX builds them, in float32, and applied as
two matrix products.
"""
from __future__ import annotations

import torch


def weight_matrix(in_size: int, out_size: int, device,
                  antialias: bool = True) -> torch.Tensor:
    """(in_size, out_size) float32 resampling weights along one axis."""
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32)
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.tensor(1.0))
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


def resize_linear(x: torch.Tensor, out_h: int, out_w: int,
                  antialias: bool = True) -> torch.Tensor:
    """Resize (..., H, W, C) float images to (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    y = x
    if out_h != h:
        wh = weight_matrix(h, out_h, x.device, antialias).to(x.dtype)
        y = torch.einsum('...hwc,ho->...owc', y, wh)
    if out_w != w:
        ww = weight_matrix(w, out_w, x.device, antialias).to(x.dtype)
        y = torch.einsum('...hwc,wo->...hoc', y, ww)
    return y
