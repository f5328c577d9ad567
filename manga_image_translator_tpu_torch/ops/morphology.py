"""Binary morphology and blurs on the device.

Counterpart of the JAX package's ``ops/morphology.py``. The reference runs
cv2.dilate with elliptical structuring elements per page on the host
(mask_refinement/text_mask_utils.py:150-195); here dilation and erosion are
a max pool (rectangular element) or a convolution with the element (any
shape), on the tensor's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def ellipse_kernel(ksize: int) -> np.ndarray:
    """Elliptical structuring element, identical to
    cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))."""
    if ksize <= 1:
        return np.ones((1, 1), dtype=np.float32)
    # cv2's ellipse SE: for each row, the points within the inscribed ellipse.
    r = ksize // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    se = np.zeros((ksize, ksize), dtype=np.float32)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round((r) * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
        else:
            dx = 0
        j1, j2 = max(0, r - dx), min(ksize, r + dx + 1)
        se[i, j1:j2] = 1.0
    return se


def _as_planes(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (B, 1, H, W)."""
    return x.reshape((-1, 1) + tuple(x.shape[-2:]))


def _pad_window(x: torch.Tensor, kh: int, kw: int,
                value: float) -> torch.Tensor:
    """Pad (B, 1, H, W) for a kh×kw window placed as the JAX package's
    reduce_window places it: k // 2 before, (k - 1) // 2 after."""
    return F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2),
                 value=value)


def _pad_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad (B, 1, H, W) for a k×k 'SAME' convolution as XLA pads it:
    (k - 1) // 2 before, k // 2 after."""
    return F.pad(x, ((k - 1) // 2, k // 2, (k - 1) // 2, k // 2))


def _binary_dilate_rect(mask: torch.Tensor, kh: int,
                        kw: int) -> torch.Tensor:
    """Rectangular dilation via a max pool. mask: (..., H, W) float."""
    x = _pad_window(_as_planes(mask), kh, kw, float('-inf'))
    return F.max_pool2d(x, (kh, kw), stride=1).reshape(mask.shape)


def dilate(mask: torch.Tensor, ksize: int,
           shape: str = 'ellipse') -> torch.Tensor:
    """Binary dilation of (..., H, W) masks with a ksize×ksize element."""
    if ksize <= 1:
        return mask
    m = mask.float()
    if shape == 'rect':
        return (_binary_dilate_rect(m, ksize, ksize) > 0).to(mask.dtype)
    # dilation with an arbitrary element == conv(mask, element) > 0
    se = torch.from_numpy(ellipse_kernel(ksize)).to(m.device)
    out = F.conv2d(_pad_same(_as_planes(m), ksize), se[None, None])
    return (out > 0).to(mask.dtype).reshape(mask.shape)


def erode(mask: torch.Tensor, ksize: int,
          shape: str = 'ellipse') -> torch.Tensor:
    """Binary erosion: complement-dilate-complement."""
    if ksize <= 1:
        return mask
    inv = 1.0 - mask.float()
    return (1.0 - dilate(inv, ksize, shape)).to(mask.dtype)


def open_(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    return dilate(erode(mask, ksize), ksize)


def close_(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    return erode(dilate(mask, ksize), ksize)


def box_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Mean filter over (..., H, W), zero padded."""
    if ksize <= 1:
        return img
    x = img.float()
    s = F.conv2d(_pad_window(_as_planes(x), ksize, ksize, 0.0),
                 torch.ones((1, 1, ksize, ksize), device=x.device))
    return s.reshape(x.shape) / (ksize * ksize)


@functools.lru_cache(maxsize=64)
def gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int = None) -> torch.Tensor:
    """Separable gaussian over (..., H, W)."""
    if radius is None:
        radius = max(1, int(round(3 * sigma)))
    k = torch.from_numpy(gaussian_kernel_1d(float(sigma), int(radius)))
    x = img.float()
    k = k.to(x.device)
    # reflect padding matches cv2.GaussianBlur's default border mode
    x4 = F.pad(_as_planes(x), (radius, radius, radius, radius),
               mode='reflect')
    x4 = F.conv2d(x4, k[None, None, :, None])
    x4 = F.conv2d(x4, k[None, None, None, :])
    return x4.reshape(x.shape)
