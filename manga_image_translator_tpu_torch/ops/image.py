"""Image plumbing on the device: resize / pad / normalize.

Counterpart of the JAX package's ``ops/image.py``: the reference's per-stage
host OpenCV work (resize_keep_aspect, square_pad_resize —
utils/generic.py:849-874) as tensor operations, so a page stays on the card
across stages. Layout: NHWC or HWC, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .resize import resize_linear


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int],
                    antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) images with
    ``jax.image.resize(method='linear')`` semantics: cv2 INTER_LINEAR
    (half-pixel centres, no antialias) when ``antialias=False``. Returns
    float32."""
    h, w = out_hw
    return resize_linear(img.float(), h, w, antialias)


def resize_area(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Downscale with box filtering (cv2 INTER_AREA analogue)."""
    return resize_bilinear(img, out_hw, antialias=True)


def _pad_hw(img: torch.Tensor, ph: int, pw: int,
            value: float) -> torch.Tensor:
    """Bottom/right pad the H and W of an HWC or NHWC tensor."""
    return F.pad(img, (0, 0, 0, pw, 0, ph), value=value)


def pad_to_multiple(img: torch.Tensor, multiple: int, value: float = 0.0
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Bottom/right pad H and W up to the next multiple."""
    h, w = img.shape[-3], img.shape[-2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    return _pad_hw(img, ph, pw, value), (ph, pw)


def letterbox(img: torch.Tensor, size: int, pad_value: float = 0.0
              ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Resize the longer side to ``size`` keeping aspect, then pad bottom/right
    to a ``size``×``size`` square.

    Returns (square image, scale ratio, (resized_h, resized_w)).
    """
    h, w = img.shape[-3], img.shape[-2]
    ratio = size / max(h, w)
    nh, nw = int(round(h * ratio)), int(round(w * ratio))
    resized = resize_bilinear(img, (nh, nw))
    return _pad_hw(resized, size - nh, size - nw, pad_value), ratio, (nh, nw)


# ImageNet statistics used by several detector backbones.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB -> imagenet-normalized float32."""
    x = img.float() / 255.0
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x - mean) / std


def to_unit(img: torch.Tensor) -> torch.Tensor:
    return img.float() / 255.0


def from_unit(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma, matching cv2.cvtColor(..., COLOR_RGB2GRAY)."""
    coeffs = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                          device=img.device)
    return torch.tensordot(img.float(), coeffs, dims=([-1], [0]))


def gamma_correct(img: torch.Tensor) -> torch.Tensor:
    """Mid-gray auto gamma (reference detection/common.py pre-filter)."""
    x = to_unit(img)
    mean = torch.mean(rgb_to_gray(img)) / 255.0
    gamma = np.log(np.float32(0.5)) / torch.log(torch.clamp(mean, min=1e-6))
    return from_unit(torch.pow(x, gamma))


def pick_canonical_size(h: int, w: int,
                        sizes: Tuple[int, ...] = (1024, 1536, 2048)) -> int:
    """Choose the smallest canonical square that fits the detection-resized
    image, bounding the number of distinct shapes."""
    longest = max(h, w)
    for s in sizes:
        if longest <= s:
            return s
    return sizes[-1]
