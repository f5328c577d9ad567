"""AOT-GAN inpainter (the registry's ``default``) — PyTorch port.

Counterpart of the JAX package's ``inpainting/inpainting_aot.py``
(reference ``inpainting/inpainting_aot.py`` + the shared preprocessing of
``inpainting_lama_mpe.py:55-118``): resize to inpainting_size keeping the
aspect, stretch to a multiple of 8, /127.5 - 1 normalisation, ``img *= (1 -
mask)``, the generator in bf16 (the JAX package's fixed compute dtype),
the composite ``pred * mask + original * (1 - mask)``. The crop path and
``translate_batch`` reach the generator through ``_batch_forward_dispatch``.
Plain PyTorch on the card (cuDNN convs).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import cv2
import numpy as np
import torch

from ..config import InpainterConfig
from ..models import aot
from ..parallel.mesh import sharded_batch
from .common import OfflineInpainter

PAD_SIZE = 8
COMPUTE_DTYPE = torch.bfloat16


def _aot_body(model: aot.AOTGenerator, img: torch.Tensor,
              mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """img (N, H, W, 3) f32 in [-1, 1], mask (N, H, W, 1) binary f32 → the
    composited f32 result."""
    img = img.to(dtype) * (1.0 - mask.to(dtype))
    out = model(img, mask.to(dtype)).float()
    return out * mask + (1.0 - mask) * img.float()


class AotInpainter(OfflineInpainter):
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/inpainting.ckpt',
            'hash': '878d541c68648969bc1b042a6e997f3a58e49b6c07c5636ad55130736977149f',
            'file': '.',
        },
    }

    def __init__(self):
        super().__init__()
        self.model: Optional[aot.AOTGenerator] = None
        self.device: Optional[torch.device] = None
        # (N, H, W) of every generator forward, in order; callers may
        # clear it
        self.forwards: List[Tuple[int, int, int]] = []

    async def _load(self, device: str):
        sd = self.load_state_dict('model', init_fn=aot.init_state_dict)
        self.device = torch.device(device)
        self.model = aot.build_aot(self.device, sd)

    async def _unload(self):
        self.model = None

    @torch.inference_mode()
    def _forward_u8(self, image: np.ndarray, mask: np.ndarray
                    ) -> torch.Tensor:
        """(N, H, W, 3) uint8 + (N, H, W) uint8 → (N, H, W, 3) uint8 on the
        device, not yet copied to the host."""
        self.forwards.append(tuple(image.shape[:3]))
        img = torch.from_numpy(np.ascontiguousarray(image)).to(
            self.device).float() / 127.5 - 1.0
        msk = (torch.from_numpy(np.ascontiguousarray(mask)).to(
            self.device).float()[..., None] / 255.0 >= 0.5).float()
        # the batch splits over the serving mesh when there is one
        out = sharded_batch(functools.partial(_aot_body, dtype=COMPUTE_DTYPE),
                            ('aot.batch', COMPUTE_DTYPE), self.model, img,
                            msk)
        return torch.clamp(torch.round((out + 1.0) * 127.5), 0,
                           255).to(torch.uint8)

    async def _infer(self, image: np.ndarray, mask: np.ndarray,
                     config: InpainterConfig, inpainting_size: int = 1024,
                     verbose: bool = False) -> np.ndarray:
        img_original = np.copy(image)
        mask_original = (np.copy(mask) >= 127).astype(np.uint8)[:, :, None]

        height, width = image.shape[:2]
        if max(image.shape[:2]) > inpainting_size:
            ratio = inpainting_size / max(height, width)
            new_size = (round(width * ratio), round(height * ratio))
            image = cv2.resize(image, new_size, interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask, new_size, interpolation=cv2.INTER_LINEAR)
        h, w = image.shape[:2]
        new_h = h + ((-h) % PAD_SIZE)
        new_w = w + ((-w) % PAD_SIZE)
        if (new_h, new_w) != (h, w):
            image = cv2.resize(image, (new_w, new_h),
                               interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask, (new_w, new_h),
                              interpolation=cv2.INTER_LINEAR)
        self.logger.info(f'Inpainting resolution: {new_w}x{new_h}')

        img_inpainted = self._forward_u8(image[None],
                                         mask[None])[0].cpu().numpy()
        if (new_h, new_w) != (height, width):
            img_inpainted = cv2.resize(img_inpainted, (width, height),
                                       interpolation=cv2.INTER_LINEAR)
        return (img_inpainted * mask_original
                + img_original * (1 - mask_original)).astype(np.uint8)

    def _batch_forward_dispatch(self, imgs: np.ndarray, masks: np.ndarray,
                                config: InpainterConfig):
        return self._forward_u8(imgs, masks)

    def _batch_forward(self, imgs: np.ndarray, masks: np.ndarray,
                       config: InpainterConfig) -> np.ndarray:
        return self._batch_forward_collect(
            self._batch_forward_dispatch(imgs, masks, config))
