"""Upscaler base classes (contract: reference upscaling/common.py)."""
from __future__ import annotations

from abc import abstractmethod
from typing import List

from PIL import Image

from ..utils.inference import InfererModule, ModelWrapper


class CommonUpscaler(InfererModule):
    _VALID_UPSCALE_RATIOS = None

    async def upscale(self, image_batch: List[Image.Image],
                      upscale_ratio: float) -> List[Image.Image]:
        if upscale_ratio == 1:
            return image_batch
        if (self._VALID_UPSCALE_RATIOS
                and upscale_ratio not in self._VALID_UPSCALE_RATIOS):
            ratio = min(self._VALID_UPSCALE_RATIOS,
                        key=lambda x: abs(x - upscale_ratio))
            self.logger.info(
                f'Clamping upscale ratio {upscale_ratio} to {ratio}')
            upscale_ratio = ratio
        return await self._upscale(image_batch, upscale_ratio)

    @abstractmethod
    async def _upscale(self, image_batch: List[Image.Image],
                       upscale_ratio: float) -> List[Image.Image]:
        ...


class OfflineUpscaler(CommonUpscaler, ModelWrapper):
    _MODEL_SUB_DIR = 'upscaling'

    def __init__(self):
        ModelWrapper.__init__(self)

    async def _upscale(self, *args, **kwargs):
        return await self.infer(*args, **kwargs)
