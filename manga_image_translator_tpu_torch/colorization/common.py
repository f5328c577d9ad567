"""Colorizer base classes (contract: reference colorization/common.py)."""
from __future__ import annotations

from abc import abstractmethod

from PIL import Image

from ..utils.inference import InfererModule, ModelWrapper


class CommonColorizer(InfererModule):

    async def colorize(self, image: Image.Image, colorization_size: int,
                       **kwargs) -> Image.Image:
        return await self._colorize(image, colorization_size, **kwargs)

    @abstractmethod
    async def _colorize(self, image: Image.Image, colorization_size: int,
                        **kwargs) -> Image.Image:
        ...


class OfflineColorizer(CommonColorizer, ModelWrapper):
    _MODEL_SUB_DIR = 'colorization'

    def __init__(self):
        ModelWrapper.__init__(self)

    async def _colorize(self, *args, **kwargs):
        return await self.infer(*args, **kwargs)
