"""Upscaling stage (contract: reference upscaling/__init__.py — dispatch
skips when ratio == 1).

Every key runs its network in PyTorch on the device (the reference's
'esrgan' and 'waifu2x' keys shell out to ncnn-vulkan executables; the JAX
package runs their networks natively, and so does the port): ``esrgan``
and ``4xultrasharp`` the RRDBNet ESRGAN, ``waifu2x`` the executable's own
ncnn graphs (``upscaling/esrgan.Waifu2xUpscaler``).
"""
from __future__ import annotations

from typing import List

from PIL import Image

from ..config import Upscaler
from .common import CommonUpscaler, OfflineUpscaler
from .esrgan import ESRGANUpscaler, ESRGANUpscalerPytorch, Waifu2xUpscaler

UPSCALERS = {
    Upscaler.waifu2x: Waifu2xUpscaler,
    Upscaler.esrgan: ESRGANUpscaler,
    Upscaler.upscler4xultrasharp: ESRGANUpscalerPytorch,
}

_upscaler_cache = {}


def get_upscaler(key: Upscaler) -> CommonUpscaler:
    if key not in UPSCALERS:
        raise ValueError(f'Could not find upscaler for: "{key}". '
                         f'Choose from the following: {list(UPSCALERS)}')
    if key not in _upscaler_cache:
        _upscaler_cache[key] = UPSCALERS[key]()
    return _upscaler_cache[key]


async def dispatch(upscaler_key: Upscaler, image_batch: List[Image.Image],
                   upscale_ratio: float, device: str = 'cuda'
                   ) -> List[Image.Image]:
    if upscale_ratio == 1:
        return image_batch
    upscaler = get_upscaler(upscaler_key)
    if isinstance(upscaler, OfflineUpscaler):
        await upscaler.load(device)
    return await upscaler.upscale(image_batch, upscale_ratio)


async def unload(upscaler_key: Upscaler):
    upscaler = _upscaler_cache.get(upscaler_key)
    if upscaler is not None and hasattr(upscaler, 'unload'):
        await upscaler.unload()
