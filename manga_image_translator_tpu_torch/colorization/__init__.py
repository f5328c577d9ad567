"""Colorization stage (contract: reference colorization/__init__.py)."""
from __future__ import annotations

from PIL import Image

from ..config import Colorizer
from .common import CommonColorizer, OfflineColorizer


def _mc2_factory():
    from .manga_colorization_v2 import MangaColorizationV2
    return MangaColorizationV2()


COLORIZERS = {
    Colorizer.mc2: _mc2_factory,
}

_colorizer_cache = {}


def get_colorizer(key: Colorizer) -> CommonColorizer:
    if key not in COLORIZERS:
        raise ValueError(f'Could not find colorizer for: "{key}". '
                         f'Choose from the following: {list(COLORIZERS)}')
    if key not in _colorizer_cache:
        _colorizer_cache[key] = COLORIZERS[key]()
    return _colorizer_cache[key]


async def dispatch(key: Colorizer, device: str = 'cuda', **kwargs
                   ) -> Image.Image:
    colorizer = get_colorizer(key)
    if isinstance(colorizer, OfflineColorizer):
        await colorizer.load(device)
    return await colorizer.colorize(**kwargs)


async def unload(key: Colorizer):
    _colorizer_cache.pop(key, None)
