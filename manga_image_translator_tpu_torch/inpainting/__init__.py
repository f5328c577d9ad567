"""Inpainting stage: registry + dispatch (contract: reference
inpainting/__init__.py:13-45: ``default`` maps to AOT, ``lama_large`` is
the recommended one). The port serves every inpainter, ``sd`` (Stable
Diffusion, ``inpainting_sd.py``) included."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Inpainter, InpainterConfig
from .common import CommonInpainter, OfflineInpainter
from .inpainting_aot import AotInpainter
from .inpainting_lama import LamaLargeInpainter, LamaMPEInpainter
from .inpainting_sd import StableDiffusionInpainter
from .none_inpainter import NoneInpainter, OriginalInpainter

INPAINTERS = {
    Inpainter.default: AotInpainter,
    Inpainter.lama_large: LamaLargeInpainter,
    Inpainter.lama_mpe: LamaMPEInpainter,
    Inpainter.sd: StableDiffusionInpainter,
    Inpainter.none: NoneInpainter,
    Inpainter.original: OriginalInpainter,
}

_inpainter_cache = {}


def get_inpainter(key: Inpainter) -> CommonInpainter:
    if key not in INPAINTERS:
        raise ValueError(f'Could not find inpainter for: "{key}". '
                         f'Choose from the following: {list(INPAINTERS)}')
    if key not in _inpainter_cache:
        _inpainter_cache[key] = INPAINTERS[key]()
    return _inpainter_cache[key]


async def dispatch(inpainter_key: Inpainter, image: np.ndarray,
                   mask: np.ndarray, config: Optional[InpainterConfig],
                   inpainting_size: int = 1024, device: str = 'cuda',
                   verbose: bool = False) -> np.ndarray:
    inpainter = get_inpainter(inpainter_key)
    if isinstance(inpainter, OfflineInpainter):
        await inpainter.load(device)
    config = config or InpainterConfig()
    return await inpainter.inpaint(image, mask, config, inpainting_size,
                                   verbose)


async def unload(inpainter_key: Inpainter):
    _inpainter_cache.pop(inpainter_key, None)
