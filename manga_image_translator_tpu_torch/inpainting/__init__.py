"""Inpainting stage: registry + dispatch (contract: reference
inpainting/__init__.py:13-45). The port serves ``lama_large`` (the
default), ``none`` and ``original``; ``default`` (AOT) and ``lama_mpe``
wait for ROADMAP A.9, ``sd`` for A.13."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Inpainter, InpainterConfig
from .common import CommonInpainter, OfflineInpainter
from .inpainting_lama import LamaLargeInpainter, LamaMPEInpainter
from .none_inpainter import NoneInpainter, OriginalInpainter


def _not_ported(name: str, item: str):
    def factory():
        raise NotImplementedError(
            f'inpainter "{name}" is not ported yet (ROADMAP {item})')
    return factory


INPAINTERS = {
    Inpainter.default: _not_ported('default', 'A.9: other inpainters'),
    Inpainter.lama_large: LamaLargeInpainter,
    Inpainter.lama_mpe: LamaMPEInpainter,
    Inpainter.sd: _not_ported('sd', 'A.13: Stable Diffusion'),
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
