"""OCR stage: registry + dispatch (contract: reference ocr/__init__.py).

``48px`` is imported with the registry; ``32px``, ``48px_ctc`` and ``mocr``
are imported when first chosen, as in the JAX package (``mocr`` imports
``transformers`` only when it loads)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import Ocr, OcrConfig
from ..utils.geometry import Quadrilateral
from .common import CommonOCR, OfflineOCR
from .model_48px import Model48pxOCR


def _lazy(name):
    def factory():
        if name == '32px':
            from .model_32px import Model32pxOCR
            return Model32pxOCR()
        if name == '48px_ctc':
            from .model_48px_ctc import Model48pxCTCOCR
            return Model48pxCTCOCR()
        if name == 'mocr':
            from .model_manga_ocr import ModelMangaOCR
            return ModelMangaOCR()
        raise KeyError(name)
    return factory


OCRS = {
    Ocr.ocr32px: _lazy('32px'),
    Ocr.ocr48px: Model48pxOCR,
    Ocr.ocr48px_ctc: _lazy('48px_ctc'),
    Ocr.mocr: _lazy('mocr'),
}

_ocr_cache = {}


def get_ocr(key: Ocr) -> CommonOCR:
    if key not in OCRS:
        raise ValueError(f'Could not find OCR for: "{key}". '
                         f'Choose from the following: {list(OCRS)}')
    if key not in _ocr_cache:
        _ocr_cache[key] = OCRS[key]()
    return _ocr_cache[key]


async def dispatch(ocr_key: Ocr, image: np.ndarray,
                   regions: List[Quadrilateral],
                   config: Optional[OcrConfig] = None, device: str = 'cuda',
                   verbose: bool = False) -> List[Quadrilateral]:
    ocr = get_ocr(ocr_key)
    if isinstance(ocr, OfflineOCR):
        await ocr.load(device)
    config = config or OcrConfig()
    return await ocr.recognize(image, regions, config, verbose)


async def unload(ocr_key: Ocr):
    _ocr_cache.pop(ocr_key, None)
