"""Detection stage: registry + dispatch.

Contract from reference ``detection/__init__.py:12-43``. The port serves
every detector: ``default`` and ``none`` directly, the others through the
JAX registry's lazy factories (their modules load on first use).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Detector
from ..utils.geometry import Quadrilateral
from .common import CommonDetector
from .default import DefaultDetector
from .none_detector import NoneDetector


def _lazy(name):
    def factory():
        if name == 'ctd':
            from .ctd import ComicTextDetector
            return ComicTextDetector()
        if name == 'craft':
            from .craft import CRAFTDetector
            return CRAFTDetector()
        if name == 'dbconvnext':
            from .dbnet_convnext import DBConvNextDetector
            return DBConvNextDetector()
        if name == 'paddle':
            from .paddle import PaddleDetector
            return PaddleDetector()
        raise KeyError(name)
    return factory


DETECTORS = {
    Detector.default: DefaultDetector,
    Detector.dbconvnext: _lazy('dbconvnext'),
    Detector.ctd: _lazy('ctd'),
    Detector.craft: _lazy('craft'),
    Detector.paddle: _lazy('paddle'),
    Detector.none: NoneDetector,
}

_detector_cache = {}


def get_detector(key: Detector) -> CommonDetector:
    if key not in DETECTORS:
        raise ValueError(f'Could not find detector for: "{key}".'
                         f' Choose from the following: {list(DETECTORS)}')
    if key not in _detector_cache:
        _detector_cache[key] = DETECTORS[key]()
    return _detector_cache[key]


async def dispatch(detector_key: Detector, image: np.ndarray,
                   detect_size: int, text_threshold: float,
                   box_threshold: float, unclip_ratio: float, invert: bool,
                   gamma_correct: bool, rotate: bool,
                   auto_rotate: bool = False, device: str = 'cuda',
                   verbose: bool = False
                   ) -> Tuple[List[Quadrilateral], np.ndarray, Optional[np.ndarray]]:
    detector = get_detector(detector_key)
    if hasattr(detector, 'load'):
        await detector.load(device)
    return await detector.detect(image, detect_size, text_threshold,
                                 box_threshold, unclip_ratio, invert,
                                 gamma_correct, rotate, auto_rotate, verbose)


async def unload(detector_key: Detector):
    detector = _detector_cache.get(detector_key)
    if detector is not None and hasattr(detector, 'unload'):
        await detector.unload()
