"""Detector base classes: pre/post filters shared by all detectors.

Contract from reference ``detection/common.py:12-137``: rotate /
add-border-if-small / invert / gamma pre-filters and their inverses, plus the
auto-rotate re-run when horizontal lines dominate.
"""
from __future__ import annotations

from abc import abstractmethod
from collections import Counter
from typing import List, Optional, Tuple

import cv2
import numpy as np

from ..utils.geometry import Quadrilateral
from ..utils.inference import InfererModule, ModelWrapper

MINIMUM_IMAGE_SIZE = 400


class CommonDetector(InfererModule):

    async def detect(self, image: np.ndarray, detect_size: int,
                     text_threshold: float, box_threshold: float,
                     unclip_ratio: float, invert: bool, gamma_correct: bool,
                     rotate: bool, auto_rotate: bool = False,
                     verbose: bool = False
                     ) -> Tuple[List[Quadrilateral], np.ndarray, Optional[np.ndarray]]:
        """Returns (textlines, raw_mask, refined_mask-or-None)."""
        img_h, img_w = image.shape[:2]
        orig_image = image.copy()
        add_border = min(img_w, img_h) < MINIMUM_IMAGE_SIZE

        if rotate:
            image = self._add_rotation(image)
        if add_border:
            image = self._add_border(image, MINIMUM_IMAGE_SIZE)
        if invert:
            image = 255 - image
        if gamma_correct:
            image = self._apply_gamma(image)

        textlines, raw_mask, mask = await self._detect(
            image, detect_size, text_threshold, box_threshold, unclip_ratio,
            verbose)
        textlines = [q for q in textlines if q.area > 1]

        if add_border:
            textlines, raw_mask, mask = self._remove_border(
                image, img_w, img_h, textlines, raw_mask, mask)

        if auto_rotate:
            if textlines:
                orientations = ['h' if q.aspect_ratio > 1 else 'v'
                                for q in textlines]
                majority = Counter(orientations).most_common(1)[0][0]
            else:
                majority = 'h'
            if majority == 'h':
                self.logger.info('Rerunning detection with 90° rotation')
                return await self.detect(
                    orig_image, detect_size, text_threshold, box_threshold,
                    unclip_ratio, invert, gamma_correct, rotate=(not rotate),
                    auto_rotate=False, verbose=verbose)

        if rotate:
            textlines, raw_mask, mask = self._remove_rotation(
                textlines, raw_mask, mask, img_w, img_h)

        return textlines, raw_mask, mask

    @abstractmethod
    async def _detect(self, image: np.ndarray, detect_size: int,
                      text_threshold: float, box_threshold: float,
                      unclip_ratio: float, verbose: bool = False):
        ...

    # -- filters ---------------------------------------------------------------
    def _add_rotation(self, image: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(np.rot90(image, k=-1))

    def _remove_rotation(self, textlines, raw_mask, mask, img_w, img_h):
        if raw_mask is not None:
            raw_mask = np.ascontiguousarray(np.rot90(raw_mask))
        if mask is not None:
            mask = np.ascontiguousarray(np.rot90(mask))
        for q in textlines:
            # rotate quad coords back: (x, y) in rotated -> (y, H_rot - x)
            x = q.pts[:, 0].copy()
            y = q.pts[:, 1].copy()
            q.pts[:, 0] = y
            q.pts[:, 1] = img_h - x
        rebuilt = [Quadrilateral(q.pts, q.text, q.prob, *q.fg_colors,
                                 *q.bg_colors) for q in textlines]
        return rebuilt, raw_mask, mask

    def _add_border(self, image: np.ndarray, target: int) -> np.ndarray:
        old_h, old_w = image.shape[:2]
        side = max(old_w, old_h, target)
        out = np.zeros((side, side, 3), np.uint8)
        out[:old_h, :old_w] = image
        return out

    def _remove_border(self, image, old_w, old_h, textlines, raw_mask, mask):
        new_h, new_w = image.shape[:2]
        if raw_mask is not None:
            raw_mask = cv2.resize(raw_mask, (new_w, new_h),
                                  interpolation=cv2.INTER_LINEAR)
            raw_mask = raw_mask[:old_h, :old_w]
        if mask is not None:
            mask = cv2.resize(mask, (new_w, new_h),
                              interpolation=cv2.INTER_LINEAR)
            mask = mask[:old_h, :old_w]
        kept = []
        for q in textlines:
            # drop regions that start in the border area, right of or below
            # the page (the reference drops only those right of and below
            # it, and clips the others to a zero-width line, whose OCR crop
            # then takes the 1e6-clamped ratio of its sides: ROADMAP §C)
            if q.xyxy[0] >= old_w or q.xyxy[1] >= old_h:
                continue
            pts = q.pts
            pts[:, 0] = np.clip(pts[:, 0], 0, old_w)
            pts[:, 1] = np.clip(pts[:, 1], 0, old_h)
            kept.append(Quadrilateral(pts, q.text, q.prob))
        return kept, raw_mask, mask

    def _apply_gamma(self, image: np.ndarray) -> np.ndarray:
        # reference common.py:119-124: gamma on raw 0-255 values with
        # gamma = log(0.5*255)/log(mean)
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
        mean = max(float(np.mean(gray)), 1.0 + 1e-6)
        gamma = np.log(0.5 * 255) / np.log(mean)
        lut = np.clip(np.power(np.arange(256, dtype=np.float64), gamma),
                      0, 255).astype(np.uint8)
        return lut[image]


class OfflineDetector(CommonDetector, ModelWrapper):
    _MODEL_SUB_DIR = 'detection'

    def __init__(self):
        ModelWrapper.__init__(self)

    async def _detect(self, *args, **kwargs):
        return await self.infer(*args, **kwargs)
