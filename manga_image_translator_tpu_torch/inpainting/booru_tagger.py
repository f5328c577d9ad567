"""wd-swinv2 booru tagger on the port's ONNX evaluator.

Counterpart of the JAX package's ``inpainting/booru_tagger.py`` (reference
``inpainting/booru_tagger.py:40-102``: onnxruntime session + pandas csv).
The ONNX graph (``utils/onnx_lite``) is interpreted by ``utils/onnx_eval``
on the tagger's device and the csv parses with the stdlib. The square pad
and resize run on the host with cv2. Output: {tag: confidence} above the
threshold, the rating rows (the first 4) excluded. A failure raises.
"""
from __future__ import annotations

import csv
from typing import Dict, List

import cv2
import numpy as np
import torch


def make_square(img: np.ndarray, target_size: int) -> np.ndarray:
    """White-pad to a centred square of at least target_size (reference
    booru_tagger.make_square)."""
    old_h, old_w = img.shape[:2]
    desired = max(old_h, old_w, target_size)
    dh, dw = desired - old_h, desired - old_w
    top, bottom = dh // 2, dh - dh // 2
    left, right = dw // 2, dw - dw // 2
    return cv2.copyMakeBorder(img, top, bottom, left, right,
                              cv2.BORDER_CONSTANT, value=[255, 255, 255])


def smart_resize(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] > size:
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    if img.shape[0] < size:
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)
    return img


class Tagger:
    """ONNX tagger: NHWC float32 BGR input -> per-tag confidences."""

    N_RATING_TAGS = 4          # general/sensitive/questionable/explicit

    def __init__(self, onnx_path, tags_csv_path, input_size: int = 448,
                 device='cpu'):
        from ..utils import onnx_eval, onnx_lite
        self._runner = onnx_eval.make_runner(onnx_lite.load(onnx_path))
        self.height = input_size
        self.device = torch.device(device)
        self.tag_names: List[str] = []
        with open(tags_csv_path, newline='', encoding='utf-8') as f:
            for row in csv.DictReader(f):
                self.tag_names.append(row['name'])

    def _run(self, image_bgr_u8: np.ndarray) -> np.ndarray:
        image = smart_resize(make_square(image_bgr_u8, self.height),
                             self.height)
        x = torch.from_numpy(image.astype(np.float32)[None]).to(self.device)
        return self._runner(x).float().cpu().numpy().reshape(-1)

    def label_cv2_bgr(self, image: np.ndarray,
                      threshold: float = 0.75) -> Dict[str, float]:
        conf = self._run(image)
        tags = {}
        for name, c in zip(self.tag_names[self.N_RATING_TAGS:],
                           conf[self.N_RATING_TAGS:]):
            if c > threshold:
                tags[name] = float(c)
        return tags
