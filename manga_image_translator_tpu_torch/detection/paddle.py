"""Paddle detector backend — PyTorch port.

Counterpart of the JAX package's ``detection/paddle.py`` (reference
``detection/common_rust.py:14-63`` + ``paddle_rust.py``: the Rust wheel's
``Session.detect(img, preproc_opts, det_opts)`` returns quads + scores and
a raw mask). The PP-OCR DB detection network (``models/paddle_det.py``)
runs in plain PyTorch on the card with the standard DB postprocess on the
host; the preprocessing is PaddleOCR's det pipeline (long side to
detection_size, a /32 canvas, ImageNet normalisation). Weights come from
``paddle-det.onnx`` through ``paddle_onnx.convert_graph``; random weights
only under the explicit opt-in.
"""
from __future__ import annotations

from typing import Optional

import cv2
import numpy as np
import torch

from ..models import paddle_det
from ..utils.geometry import Quadrilateral
from ..utils.inference import MissingWeightsError, random_weights_allowed
from .common import OfflineDetector
from .db_postprocess import DBPostprocess

PAD_MULT = 32
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@torch.no_grad()
def _forward(model, batch: torch.Tensor):
    """(N, H, W, 3) uint8 → (shrink (N, H, W), threshold (N, H, W))."""
    mean = torch.tensor(IMAGENET_MEAN, device=batch.device)
    std = torch.tensor(IMAGENET_STD, device=batch.device)
    x = (batch.float() / 255.0 - mean) / std
    maps = paddle_det.paddle_det_forward(model, x)
    return maps[..., 0], maps[..., 1]


def state_dict_from_onnx(path) -> dict:
    """The port's state dict from a PaddleOCR det ONNX file (pure-Python
    protobuf reader + structural matcher; raises on any shape
    mismatch)."""
    from ..utils import onnx_lite
    from .paddle_onnx import convert_graph
    return {k: torch.from_numpy(np.array(v))     # writable copies
            for k, v in convert_graph(onnx_lite.load(path)).items()}


class PaddleDetector(OfflineDetector):
    _MODEL_MAPPING = {}

    def __init__(self):
        super().__init__()
        self.model = None
        self.device: Optional[torch.device] = None

    async def _load(self, device: str):
        self.device = torch.device(device)
        onnx_path = self._get_file_path('paddle-det.onnx')
        if onnx_path.is_file():
            try:
                self.model = paddle_det.build_paddle_det(
                    self.device, state_dict_from_onnx(onnx_path))
                return
            except Exception as e:
                self.logger.warning(f'ONNX conversion failed: {e}')
        if not random_weights_allowed(self):
            raise MissingWeightsError(
                'PaddleDetector: ONNX weights unavailable or unconvertible. '
                'Refusing to detect with random weights; set '
                'MIT_TPU_ALLOW_RANDOM_WEIGHTS=1 to opt in for tests.')
        self.logger.warning('paddle detector weights unavailable — '
                            'using random init')
        self.using_random_weights = True
        self.model = paddle_det.build_paddle_det(
            self.device, paddle_det.init_state_dict())

    async def _unload(self):
        self.model = None

    async def _infer(self, image: np.ndarray, detect_size: int,
                     text_threshold: float, box_threshold: float,
                     unclip_ratio: float, verbose: bool = False):
        im_h, im_w = image.shape[:2]
        ratio = detect_size / max(im_h, im_w)
        tw, th = int(round(im_w * ratio)), int(round(im_h * ratio))
        resized = cv2.resize(image, (tw, th), interpolation=cv2.INTER_LINEAR)
        pad_h = (-th) % PAD_MULT
        pad_w = (-tw) % PAD_MULT
        canvas = np.zeros((th + pad_h, tw + pad_w, 3), np.uint8)
        canvas[:th, :tw] = resized

        prob, _thresh = _forward(
            self.model, torch.from_numpy(canvas)[None].to(self.device))
        prob_np = prob[0, :th, :tw].float().cpu().numpy()

        det = DBPostprocess(text_threshold, box_threshold,
                            unclip_ratio=unclip_ratio)
        boxes, scores = det(prob_np, im_w, im_h)
        if boxes.shape[0]:
            keep = boxes.reshape(boxes.shape[0], -1).sum(axis=1) > 0
            boxes, scores = boxes[keep], scores[keep]

        textlines = [Quadrilateral(pts.astype(int), '', float(s))
                     for pts, s in zip(boxes, scores)]
        textlines = [q for q in textlines if q.area > 16]

        raw_mask = np.clip(
            cv2.resize(prob_np, (im_w, im_h),
                       interpolation=cv2.INTER_LINEAR) * 255,
            0, 255).astype(np.uint8)
        return textlines, raw_mask, None
