"""DBConvNext detector — PyTorch port.

Counterpart of the JAX package's ``detection/dbnet_convnext.py``
(reference ``detection/dbnet_convnext.py:512-596``): the default
detector's /127.5 - 1 normalisation and DB postprocess on a canvas padded
to a multiple of 128; the half-resolution mask and its trim are copied as
the JAX package has them. The reference ships no checkpoint for this
backend (an empty URL), so random init is the only mode upstream as well.
The network is plain PyTorch on the card.
"""
from __future__ import annotations

from typing import Optional

import cv2
import numpy as np
import torch

from ..models import dbnet_convnext as model
from ..utils.geometry import Quadrilateral
from .common import OfflineDetector
from .db_postprocess import DBPostprocess

PAD_MULT = 128


@torch.no_grad()
def _forward_batch(net, batch: torch.Tensor):
    """(N, H, W, 3) uint8 → (prob (N, H, W), mask (N, H/2, W/2))."""
    db, mask = model.dbnet_convnext_forward(net, batch.float() / 127.5 - 1.0)
    return torch.sigmoid(db[..., 0]), mask[..., 0]


class DBConvNextDetector(OfflineDetector):
    _MODEL_MAPPING = {}  # the reference declares an empty URL

    def __init__(self):
        super().__init__()
        self.model = None
        self.device: Optional[torch.device] = None

    async def _load(self, device: str):
        self.logger.warning(
            'dbconvnext has no released checkpoint (empty URL in the '
            'reference); using random init')
        self.using_random_weights = True
        self.device = torch.device(device)
        self.model = model.build_dbnet_convnext(self.device,
                                                model.init_state_dict())

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

        prob, mask = _forward_batch(
            self.model, torch.from_numpy(canvas)[None].to(self.device))
        prob_np = prob[0].float().cpu().numpy()
        mask_np = mask[0].float().cpu().numpy()

        det = DBPostprocess(text_threshold, box_threshold,
                            unclip_ratio=unclip_ratio)
        boxes, scores = det(prob_np, canvas.shape[1], canvas.shape[0])
        if boxes.shape[0]:
            keep = boxes.reshape(boxes.shape[0], -1).sum(axis=1) > 0
            polys = (boxes[keep].astype(np.float64) / ratio).astype(np.int64)
            scores = scores[keep]
        else:
            polys = boxes

        textlines = [Quadrilateral(pts.astype(int), '', float(s))
                     for pts, s in zip(polys, scores)]
        textlines = [q for q in textlines if q.area > 16]

        mask_resized = cv2.resize(mask_np, (mask_np.shape[1] * 2,
                                            mask_np.shape[0] * 2),
                                  interpolation=cv2.INTER_LINEAR)
        if pad_h > 0:
            mask_resized = mask_resized[:-pad_h * 2 // 2, :]
        if pad_w > 0:
            mask_resized = mask_resized[:, :-pad_w * 2 // 2]
        raw_mask = np.clip(mask_resized * 255, 0, 255).astype(np.uint8)
        return textlines, raw_mask, None
