"""CRAFT detector — PyTorch port.

Counterpart of the JAX package's ``detection/craft.py`` (reference
``detection/craft.py:111-200``): ImageNet normalisation, the VGG16-BN
forward + RefineNet link refinement, the ``getDetBoxes`` postprocess
(host, copied as the JAX package has it), 1.2×-scaled min-rect polygons
and a 9 px mask dilation. The reference's polygon tracing (getPoly_core)
often returns None and falls back to rotated boxes; like the JAX package,
this uses the box path directly. The networks are plain PyTorch on the
card.
"""
from __future__ import annotations

import math
from typing import List, Optional

import cv2
import numpy as np
import torch

from ..models import craft as craft_model
from ..utils.geometry import Quadrilateral
from .common import OfflineDetector

PAD_MULT = 32
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@torch.no_grad()
def _forward(craft, refiner, batch: torch.Tensor):
    """(N, H, W, 3) uint8 → (text map, refined link map), each (N, H/2,
    W/2)."""
    mean = torch.tensor(IMAGENET_MEAN, device=batch.device) * 255.0
    var = torch.tensor(IMAGENET_STD, device=batch.device) * 255.0
    x = (batch.float() - mean) / var
    return craft_model.craft_forward(craft, refiner, x)


def _strip_module(sd):
    return {k.split('.', 1)[1] if k.startswith('module.') else k: v
            for k, v in sd.items()}


def get_det_boxes(textmap: np.ndarray, linkmap: np.ndarray,
                  text_threshold: float, link_threshold: float,
                  low_text: float) -> List[np.ndarray]:
    """reference craft_utils.getDetBoxes_core:19-81."""
    img_h, img_w = textmap.shape
    _, text_score = cv2.threshold(textmap, low_text, 1, 0)
    _, link_score = cv2.threshold(linkmap, link_threshold, 1, 0)
    comb = np.clip(text_score + link_score, 0, 1)
    n_labels, labels, stats, _ = cv2.connectedComponentsWithStats(
        comb.astype(np.uint8), connectivity=4)
    det = []
    for k in range(1, n_labels):
        size = stats[k, cv2.CC_STAT_AREA]
        if size < 10:
            continue
        if np.max(textmap[labels == k]) < text_threshold:
            continue
        segmap = np.zeros(textmap.shape, np.uint8)
        segmap[labels == k] = 255
        segmap[np.logical_and(link_score == 1, text_score == 0)] = 0
        x, y = stats[k, cv2.CC_STAT_LEFT], stats[k, cv2.CC_STAT_TOP]
        w, h = stats[k, cv2.CC_STAT_WIDTH], stats[k, cv2.CC_STAT_HEIGHT]
        niter = int(math.sqrt(size * min(w, h) / (w * h)) * 2)
        sx, ex = max(x - niter, 0), min(x + w + niter + 1, img_w)
        sy, ey = max(y - niter, 0), min(y + h + niter + 1, img_h)
        kernel = cv2.getStructuringElement(cv2.MORPH_RECT,
                                           (2 + niter, 2 + niter))
        segmap[sy:ey, sx:ex] = cv2.dilate(segmap[sy:ey, sx:ex], kernel)
        np_contours = np.roll(np.array(np.where(segmap != 0)), 1,
                              axis=0).transpose().reshape(-1, 2)
        rectangle = cv2.minAreaRect(np_contours)
        box = cv2.boxPoints(rectangle)
        bw = np.linalg.norm(box[0] - box[1])
        bh = np.linalg.norm(box[1] - box[2])
        if abs(1 - max(bw, bh) / (min(bw, bh) + 1e-5)) <= 0.1:
            l, r = np_contours[:, 0].min(), np_contours[:, 0].max()
            t, b = np_contours[:, 1].min(), np_contours[:, 1].max()
            box = np.array([[l, t], [r, t], [r, b], [l, b]], np.float32)
        startidx = box.sum(axis=1).argmin()
        det.append(np.roll(box, 4 - startidx, 0))
    return det


class CRAFTDetector(OfflineDetector):
    _MODEL_MAPPING = {
        'refiner': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/craft_refiner_CTW1500.pth',
            'hash': 'f7000cd3e9c76f2231b62b32182212203f73c08dfaa12bb16ffb529948a01399',
            'file': 'craft_refiner_CTW1500.pth',
        },
        'craft': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/craft_mlt_25k.pth',
            'hash': '4a5efbfb48b4081100544e75e1e2b57f8de3d84f213004b14b85fd4b3748db17',
            'file': 'craft_mlt_25k.pth',
        },
    }

    def __init__(self):
        super().__init__()
        self.craft = None
        self.refiner = None
        self.device: Optional[torch.device] = None

    async def _load(self, device: str):
        self.device = torch.device(device)
        self.craft = craft_model.build(
            craft_model.CRAFT, self.device, _strip_module(self.load_state_dict(
                'craft', init_fn=craft_model.init_state_dict)))
        self.refiner = craft_model.build(
            craft_model.RefineNet, self.device,
            _strip_module(self.load_state_dict(
                'refiner', init_fn=craft_model.init_refiner_state_dict)))

    async def _unload(self):
        self.craft = None
        self.refiner = None

    async def _infer(self, image: np.ndarray, detect_size: int,
                     text_threshold: float, box_threshold: float,
                     unclip_ratio: float, verbose: bool = False):
        im_h, im_w = image.shape[:2]
        ratio = detect_size / max(im_h, im_w)
        tw, th = int(round(im_w * ratio)), int(round(im_h * ratio))
        resized = cv2.resize(image, (tw, th), interpolation=cv2.INTER_CUBIC)
        pad_h = (-th) % PAD_MULT
        pad_w = (-tw) % PAD_MULT
        canvas = np.zeros((th + pad_h, tw + pad_w, 3), np.uint8)
        canvas[:th, :tw] = resized

        text_map, link_map = _forward(
            self.craft, self.refiner,
            torch.from_numpy(canvas)[None].to(self.device))
        score_text = text_map[0].float().cpu().numpy()
        score_link = link_map[0].float().cpu().numpy()

        boxes = get_det_boxes(score_text, score_link, text_threshold,
                              box_threshold, box_threshold)
        inv = (1.0 / ratio) * 2  # maps are at half the network input
        polys = [box * inv for box in boxes]

        mask = np.zeros((im_h, im_w), np.uint8)
        for poly in polys:
            cv2.fillPoly(mask, [poly.reshape(-1, 1, 2).astype(np.int32)], 255)

        polys_ret = []
        for poly in polys:
            rect = cv2.minAreaRect(poly.astype(np.float32))
            if rect[1][0] * rect[1][1] <= 10:
                continue
            grown = (rect[0], (rect[1][0] * 1.2, rect[1][1] * 1.2), rect[2])
            polys_ret.append(np.roll(cv2.boxPoints(grown), 2, axis=0))

        kern = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (9, 9))
        mask = cv2.dilate(mask, kern)

        textlines = [Quadrilateral(pts.astype(int), '', 1)
                     for pts in polys_ret]
        textlines = [q for q in textlines if q.area > 16]
        return textlines, mask, None
