"""ComicTextDetector (ctd) — PyTorch port.

Counterpart of the JAX package's ``detection/ctd.py`` (reference
``detection/ctd.py:62-186``): /255 normalisation, a 1024 px letterbox
(stride 64, fill 114), the webtoon rearrange for tall pages (``ops/
tiling.py``, resized with ``ops/resize.resize_linear`` as the JAX package
resizes with ``jax.image.resize``), the DB postprocess with thresh 0.3 and
box_thresh 0.6 on the line maps, and the ctd textmask refinement as the
raw mask. The network is plain PyTorch on the card; contours and the mask
refinement run on the host.
"""
from __future__ import annotations

from typing import Optional

import cv2
import numpy as np
import torch

from ..models import ctd as ctd_model
from ..ops.resize import resize_linear
from ..ops.tiling import extract_squares, needs_tiling, plan_tiles, stitch_maps
from ..utils.geometry import Quadrilateral
from .common import OfflineDetector
from .ctd_textmask import refine_mask
from .db_postprocess import DBPostprocess

STRIDE = 64
PARTS = ('blk_det', 'text_seg', 'text_det')


@torch.no_grad()
def _forward_batch(model, batch: torch.Tensor):
    """(N, H, W, 3) uint8 or float pixels → (mask (N, H, W), lines (N, H,
    W, 2))."""
    mask, lines = ctd_model.ctd_forward(model, batch.float() / 255.0)
    return mask[..., 0], lines


def flatten_checkpoint(sd: dict) -> dict:
    """The checkpoint's three parts as one flat state dict with the part
    names as prefixes; ``blk_det`` may wrap its weights under
    ``weights`` (JAX ``ComicTextDetector._load``)."""
    flat = {}
    for part in PARTS:
        sub = sd.get(part, {})
        if part == 'blk_det' and isinstance(sub, dict) and 'weights' in sub:
            sub = sub['weights']
        for k, v in sub.items():
            flat[f'{part}.{k}'] = v
    return flat


def _nested_init() -> dict:
    flat = ctd_model.init_state_dict()
    return {part: {k[len(part) + 1:]: v for k, v in flat.items()
                   if k.startswith(part + '.')} for part in PARTS}


class ComicTextDetector(OfflineDetector):
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/comictextdetector.pt',
            'hash': '1f90fa60aeeb1eb82e2ac1167a66bf139a8a61b8780acd351ead55268540cccb',
            'file': '.',
        },
    }

    def __init__(self, input_size: int = 1024, conf_thresh: float = 0.4,
                 nms_thresh: float = 0.35):
        super().__init__()
        self.model = None
        self.device: Optional[torch.device] = None
        self.input_size = input_size
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh

    async def _load(self, device: str):
        sd = self.load_state_dict('model', init_fn=_nested_init)
        self.device = torch.device(device)
        self.model = ctd_model.build_ctd(self.device, flatten_checkpoint(sd))

    async def _unload(self):
        self.model = None

    async def _infer(self, image: np.ndarray, detect_size: int,
                     text_threshold: float, box_threshold: float,
                     unclip_ratio: float, verbose: bool = False):
        im_h, im_w = image.shape[:2]
        size = self.input_size

        if needs_tiling(im_h, im_w, size):
            plan = plan_tiles(im_h, im_w, size)
            img = torch.from_numpy(np.ascontiguousarray(image)).to(
                self.device)
            squares = extract_squares(img, plan)
            s = squares.shape[1]
            mask, lines = _forward_batch(
                self.model, resize_linear(squares.float(), size, size))
            mask_full = stitch_maps(resize_linear(mask[..., None], s, s),
                                    plan)[..., 0].cpu().numpy()
            prob_np = stitch_maps(resize_linear(lines[..., 0:1], s, s),
                                  plan)[..., 0].cpu().numpy()
            mask_np = np.clip(mask_full * 255, 0, 255).astype(np.uint8)
        else:
            # letterbox to input_size, stride 64
            ratio = size / max(im_h, im_w)
            tw, th = int(round(im_w * ratio)), int(round(im_h * ratio))
            resized = cv2.resize(image, (tw, th),
                                 interpolation=cv2.INTER_LINEAR)
            pw = (-tw) % STRIDE
            ph = (-th) % STRIDE
            canvas = np.full((th + ph, tw + pw, 3), 114, np.uint8)
            canvas[:th, :tw] = resized
            mask, lines = _forward_batch(
                self.model, torch.from_numpy(canvas)[None].to(self.device))
            mask_np = np.clip(mask[0].float().cpu().numpy() * 255,
                              0, 255).astype(np.uint8)[:th, :tw]
            # line maps are at the network input's resolution: trim the pads
            prob_np = lines[0, :th, :tw, 0].float().cpu().numpy()

        det = DBPostprocess(thresh=0.3, box_thresh=0.6,
                            unclip_ratio=unclip_ratio)
        boxes, scores = det(prob_np, im_w, im_h)
        if boxes.shape[0]:
            keep = boxes.reshape(boxes.shape[0], -1).sum(axis=1) > 0
            boxes, scores = boxes[keep], scores[keep]

        textlines = [Quadrilateral(pts.astype(int), '', float(s))
                     for pts, s in zip(boxes, scores)]
        textlines = [q for q in textlines if q.area > 16]

        mask_resized = cv2.resize(mask_np, (im_w, im_h),
                                  interpolation=cv2.INTER_LINEAR)
        mask_refined = refine_mask(image, mask_resized, textlines,
                                   refine_mode=None)
        return textlines, mask_refined, None
