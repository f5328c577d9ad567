"""Default detector: DBNet-ResNet34, PyTorch port.

Counterpart of the JAX package's ``detection/default.py`` (reference
``detection/default.py``: detect-20241225.ckpt, /127.5-1 normalization,
bilateral prefilter, pad to a multiple of 256, webtoon rearrange,
SegDetectorRepresenter postprocess). The bilateral prefilter is kernel K1
(``ops.bilateral``); resize, network and sigmoid are plain PyTorch; contour
extraction runs on the host. Batch mode (``infer_batch_dispatch`` /
``infer_batch_collect``) runs one K1 launch and one forward per chunk of
letterboxed pages.
"""
from __future__ import annotations

from typing import Optional, Tuple

import cv2
import numpy as np
import torch

from ..models.dbnet import build_dbnet, dbnet_forward, init_state_dict
from ..ops.bilateral import bilateral_filter, bilateral_filter_batch
from ..ops.resize import resize_linear
from ..ops.tiling import extract_squares, needs_tiling, plan_tiles, stitch_maps
from ..utils.geometry import Quadrilateral
from ..utils.profiling import span, to_host
from .common import OfflineDetector
from .db_postprocess import DBPostprocess

PAD_MULT = 256  # reference imgproc.resize_aspect_ratio pads to 256


@torch.no_grad()
def _forward_batch(model, batch: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) uint8 or float pixels → (prob (N, H, W), mask (N, H/2,
    W/2))."""
    x = batch.float() / 127.5 - 1.0
    db, mask = dbnet_forward(model, x)
    return torch.sigmoid(db[..., 0]), mask[..., 0]


def _preprocess_page(img: torch.Tensor, out_h: int, out_w: int,
                     pad_h: int, pad_w: int) -> torch.Tensor:
    """bilateral filter (on the original page, the reference order) +
    resize + zero pad, on the device."""
    smoothed = bilateral_filter(img, 17, 80.0, 80.0)
    resized = resize_linear(smoothed.float(), out_h, out_w)
    return torch.nn.functional.pad(resized, (0, 0, 0, pad_w, 0, pad_h))


def _preprocess_batch(imgs: torch.Tensor) -> torch.Tensor:
    """Batched bilateral prefilter of letterboxed (N, S, S, 3) uint8
    canvases (one kernel launch for the batch)."""
    return bilateral_filter_batch(imgs, 17, 80.0, 80.0)


@torch.no_grad()
def _maps_batch(model, canvases: torch.Tensor):
    """Bilateral prefilter (K1) + DBNet forward on (N, S, S, 3) uint8
    canvases: the per-shard body of the multi-device detection path."""
    return _forward_batch(model, _preprocess_batch(canvases))


@torch.no_grad()
def _detect_maps(model, canvases: torch.Tensor):
    """Prob/mask maps for a letterboxed page batch: split over every
    device of the serving mesh when there is one
    (``parallel.mesh.get_mesh``), else one batched prefilter + one network
    forward on the model's device."""
    from ..parallel.mesh import sharded_batch
    return sharded_batch(_maps_batch, 'dbnet.maps', model, canvases)


class DefaultDetector(OfflineDetector):
    """DBNet-ResNet34 'default' detector."""

    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/detect-20241225.ckpt',
            'hash': '67ce1c4ed4793860f038c71189ba9630a7756f7683b1ee5afb69ca0687dc502e',
            'file': '.',
        },
    }

    def __init__(self):
        super().__init__()
        self.model = None
        self.device: Optional[torch.device] = None

    async def _load(self, device: str):
        sd = self.load_state_dict('model', init_fn=init_state_dict)
        self.device = torch.device(device)
        self.model = build_dbnet(self.device, sd)

    async def _unload(self):
        self.model = None

    async def _infer(self, image: np.ndarray, detect_size: int,
                     text_threshold: float, box_threshold: float,
                     unclip_ratio: float, verbose: bool = False):
        im_h, im_w = image.shape[:2]
        if needs_tiling(im_h, im_w, detect_size):
            prob, mask, (res_h, res_w), ratio, pads = self._forward_tiled(
                image, detect_size)
        else:
            prob, mask, (res_h, res_w), ratio, pads = self._forward_single(
                image, detect_size)
        pad_h, pad_w = pads

        with span('detect.postprocess'):
            det = DBPostprocess(text_threshold, box_threshold,
                                unclip_ratio=unclip_ratio)
            boxes, scores = det(prob, res_w, res_h)
            if boxes.shape[0]:
                keep = boxes.reshape(boxes.shape[0], -1).sum(axis=1) > 0
                polys = boxes[keep].astype(np.float64)
                polys *= (1.0 / ratio)
                polys = polys.astype(np.int64)
                scores = scores[keep]
            else:
                polys, scores = boxes, scores

            textlines = [Quadrilateral(pts.astype(int), '', float(score))
                         for pts, score in zip(polys, scores)]
            textlines = [q for q in textlines if q.area > 16]

            # mask comes out at 1/2 the network input; restore to input res
            mask_resized = cv2.resize(
                mask, (mask.shape[1] * 2, mask.shape[0] * 2),
                interpolation=cv2.INTER_LINEAR)
            if pad_h > 0:
                mask_resized = mask_resized[:-pad_h, :]
            if pad_w > 0:
                mask_resized = mask_resized[:, :-pad_w]
            raw_mask = np.clip(mask_resized * 255, 0, 255).astype(np.uint8)
        return textlines, raw_mask, None

    # -- batched page path -------------------------------------------------
    async def infer_batch(self, images, detect_size: int,
                          text_threshold: float, box_threshold: float,
                          unclip_ratio: float, verbose: bool = False):
        """Detect over N pages in one network forward: each page is
        letterboxed top-left into a shared ``detect_size`` square."""
        handle = await self.infer_batch_dispatch(images, detect_size)
        return self.infer_batch_collect(handle, detect_size, text_threshold,
                                        box_threshold, unclip_ratio)

    async def infer_batch_dispatch(self, images, detect_size: int):
        """Enqueue a page batch's device work (batched K1 + one DBNet
        forward) without waiting for it. Returns the handle that
        ``infer_batch_collect`` takes; the maps stay device tensors, so the
        caller can run the previous chunk's host postprocess meanwhile.

        Unlike the single-page path, which filters the original page and
        then resizes, the batch filters the letterboxed canvases, so that
        every page shares one shape."""
        if not self.is_loaded:
            await self.load()
        n = len(images)
        canvases = np.zeros((n, detect_size, detect_size, 3), np.uint8)
        metas = []
        for i, image in enumerate(images):
            im_h, im_w = image.shape[:2]
            ratio = detect_size / max(im_h, im_w)
            th, tw = int(round(im_h * ratio)), int(round(im_w * ratio))
            canvases[i, :th, :tw] = cv2.resize(
                image, (tw, th), interpolation=cv2.INTER_LINEAR)
            metas.append((ratio, th, tw))
        prob, mask = _detect_maps(self.model,
                                  torch.from_numpy(canvases).to(self.device))
        return {'metas': metas, 'prob': prob, 'mask': mask}

    def infer_batch_collect(self, handle, detect_size: int,
                            text_threshold: float, box_threshold: float,
                            unclip_ratio: float):
        """Move a dispatched batch's maps to the host and run the DB
        postprocess on each page."""
        prob_np = handle['prob'].float().cpu().numpy()
        mask_np = handle['mask'].float().cpu().numpy()
        results = []
        det = DBPostprocess(text_threshold, box_threshold,
                            unclip_ratio=unclip_ratio)
        for i, (ratio, th, tw) in enumerate(handle['metas']):
            boxes, scores = det(prob_np[i], detect_size, detect_size)
            if boxes.shape[0]:
                keep = boxes.reshape(boxes.shape[0], -1).sum(axis=1) > 0
                polys = (boxes[keep].astype(np.float64)
                         / ratio).astype(np.int64)
                scores = scores[keep]
            else:
                polys = boxes
            textlines = [Quadrilateral(pts.astype(int), '', float(s))
                         for pts, s in zip(polys, scores)]
            textlines = [q for q in textlines if q.area > 16]
            m = cv2.resize(mask_np[i], (detect_size, detect_size),
                           interpolation=cv2.INTER_LINEAR)[:th, :tw]
            raw_mask = np.clip(m * 255, 0, 255).astype(np.uint8)
            results.append((textlines, raw_mask, None))
        return results

    def _forward_single(self, image: np.ndarray, detect_size: int):
        im_h, im_w = image.shape[:2]
        ratio = detect_size / max(im_h, im_w)
        target_h, target_w = int(round(im_h * ratio)), int(round(im_w * ratio))
        pad_h = (-target_h) % PAD_MULT
        pad_w = (-target_w) % PAD_MULT
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        page = _preprocess_page(img, target_h, target_w, pad_h, pad_w)
        prob, mask = _forward_batch(self.model, page[None])
        prob = to_host(prob[0].float()).numpy()
        mask = to_host(mask[0].float()).numpy()
        return (prob, mask, (target_h + pad_h, target_w + pad_w), ratio,
                (pad_h, pad_w))

    def _forward_tiled(self, image: np.ndarray, detect_size: int):
        im_h, im_w = image.shape[:2]
        plan = plan_tiles(im_h, im_w, detect_size)
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        squares = extract_squares(img, plan)
        n, s, _, _ = squares.shape
        batch = resize_linear(squares.float(), detect_size, detect_size)
        prob, mask = _forward_batch(self.model, batch)
        prob_full = stitch_maps(resize_linear(prob[..., None], s, s), plan)
        mask_full = stitch_maps(resize_linear(mask[..., None], s // 2, s // 2),
                                plan)
        return (to_host(prob_full[..., 0]).numpy(),
                to_host(mask_full[..., 0]).numpy(), (im_h, im_w), 1.0,
                (0, 0))
