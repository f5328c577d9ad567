"""Inpainter base classes (contract: reference inpainting/common.py).

Counterpart of the JAX package's ``inpainting/common.py``. Masked-crop
mode: instead of running the generator over the whole page, inpaint only
context-padded, bucket-snapped crops around the mask's connected
components (``crop_plan.py``) and composite each crop's own mask pixels
back. The final composite discards everything outside the mask anyway
(reference ``inpainting_lama_mpe.py:117``), and the LaMa checkpoint is
512px-native. Crops from all pages of a batch share the device batches;
pages whose plan falls back (the mask covers most of the page) take the
full-page path.

Port notes: every bucket runs at its real crop count (the JAX package
padded batches to {1, 2, 4, 8, 16, 32} to bound XLA compiles; rows are
independent, so the output is the same). The device work of every bucket
is enqueued before the first result is copied to the host, so PyTorch's
asynchronous launches overlap the next bucket's host crop work with the
device, as JAX's dispatch did. Crop mode is the only route (the JAX
package's ``MIT_TPU_INPAINT_CROPS`` and ``MIT_TPU_INPAINT_CROP_NATIVE``
switches are not ported).
"""
from __future__ import annotations

from abc import abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import cv2
import numpy as np

from ..config import InpainterConfig
from ..utils.inference import InfererModule, ModelWrapper
from ..utils.profiling import to_host
from .crop_plan import (DEFAULT_BUCKETS, _consolidate_buckets,
                        apply_bucket_mapping, full_page_path_pixels,
                        plan_crops)

PAD_SIZE = 8

# Shared planner pool: only the cv2/numpy portions of plan_crops release
# the GIL, so threads buy back part of the per-page plan cost.
_PLAN_POOL: Optional[ThreadPoolExecutor] = None


def _plan_pool() -> ThreadPoolExecutor:
    global _PLAN_POOL
    if _PLAN_POOL is None:
        _PLAN_POOL = ThreadPoolExecutor(4, thread_name_prefix='crop-plan')
    return _PLAN_POOL


class CommonInpainter(InfererModule):

    async def inpaint(self, image: np.ndarray, mask: np.ndarray,
                      config: InpainterConfig, inpainting_size: int = 1024,
                      verbose: bool = False) -> np.ndarray:
        return await self._inpaint(image, mask, config, inpainting_size,
                                   verbose)

    @abstractmethod
    async def _inpaint(self, image, mask, config, inpainting_size, verbose):
        ...


class OfflineInpainter(CommonInpainter, ModelWrapper):
    _MODEL_SUB_DIR = 'inpainting'

    def __init__(self):
        ModelWrapper.__init__(self)

    async def _inpaint(self, image, mask, config, inpainting_size=1024,
                       verbose=False):
        if self.supports_batch:
            outs = self._inpaint_crops_multi([image], [mask], config,
                                             inpainting_size)
            if outs[0] is not None:
                return outs[0]
        return await self.infer(image, mask, config, inpainting_size,
                                verbose)

    # -- batched page path -------------------------------------------------

    def _batch_forward(self, imgs: np.ndarray, masks: np.ndarray,
                       config: InpainterConfig) -> np.ndarray:
        """(N, H, W, 3) uint8 + (N, H, W) uint8 mask -> (N, H, W, 3) uint8
        inpainted. Overridden by inpainters with a batchable forward."""
        raise NotImplementedError

    def _batch_forward_dispatch(self, imgs: np.ndarray, masks: np.ndarray,
                                config: InpainterConfig):
        """Enqueue a batch forward without waiting for the device; the
        returned handle feeds ``_batch_forward_collect``. Default: the
        synchronous ``_batch_forward``."""
        return self._batch_forward(imgs, masks, config)

    @staticmethod
    def _batch_forward_collect(handle) -> np.ndarray:
        if hasattr(handle, 'cpu'):          # a torch tensor
            return to_host(handle).numpy()
        return np.asarray(handle)

    @property
    def supports_batch(self) -> bool:
        return (type(self)._batch_forward
                is not OfflineInpainter._batch_forward)

    # -- masked-crop path ---------------------------------------------------

    def _inpaint_crops_multi(self, images: List[np.ndarray],
                             masks: List[np.ndarray],
                             config: InpainterConfig,
                             inpainting_size: int = 1024
                             ) -> List[Optional[np.ndarray]]:
        """Inpaint N pages via mask-driven crops (crop_plan.plan_crops).

        Crops from every page are pooled, grouped by bucket shape and run
        through ``_batch_forward_dispatch``: one device forward per
        distinct bucket. Entries come back None for pages whose plan fell
        back (mask covers most of the page): the caller routes those
        through the full-page path. Pixels outside the mask are
        byte-identical to the input by construction."""
        buckets = tuple(b for b in DEFAULT_BUCKETS
                        if b <= max(DEFAULT_BUCKETS[0], inpainting_size))

        # crops render at the full-page path's effective scale (page ->
        # inpainting_size aspect-preserving resize): native scale for
        # pages up to inpainting_size (2048 by default)
        def _scale(img) -> float:
            h, w = img.shape[:2]
            return min(1.0, inpainting_size / max(h, w))

        def _plan(img, mask):
            h, w = img.shape[:2]
            # bucket consolidation runs once below over the pooled shapes
            return plan_crops(
                mask, buckets=buckets, scale=_scale(img),
                full_page_pixels=full_page_path_pixels(h, w,
                                                       inpainting_size),
                consolidate=False)

        if len(images) > 1:
            plans = list(_plan_pool().map(_plan, images, masks))
        else:
            plans = [_plan(images[0], masks[0])]

        pooled_shapes = [(c.bh, c.bw) for plan in plans if plan
                         for c in plan[0]]
        mapping = _consolidate_buckets(pooled_shapes)

        outs: List[Optional[np.ndarray]] = [None] * len(images)
        jobs = {}
        for i, plan in enumerate(plans):
            if plan is None:
                continue
            crops, mask_bin, owner = plan
            crops = apply_bucket_mapping(crops, mapping, _scale(images[i]),
                                         *images[i].shape[:2])
            outs[i] = np.copy(images[i])
            for c in crops:
                jobs.setdefault((c.bh, c.bw), []).append(
                    (i, c, mask_bin, owner))

        if jobs:
            total = sum(len(v) for v in jobs.values())
            self.logger.info(
                f'Crop inpainting (size {inpainting_size}): {total} crops '
                f'over {len(jobs)} bucket{"s" if len(jobs) != 1 else ""} '
                f'({", ".join(f"{len(v)}x{bh}x{bw}" for (bh, bw), v in sorted(jobs.items()))})')

        # pass 1 builds and enqueues every bucket's forward; pass 2
        # collects and composites in order
        handles = []
        for (bh, bw), items in sorted(jobs.items()):
            batch_img = np.empty((len(items), bh, bw, 3), np.uint8)
            batch_msk = np.empty((len(items), bh, bw), np.uint8)
            for k, (i, c, _wg, _ow) in enumerate(items):
                src_img = images[i][c.y0:c.y0 + c.h, c.x0:c.x0 + c.w]
                src_msk = masks[i][c.y0:c.y0 + c.h, c.x0:c.x0 + c.w]
                if c.scaled:
                    src_img = cv2.resize(src_img, (bw, bh),
                                         interpolation=cv2.INTER_LINEAR)
                    src_msk = cv2.resize(src_msk, (bw, bh),
                                         interpolation=cv2.INTER_LINEAR)
                batch_img[k] = src_img
                batch_msk[k] = src_msk
            handles.append(
                (items, self._batch_forward_dispatch(batch_img, batch_msk,
                                                     config)))

        for items, handle in handles:
            res = self._batch_forward_collect(handle)
            for k, (i, c, mask_bin, owner) in enumerate(items):
                out = res[k]
                if c.scaled:
                    out = cv2.resize(out, (c.w, c.h),
                                     interpolation=cv2.INTER_LINEAR)
                # write back only this crop's owned mask pixels: mask
                # pixels inside its cell rect whose CC label is in its
                # label set (disjoint across crops by construction)
                region = outs[i][c.gy0:c.gy1, c.gx0:c.gx1]
                osub = out[c.gy0 - c.y0:c.gy1 - c.y0,
                           c.gx0 - c.x0:c.gx1 - c.x0]
                wsel = mask_bin[c.gy0:c.gy1, c.gx0:c.gx1]
                if owner is not None and c.labels:
                    wsel = wsel & np.isin(
                        owner[c.gy0:c.gy1, c.gx0:c.gx1],
                        np.asarray(c.labels, np.int32))
                region[wsel] = osub[wsel]
        return outs

    async def infer_batch(self, images: List[np.ndarray],
                          masks: List[np.ndarray], config: InpainterConfig,
                          inpainting_size: int = 1024,
                          verbose: bool = False) -> List[np.ndarray]:
        """Inpaint N same-config pages: crops pooled across pages first;
        pages whose plan fell back go through the letterboxed full-page
        batch."""
        outs = self._inpaint_crops_multi(images, masks, config,
                                         inpainting_size)
        rest = [i for i, o in enumerate(outs) if o is None]
        if rest:
            full = await self._infer_batch_letterbox(
                [images[i] for i in rest], [masks[i] for i in rest],
                config, inpainting_size, verbose)
            for i, o in zip(rest, full):
                outs[i] = o
        return outs

    async def _infer_batch_letterbox(
            self, images: List[np.ndarray], masks: List[np.ndarray],
            config: InpainterConfig, inpainting_size: int = 1024,
            verbose: bool = False) -> List[np.ndarray]:
        """Full-page batch path: N same-config pages in one device forward.

        Per-page preprocessing mirrors ``_infer`` (aspect-resize to
        inpainting_size, stretch to a multiple of 8), then every page
        letterboxes top-left onto the batch's largest canvas with a zero
        mask in the padding: unmasked pixels pass through the final
        composite unchanged, so padding never leaks into the output."""
        n = len(images)
        metas, proc = [], []
        for image, mask in zip(images, masks):
            img_original = np.copy(image)
            mask_original = (np.copy(mask) >= 127).astype(np.uint8)[:, :,
                                                                    None]
            height, width = image.shape[:2]
            if max(image.shape[:2]) > inpainting_size:
                ratio = inpainting_size / max(height, width)
                new_size = (round(width * ratio), round(height * ratio))
                image = cv2.resize(image, new_size,
                                   interpolation=cv2.INTER_LINEAR)
                mask = cv2.resize(mask, new_size,
                                  interpolation=cv2.INTER_LINEAR)
            h, w = image.shape[:2]
            new_h = h + ((-h) % PAD_SIZE)
            new_w = w + ((-w) % PAD_SIZE)
            if (new_h, new_w) != (h, w):
                image = cv2.resize(image, (new_w, new_h),
                                   interpolation=cv2.INTER_LINEAR)
                mask = cv2.resize(mask, (new_w, new_h),
                                  interpolation=cv2.INTER_LINEAR)
            metas.append((height, width, new_h, new_w, img_original,
                          mask_original))
            proc.append((image, mask))

        canvas_h = max(m[2] for m in metas)
        canvas_w = max(m[3] for m in metas)
        canvas = np.zeros((n, canvas_h, canvas_w, 3), np.uint8)
        mcanvas = np.zeros((n, canvas_h, canvas_w), np.uint8)
        for i, (image, mask) in enumerate(proc):
            h, w = image.shape[:2]
            canvas[i, :h, :w] = image
            mcanvas[i, :h, :w] = mask
        self.logger.info(
            f'Batched inpainting: {n} pages at {canvas_w}x{canvas_h}')

        out = self._batch_forward(canvas, mcanvas, config)

        results = []
        for i, (height, width, new_h, new_w, img_original,
                mask_original) in enumerate(metas):
            img = out[i, :new_h, :new_w]
            if (new_h, new_w) != (height, width):
                img = cv2.resize(img, (width, height),
                                 interpolation=cv2.INTER_LINEAR)
            results.append((img * mask_original
                            + img_original * (1 - mask_original)
                            ).astype(np.uint8))
        return results
