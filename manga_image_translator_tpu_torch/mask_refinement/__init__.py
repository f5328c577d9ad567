"""Mask refinement: fit the raw text-probability mask to actual text pixels.

Contract from reference ``mask_refinement/__init__.py`` +
``text_mask_utils.py:96-195``: downscale, connected components of the raw
mask, assign each CC to its best textline (polygon-overlap ratio, centroid
distance), per-textline CRF refinement, font-size-scaled elliptical dilation,
final kernel_size dilation.

Port split (as in the JAX package): CC labeling/assignment stays on the
host (cheap, irregular); the windowed CRF (``ops.crf``) runs on the device,
one call per crop bucket, and the bilateral prefilter is kernel K1.
"""
from __future__ import annotations

from typing import List, Optional

import cv2
import numpy as np

import torch

from ..ops.bilateral import bilateral_filter
from ..ops.crf import crf_refine_batch
from ..utils.bubble import is_ignore
from ..utils.geometry import Quadrilateral
from ..utils.profiling import span, to_host
from ..utils.textblock import TextBlock


def _point_to_poly_distance(pts: np.ndarray, point) -> float:
    """shapely Polygon.distance(Point) equivalent: 0 inside, else boundary
    distance."""
    d = cv2.pointPolygonTest(pts.astype(np.float32), (float(point[0]),
                                                      float(point[1])), True)
    return 0.0 if d >= 0 else -d


def _convex_intersection_area(pts_a: np.ndarray, pts_b: np.ndarray) -> float:
    inter, _ = cv2.intersectConvexConvex(pts_a.astype(np.float32),
                                         pts_b.astype(np.float32))
    return float(inter)


def extend_rect(x, y, w, h, max_x, max_y, extend_size):
    x1 = max(x - extend_size, 0)
    y1 = max(y - extend_size, 0)
    w1 = min(w + extend_size * 2, max_x - x1 - 1)
    h1 = min(h + extend_size * 2, max_y - y1 - 1)
    return x1, y1, w1, h1


def _bucket(v: int, step: int = 64, cap: int = 1024) -> int:
    return min(((v + step - 1) // step) * step, cap)


def _pad_n(n: int) -> int:
    """Batch sizes CRF crop batches are padded up to (bounds compiles)."""
    for s in (1, 2, 4, 8, 16, 32):
        if s >= n:
            return s
    return -(-n // 32) * 32


def _tiles(jobs):
    """(job index, y, x, rgb tile, mask tile) of every job, a crop larger
    than the CRF bucket cap (1024) split into tiles of at most the cap."""
    cap = _bucket(1 << 30)
    for idx, (rgbimg, rawmask) in enumerate(jobs):
        h, w = rawmask.shape[:2]
        for y in range(0, h, cap):
            for x in range(0, w, cap):
                yield (idx, y, x, rgbimg[y:y + cap, x:x + cap],
                       rawmask[y:y + cap, x:x + cap])


def refine_masks_batched(jobs, device='cpu') -> List[np.ndarray]:
    """Device CRF refinement of many textline crops in few dispatches.

    ``jobs``: list of ``(rgb (h,w,3) uint8, rawmask (h,w) uint8)``; returns
    refined uint8 masks of the jobs' shapes, in job order. The reference
    refines each textline with its own pydensecrf call
    (text_mask_utils.py:96-195); dispatching a device kernel per line costs
    ~4 synchronous host<->device interactions each. Here same-bucket crops
    stack into ONE batched kernel call and every bucket's call is
    dispatched before any result is pulled, so a ~24-line page needs a
    handful of round trips instead of ~100. A crop past the buckets' cap
    of 1024 is refined in tiles of at most 1024 (the JAX package returns
    only its first 1024 rows and columns, and its caller then fails).
    """
    tiles = list(_tiles(jobs))
    padded = []
    groups: dict = {}
    for t, (_, _, _, rgbimg, rawmask) in enumerate(tiles):
        h, w = rawmask.shape[:2]
        bh, bw = _bucket(h), _bucket(w)
        # edge-replicated padding: zero padding would inject confident
        # background pixels whose color can alias with the text strokes
        img_p = np.pad(rgbimg, ((0, bh - h), (0, bw - w), (0, 0)),
                       mode='edge')
        mask_p = np.pad(rawmask.astype(np.float32) / 255.0,
                        ((0, bh - h), (0, bw - w)), mode='edge')
        padded.append((img_p, mask_p, h, w))
        groups.setdefault((bh, bw), []).append(t)

    pending = []
    for (bh, bw), idxs in groups.items():
        n_pad = _pad_n(len(idxs))
        imgs = np.zeros((n_pad, bh, bw, 3), np.uint8)
        masks = np.zeros((n_pad, bh, bw), np.float32)
        for row, t in enumerate(idxs):
            imgs[row] = padded[t][0]
            masks[row] = padded[t][1]
        out = crf_refine_batch(torch.from_numpy(imgs).to(device),
                               torch.from_numpy(masks).to(device),
                               num_iters=5, radius=23, stride=3)
        pending.append((idxs, out))

    results = [np.zeros(raw.shape[:2], np.uint8) for _, raw in jobs]
    for idxs, out in pending:
        out_np = to_host(out).numpy()
        for row, t in enumerate(idxs):
            idx, y, x = tiles[t][:3]
            h, w = padded[t][2], padded[t][3]
            results[idx][y:y + h, x:x + w] = (
                (out_np[row, :h, :w] > 0.5).astype(np.uint8) * 255)
    return results


def complete_mask_fill(mask_shape, text_lines) -> np.ndarray:
    final_mask = np.zeros(mask_shape, np.uint8)
    for (x, y, w, h) in text_lines:
        cv2.rectangle(final_mask, (x, y), (x + w, y + h), 255, -1)
    return final_mask


def assign_components(mask: np.ndarray, textlines: List[Quadrilateral],
                      keep_threshold: float):
    """Each connected component of ``mask`` (the line boxes' outlines
    erased) given to its textline: the one it overlaps most, or the
    nearest within half a glyph. Returns each textline's component mask
    and its (x, y, w, h) rectangle, or None when no component was given
    to any line."""
    bboxes = [q.aabb.xywh for q in textlines]
    poly_pts = [q.pts.astype(np.float64) for q in textlines]
    poly_areas = [cv2.contourArea(p.astype(np.float32)) for p in poly_pts]
    for (x, y, w, h) in bboxes:
        cv2.rectangle(mask, (int(x), int(y)), (int(x + w), int(y + h)), 0, 1)
    num_labels, labels, stats, _ = cv2.connectedComponentsWithStats(mask)

    M = len(textlines)
    if M == 0:
        return None
    textline_ccs = [np.zeros_like(mask) for _ in range(M)]
    iinfo = np.iinfo(labels.dtype)
    textline_rects = np.full((M, 4), [iinfo.max, iinfo.max, iinfo.min,
                                      iinfo.min], dtype=labels.dtype)
    valid = False
    for label in range(1, num_labels):
        if stats[label, cv2.CC_STAT_AREA] <= 9:
            continue
        x1 = stats[label, cv2.CC_STAT_LEFT]
        y1 = stats[label, cv2.CC_STAT_TOP]
        w1 = stats[label, cv2.CC_STAT_WIDTH]
        h1 = stats[label, cv2.CC_STAT_HEIGHT]
        area1 = stats[label, cv2.CC_STAT_AREA]
        cc_pts = np.array([[x1, y1], [x1 + w1, y1], [x1 + w1, y1 + h1],
                           [x1, y1 + h1]], np.float64)
        cc_centroid = (x1 + w1 / 2.0, y1 + h1 / 2.0)

        ratios = np.zeros((M,), np.float32)
        dists = np.zeros((M,), np.float32)
        for tl_idx in range(M):
            area2 = poly_areas[tl_idx]
            overlap = _convex_intersection_area(poly_pts[tl_idx], cc_pts)
            ratios[tl_idx] = overlap / max(min(area1, area2), 1e-9)
            dists[tl_idx] = _point_to_poly_distance(poly_pts[tl_idx],
                                                    cc_centroid)
        avg = int(np.argmax(ratios))
        area2 = poly_areas[avg]
        if area1 >= area2:
            continue
        if ratios[avg] <= keep_threshold:
            avg = int(np.argmin(dists))
            unit = max(min([textlines[avg].font_size, w1, h1]), 10)
            if dists[avg] >= 0.5 * unit:
                continue

        region = textline_ccs[avg][y1:y1 + h1, x1:x1 + w1]
        region[labels[y1:y1 + h1, x1:x1 + w1] == label] = 255
        textline_rects[avg, 0] = min(textline_rects[avg, 0], x1)
        textline_rects[avg, 1] = min(textline_rects[avg, 1], y1)
        textline_rects[avg, 2] = max(textline_rects[avg, 2], x1 + w1)
        textline_rects[avg, 3] = max(textline_rects[avg, 3], y1 + h1)
        valid = True

    if not valid:
        return None
    textline_rects[:, 2] -= textline_rects[:, 0]
    textline_rects[:, 3] -= textline_rects[:, 1]
    return textline_ccs, textline_rects


def complete_mask(img: np.ndarray, mask: np.ndarray,
                  textlines: List[Quadrilateral], keep_threshold=1e-2,
                  dilation_offset=0, kernel_size=3,
                  device='cpu') -> Optional[np.ndarray]:
    with span('mask.assign'):
        assigned = assign_components(mask, textlines, keep_threshold)
    if assigned is None:
        return None
    textline_ccs, textline_rects = assigned

    final_mask = np.zeros_like(mask)
    with span('mask.bilateral'):
        img = to_host(bilateral_filter(
            torch.from_numpy(np.ascontiguousarray(img)).to(device), 17,
            80.0, 80.0)).numpy()
    # Phase 1 (host): collect every textline's CRF crop. Phase 2 (device):
    # refine them all in a few batched calls. Phase 3 (host): dilate and
    # composite.
    with span('mask.crf'):
        jobs = []
        meta = []
        for i, cc in enumerate(textline_ccs):
            x1, y1, w1, h1 = [int(v) for v in textline_rects[i]]
            if w1 <= 0 or h1 <= 0:
                continue
            text_size = min(w1, h1, textlines[i].font_size)
            x1, y1, w1, h1 = extend_rect(x1, y1, w1, h1, img.shape[1],
                                         img.shape[0], int(text_size * 0.1))
            dilate_size = max((int((text_size + dilation_offset) * 0.3) // 2)
                              * 2 + 1, 3)
            cc_region = np.ascontiguousarray(cc[y1:y1 + h1, x1:x1 + w1])
            if cc_region.size == 0:
                continue
            img_region = np.ascontiguousarray(img[y1:y1 + h1, x1:x1 + w1])
            jobs.append((img_region, cc_region))
            meta.append((i, x1, y1, w1, h1, dilate_size))

        refined = refine_masks_batched(jobs, device)
    with span('mask.dilate'):
        for (i, x1, y1, w1, h1, dilate_size), cc_region in zip(meta, refined):
            cc = textline_ccs[i]
            kern = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                             (dilate_size, dilate_size))
            cc[y1:y1 + h1, x1:x1 + w1] = cc_region
            x2, y2, w2, h2 = extend_rect(x1, y1, w1, h1, img.shape[1],
                                         img.shape[0], -(-dilate_size // 2))
            cc[y2:y2 + h2, x2:x2 + w2] = cv2.dilate(cc[y2:y2 + h2, x2:x2 + w2],
                                                    kern)
            final_mask[y2:y2 + h2, x2:x2 + w2] = cv2.bitwise_or(
                final_mask[y2:y2 + h2, x2:x2 + w2], cc[y2:y2 + h2, x2:x2 + w2])

        kern = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                         (kernel_size, kernel_size))
        return cv2.dilate(final_mask, kern)

async def dispatch(text_regions: List[TextBlock], raw_image: np.ndarray,
                   raw_mask: np.ndarray, method: str = 'fit_text',
                   dilation_offset: int = 0, ignore_bubble: int = 0,
                   verbose: bool = False, kernel_size: int = 3,
                   device='cpu') -> np.ndarray:
    scale_factor = max(min((raw_mask.shape[0] - raw_image.shape[0] / 3)
                           / raw_mask.shape[0], 1), 0.5)
    size = (int(raw_image.shape[1] * scale_factor),
            int(raw_image.shape[0] * scale_factor))
    img_resized = cv2.resize(raw_image, size, interpolation=cv2.INTER_LINEAR)
    mask_resized = cv2.resize(raw_mask, size, interpolation=cv2.INTER_LINEAR)
    mask_resized[mask_resized > 0] = 255

    textlines = []
    for region in text_regions:
        for l in region.lines:
            textlines.append(Quadrilateral(l * scale_factor, '', 0))

    if method == 'fit_text':
        final_mask = complete_mask(img_resized, mask_resized, textlines,
                                   dilation_offset=dilation_offset,
                                   kernel_size=kernel_size, device=device)
    else:
        final_mask = complete_mask_fill(
            mask_resized.shape, [q.aabb.xywh for q in textlines])

    if final_mask is None:
        return np.zeros((raw_image.shape[0], raw_image.shape[1]), np.uint8)
    final_mask = cv2.resize(final_mask,
                            (raw_image.shape[1], raw_image.shape[0]),
                            interpolation=cv2.INTER_LINEAR)
    final_mask[final_mask > 0] = 255

    if ignore_bubble < 1 or ignore_bubble > 50:
        return final_mask

    ksize = int(max(final_mask.shape) * 0.025)
    kernel = np.ones((max(ksize, 1), max(ksize, 1)), np.uint8)
    final_mask = cv2.dilate(final_mask, kernel, iterations=1)
    contours, _ = cv2.findContours(final_mask, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    for cnt in contours:
        temp_mask = np.zeros_like(final_mask)
        x, y, w, h = cv2.boundingRect(cnt)
        cv2.rectangle(temp_mask, (x, y), (x + w, y + h), 255, -1)
        textblock = cv2.bitwise_and(raw_image, raw_image, mask=temp_mask)
        if is_ignore(textblock, ignore_bubble):
            cv2.drawContours(final_mask, [cnt], -1, 0, -1)
    return final_mask
