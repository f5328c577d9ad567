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
from ..utils.profiling import count, span, to_host
from ..utils.textblock import TextBlock


# components ``assign_components`` decides at once against every line, in
# (rows, M) arrays of at most 128 KiB
_PAIRS_PER_BLOCK = 16384
# px by which a component's rectangle may miss a line's box and still have
# its overlap with a quad that is not convex taken from cv2, and the slack
# of the box test that spares the distances of lines beyond half a glyph
_TOUCH_PX = 1e-2
# bound on how far an overlap clipped here may lie from cv2's, in px^2 per
# px of the rectangle's half perimeter (cv2 rounds each clipped corner to
# float32: 6e-5 px at 1,024-2,048 px)
_AREA_TOL = 4e-3
# relative bound on how far a distance computed here may lie from cv2's
_DIST_TOL = 1e-6
# relative room kept around ties and thresholds for float32 rounding
_REL_MARGIN = 1e-6


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


class _Lines:
    """The textlines as ``assign_components`` reads them, once: each quad's
    corners as the float32 cv2 is given, its ``contourArea``, box and font
    size, and whether it is a convex quad of some area (``regular``: only
    such quads are clipped here; cv2 decides the overlaps of the rest)."""

    def __init__(self, textlines: List[Quadrilateral]):
        self.pts = np.stack([q.pts for q in textlines]).astype(np.float32)
        self.area = np.array([cv2.contourArea(p) for p in self.pts])
        self.lo = self.pts.min(axis=1).astype(np.float64)
        self.hi = self.pts.max(axis=1).astype(np.float64)
        self.font = np.array([q.font_size for q in textlines])
        edge = np.roll(self.pts, -1, axis=1).astype(np.float64) - self.pts
        nxt = np.roll(edge, -1, axis=1)
        turn = edge[..., 0] * nxt[..., 1] - edge[..., 1] * nxt[..., 0]
        bend = _REL_MARGIN * (np.hypot(*edge.transpose(2, 0, 1))
                              * np.hypot(*nxt.transpose(2, 0, 1)))
        self.regular = (((turn > bend).all(axis=1)
                         | (turn < -bend).all(axis=1))
                        & (self.area >= 1))


def _rect_pts(st: np.ndarray) -> np.ndarray:
    """The corners of the rectangle of a component's stats row, as the
    scalar assignment built them."""
    x1, y1, w1, h1 = (int(v) for v in st[:4])
    return np.array([[x1, y1], [x1 + w1, y1], [x1 + w1, y1 + h1],
                     [x1, y1 + h1]], np.float64)


def _clip_areas(quads: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """The area of each convex quad (P, 4, 2) inside its rectangle (P, 4:
    x1, y1, x2, y2): the quad clipped by the rectangle's four sides in turn
    (Sutherland-Hodgman; each side adds at most one corner, so at most 8),
    then the shoelace formula. Each polygon's live corners are the first
    ``n`` of its row."""
    poly = quads.astype(np.float64)
    rows = np.arange(len(poly))[:, None]
    n = np.full(len(poly), 4)
    for axis, sign, side in ((0, 1, 0), (1, 1, 1), (0, -1, 2), (1, -1, 3)):
        slot = np.arange(poly.shape[1])
        live = slot < n[:, None]
        nxt = poly[rows, np.where(slot + 1 < n[:, None], slot + 1, 0)]
        bound = boxes[:, side, None]
        s = sign * (poly[..., axis] - bound)
        t = sign * (nxt[..., axis] - bound)
        with np.errstate(divide='ignore', invalid='ignore'):
            cut = poly + (s / (s - t))[..., None] * (nxt - poly)
        cut[..., axis] = bound
        keep = np.stack([live & (s >= 0), live & ((s >= 0) != (t >= 0))],
                        axis=2).reshape(len(poly), -1)
        n = keep.sum(axis=1)
        order = np.argsort(~keep, axis=1, kind='stable')[:, :max(n.max(), 1)]
        poly = np.stack([poly, cut], axis=2).reshape(len(poly), -1, 2)[
            rows, order]
    slot = np.arange(poly.shape[1])
    nxt = poly[rows, np.where(slot + 1 < n[:, None], slot + 1, 0)]
    with np.errstate(invalid='ignore'):
        cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    return 0.5 * np.abs(np.where(slot < n[:, None], cross, 0.0).sum(axis=1))


def _centroid_distances(pt: np.ndarray, quads: np.ndarray):
    """``cv2.pointPolygonTest``'s distance from each point (P, 2) to its
    float32 quad (P, 4, 2), 0 inside, computed as cv2 computes it (corner
    differences in float32, the rest in float64, crossings counted on a ray
    to +x)."""
    v = quads
    v0 = np.roll(v, 1, axis=1)
    p = pt.astype(np.float32)[:, None]
    d = (v - v0).astype(np.float64)
    d1 = (p - v0).astype(np.float64)
    d2 = (p - v).astype(np.float64)
    cross = d1[..., 1] * d[..., 0] - d1[..., 0] * d[..., 1]
    with np.errstate(divide='ignore', invalid='ignore'):
        seg = np.where((d1 * d).sum(axis=-1) <= 0, (d1 * d1).sum(axis=-1),
                       np.where((d2 * d).sum(axis=-1) >= 0,
                                (d2 * d2).sum(axis=-1),
                                cross * cross / (d * d).sum(axis=-1)))
    px, py = p[..., 0], p[..., 1]
    skip = (((v0[..., 1] <= py) & (v[..., 1] <= py))
            | ((v0[..., 1] > py) & (v[..., 1] > py))
            | ((v0[..., 0] < px) & (v[..., 0] < px)))
    up = np.where(d[..., 1] < 0, -cross, cross) > 0
    inside = (~skip & up).sum(axis=-1) % 2 == 1
    return np.where(inside, 0.0, np.sqrt(seg.min(axis=-1)))


def _owners(st: np.ndarray, lines: _Lines,
            keep_threshold: float) -> np.ndarray:
    """The line each component of the stats rows ``st`` goes to, or -1: the
    scalar assignment's decisions for all pairs at once. A pair whose boxes
    do not overlap overlaps by exactly 0; the rest are clipped here, or
    taken from cv2 where the quad is not convex. Each decision (the first
    argmax of the ratios, the ``keep_threshold`` test, the first argmin of
    the distances, the half glyph test) that a value near a tie or a
    threshold could turn is settled with the scalar assignment's own cv2
    calls and expression."""
    x1, y1, w1, h1, area1 = st[:, :5].astype(np.float64).T
    K, M = len(st), len(lines.area)
    box = np.stack([x1, y1, x1 + w1, y1 + h1], axis=1)
    reach = np.minimum(
        np.minimum(box[:, None, 2], lines.hi[:, 0])
        - np.maximum(box[:, None, 0], lines.lo[:, 0]),
        np.minimum(box[:, None, 3], lines.hi[:, 1])
        - np.maximum(box[:, None, 1], lines.lo[:, 1]))
    # a convex quad and a rectangle whose boxes only touch share no area,
    # and cv2 reads 0; for a crossed or concave quad it may read -1
    k, m = np.nonzero((reach > 0)
                      | (~lines.regular & (reach >= -_TOUCH_PX)))
    count('mask.pairs', len(k))
    overlap = np.zeros((K, M))
    exact = np.ones((K, M), bool)

    def settle_overlap(kk, mm):
        for a, b in zip(kk.tolist(), mm.tolist()):
            overlap[a, b] = _convex_intersection_area(lines.pts[b],
                                                      _rect_pts(st[a]))
        exact[kk, mm] = True

    clip = lines.regular[m]
    if clip.any():
        overlap[k[clip], m[clip]] = _clip_areas(lines.pts[m[clip]],
                                                box[k[clip]])
        exact[k[clip], m[clip]] = False
    settle_overlap(k[~clip], m[~clip])

    denom = np.maximum(np.minimum(area1[:, None], lines.area), 1e-9)
    err = np.where(exact, 0.0, _AREA_TOL * (w1 + h1)[:, None] / denom)
    ratio = overlap / denom
    floor = (ratio - err).max(axis=1, keepdims=True)
    cand = ratio + err >= floor - _REL_MARGIN * np.abs(floor)
    tie = cand & ~exact & (cand.sum(axis=1) > 1)[:, None]
    if tie.any():
        settle_overlap(*np.nonzero(tie))
        ratio = overlap / denom
        err[tie] = 0.0
    avg = np.argmax(np.where(cand, ratio.astype(np.float32), -np.inf),
                    axis=1)
    owner = np.where(area1 >= lines.area[avg], -1, avg)

    r, e = ratio[np.arange(K), avg], err[np.arange(K), avg]
    fallback = r <= keep_threshold
    for i in np.nonzero((owner >= 0) & (np.abs(r - keep_threshold)
                                        <= e + _REL_MARGIN * keep_threshold)
                        )[0].tolist():
        if not exact[i, avg[i]]:
            settle_overlap(np.array([i]), avg[i:i + 1])
        fallback[i] = (np.float32(overlap[i, avg[i]] / denom[i, avg[i]])
                       <= keep_threshold)
    far = np.nonzero((owner >= 0) & fallback)[0]
    if len(far) == 0:
        return owner

    centroid = np.stack([x1[far] + w1[far] / 2.0, y1[far] + h1[far] / 2.0],
                        axis=1)
    # a line whose box lies half a glyph (the most a unit can be) or more
    # from a centroid can neither keep its component nor lie nearer than a
    # line that does: its distance stays infinite
    bound = 0.5 * np.maximum(np.minimum(w1[far], h1[far]), 10) + _TOUCH_PX
    box_gap = np.hypot(
        np.maximum(np.maximum(lines.lo[:, 0] - centroid[:, :1],
                              centroid[:, :1] - lines.hi[:, 0]), 0),
        np.maximum(np.maximum(lines.lo[:, 1] - centroid[:, 1:],
                              centroid[:, 1:] - lines.hi[:, 1]), 0))
    f, m = np.nonzero(box_gap < bound[:, None])
    dist = np.full((len(far), M), np.inf)
    exact = np.ones((len(far), M), bool)
    dist[f, m] = _centroid_distances(centroid[f], lines.pts[m])
    exact[f, m] = dist[f, m] == 0.0

    def settle_distance(ff, mm):
        for a, b in zip(ff.tolist(), mm.tolist()):
            dist[a, b] = _point_to_poly_distance(lines.pts[b], centroid[a])
        exact[ff, mm] = True

    err = np.where(exact, 0.0, _DIST_TOL * (1.0 + dist))
    ceil = (dist + err).min(axis=1, keepdims=True)
    cand = dist - err <= ceil * (1.0 + _REL_MARGIN)
    tie = cand & ~exact & (cand.sum(axis=1) > 1)[:, None]
    if tie.any():
        settle_distance(*np.nonzero(tie))
        err[tie] = 0.0
    near = np.argmin(np.where(cand, dist.astype(np.float32), np.inf), axis=1)
    fs = np.arange(len(far))
    d, e = dist[fs, near], err[fs, near]
    half = 0.5 * np.maximum(np.minimum(lines.font[near],
                                       np.minimum(w1[far], h1[far])), 10)
    drop = d >= half
    for j in np.nonzero(np.abs(d - half)
                        <= e + _REL_MARGIN * half)[0].tolist():
        if not exact[j, near[j]]:
            settle_distance(np.array([j]), near[j:j + 1])
        _, _, w, h = st[far[j], :4]
        drop[j] = (np.float32(dist[j, near[j]])
                   >= 0.5 * max(min([float(lines.font[near[j]]), w, h]), 10))
    owner[far] = np.where(drop, -1, near)
    return owner


def assign_components(mask: np.ndarray, textlines: List[Quadrilateral],
                      keep_threshold: float):
    """Each connected component of ``mask`` (the line boxes' outlines
    erased) given to its textline: the one it overlaps most, or the
    nearest within half a glyph. Returns each textline's component mask
    and its (x, y, w, h) rectangle, or None when no component was given
    to any line.

    The components over 9 px are decided in blocks of rows against every
    line at once (``_owners``), with the same result, ties included, as
    one overlap (``cv2.intersectConvexConvex``) and one distance
    (``cv2.pointPolygonTest``) for each pair; a lookup table from label to
    line then paints each line's mask inside the line's rectangle. Counts
    the pairs whose boxes met in ``mask.pairs``."""
    for q in textlines:
        x, y, w, h = q.aabb.xywh
        cv2.rectangle(mask, (int(x), int(y)), (int(x + w), int(y + h)), 0, 1)
    M = len(textlines)
    if M == 0:
        return None
    num_labels, labels, stats, _ = cv2.connectedComponentsWithStats(mask)
    lines = _Lines(textlines)
    ccs = np.nonzero(stats[1:, cv2.CC_STAT_AREA] > 9)[0] + 1
    lut = np.full(num_labels, -1, np.int32)
    rows = max(1, _PAIRS_PER_BLOCK // M)
    for k0 in range(0, len(ccs), rows):
        block = ccs[k0:k0 + rows]
        lut[block] = _owners(stats[block], lines, keep_threshold)

    given = ccs[lut[ccs] >= 0]
    if len(given) == 0:
        return None
    line = lut[given]
    x1, y1, w1, h1 = stats[given, :4].T
    iinfo = np.iinfo(labels.dtype)
    textline_rects = np.full((M, 4), [iinfo.max, iinfo.max, iinfo.min,
                                      iinfo.min], dtype=labels.dtype)
    np.minimum.at(textline_rects[:, 0], line, x1)
    np.minimum.at(textline_rects[:, 1], line, y1)
    np.maximum.at(textline_rects[:, 2], line, x1 + w1)
    np.maximum.at(textline_rects[:, 3], line, y1 + h1)
    # one zeroed block for all lines: the pages stay unmapped until written
    textline_ccs = list(np.zeros((M,) + mask.shape, mask.dtype))
    for i in np.unique(line).tolist():
        xa, ya, xb, yb = textline_rects[i]
        textline_ccs[i][ya:yb, xa:xb][lut[labels[ya:yb, xa:xb]] == i] = 255
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
