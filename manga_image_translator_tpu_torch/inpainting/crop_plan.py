"""Mask-driven crop planning for inpainting (host only).

A copy of the JAX package's ``inpainting/crop_plan.py``: the plan decides
which crops the inpainter runs, so the port keeps it unchanged (buckets,
merging, consolidation and its cost model included) and plans the same
crops as the JAX package. The TPU rates quoted below (v5e) are the JAX
package's measurements, not the port's. The port's executor
(``common.OfflineInpainter``) runs each bucket at its real crop count;
``pad_batch_size`` survives only inside the consolidation's cost model.

Original notes:

The pipeline composite ``inpainted*mask + original*(1-mask)`` (reference
``inpainting/inpainting_lama_mpe.py:117``) discards every pixel computed
outside the mask; text masks cover a small fraction of the page; and the
shipped LaMa checkpoint is 512px-native (reference
``inpainting_lama_mpe.py:123-129`` — ``lama_large_512px.ckpt``). Running the
generator over the full page is therefore mostly wasted FLOPs at an
out-of-distribution scale.

This module plans context-padded crop rectangles around the mask's connected
components, snapped to a small static bucket set so XLA compiles a bounded
family of shapes. Same-bucket crops (possibly from *different pages*) batch
into one device forward; the executor (``common.OfflineInpainter``)
composites each crop's own mask pixels back, so output is byte-identical to
the full-page path outside the mask by construction.

Design (v2, measured against devscripts/profiling/crop_inpaint_bench.py):

* CC analysis runs on an ``analysis_scale``-downscaled mask (INTER_AREA +
  ``>0``, so every full-res mask pixel lands in some downscaled CC — boxes
  only ever grow). Planning must stay ~ms on a 1-core host.
* Ownership is by CC LABEL SET, not by disjoint geometry: each crop owns
  the mask pixels whose (upsampled) CC label is in its set, intersected
  with its tile cell. Labels partition the mask, cells partition a group —
  write-back is disjoint even though crop WINDOWS may overlap.
* Merging is pixel-saving only: two boxes merge when the union bbox fits
  the bucket caps AND is no larger than the two boxes separately. This
  stops the transitive page-wide merges dense pages otherwise produce.
* Groups larger than the caps tile into full-resolution cells; windows
  shrink to the mask extent inside each cell. No downscaling: the
  batch-1 (1024, 1024) shape measures ~97 ns/px on v5e vs ~22-28 ns/px
  for batched small crops and 44 ns/px for the full 1536 page.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

# Static bucket set: multiples of 8 (generator stride), from one textline
# (128) to one-column scale (1024). Each distinct (bh, bw, batch) triple is
# one XLA compile.
DEFAULT_BUCKETS: Tuple[int, ...] = (128, 192, 256, 320, 384, 512, 640, 768,
                                    1024)

# Batch sizes crops are padded up to (bounds compile count per bucket).
BATCH_SIZES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)

# Group box caps: per-side, and area (the square-1024 bucket is
# pathologically slow at batch 1 on v5e — see module docstring).
CAP_SIDE = 1024
CAP_AREA = 768 * 1024


@dataclass
class Crop:
    """One planned inpaint crop.

    ``(x0, y0, w, h)`` is the source window in page coordinates; ``(bh,
    bw)`` the device shape it is resized to (equal to ``(h, w)`` in the
    common unscaled case). The crop OWNS the mask pixels inside its cell
    rect ``(gx0, gy0, gx1, gy1)`` whose CC label is in ``labels`` — labels
    partition the mask and cells partition a group, so write-back is
    complete and conflict-free even when windows overlap.
    """
    x0: int
    y0: int
    w: int
    h: int
    bw: int
    bh: int
    gx0: int
    gy0: int
    gx1: int
    gy1: int
    labels: Tuple[int, ...] = field(default_factory=tuple)

    @property
    def scaled(self) -> bool:
        return (self.h, self.w) != (self.bh, self.bw)


class OwnerMap:
    """Lazy full-resolution CC-ownership map.

    ``owner[y, x] == labels_small[(y*hs)//h, (x*ws)//w]`` — the exact
    inverse of the planner's INTER_AREA box scaling. Materializing the full
    (H, W) int32 map by fancy indexing costs ~10 ms at 1536² (the whole
    planner host budget), but the executor only ever reads per-crop CELL
    slices, so slices are computed on demand. ``np.asarray(owner)`` (used
    by the invariant tests) still yields the full map.
    """

    def __init__(self, labels_small: np.ndarray, h_img: int, w_img: int):
        self._lab = labels_small.astype(np.int32)
        self._h, self._w = h_img, w_img
        self._hs, self._ws = labels_small.shape

    def __getitem__(self, key) -> np.ndarray:
        ys, xs = key
        # integer indices are accepted as single-row/col slices so the
        # object behaves like the ndarray it stands in for; anything
        # fancier (arrays, bool masks) should go through np.asarray(owner)
        if isinstance(ys, (int, np.integer)):
            ys = slice(ys, ys + 1)
        if isinstance(xs, (int, np.integer)):
            xs = slice(xs, xs + 1)
        if not (isinstance(ys, slice) and isinstance(xs, slice)):
            raise TypeError('OwnerMap supports only (slice|int, slice|int) '
                            'indexing — materialize via np.asarray(owner) '
                            'for anything else')
        rows = (np.arange(*ys.indices(self._h), dtype=np.int64)
                * self._hs) // self._h
        cols = (np.arange(*xs.indices(self._w), dtype=np.int64)
                * self._ws) // self._w
        return self._lab[rows[:, None], cols[None, :]]

    def __array__(self, dtype=None, copy=None):
        full = self[:, :]
        return full if dtype is None else full.astype(dtype)


def _round8_down(v: int) -> int:
    return max(8, (v // 8) * 8)


def _pick_bucket(buckets: Sequence[int], need: int, limit: int) -> int:
    """Smallest bucket >= need, capped by the image dimension (rounded to
    the generator stride). Falls back to the largest bucket when the group
    is bigger than every bucket — the crop is then resized down."""
    fitting = [b for b in buckets if b >= need]
    b = min(fitting) if fitting else max(buckets)
    if b > limit:
        b = _round8_down(limit)
    return b


def _place(c0: int, c1: int, b: int, limit: int) -> Tuple[int, int]:
    """Position a length-``b`` window covering [c0, c1) inside [0, limit).
    Returns (start, src_len). When the group span exceeds ``b`` the source
    covers the whole span (the executor resizes it down to ``b``)."""
    span = c1 - c0
    if b >= span:
        start = (c0 + c1 - b) // 2
        start = max(0, min(start, limit - b))
        return start, b
    return c0, span


def pad_batch_size(n: int) -> int:
    for s in BATCH_SIZES:
        if s >= n:
            return s
    return -(-n // BATCH_SIZES[-1]) * BATCH_SIZES[-1]


# Measured v5e LaMa-18 crop cost (devscripts/profiling/crop_inpaint_bench):
# ~ns per device pixel by padded batch size. Batching amortizes strongly,
# so padding small bucket groups up to one shared shape often SAVES wall
# time AND cuts the compiled-shape count.
_RATE_NS = {1: 40.0, 2: 36.0, 4: 31.0, 8: 26.0, 16: 24.0, 32: 22.0}


def _bucket_cost(bh: int, bw: int, n: int) -> float:
    n_pad = pad_batch_size(n)
    return bh * bw * n_pad * _RATE_NS.get(n_pad, 22.0)


def _consolidate_buckets(shapes: List[Tuple[int, int]]
                         ) -> dict[Tuple[int, int], Tuple[int, int]]:
    """Map per-crop (bh, bw) shapes onto a smaller shared set when the
    batch-rate model says padding up to the elementwise-max shape costs no
    more device time than running the groups separately (ties accepted:
    fewer distinct shapes = fewer XLA compiles)."""
    groups: dict[Tuple[int, int], int] = {}
    for s in shapes:
        groups[s] = groups.get(s, 0) + 1
    mapping = {s: s for s in groups}
    while len(groups) > 1:
        best = None
        items = list(groups.items())
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                (ah, aw), na = items[i]
                (bh, bw), nb = items[j]
                mh, mw = max(ah, bh), max(aw, bw)
                if mh * mw > CAP_AREA:
                    continue
                delta = (_bucket_cost(mh, mw, na + nb)
                         - _bucket_cost(ah, aw, na)
                         - _bucket_cost(bh, bw, nb))
                if delta <= 0 and (best is None or delta < best[0]):
                    best = (delta, (ah, aw), (bh, bw), (mh, mw))
        if best is None:
            break
        _, a, b, m = best
        n = groups.pop(a) + groups.pop(b)
        groups[m] = groups.get(m, 0) + n
        for s, t in mapping.items():
            if t == a or t == b:
                mapping[s] = m
    return mapping


def _merge_pixel_saving(boxes: np.ndarray, cap_side: int, cap_area: int
                        ) -> List[Tuple[int, int, int, int, List[int]]]:
    """Greedy fixpoint merge of (x0, y0, x1, y1) boxes. Two groups merge
    only when the union bbox fits the caps AND does not exceed the groups'
    combined area — merging must SAVE device pixels, never create
    page-wide super-groups. Returns (x0, y0, x1, y1, labels) groups."""
    groups = [(int(b[0]), int(b[1]), int(b[2]), int(b[3]), [i + 1])
              for i, b in enumerate(boxes)]
    merged = True
    while merged:
        merged = False
        out: List[Tuple[int, int, int, int, List[int]]] = []
        for g in groups:
            hit = -1
            for j, og in enumerate(out):
                ux0 = min(g[0], og[0])
                uy0 = min(g[1], og[1])
                ux1 = max(g[2], og[2])
                uy1 = max(g[3], og[3])
                if ux1 - ux0 > cap_side or uy1 - uy0 > cap_side:
                    continue
                if (ux1 - ux0) * (uy1 - uy0) > cap_area:
                    continue
                a_g = (g[2] - g[0]) * (g[3] - g[1])
                a_o = (og[2] - og[0]) * (og[3] - og[1])
                if (ux1 - ux0) * (uy1 - uy0) <= a_g + a_o:
                    hit = j
                    break
            if hit >= 0:
                og = out[hit]
                out[hit] = (min(g[0], og[0]), min(g[1], og[1]),
                            max(g[2], og[2]), max(g[3], og[3]),
                            og[4] + g[4])
                merged = True
            else:
                out.append(g)
        groups = out
    return groups


def plan_crops(mask: np.ndarray,
               buckets: Sequence[int] = DEFAULT_BUCKETS,
               pad_frac: float = 0.2,
               min_pad: int = 32,
               max_pad: int = 64,
               tile_ctx: int = 64,
               max_coverage: float = 1.6,
               full_page_pixels: Optional[int] = None,
               analysis_scale: int = 8,
               scale: float = 1.0,
               consolidate: bool = True,
               ) -> Optional[Tuple[List[Crop], np.ndarray,
                                   Optional[OwnerMap]]]:
    """Plan inpaint crops for one page mask.

    mask: (H, W) uint8, >=127 marks pixels to inpaint (the pipeline's
    refined mask at page resolution).

    scale: device resolution per page pixel. The reference's full-page
    path downscales the page to ``inpainting_size`` before the generator
    (``inpainting_lama_mpe.py:56-118``: aspect-preserving resize, 1024
    default — a 1536px page runs LaMa at 2/3 resolution). Planning with
    the same ``scale`` renders crops at the reference's effective quality
    for
    ``scale**2`` of the native-res pixels; the executor resizes each
    source window down to its bucket and back up at composite. ``1.0``
    keeps native-res crops (higher quality than the reference full-page
    path, ~2x the device pixels at 1536px).

    Returns ``(crops, mask_bin, owner)`` where ``mask_bin`` is the boolean
    (H, W) inpaint mask and ``owner`` a lazy (H, W) int32 CC-label map
    (``OwnerMap``) the executor composites with (None when there is a
    single crop — no ownership test needed). Returns ``([], mask_bin, None)`` for an empty
    mask and ``None`` when the planned device pixels exceed
    ``max_coverage`` of the full-page path's pixels (full-page fallback is
    then cheaper).

    ``max_coverage`` defaults above 1 because batched crop forwards cost
    ~22-36 ns/px on v5e vs ~44 ns/px for the batch-1 full page (measured:
    devscripts/profiling/crop_inpaint_bench.py) — crops win on wall time
    until planned pixels reach ~1.6x the full-page pixels.
    """
    h_img, w_img = mask.shape[:2]
    mask_bin = mask >= 127
    if not mask_bin.any():
        return [], mask_bin, None

    # CC analysis on a downscaled mask: INTER_AREA gives every source pixel
    # positive weight in some dest pixel, so `>0` keeps all mask pixels
    # (boxes only grow by up to one analysis cell).
    s = max(1, analysis_scale)
    ws, hs = -(-w_img // s), -(-h_img // s)
    if s > 1:
        small = cv2.resize(mask_bin.astype(np.uint8) * 255, (ws, hs),
                           interpolation=cv2.INTER_AREA) > 0
    else:
        small = mask_bin
    n_cc, labels_small, stats, _ = cv2.connectedComponentsWithStats(
        small.astype(np.uint8), connectivity=8)
    if n_cc <= 1:
        return [], mask_bin, None

    fx, fy = w_img / ws, h_img / hs
    boxes = np.empty((n_cc - 1, 4), np.int64)
    for i in range(1, n_cc):
        x, y, w, h = (int(stats[i, cv2.CC_STAT_LEFT]),
                      int(stats[i, cv2.CC_STAT_TOP]),
                      int(stats[i, cv2.CC_STAT_WIDTH]),
                      int(stats[i, cv2.CC_STAT_HEIGHT]))
        x0 = int(np.floor(x * fx))
        y0 = int(np.floor(y * fy))
        x1 = int(np.ceil((x + w) * fx))
        y1 = int(np.ceil((y + h) * fy))
        pad = min(max_pad,
                  max(min_pad, int(round(pad_frac * max(x1 - x0, y1 - y0)))))
        boxes[i - 1] = (max(0, x0 - pad), max(0, y0 - pad),
                        min(w_img, x1 + pad), min(h_img, y1 + pad))

    # geometry stays in page coordinates; caps/buckets are DEVICE-space
    # (bucketed crops are resized by ``scale`` before the forward), so page
    # spans compare against caps inflated by 1/scale
    scale = min(1.0, max(scale, 1e-3))
    cap_side_pg = int(CAP_SIDE / scale)
    cap_area_pg = int(CAP_AREA / (scale * scale))
    groups = _merge_pixel_saving(boxes, cap_side_pg, cap_area_pg)

    crops: List[Crop] = []
    pending: List[tuple] = []
    for (x0, y0, x1, y1, labs) in groups:
        gw, gh = x1 - x0, y1 - y0
        cell_cap_x = cap_side_pg - 2 * tile_ctx
        cell_cap_y = cap_side_pg - 2 * tile_ctx
        nx = 1 if gw <= cap_side_pg else -(-gw // cell_cap_x)
        ny = 1 if gh <= cap_side_pg else -(-gh // cell_cap_y)
        # area cap on the BUCKETED shape (bucket snap can inflate a ~900^2
        # group into the pathological square-1024 bucket): tile the longer
        # dim so tiles land in <=768-wide buckets
        if nx == 1 and ny == 1:
            bw_g = _pick_bucket(buckets, int(round(gw * scale)),
                                max(8, int(round(w_img * scale))))
            bh_g = _pick_bucket(buckets, int(round(gh * scale)),
                                max(8, int(round(h_img * scale))))
            if bw_g * bh_g > CAP_AREA:
                cell_768 = int(768 / scale) - 2 * tile_ctx
                if gw >= gh:
                    nx = -(-gw // cell_768)
                else:
                    ny = -(-gh // cell_768)
        cell_w = -(-gw // nx)
        cell_h = -(-gh // ny)
        tiled = nx > 1 or ny > 1
        for iy in range(ny):
            for ix in range(nx):
                cx0 = x0 + ix * cell_w
                cy0 = y0 + iy * cell_h
                cx1 = min(x1, cx0 + cell_w)
                cy1 = min(y1, cy0 + cell_h)
                if cx0 >= cx1 or cy0 >= cy1:
                    continue
                if tiled:
                    # shrink the tile's crop window to the mask extent
                    # inside its cell (cells of a big group are mostly
                    # empty); ownership stays the full cell. Conservative
                    # outward rounding: each ``small`` pixel covers an
                    # (fy, fx) block of the full-res mask.
                    sx0, sx1 = int(cx0 / fx), int(-(-cx1 // fx))
                    sy0, sy1 = int(cy0 / fy), int(-(-cy1 // fy))
                    sub = small[sy0:sy1, sx0:sx1]
                    ys_any = np.flatnonzero(sub.any(axis=1))
                    if ys_any.size == 0:
                        continue
                    xs_any = np.flatnonzero(sub.any(axis=0))
                    mx0 = int(np.floor((sx0 + xs_any[0]) * fx))
                    mx1 = int(np.ceil((sx0 + xs_any[-1] + 1) * fx))
                    my0 = int(np.floor((sy0 + ys_any[0]) * fy))
                    my1 = int(np.ceil((sy0 + ys_any[-1] + 1) * fy))
                    px0 = max(0, max(cx0 - tile_ctx, mx0 - max_pad))
                    px1 = min(w_img, min(cx1 + tile_ctx, mx1 + max_pad))
                    py0 = max(0, max(cy0 - tile_ctx, my0 - max_pad))
                    py1 = min(h_img, min(cy1 + tile_ctx, my1 + max_pad))
                    # window must still cover the cell's own mask pixels
                    px0 = min(px0, max(0, mx0))
                    px1 = max(px1, min(w_img, mx1))
                    py0 = min(py0, max(0, my0))
                    py1 = max(py1, min(h_img, my1))
                else:
                    px0, py0, px1, py1 = cx0, cy0, cx1, cy1
                pending.append((px0, px1, py0, py1,
                                cx0, cy0, cx1, cy1, labs))

    # smallest fitting bucket per crop, then cost-model consolidation onto
    # shared shapes (batch amortization usually beats the padding waste)
    lim_w = max(8, int(round(w_img * scale)))
    lim_h = max(8, int(round(h_img * scale)))
    init_shapes = [( _pick_bucket(buckets, int(round((py1 - py0) * scale)),
                                  lim_h),
                     _pick_bucket(buckets, int(round((px1 - px0) * scale)),
                                  lim_w))
                   for (px0, px1, py0, py1, *_r) in pending]
    # consolidate=False leaves every crop at its smallest fitting bucket so
    # a multi-page executor can run ONE consolidation over the pooled
    # shapes of the whole batch (its batch sizes are the real ones) and
    # re-snap via apply_bucket_mapping
    mapping = (_consolidate_buckets(init_shapes) if consolidate
               else {s: s for s in init_shapes})
    for (px0, px1, py0, py1, cx0, cy0, cx1, cy1, labs), s0 in zip(
            pending, init_shapes):
        bh, bw = mapping[s0]
        # window length in page px: bucket/scale (the executor resizes the
        # window down to the bucket), clamped to the page — extra length
        # is free context, not padding
        win_w = min(w_img, int(round(bw / scale)))
        win_h = min(h_img, int(round(bh / scale)))
        sx, w_src = _place(px0, px1, win_w, w_img)
        sy, h_src = _place(py0, py1, win_h, h_img)
        crops.append(Crop(x0=int(sx), y0=int(sy), w=int(w_src),
                          h=int(h_src), bw=int(bw), bh=int(bh),
                          gx0=int(cx0), gy0=int(cy0), gx1=int(cx1),
                          gy1=int(cy1),
                          labels=tuple(int(v) for v in labs)))

    device_px = sum(c.bw * c.bh for c in crops)
    if full_page_pixels is None:
        full_page_pixels = h_img * w_img
    if device_px > max_coverage * full_page_pixels:
        return None
    # the >1x allowance is justified by batch amortization only — without
    # enough crops to batch, more-pixels-than-full-page is a plain loss
    if device_px >= full_page_pixels and len(crops) < 4:
        return None

    owner: Optional[OwnerMap] = None
    if len(crops) > 1:
        # lazy CC label map at full res (exact inverse of the box scaling:
        # cell j covers full-res [j*fx, (j+1)*fx), INTER_AREA's aggregation
        # window): every full-res mask pixel maps into a positive ``small``
        # cell, whose label is its owner. Slices materialize on demand.
        owner = OwnerMap(labels_small, h_img, w_img)
    return crops, mask_bin, owner


def apply_bucket_mapping(crops: List[Crop],
                         mapping: dict,
                         scale: float, h_img: int, w_img: int) -> List[Crop]:
    """Re-snap planned crops onto consolidated bucket shapes.

    ``mapping`` maps (bh, bw) -> (bh', bw') with bh' >= bh and bw' >= bw
    (``_consolidate_buckets`` only merges onto elementwise maxima), so the
    new window always covers the old one — extra length is free context.
    Ownership rects and label sets are untouched."""
    scale = min(1.0, max(scale, 1e-3))
    out: List[Crop] = []
    for c in crops:
        bh, bw = mapping.get((c.bh, c.bw), (c.bh, c.bw))
        if (bh, bw) == (c.bh, c.bw):
            out.append(c)
            continue
        win_w = min(w_img, int(round(bw / scale)))
        win_h = min(h_img, int(round(bh / scale)))
        sx, w_src = _place(c.x0, c.x0 + c.w, win_w, w_img)
        sy, h_src = _place(c.y0, c.y0 + c.h, win_h, h_img)
        out.append(Crop(x0=int(sx), y0=int(sy), w=int(w_src), h=int(h_src),
                        bw=int(bw), bh=int(bh), gx0=c.gx0, gy0=c.gy0,
                        gx1=c.gx1, gy1=c.gy1, labels=c.labels))
    return out


def full_page_path_pixels(h: int, w: int, inpainting_size: int) -> int:
    """Device pixels the full-page path would process (after its
    aspect-preserving resize to ``inpainting_size`` — see
    ``common.OfflineInpainter.infer_batch`` / reference
    ``inpainting_lama_mpe.py:56-118``)."""
    ratio = min(1.0, inpainting_size / max(h, w))
    return int(round(h * ratio)) * int(round(w * ratio))
