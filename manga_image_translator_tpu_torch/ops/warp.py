"""Batched perspective rectification of OCR textline crops on the device.

Counterpart of the JAX package's ``ops/warp.py``. The reference warps each
textline on the host with cv2.warpPerspective (utils/generic.py:445-481),
one OpenCV call per line. Here the homographies are computed on the host
(4-point DLT, tiny) and the sampling runs on the page's device:

* ``crop_batch``: one batched bilinear gather for arbitrary quads;
* ``crop_batch_separable``: for axis-aligned quads (almost every manga
  textline: minAreaRect of horizontal text, vertical text folded by the
  crop plan) bilinear warping is separable, one vertical and one
  horizontal linear resample, each a small matrix product whose triangle
  weights come from index arithmetic;
* ``crop_chunk_mixed``: the separable batch with the few rotated quads
  warped by cv2 on the host and written over their rows.

Every function computes what its JAX counterpart computes, in f32 (the
port keeps TF32 off for matmuls, ``device.py``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def homography_from_quad(src_pts: np.ndarray, w: int, h: int) -> np.ndarray:
    """Homography mapping the output (w×h) rect back onto ``src_pts``
    (tl, tr, br, bl) — i.e. the *inverse* map used for sampling."""
    dst = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                   dtype=np.float64)
    src = np.asarray(src_pts, dtype=np.float64)
    # Solve DLT for H: src = H @ dst (so sampling pulls from src coords).
    A = []
    for (xd, yd), (xs, ys) in zip(dst, src):
        A.append([xd, yd, 1, 0, 0, 0, -xs * xd, -xs * yd, -xs])
        A.append([0, 0, 0, xd, yd, 1, -ys * xd, -ys * yd, -ys])
    A = np.asarray(A)
    _, _, vt = np.linalg.svd(A)
    H = vt[-1].reshape(3, 3)
    return H / H[2, 2]


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) image at float coords (any shape); zero padding
    outside. Returns (*xs.shape, C) f32."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    imgf = img.float()

    def getf(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = imgf[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    v00 = getf(y0, x0)
    v01 = getf(y0, x1)
    v10 = getf(y1, x0)
    v11 = getf(y1, x1)
    return ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
            + (v10 * (1 - wx) + v11 * wx) * wy)


def _project(Hs: torch.Tensor, out_hw: Tuple[int, int]):
    """(N, 3, 3) output→source homographies → per-output-pixel source
    coords (N, oh, ow), elementwise in f32 as the JAX package computes
    them."""
    oh, ow = out_hw
    dev = Hs.device
    ys = torch.arange(oh, dtype=torch.float32, device=dev)[:, None].expand(
        oh, ow)
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, :].expand(
        oh, ow)
    H = Hs.float()[:, :, :, None, None]
    den = H[:, 2, 0] * xs + H[:, 2, 1] * ys + H[:, 2, 2]
    sx = (H[:, 0, 0] * xs + H[:, 0, 1] * ys + H[:, 0, 2]) / den
    sy = (H[:, 1, 0] * xs + H[:, 1, 1] * ys + H[:, 1, 2]) / den
    return sx, sy


def warp_perspective(img: torch.Tensor, H: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """Pull-warp ``img`` (H, W, C) through homography ``H`` (maps output
    coords -> source coords) to an (out_h, out_w, C) crop."""
    sx, sy = _project(torch.as_tensor(H, device=img.device)[None], out_hw)
    return bilinear_sample(img, sx[0], sy[0])


def warp_quads_batch(img: torch.Tensor, Hs: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """Extract N rectified crops of identical (out_h, out_w) in one shot.

    Args:
      img: (H, W, C) page.
      Hs: (N, 3, 3) output->source homographies (host-computed).
    Returns (N, out_h, out_w, C) crops.
    """
    sx, sy = _project(torch.as_tensor(Hs, device=img.device), out_hw)
    return bilinear_sample(img, sx, sy)


# -- OCR crop planning --------------------------------------------------------
#
# Host-side mirrors of Quadrilateral.get_transformed_region
# (utils/geometry.py) and TextBlock.get_transformed_region
# (utils/textblock.py): same integer quantization, same output dimensions,
# but instead of a cv2 warp they produce an output→source homography over
# FULL-page coordinates. The vertical-text CCW rotation is folded into the
# correspondence order (output always reads left→right at ``textheight``
# rows), so the device never materializes the unrotated intermediate. The
# reference zero-pads outside the *clipped* quad bbox; every source
# coordinate inside the quad is either inside that bbox or outside the
# image, so zero-padding outside the image (bilinear_sample) is equivalent.

_DEGENERATE_H = np.array([[0.0, 0.0, -10.0],
                          [0.0, 0.0, -10.0],
                          [0.0, 0.0, 1.0]])


def _plan_homography(src: np.ndarray, direction: str, w: int,
                     textheight: int) -> np.ndarray:
    """(tl,tr,br,bl) int page coords → output→page H for a (textheight, w)
    left-to-right crop. For vertical lines the CCW rotation of the
    rectified region is folded into the correspondence order: out-corners
    (tl,tr,br,bl) ↦ quad (tr,br,bl,tl)."""
    order = (0, 1, 2, 3) if direction == 'h' else (1, 2, 3, 0)
    return homography_from_quad(src[list(order)].astype(np.float64),
                                w, textheight)


def crop_plan_quad(quad, direction: str, textheight: int
                   ) -> Tuple[int, np.ndarray]:
    """Plan a device crop for a Quadrilateral textline. Returns
    (out_width, H) for an output of (textheight, out_width); H maps output
    coords to page coords (pull warp). Sets ``quad.assigned_direction``, as
    the host crop does."""
    v1, v2 = quad._axes()
    n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
    if n1 <= 1e-6 or n2 <= 1e-6:
        return max(int(textheight), 2), _DEGENERATE_H
    ratio = n1 / n2
    # match geometry.get_transformed_region's max(..., 2) floors
    if direction == 'h':
        w = max(int(round(textheight / ratio)), 2)
    else:
        w = max(int(round(textheight * ratio)), 2)
    quad.assigned_direction = direction
    return w, _plan_homography(quad.pts.astype(np.int64), direction, w,
                               textheight)


def crop_plan_textblock(blk, line_idx: int, textheight: int
                        ) -> Tuple[int, np.ndarray]:
    """Plan a device crop for one line of a TextBlock (direction from
    blk.src_is_vertical, ratio from midpoint norms)."""
    line = np.round(np.array(blk.lines[line_idx])).astype(np.int64)
    direction = 'v' if blk.src_is_vertical else 'h'
    mid = (line[[1, 2, 3, 0]] + line) / 2
    norm_v = np.linalg.norm(mid[2] - mid[0])
    norm_h = np.linalg.norm(mid[1] - mid[3])
    if norm_v <= 0 or norm_h <= 0:
        return max(int(textheight), 2), _DEGENERATE_H
    ratio = norm_v / norm_h
    if direction == 'h':
        w = int(round(textheight / ratio))
    else:
        w = int(round(textheight * ratio))
    w = max(w, 2)
    return w, _plan_homography(line, direction, w, textheight)


def _mask_and_normalize(crops: torch.Tensor,
                        valid_w: torch.Tensor) -> torch.Tensor:
    """Zero the columns ≥ valid_w[i] of crop i, then /127.5 - 1 (padding
    becomes -1.0, matching the host path's zero-pad-then-normalize)."""
    out_w = crops.shape[2]
    xs = torch.arange(out_w, device=crops.device)[None, None, :, None]
    vw = torch.as_tensor(valid_w, device=crops.device)[:, None, None, None]
    crops = torch.where(xs < vw, crops, torch.zeros_like(crops))
    return crops / 127.5 - 1.0


def crop_batch(img: torch.Tensor, Hs, valid_w, out_h: int,
               out_w: int) -> torch.Tensor:
    """N rectified OCR crops by the bilinear gather.

    Args:
      img: (H, W, 3) uint8 page on the OCR's device.
      Hs: (N, 3, 3) output→page homographies.
      valid_w: (N,) int — columns ≥ valid_w[i] are padding.
    Returns (N, out_h, out_w, 3) float32, /127.5-1 normalized.
    """
    Hs = torch.as_tensor(np.asarray(Hs, np.float32), device=img.device)
    crops = warp_quads_batch(img, Hs, (out_h, out_w))
    return _mask_and_normalize(crops, valid_w)


# --------------------------------------------------------------------------
# Separable matmul resampler
# --------------------------------------------------------------------------

SEP_SRC_H = 128          # static source-box rows (source text ≤ 128px tall)


def separable_plan(H: np.ndarray, out_h: int, out_w: int, src_h: int,
                   src_w: int):
    """Per-crop plan for the separable resampler, or None if the quad is
    not axis-aligned / does not fit the static source box.

    Returns ((y0, x0), (yb, yk), (xb, xk)): source-box origin in page
    coords and box-relative sample coords sy(r) = yb + yk*r,
    sx(o) = xb + xk*o.
    """
    H = np.asarray(H, np.float64)
    if abs(H[2, 2]) < 1e-12:
        return None
    H = H / H[2, 2]
    scale = max(abs(H[0, 0]), abs(H[1, 1]), 1.0)
    if max(abs(H[0, 1]), abs(H[1, 0])) > 1e-6 * scale \
            or max(abs(H[2, 0]), abs(H[2, 1])) > 1e-9:
        return None
    a, c = H[0, 0], H[0, 2]
    e, f = H[1, 1], H[1, 2]
    ys = (f, f + e * (out_h - 1))
    xs = (c, c + a * (out_w - 1))
    y0 = int(np.floor(min(ys))) - 1
    x0 = int(np.floor(min(xs))) - 1
    if int(np.ceil(max(ys))) + 2 - y0 > src_h:
        return None
    if int(np.ceil(max(xs))) + 2 - x0 > src_w:
        return None
    return (y0, x0), (f - y0, e), (c - x0, a)


def _triangle_weights(coef: torch.Tensor, n_out: int,
                      n_src: int) -> torch.Tensor:
    """(N, 2) [b, k] → (N, n_out, n_src) weights max(0, 1 - |b + k·o - s|)
    of linear interpolation at sample coords b + k·o."""
    dev = coef.device
    o = torch.arange(n_out, dtype=torch.float32, device=dev)
    s = coef[:, 0:1] + coef[:, 1:2] * o[None, :]
    src = torch.arange(n_src, dtype=torch.float32, device=dev)
    return torch.clamp(1.0 - (s[:, :, None] - src[None, None, :]).abs(),
                       min=0.0)


def crop_batch_separable(img: torch.Tensor, origins, ycoef, xcoef, valid_w,
                         out_h: int, out_w: int, src_h: int,
                         src_w: int) -> torch.Tensor:
    """N axis-aligned rectified crops as two matrix products per crop.

    Args:
      img: (H, W, 3) uint8 page.
      origins: (N, 2) host ints, source-box (y0, x0) in page coords (may
        hang off the page; the page is zero-padded so out-of-image samples
        are 0, matching bilinear_sample; a box past the padding is clamped
        into it, as the JAX package's dynamic_slice does).
      ycoef/xcoef: (N, 2) f32 [b, k] — box-relative sy(r)=b+k*r,
        sx(o)=b+k*o.
      valid_w: (N,) int output-column validity.
    Returns (N, out_h, out_w, 3) float32 normalized like crop_batch.
    """
    dev = img.device
    padded = torch.nn.functional.pad(img, (0, 0, src_w, src_w, src_h, src_h))
    ph, pw = padded.shape[0], padded.shape[1]
    boxes = []
    for y0, x0 in np.asarray(origins, np.int64).tolist():
        ys = min(max(y0 + src_h, 0), ph - src_h)
        xs = min(max(x0 + src_w, 0), pw - src_w)
        boxes.append(padded[ys:ys + src_h, xs:xs + src_w])
    box = torch.stack(boxes).float()
    wv = _triangle_weights(
        torch.as_tensor(np.asarray(ycoef, np.float32), device=dev), out_h,
        src_h)
    wh = _triangle_weights(
        torch.as_tensor(np.asarray(xcoef, np.float32), device=dev), out_w,
        src_w)
    tmp = torch.einsum('nrh,nhxc->nrxc', wv, box)
    crops = torch.einsum('nox,nrxc->nroc', wh, tmp)
    return _mask_and_normalize(crops, valid_w)


def crop_batch_separable_patched(img: torch.Tensor, origins, ycoef, xcoef,
                                 valid_w, patch_rows, patch_vals,
                                 out_h: int, out_w: int, src_h: int,
                                 src_w: int) -> torch.Tensor:
    """Separable crop batch with a few HOST-warped rows written over it.

    Args:
      patch_rows: (M,) row indices to overwrite (duplicates allowed —
        callers pad to a bucket size by repeating the last row).
      patch_vals: (M, out_h, out_w, 3) float32 crops already normalized
        like crop_batch output (/127.5-1, padding -1).
    """
    crops = crop_batch_separable(img, origins, ycoef, xcoef, valid_w,
                                 out_h, out_w, src_h, src_w)
    rows = torch.as_tensor(np.asarray(patch_rows, np.int64), device=img.device)
    crops[rows] = torch.as_tensor(np.asarray(patch_vals, np.float32),
                                  device=img.device)
    return crops


_ZERO_PLAN = ((0, 0), (0.0, 0.0), (0.0, 0.0))


def crop_chunk_mixed(img: torch.Tensor, plans, indices, host_regions: dict,
                     valid_w: np.ndarray, out_h: int, out_w: int,
                     chunk_size: int) -> torch.Tensor:
    """One (chunk_size, out_h, out_w, 3) normalized crop batch with
    per-quad routing: axis-aligned quads through the separable resampler,
    the (rare) rotated/perspective quads cv2-warped on the host by the
    caller (``host_regions[idx]`` uint8 crops) and patched over their
    rows. Falls back to the whole-chunk gather only if a quad that probed
    separable at its own width fails at the bucket width (cannot happen for
    out_w ≥ own width; kept as a guard).
    """
    src_w = 2 * out_w
    sep_plans = []
    patch_rows: list = []
    patch_vals: list = []
    for row, i in enumerate(indices):
        if i in host_regions:
            reg = host_regions[i]
            buf = np.zeros((out_h, out_w, 3), np.float32)
            w = min(reg.shape[1], out_w)
            buf[:, :w] = reg[:, :w]
            patch_rows.append(row)
            patch_vals.append(buf / 127.5 - 1.0)
            sep_plans.append(_ZERO_PLAN)
        else:
            p = separable_plan(plans[i][1], out_h, out_w, SEP_SRC_H, src_w)
            if p is None:
                Hs = np.stack([plans[j][1] for j in indices]
                              + [_DEGENERATE_H] * (chunk_size - len(indices)))
                return crop_batch(img, Hs, valid_w, out_h, out_w)
            sep_plans.append(p)
    sep_plans += [_ZERO_PLAN] * (chunk_size - len(indices))
    origins = [p[0] for p in sep_plans]
    ycoef = [p[1] for p in sep_plans]
    xcoef = [p[2] for p in sep_plans]
    if not patch_rows:
        return crop_batch_separable(img, origins, ycoef, xcoef, valid_w,
                                    out_h, out_w, SEP_SRC_H, src_w)
    # pad the patch list to a power-of-two bucket (duplicate writes of the
    # same row/value are idempotent), as the JAX package does to bound its
    # compiled shapes
    m = 1
    while m < len(patch_rows):
        m *= 2
    while len(patch_rows) < m:
        patch_rows.append(patch_rows[-1])
        patch_vals.append(patch_vals[-1])
    return crop_batch_separable_patched(
        img, origins, ycoef, xcoef, valid_w, patch_rows,
        np.stack(patch_vals), out_h, out_w, SEP_SRC_H, src_w)


def crop_batch_auto(img: torch.Tensor, Hs: np.ndarray, valid_w: np.ndarray,
                    out_h: int, out_w: int) -> torch.Tensor:
    """Route a crop chunk to the separable resampler when EVERY quad is
    axis-aligned and fits the static source box, else the gather path."""
    src_w = 2 * out_w
    plans = [separable_plan(H, out_h, out_w, SEP_SRC_H, src_w)
             for H in np.asarray(Hs)]
    if all(p is not None for p in plans):
        return crop_batch_separable(
            img, [p[0] for p in plans], [p[1] for p in plans],
            [p[2] for p in plans], valid_w, out_h, out_w, SEP_SRC_H, src_w)
    return crop_batch(img, Hs, valid_w, out_h, out_w)
