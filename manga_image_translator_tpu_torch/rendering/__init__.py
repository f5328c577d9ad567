"""Rendering stage: typeset translations back onto the page.

Contract from reference ``rendering/__init__.py`` — resize_regions_to_
font_size grows the destination quad when the translation needs more lines
(:48-233), render() rasterizes the text box and homography-warps it onto the
page with alpha compositing (:264-410). Host-side by design (glyph
rasterization); the per-region composite is vectorized numpy.

A copy of the JAX package's ``rendering/__init__.py`` (host only, no
device work); the layered xcf/psd/pdf export is ``gimp_render.py``.
"""
from __future__ import annotations

from typing import List, Optional

import cv2
import numpy as np

from ..utils.generic import color_difference
from ..utils.log import get_logger
from ..utils.profiling import span
from ..utils.textblock import TextBlock, rotate_polygons
from . import text_render
from .text_render import count_text_length

logger = get_logger('render')


def parse_font_paths(path: str, default: Optional[List[str]] = None
                     ) -> List[str]:
    import os
    if path:
        return [p for p in path.split(',') if os.path.isfile(p)]
    return default or []


def fg_bg_compare(fg, bg):
    fg_avg = np.mean(fg)
    if color_difference(fg, bg) < 30:
        bg = (255, 255, 255) if fg_avg <= 127 else (0, 0, 0)
    return fg, bg


def _scale_rect_pts(region: TextBlock, xfact: float, yfact: float,
                    origin: str) -> np.ndarray:
    """Scale the unrotated min-rect and rotate back (replaces shapely
    affinity.scale on the polygon)."""
    pts = region.unrotated_min_rect[0].astype(np.float64)
    if origin == 'corner':
        ox, oy = pts[:, 0].min(), pts[:, 1].min()
    else:  # center
        ox, oy = pts[:, 0].mean(), pts[:, 1].mean()
    pts = np.stack([(pts[:, 0] - ox) * xfact + ox,
                    (pts[:, 1] - oy) * yfact + oy], axis=1)
    return rotate_polygons(region.center, pts.reshape(1, -1), -region.angle,
                           to_int=False).reshape(-1, 4, 2).astype(np.int64)


def resize_regions_to_font_size(img: np.ndarray,
                                text_regions: List[TextBlock],
                                font_size_fixed: Optional[int],
                                font_size_offset: int,
                                font_size_minimum: int) -> List[np.ndarray]:
    if font_size_minimum == -1:
        font_size_minimum = round((img.shape[0] + img.shape[1]) / 200)
    font_size_minimum = max(1, font_size_minimum)

    dst_points_list = []
    for region in text_regions:
        original_font_size = region.font_size
        if original_font_size <= 0:
            original_font_size = font_size_minimum
        if font_size_fixed is not None:
            target_font_size = font_size_fixed
        else:
            target_font_size = original_font_size + font_size_offset
        target_font_size = max(target_font_size, font_size_minimum, 1)

        single_axis_expanded = False
        dst_points = None

        if region.horizontal:
            used_rows = max(len(region.texts), 1)
            lines, _ = text_render.calc_horizontal(
                region.font_size, region.translation,
                max_width=region.unrotated_size[0],
                max_height=region.unrotated_size[1],
                language=getattr(region, 'target_lang', 'en_US'))
            needed_rows = len(lines)
            if needed_rows > used_rows:
                scale_x = (needed_rows - used_rows) / used_rows + 1
                dst_points = _scale_rect_pts(region, scale_x, 1.0, 'corner')
                single_axis_expanded = True
        if region.vertical:
            used_cols = max(len(region.texts), 1)
            cols, _ = text_render.calc_vertical(
                region.font_size, region.translation,
                max_height=region.unrotated_size[1])
            needed_cols = len(cols)
            if needed_cols > used_cols:
                scale_y = (needed_cols - used_cols) / used_cols + 1
                dst_points = _scale_rect_pts(region, 1.0, scale_y, 'corner')
                single_axis_expanded = True

        if not single_axis_expanded:
            orig_text = getattr(region, 'text_raw', region.text)
            n_orig = count_text_length(orig_text)
            n_trans = count_text_length(region.translation.strip())
            target_scale = 1.0
            if n_orig > 0 and n_trans > n_orig:
                inc = (n_trans - n_orig) / n_orig
                font_ratio = min(1.5, max(1.0, 1 + inc * 0.3))
                target_font_size = int(target_font_size * font_ratio)
                target_scale = max(1, min(1 + inc * 0.3, 2))
            font_size_scale = (((target_font_size - original_font_size)
                                / original_font_size) * 0.4 + 1
                               if original_font_size > 0 else 1.0)
            final_scale = max(1, min(max(font_size_scale, target_scale), 1.1))
            if final_scale > 1.001:
                dst_points = _scale_rect_pts(region, final_scale,
                                             final_scale, 'center')
            else:
                dst_points = region.min_rect

        dst_points_list.append(dst_points)
        region.font_size = int(target_font_size)
    return dst_points_list


def render(img: np.ndarray, region: TextBlock, dst_points: np.ndarray,
           hyphenate: bool, line_spacing: Optional[int],
           disable_font_border: bool) -> np.ndarray:
    fg, bg = region.get_font_colors()
    fg, bg = fg_bg_compare(fg, bg)
    if disable_font_border:
        bg = None

    middle_pts = (dst_points[:, [1, 2, 3, 0]] + dst_points) / 2
    norm_h = np.linalg.norm(middle_pts[:, 1] - middle_pts[:, 3], axis=1)
    norm_v = np.linalg.norm(middle_pts[:, 2] - middle_pts[:, 0], axis=1)
    r_orig = float(np.mean(norm_h / np.maximum(norm_v, 1e-9)))

    forced = getattr(region, '_direction', region.direction)
    if forced != 'auto':
        render_horizontally = forced in ('horizontal', 'h', 'hr', 'hl')
    else:
        render_horizontally = region.horizontal

    if render_horizontally:
        temp_box = text_render.put_text_horizontal(
            region.font_size, region.get_translation_for_rendering(),
            round(norm_h[0]), round(norm_v[0]), region.alignment,
            region.direction == 'hl', fg, bg, region.target_lang,
            hyphenate, line_spacing)
    else:
        temp_box = text_render.put_text_vertical(
            region.font_size, region.get_translation_for_rendering(),
            round(norm_v[0]), region.alignment, fg, bg, line_spacing)
    h, w = temp_box.shape[:2]
    r_temp = w / h

    # pad the box to the original aspect ratio (reference render :325-395)
    if region.horizontal:
        if r_temp > r_orig:
            h_ext = int((w / r_orig - h) // 2) if r_orig > 0 else 0
            if h_ext >= 0:
                box = np.zeros((h + h_ext * 2, w, 4), np.uint8)
                box[h_ext:h_ext + h, :w] = temp_box
            else:
                box = temp_box.copy()
        else:
            w_ext = int((h * r_orig - w) // 2)
            if w_ext >= 0:
                box = np.zeros((h, w + w_ext * 2, 4), np.uint8)
                box[:h, :w] = temp_box
            else:
                box = temp_box.copy()
    else:
        if r_temp > r_orig:
            h_ext = int(w / (2 * r_orig) - h / 2) if r_orig > 0 else 0
            if h_ext >= 0:
                box = np.zeros((h + h_ext * 2, w, 4), np.uint8)
                box[:h, :w] = temp_box
            else:
                box = temp_box.copy()
        else:
            w_ext = int((h * r_orig - w) / 2)
            if w_ext >= 0:
                box = np.zeros((h, w + w_ext * 2, 4), np.uint8)
                box[:h, w_ext:w_ext + w] = temp_box
            else:
                box = temp_box.copy()

    src_points = np.array([[0, 0], [box.shape[1], 0],
                           [box.shape[1], box.shape[0]],
                           [0, box.shape[0]]], np.float32)
    M, _ = cv2.findHomography(src_points, dst_points.astype(np.float32),
                              cv2.RANSAC, 5.0)
    if M is None:
        return img
    rgba_region = cv2.warpPerspective(
        box, M, (img.shape[1], img.shape[0]), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    x, y, w, h = cv2.boundingRect(dst_points.astype(np.int32))
    x, y = max(x, 0), max(y, 0)
    w = min(w, img.shape[1] - x)
    h = min(h, img.shape[0] - y)
    if w <= 0 or h <= 0:
        return img
    canvas_region = rgba_region[y:y + h, x:x + w, :3]
    mask_region = rgba_region[y:y + h, x:x + w, 3:4].astype(np.float32) / 255.0
    img[y:y + h, x:x + w] = np.clip(
        img[y:y + h, x:x + w].astype(np.float32) * (1 - mask_region)
        + canvas_region.astype(np.float32) * mask_region, 0, 255
    ).astype(np.uint8)
    return img


async def dispatch(img: np.ndarray, text_regions: List[TextBlock],
                   font_path: str = '', font_size_fixed: Optional[int] = None,
                   font_size_offset: int = 0, font_size_minimum: int = 0,
                   hyphenate: bool = True,
                   render_mask: Optional[np.ndarray] = None,
                   line_spacing: Optional[int] = None,
                   disable_font_border: bool = False) -> np.ndarray:
    text_render.set_font(font_path)
    text_regions = [r for r in text_regions if r.translation]
    dst_points_list = resize_regions_to_font_size(
        img, text_regions, font_size_fixed, font_size_offset,
        font_size_minimum)
    for region, dst_points in zip(text_regions, dst_points_list):
        with span('render.region'):
            if render_mask is not None:
                cv2.fillConvexPoly(render_mask, dst_points.astype(np.int32),
                                   1)
            img = render(img, region, dst_points, hyphenate, line_spacing,
                         disable_font_border)
    return img


async def dispatch_eng_render(img_canvas: np.ndarray,
                              original_img: np.ndarray,
                              text_regions: List[TextBlock],
                              font_path: str = '', line_spacing: int = 0,
                              disable_font_border: bool = False
                              ) -> np.ndarray:
    """manga2eng renderer: balloon-aware English typesetting."""
    from .text_render_eng import render_textblock_list_eng
    if len(text_regions) == 0:
        return img_canvas
    text_render.set_font(font_path)
    return render_textblock_list_eng(
        img_canvas, text_regions, line_spacing=line_spacing, size_tol=1.2,
        original_img=original_img, downscale_constraint=0.8,
        disable_font_border=disable_font_border)


async def dispatch_eng_render_pillow(img_canvas: np.ndarray,
                                     original_img: np.ndarray,
                                     text_regions: List[TextBlock],
                                     font_path: str = '',
                                     line_spacing: int = 0,
                                     disable_font_border: bool = False
                                     ) -> np.ndarray:
    return await dispatch_eng_render(img_canvas, original_img, text_regions,
                                     font_path, line_spacing,
                                     disable_font_border)
