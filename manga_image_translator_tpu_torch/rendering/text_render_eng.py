"""manga2eng renderer: English typesetting fitted to speech-balloon shape.

Behavioral contract from reference ``rendering/text_render_eng.py:158-334``
(``layout_lines_aligncenter``) + ``ballon_extractor.py:31``: estimate the
balloon's free region by flood-filling the near-uniform background around
the text bbox, then lay words out center-aligned from the region centroid —
the central line grows while its endpoints stay inside the balloon, earlier
words stack upward, later words stack downward — shrinking the font until
the layout fits. Falls back to bbox-centered wrapped text when no balloon
shape is recoverable.

A copy of the JAX package's ``rendering/text_render_eng.py`` (host only).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import cv2
import numpy as np
from PIL import Image, ImageDraw

from ..utils.profiling import span
from ..utils.textblock import TextBlock
from . import text_render


def extract_ballon_region(img: np.ndarray, xyxy, enlarge_ratio: float = 2.0):
    """Estimate the balloon interior around a text bbox by flood filling the
    (assumed near-uniform) background from points just outside the text.

    Returns (region, (ex1, ey1, ex2, ey2)): region is a uint8 mask on the
    enlarged crop, 255 = balloon interior."""
    x1, y1, x2, y2 = [int(v) for v in xyxy]
    h, w = img.shape[:2]
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    bw, bh = x2 - x1, y2 - y1
    ex1 = max(int(cx - bw * enlarge_ratio / 2), 0)
    ey1 = max(int(cy - bh * enlarge_ratio / 2), 0)
    ex2 = min(int(cx + bw * enlarge_ratio / 2), w)
    ey2 = min(int(cy + bh * enlarge_ratio / 2), h)
    crop = img[ey1:ey2, ex1:ex2]
    gray = cv2.cvtColor(crop, cv2.COLOR_RGB2GRAY)
    _, binary = cv2.threshold(gray, 127, 255,
                              cv2.THRESH_BINARY | cv2.THRESH_OTSU)
    # flood from the text-bbox corner band (likely balloon interior)
    mask = np.zeros((binary.shape[0] + 2, binary.shape[1] + 2), np.uint8)
    seed = (min(max(cx - ex1, 0), binary.shape[1] - 1),
            min(max(y1 - ey1 - 2, 0), binary.shape[0] - 1))
    ff = binary.copy()
    try:
        cv2.floodFill(ff, mask, seed, 128, loDiff=30, upDiff=30)
        region = (ff == 128).astype(np.uint8) * 255
        if region.sum() == 0:
            raise ValueError
    except Exception:
        region = np.full_like(binary, 255)
    return region, (ex1, ey1, ex2, ey2)


class Line:
    """One laid-out line: text centered on the balloon centroid column."""
    __slots__ = ('text', 'x', 'y', 'width')

    def __init__(self, text: str, x: int, y: int, width: float):
        self.text = text
        self.x = x
        self.y = y
        self.width = width


def _fits(region: np.ndarray, cx: int, y0: int, y1: int,
          length: float) -> bool:
    """True when a line of ``length`` centered on column ``cx`` over rows
    [y0, y1) lies entirely inside the balloon free region (both endpoint
    columns free across the whole band — the reference's criterion)."""
    h, w = region.shape[:2]
    lx = int(cx - length / 2)
    rx = int(cx + length / 2)
    if lx < 0 or rx >= w or y0 < 0 or y1 > h:
        return False
    return bool((region[y0:y1, lx] == 255).all()
                and (region[y0:y1, rx] == 255).all())


def layout_lines_in_balloon(region: np.ndarray, words: List[str],
                            widths: List[float], space_w: float,
                            line_h: int) -> Optional[List[Line]]:
    """Center-out greedy word layout constrained by the balloon shape
    (re-derivation of reference ``layout_lines_aligncenter``).

    The central line sits on the free-region centroid and takes the word
    whose centered cumulative offset is nearest zero, then grows with
    neighbors (earlier words on the left, later on the right) while its
    endpoints stay free. Remaining earlier words stack on lines above
    (prepending), later words on lines below — preserving reading order.
    Returns None when any word cannot be placed (caller shrinks the font).
    """
    if not words:
        return []
    m = cv2.moments(region)
    if m['m00'] == 0:
        return None
    cx = int(m['m10'] / m['m00'])
    cy = int(m['m01'] / m['m00'])

    cum = np.cumsum(widths, dtype=np.float64)
    centered = cum - cum[-1] / 2 - np.asarray(widths) / 2
    ci = int(np.argmin(np.abs(centered)))

    y0 = cy - line_h // 2
    if not _fits(region, cx, y0, y0 + line_h, widths[ci]):
        return None
    text, length = words[ci], widths[ci]
    left, right = ci - 1, ci + 1

    # grow the central line: prefer the heavier remaining side (keeps the
    # block balanced, like the reference)
    while left >= 0 or right < len(words):
        rem_l = cum[left] if left >= 0 else 0.0
        rem_r = cum[-1] - cum[right - 1] if right < len(words) else 0.0
        grew = False
        for side in sorted(('L', 'R'), key=lambda s: -(rem_l if s == 'L'
                                                       else rem_r)):
            if side == 'L' and left >= 0:
                new_len = length + space_w + widths[left]
                if _fits(region, cx, y0, y0 + line_h, new_len):
                    text = f'{words[left]} {text}'
                    length = new_len
                    left -= 1
                    grew = True
                    break
            if side == 'R' and right < len(words):
                new_len = length + space_w + widths[right]
                if _fits(region, cx, y0, y0 + line_h, new_len):
                    text = f'{text} {words[right]}'
                    length = new_len
                    right += 1
                    grew = True
                    break
        if not grew:
            break
    lines = [Line(text, int(cx - length / 2), y0, length)]

    # later words flow into lines below
    ly0 = y0 + line_h
    idx = right
    while idx < len(words):
        if not _fits(region, cx, ly0, ly0 + line_h, widths[idx]):
            return None
        text, length = words[idx], widths[idx]
        idx += 1
        while idx < len(words):
            new_len = length + space_w + widths[idx]
            if not _fits(region, cx, ly0, ly0 + line_h, new_len):
                break
            text = f'{text} {words[idx]}'
            length = new_len
            idx += 1
        lines.append(Line(text, int(cx - length / 2), ly0, length))
        ly0 += line_h

    # earlier words stack upward (prepending keeps reading order)
    ly0 = y0 - line_h
    idx = left
    above: List[Line] = []
    while idx >= 0:
        if not _fits(region, cx, ly0, ly0 + line_h, widths[idx]):
            return None
        text, length = words[idx], widths[idx]
        idx -= 1
        while idx >= 0:
            new_len = length + space_w + widths[idx]
            if not _fits(region, cx, ly0, ly0 + line_h, new_len):
                break
            text = f'{words[idx]} {text}'
            length = new_len
            idx -= 1
        above.insert(0, Line(text, int(cx - length / 2), ly0, length))
        ly0 -= line_h
    return above + lines


def _render_lines(img: np.ndarray, lines: List[Line], offset: Tuple[int, int],
                  font_size: int, fg, bg) -> None:
    """Draw laid-out lines (balloon-crop coordinates) onto the page."""
    ox, oy = offset
    font = text_render.get_cached_font(font_size)
    sw = text_render._stroke_width(font_size, bg)
    x0 = min(l.x for l in lines) + ox - sw - 2
    y0 = min(l.y for l in lines) + oy - sw - 2
    x1 = max(int(l.x + l.width) for l in lines) + ox + sw + 2
    y1 = max(l.y for l in lines) + int(font_size * 1.3) + oy + sw + 2
    x0c, y0c = max(x0, 0), max(y0, 0)
    x1c, y1c = min(x1, img.shape[1]), min(y1, img.shape[0])
    if x1c <= x0c or y1c <= y0c:
        return
    canvas = Image.new('RGBA', (x1c - x0c, y1c - y0c), (0, 0, 0, 0))
    draw = ImageDraw.Draw(canvas)
    fg_t = tuple(int(v) for v in fg) + (255,)
    bg_t = tuple(int(v) for v in bg) + (255,) if bg is not None else None
    for l in lines:
        draw.text((l.x + ox - x0c, l.y + oy - y0c), l.text, font=font,
                  fill=fg_t, stroke_width=sw, stroke_fill=bg_t)
    sub = np.array(canvas)
    alpha = sub[:, :, 3:4].astype(np.float32) / 255.0
    img[y0c:y1c, x0c:x1c] = np.clip(
        img[y0c:y1c, x0c:x1c].astype(np.float32) * (1 - alpha)
        + sub[:, :, :3].astype(np.float32) * alpha, 0, 255).astype(np.uint8)


def render_textblock_list_eng(img: np.ndarray, text_regions: List[TextBlock],
                              line_spacing: float = 0,
                              size_tol: float = 1.2,
                              original_img: Optional[np.ndarray] = None,
                              downscale_constraint: float = 0.8,
                              disable_font_border: bool = False
                              ) -> np.ndarray:
    src = original_img if original_img is not None else img
    for region in text_regions:
        if not region.translation:
            continue
        with span('render.region'):
            _render_region_eng(img, src, region, line_spacing, size_tol,
                               downscale_constraint, disable_font_border)
    return img


def _render_region_eng(img: np.ndarray, src: np.ndarray, region: TextBlock,
                       line_spacing: float, size_tol: float,
                       downscale_constraint: float,
                       disable_font_border: bool) -> None:
    """One region of ``render_textblock_list_eng``, drawn into ``img``."""
    fg, bg = region.get_font_colors()
    if disable_font_border:
        bg = None
    x1, y1, x2, y2 = [int(v) for v in region.xyxy]
    bw = max(x2 - x1, 8)
    bh = max(y2 - y1, 8)
    text = region.get_translation_for_rendering()

    font_size = max(int(region.font_size), 8)
    min_size = max(int(font_size * downscale_constraint), 6)

    ballon, (ex1, ey1, _ex2, _ey2) = extract_ballon_region(
        src, region.xyxy)
    words = [w for w in text.replace('\n', ' ').split(' ') if w]

    placed = False
    if words and (ballon == 0).any():
        # real balloon shape recovered: shrink the font until the
        # center-aligned shape fit succeeds
        for fs in range(font_size, min_size - 1, -2):
            font = text_render.get_cached_font(fs)
            widths = [font.getlength(w) for w in words]
            line_h = int(fs * (1.15 + line_spacing))
            lines = layout_lines_in_balloon(
                ballon, words, widths, font.getlength(' '), line_h)
            if lines is not None:
                _render_lines(img, lines, (ex1, ey1), fs, fg, bg)
                placed = True
                break
    if placed:
        return

    # fallback: bbox-centered wrapped box (no balloon shape found or
    # the text does not fit at the minimum size)
    fs = font_size
    for cand in range(font_size, min_size - 1, -2):
        font = text_render.get_cached_font(cand)
        n_lines = len(text_render._break_text(font, text, bw * size_tol))
        if n_lines * int(cand * (1.15 + line_spacing)) <= bh * size_tol:
            fs = cand
            break
    else:
        fs = min_size
    box = text_render.put_text_horizontal(
        fs, text, bw, bh, 'center', False,
        fg, bg, region.target_lang, True, line_spacing or None)
    gh, gw = box.shape[:2]
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    ox1 = max(cx - gw // 2, 0)
    oy1 = max(cy - gh // 2, 0)
    ox2 = min(ox1 + gw, img.shape[1])
    oy2 = min(oy1 + gh, img.shape[0])
    sub = box[:oy2 - oy1, :ox2 - ox1]
    alpha = sub[:, :, 3:4].astype(np.float32) / 255.0
    img[oy1:oy2, ox1:ox2] = np.clip(
        img[oy1:oy2, ox1:ox2].astype(np.float32) * (1 - alpha)
        + sub[:, :, :3].astype(np.float32) * alpha, 0, 255
    ).astype(np.uint8)
