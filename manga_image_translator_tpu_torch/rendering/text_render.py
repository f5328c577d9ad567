"""Glyph rasterization and text layout (host-side).

Behavioral contract from reference ``rendering/text_render.py`` (freetype
glyph rendering with border stroke, horizontal wrap with hyphenation,
vertical column layout with CJK-compatibility-form rotation). This
implementation rasterizes through PIL's FreeType binding instead of raw
freetype-py (not available here) — same outputs: RGBA boxes with fg text and
optional bg stroke.

A copy of the JAX package's ``rendering/text_render.py`` (host only).
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

DEFAULT_FONT_CANDIDATES = [
    '/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf',
]

_current_font_path: Optional[str] = None

# CJK compatibility forms: horizontal -> vertical presentation forms
# (reference text_render.py:118-157 CJK_H2V / CJK_V2H + the 'ー' rotation).
CJK_H2V = {
    '‥': '︰', '—': '︱', '―': '|', '–': '︲', '_': '︳',
    '(': '︵', ')': '︶', '（': '︵', '）': '︶',
    '{': '︷', '}': '︸', '｛': '︷', '｝': '︸',
    '〈': '︿', '〉': '﹀', '《': '︽', '》': '︾',
    '「': '﹁', '」': '﹂', '『': '﹃', '』': '﹄',
    '[': '﹇', ']': '﹈', '［': '﹇', '］': '﹈',
    '〔': '︹', '〕': '︺', '…': '︙', '・': '·',
}
CJK_V2H = {v: k for k, v in CJK_H2V.items()}


def cjk_compat_form(cdpt: str, direction: int):
    """Translate a codepoint for the target direction (0=h, 1=v); returns
    (char, rotation_degrees) — mirrors CJK_Compatibility_Forms_translate."""
    if cdpt == 'ー' and direction == 1:
        return 'ー', 90
    if cdpt in ('〜', '～') and direction == 1:
        return cdpt, 90
    if cdpt in CJK_V2H:
        return (CJK_V2H[cdpt], 0) if direction == 0 else (cdpt, 0)
    if cdpt in CJK_H2V:
        return (cdpt, 0) if direction == 0 else (CJK_H2V[cdpt], 0)
    return cdpt, 0


# Characters that rotate in vertical layout when the font lacks the
# vertical presentation form glyph (fallback to rotation).
_VERTICAL_ROTATE = set('ー〜～…‥—―–_=：；')
_VERTICAL_PUNCT_SHIFT = set('。、．，')  # shift to top-right corner

HALF_WIDTH_CHARS = 'っッぁぃぅぇぉ'


def set_font(font_path: str):
    global _current_font_path
    if font_path and os.path.isfile(font_path):
        _current_font_path = font_path
    else:
        for cand in DEFAULT_FONT_CANDIDATES:
            if os.path.isfile(cand):
                _current_font_path = cand
                break
    get_cached_font.cache_clear()


@functools.lru_cache(maxsize=64)
def get_cached_font(size: int) -> ImageFont.FreeTypeFont:
    path = _current_font_path
    if path is None:
        set_font('')
        path = _current_font_path
    if path is None:
        return ImageFont.load_default()
    return ImageFont.truetype(path, max(size, 2))


def _is_cjk(ch: str) -> bool:
    o = ord(ch)
    return (0x3000 <= o <= 0x9FFF or 0xF900 <= o <= 0xFAFF
            or 0xFF00 <= o <= 0xFFEF or 0xAC00 <= o <= 0xD7AF)


def _char_width(font, ch: str) -> float:
    return font.getlength(ch)


def count_text_length(text: str) -> float:
    return sum(0.5 if c in HALF_WIDTH_CHARS else 1.0 for c in text.strip())


# --------------------------------------------------------------------------
# Layout
# --------------------------------------------------------------------------

def _break_text_syllables(font, text: str, max_width: float,
                          max_height: float, font_size: int,
                          language: str = 'en_US', hyphenate: bool = True
                          ) -> Tuple[List[str], float]:
    """Syllable-aware line filling with hyphen insertion and the
    reference's expand-the-box loop (calc_horizontal :612-700): when a
    height overflow is unavoidable, width/height grow by sqrt(overflow)
    until the text fits; words break at dictionary/rule syllable
    boundaries with a trailing '-'."""
    from .hyphenation import syllables as hyph_syllables

    max_width = max(max_width, 2 * font_size)
    space_w = font.getlength(' ')
    hyphen_w = font.getlength('-')

    words = [w for w in text.replace('\n', ' ').split(' ') if w]
    if not words:
        return [''], max_width
    word_widths = [font.getlength(w) for w in words]

    # expand the box when overflow is unavoidable (ref :629-639)
    if max_height > 0:
        while True:
            max_lines = max_height // font_size + 1
            expected = (sum(word_widths)
                        + max((len(words) - 1) * space_w
                              - (max_lines - 1) * hyphen_w, 0))
            if max_width * max_lines >= expected:
                break
            mult = float(np.sqrt(expected / (max_width * max_lines)))
            max_width *= max(mult, 1.05)
            max_height *= mult

    lines: List[str] = []
    cur = ''
    cur_w = 0.0
    for word, ww in zip(words, word_widths):
        sep_w = space_w if cur else 0.0
        if cur_w + sep_w + ww <= max_width:
            cur = f'{cur} {word}' if cur else word
            cur_w += sep_w + ww
            continue
        if not hyphenate or _is_cjk(word[0]):
            # CJK: fill by characters, no hyphen
            if _is_cjk(word[0]):
                for ch in word:
                    cw = font.getlength(ch)
                    if cur_w + cw > max_width and cur:
                        lines.append(cur)
                        cur, cur_w = '', 0.0
                    cur += ch
                    cur_w += cw
                continue
            if cur:
                lines.append(cur)
            cur, cur_w = word, ww
            continue
        syls = hyph_syllables(word, language)
        # split syllables that alone exceed the width
        norm: List[str] = []
        for s in syls:
            if font.getlength(s) > max_width:
                norm.extend(list(s))
            else:
                norm.append(s)
        # greedily place syllables; remainder wraps (possibly over several
        # lines for very long words)
        remaining = norm
        while remaining:
            placed = 0
            line, line_w = cur, cur_w
            for syl in remaining:
                sw_ = font.getlength(syl)
                sep = space_w if (line and placed == 0 and line == cur
                                  and cur) else 0.0
                if line_w + sep + sw_ + hyphen_w <= max_width or not line:
                    line = (f'{line} {syl}' if sep else line + syl)
                    line_w += sep + sw_
                    placed += 1
                else:
                    break
            if placed == len(remaining):
                cur, cur_w = line, line_w
                remaining = []
            elif placed > 0:
                lines.append(line + '-')
                cur, cur_w = '', 0.0
                remaining = remaining[placed:]
            else:
                if cur:
                    lines.append(cur)
                cur, cur_w = '', 0.0
    if cur:
        lines.append(cur)
    return (lines or ['']), max_width


def _break_text(font, text: str, max_width: float, hyphenate: bool = True
                ) -> List[str]:
    """Greedy line breaking: words for spaced scripts, chars for CJK."""
    lines: List[str] = []
    cur = ''
    cur_w = 0.0

    def flush():
        nonlocal cur, cur_w
        if cur:
            lines.append(cur)
        cur, cur_w = '', 0.0

    tokens: List[str] = []
    word = ''
    for ch in text:
        if _is_cjk(ch):
            if word:
                tokens.append(word)
                word = ''
            tokens.append(ch)
        elif ch == ' ':
            if word:
                tokens.append(word)
                word = ''
            tokens.append(' ')
        elif ch == '\n':
            if word:
                tokens.append(word)
                word = ''
            tokens.append('\n')
        else:
            word += ch
    if word:
        tokens.append(word)

    for tok in tokens:
        if tok == '\n':
            flush()
            continue
        w = font.getlength(tok)
        if cur_w + w <= max_width or not cur:
            if not (tok == ' ' and not cur):
                cur += tok
                cur_w += w
        else:
            if tok == ' ':
                flush()
                continue
            if hyphenate and w > max_width and not _is_cjk(tok[0]):
                # split over-long word with hyphen
                flush()
                piece = ''
                for ch in tok:
                    if font.getlength(piece + ch + '-') > max_width and piece:
                        lines.append(piece + '-')
                        piece = ''
                    piece += ch
                cur, cur_w = piece, font.getlength(piece)
            else:
                flush()
                cur, cur_w = tok, w
    flush()
    return lines or ['']


def calc_horizontal(font_size: int, text: str, max_width: float,
                    max_height: float = 0, language: str = 'en_US',
                    hyphenate: bool = True) -> Tuple[List[str], float]:
    font = get_cached_font(int(font_size))
    lines, _ = _break_text_syllables(font, text, max(max_width, font_size),
                                     max_height, int(font_size), language,
                                     hyphenate)
    height = len(lines) * font_size * 1.1
    return lines, height


def calc_vertical(font_size: int, text: str, max_height: float
                  ) -> Tuple[List[str], float]:
    """Split text into vertical columns of at most max_height."""
    chars_per_col = max(int(max_height // max(font_size, 1)), 1)
    text = text.replace('\n', '')
    cols = [text[i:i + chars_per_col]
            for i in range(0, len(text), chars_per_col)]
    return cols or [''], len(cols) * font_size * 1.2


# --------------------------------------------------------------------------
# Rasterization
# --------------------------------------------------------------------------

def _stroke_width(font_size: int, bg) -> int:
    return max(int(font_size * 0.07), 2) if bg is not None else 0


def put_text_horizontal(font_size: int, text: str, width: int, height: int,
                        alignment: str = 'center', reversed_direction: bool = False,
                        fg=(0, 0, 0), bg=None, target_lang: str = '',
                        hyphenate: bool = True,
                        line_spacing: Optional[float] = None) -> np.ndarray:
    """Render wrapped horizontal text into a tight RGBA box."""
    font_size = max(int(font_size), 4)
    font = get_cached_font(font_size)
    spacing = line_spacing if line_spacing is not None else 0.01
    lines, _ = _break_text_syllables(
        font, text, max(width, font_size), height, font_size,
        target_lang or 'en_US', hyphenate)
    sw = _stroke_width(font_size, bg)
    line_h = int(font_size * (1 + spacing)) + 1
    box_h = line_h * len(lines) + 2 * sw + font_size // 2
    box_w = max(int(max(font.getlength(l) for l in lines)) + 2 * sw + 2,
                4)
    img = Image.new('RGBA', (box_w, box_h), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    fg_t = tuple(int(v) for v in fg) + (255,)
    bg_t = tuple(int(v) for v in bg) + (255,) if bg is not None else None
    y = sw
    for line in lines:
        lw = font.getlength(line)
        if alignment == 'center':
            x = (box_w - lw) / 2
        elif alignment == 'right':
            x = box_w - lw - sw
        else:
            x = sw
        draw.text((x, y), line, font=font, fill=fg_t,
                  stroke_width=sw, stroke_fill=bg_t)
        y += line_h
    return np.array(img)


def put_char_vertical(font_size: int, ch: str, fg, bg) -> np.ndarray:
    """One character cell for vertical layout.

    Applies the CJK compatibility-form translation first (reference
    CJK_Compatibility_Forms_translate); if the font lacks the vertical
    presentation glyph (rendered as .notdef/empty), falls back to rotating
    the horizontal form.
    """
    font = get_cached_font(font_size)
    sw = _stroke_width(font_size, bg)
    cell = int(font_size * 1.2) + 2 * sw
    img = Image.new('RGBA', (cell, cell), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    fg_t = tuple(int(v) for v in fg) + (255,)
    bg_t = tuple(int(v) for v in bg) + (255,) if bg is not None else None

    cdpt, rot = cjk_compat_form(ch, 1)
    rotate_fallback = False
    if cdpt != ch and not _font_has_glyph(font, cdpt):
        cdpt = ch
        rotate_fallback = True

    if cdpt in _VERTICAL_PUNCT_SHIFT:
        draw.text((cell * 0.55, -cell * 0.1), cdpt, font=font, fill=fg_t,
                  stroke_width=sw, stroke_fill=bg_t)
    else:
        w = font.getlength(cdpt)
        draw.text(((cell - w) / 2, sw), cdpt, font=font, fill=fg_t,
                  stroke_width=sw, stroke_fill=bg_t)
        if rot == 90 or rotate_fallback or (cdpt in _VERTICAL_ROTATE):
            img = img.rotate(-90, expand=False)
    return np.array(img)


@functools.lru_cache(maxsize=4096)
def _font_has_glyph_cached(path: Optional[str], size: int,
                           ch: str) -> bool:
    font = get_cached_font(size)
    try:
        mask = font.getmask(ch)
        if mask.size[0] == 0 or mask.size[1] == 0:
            return False
        # compare against .notdef (tofu) rendering of an unassigned char
        tofu = font.getmask('\U000E01EF')
        return mask.size != tofu.size or bytes(mask) != bytes(tofu)
    except Exception:
        return False


def _font_has_glyph(font, ch: str) -> bool:
    return _font_has_glyph_cached(_current_font_path, font.size, ch)


def put_text_vertical(font_size: int, text: str, height: int,
                      alignment: str = 'left', fg=(0, 0, 0), bg=None,
                      line_spacing: Optional[float] = None) -> np.ndarray:
    """Vertical layout: columns read right→left, chars top→bottom."""
    font_size = max(int(font_size), 4)
    spacing = line_spacing if line_spacing is not None else 0.2
    sw = _stroke_width(font_size, bg)
    cols, _ = calc_vertical(font_size, text, max(height, font_size))
    cell = int(font_size * 1.2) + 2 * sw
    col_w = int(font_size * (1 + spacing)) + 2 * sw
    box_h = max(cell * max(len(c) for c in cols), cell)
    box_w = max(col_w * len(cols), col_w)
    out = np.zeros((box_h, box_w, 4), dtype=np.uint8)
    for ci, col in enumerate(cols):
        x0 = box_w - (ci + 1) * col_w  # rightmost column first
        for ri, ch in enumerate(col):
            if ch == ' ':
                continue
            glyph = put_char_vertical(font_size, ch, fg, bg)
            gh, gw = glyph.shape[:2]
            y0 = ri * cell
            y1 = min(y0 + gh, box_h)
            x1 = min(x0 + gw, box_w)
            if y1 <= y0 or x1 <= x0:
                continue
            dst = out[y0:y1, x0:x1]
            src = glyph[:y1 - y0, :x1 - x0]
            alpha = src[:, :, 3:4].astype(np.uint16)
            dst[:] = ((dst.astype(np.uint16) * (255 - alpha)
                       + src.astype(np.uint16) * alpha) // 255).astype(np.uint8)
    return out
