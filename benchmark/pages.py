"""The page generator: one chapter of synthetic manga pages from a traffic
mix's parameters, in an order drawn from a seed.

The chapter's pages are drawn from the mix's own ``page_seed``, with line
counts and lengths spread evenly over the mix's ranges; ``--seed`` decides
the order the client sends them in. So every seed puts the same work
through the pipeline in another order (the pages' glyphs decide what the
random OCR reads and so how long each translation runs), and a window
that holds about two chapters reads the same tail.

Lines are drawn glyph by glyph (random strokes in a square cell): there is
no CJK font to draw real text with, and the OCR's weights are random, so
what matters is the geometry, the count and the lengths of the lines.

Each page carries what the benchmark knows of it: its text lines as
axis-aligned boxes (x0, y0, x1, y1) and a mask of its glyph strokes, from
which ``detection_maps`` draws the probability map and the text mask that
stand in for the random DBNet's (``seams.install_detection_seam``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import cv2
import numpy as np


@dataclasses.dataclass
class Page:
    index: int                    # position in the chapter
    image: np.ndarray             # (H, W, 3) uint8 RGB, as the program gets it
    lines: np.ndarray             # (n, 4) int boxes x0, y0, x1, y1, full scale
    vertical: np.ndarray          # (n,) bool
    chars: np.ndarray             # (n,) glyphs a line
    strokes: np.ndarray           # (H_full, W_full) uint8 glyph mask, 0/255
    bubbles: np.ndarray           # (b, 4) int boxes of the bubbles, full scale

    @property
    def n_lines(self) -> int:
        return int(self.lines.shape[0])


def _spread(lo: int, hi: int, n: int) -> List[int]:
    """``n`` whole numbers spread evenly over [lo, hi]."""
    if n == 1:
        return [int(round((lo + hi) / 2))]
    return [int(round(lo + (hi - lo) * i / (n - 1))) for i in range(n)]


def _glyph(rng: np.random.Generator, size: int) -> np.ndarray:
    """A pseudo-glyph: 3-7 strokes between points of a 5x5 grid."""
    cell = np.zeros((size, size), np.uint8)
    grid = np.linspace(size * 0.12, size * 0.88, 5)
    thick = max(2, size // 12)
    for _ in range(int(rng.integers(3, 8))):
        a, b = rng.integers(0, 5, 2), rng.integers(0, 5, 2)
        cv2.line(cell, (int(grid[a[0]]), int(grid[a[1]])),
                 (int(grid[b[0]]), int(grid[b[1]])), 255, thick, cv2.LINE_AA)
    return cell


def _art(rng: np.random.Generator, img: np.ndarray, box, density: float):
    """Line art and fills inside ``box``: curves, ellipses, hatching."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    n = int(density * w * h / 4000)
    for _ in range(n):
        kind = rng.integers(0, 4)
        shade = int(rng.integers(0, 160))
        if kind == 0:
            pts = np.stack([rng.integers(x0, x1, 6), rng.integers(y0, y1, 6)],
                           1).astype(np.int32)
            cv2.polylines(img, [pts], False, (shade,) * 3,
                          int(rng.integers(1, 5)), cv2.LINE_AA)
        elif kind == 1:
            c = (int(rng.integers(x0, x1)), int(rng.integers(y0, y1)))
            ax = (int(rng.integers(10, max(11, w // 4))),
                  int(rng.integers(10, max(11, h // 4))))
            cv2.ellipse(img, c, ax, float(rng.uniform(0, 180)), 0, 360,
                        (shade,) * 3, -1 if rng.random() < 0.3 else 2,
                        cv2.LINE_AA)
        elif kind == 2:
            xa = int(rng.integers(x0, x1))
            ya = int(rng.integers(y0, y1))
            span = int(rng.integers(20, 120))
            step = int(rng.integers(4, 10))
            for k in range(0, span, step):
                cv2.line(img, (xa + k, ya), (xa + k + span // 3, ya + span),
                         (shade,) * 3, 1, cv2.LINE_AA)
        else:
            xa, ya = int(rng.integers(x0, x1)), int(rng.integers(y0, y1))
            cv2.rectangle(img, (xa, ya), (min(x1, xa + int(rng.integers(
                20, 200))), min(y1, ya + int(rng.integers(20, 200)))),
                (shade,) * 3, -1)


def _screentone(img: np.ndarray, box, pitch: int, level: int):
    x0, y0, x1, y1 = box
    sub = img[y0:y1, x0:x1]
    yy, xx = np.mgrid[0:y1 - y0, 0:x1 - x0]
    dots = ((yy % pitch) < pitch // 2) & ((xx % pitch) < pitch // 2)
    sub[dots & (sub[..., 0] > 200)] = level


def _panels(rng: np.random.Generator, w: int, h: int, margin: int
            ) -> List[Tuple[int, int, int, int]]:
    """Panel boxes: 3-4 tiers, each split into 1-3 panels."""
    tiers = int(rng.integers(3, 5))
    ys = np.linspace(margin, h - margin, tiers + 1).astype(int)
    boxes = []
    for t in range(tiers):
        cols = int(rng.integers(1, 4))
        xs = [margin] + sorted(int(margin + f * (w - 2 * margin))
                               for f in rng.uniform(0.25, 0.75, cols - 1)) \
            + [w - margin]
        for c in range(cols):
            box = (xs[c] + 6, ys[t] + 6, xs[c + 1] - 6, ys[t + 1] - 6)
            if box[2] - box[0] > 40 and box[3] - box[1] > 40:
                boxes.append(box)
    return boxes


def make_chapter(traffic: dict, seed: int, scale: float = 1.0) -> List[Page]:
    """The chapter of ``traffic['chapter_pages']`` pages in the order
    ``seed`` draws. ``scale`` < 1 draws each page at full size and hands
    the program the page resized by it (a low-resolution scan); the boxes
    and strokes stay at full size."""
    n_pages = int(traffic['chapter_pages'])
    w, h = traffic['page']
    page_seed = int(traffic['page_seed'])
    lines_per_page = _spread(*traffic['lines_per_page'], n_pages)
    bubbles_per_page = _spread(*traffic['bubbles'], n_pages)
    kind = np.random.default_rng(page_seed).permutation(n_pages)
    order = np.random.default_rng(seed).permutation(n_pages)
    pages = []
    for i, k in enumerate(order):
        pages.append(_draw_page(traffic, i, lines_per_page[kind[k]],
                                bubbles_per_page[kind[k]], w, h,
                                np.random.default_rng([page_seed, int(k)]),
                                scale))
    return pages


def _draw_page(traffic: dict, index: int, n_lines: int, n_bubbles: int,
               w: int, h: int, rng: np.random.Generator,
               scale: float) -> Page:
    glyph = int(traffic['glyph_px'])
    gap = max(2, glyph // 6)
    img = np.full((h, w, 3), 250, np.uint8)
    strokes = np.zeros((h, w), np.uint8)
    margin = int(traffic['margin_px'])
    panels = _panels(rng, w, h, margin)
    for box in panels:
        if rng.random() < traffic['screentone_share']:
            _screentone(img, box, int(rng.integers(5, 9)),
                        int(rng.integers(120, 200)))
        _art(rng, img, box, float(traffic['art_density']))
        cv2.rectangle(img, box[:2], box[2:], (0, 0, 0), 5)

    # bubbles in cells of a grid, each cell at most one bubble
    cols, rows = traffic['bubble_grid']
    cell_w, cell_h = (w - 2 * margin) // cols, (h - 2 * margin) // rows
    cells = rng.permutation(cols * rows)[:n_bubbles]
    lo, hi = traffic['chars_per_line']
    # every page holds lines of every length in the range, evenly spread
    lengths = np.array(_spread(lo, hi, n_lines))
    rng.shuffle(lengths)
    # whole bubbles are set vertically, in the mix's share
    vert = np.zeros(n_bubbles, bool)
    vert[:int(round(traffic['vertical_share'] * n_bubbles))] = True
    rng.shuffle(vert)
    per_bubble = np.full(n_bubbles, n_lines // n_bubbles)
    per_bubble[:n_lines % n_bubbles] += 1

    boxes, verticals, chars, bubble_boxes = [], [], [], []
    li = 0
    for b, cell in enumerate(cells):
        cx0 = margin + (cell % cols) * cell_w
        cy0 = margin + (cell // cols) * cell_h
        idx = list(range(li, li + per_bubble[b]))
        li += per_bubble[b]
        is_vert = bool(vert[b])
        pitch = glyph + gap
        longest = int(lengths[idx].max()) * pitch
        n = len(idx)
        if is_vert:
            tw, th = n * (glyph + 2 * gap), longest
        else:
            tw, th = longest, n * (glyph + 2 * gap)
        tw = min(tw, cell_w - 40)
        th = min(th, cell_h - 40)
        tx0 = cx0 + 20 + int(rng.integers(0, max(1, cell_w - 40 - tw)))
        ty0 = cy0 + 20 + int(rng.integers(0, max(1, cell_h - 40 - th)))
        centre = (tx0 + tw // 2, ty0 + th // 2)
        axes = (int(tw * 0.62 + 24), int(th * 0.62 + 24))
        cv2.ellipse(img, centre, axes, 0, 0, 360, (255, 255, 255), -1,
                    cv2.LINE_AA)
        cv2.ellipse(img, centre, axes, 0, 0, 360, (0, 0, 0), 3, cv2.LINE_AA)
        bubble_boxes.append((centre[0] - axes[0], centre[1] - axes[1],
                             centre[0] + axes[0], centre[1] + axes[1]))
        for j, line in enumerate(idx):
            n_chars = int(lengths[line])
            # columns right to left, lines top to bottom
            if is_vert:
                x = tx0 + tw - (j + 1) * (glyph + 2 * gap) + gap
                y = ty0
                max_chars = max(1, th // pitch)
            else:
                x = tx0
                y = ty0 + j * (glyph + 2 * gap) + gap
                max_chars = max(1, tw // pitch)
            n_chars = min(n_chars, max_chars)
            for c in range(n_chars):
                g = _glyph(rng, glyph)
                gx, gy = (x, y + c * pitch) if is_vert else (x + c * pitch, y)
                region = strokes[gy:gy + glyph, gx:gx + glyph]
                np.maximum(region, g[:region.shape[0], :region.shape[1]],
                           out=region)
            span = n_chars * pitch - gap
            x1, y1 = (x + glyph, y + span) if is_vert else (x + span,
                                                            y + glyph)
            boxes.append((x, y, x1, y1))
            verticals.append(is_vert)
            chars.append(n_chars)
    ink = strokes > 0
    img[ink] = (img[ink].astype(np.int32) * (255 - strokes[ink, None])
                // 255).astype(np.uint8)
    out = img
    if scale != 1.0:
        out = cv2.resize(img, (int(round(w * scale)), int(round(h * scale))),
                         interpolation=cv2.INTER_AREA)
    return Page(index, np.ascontiguousarray(out), np.array(boxes, np.int64),
                np.array(verticals, bool), np.array(chars, np.int64),
                strokes, np.array(bubble_boxes, np.int64))


def _shrink(w: float, h: float, unclip: float) -> float:
    """The inset s at which DB's unclip (the box grown on every side by
    area * ratio / perimeter) gives back a w x h box."""
    lo, hi = 0.0, min(w, h) / 2 - 0.5
    for _ in range(40):
        s = (lo + hi) / 2
        iw, ih = w - 2 * s, h - 2 * s
        grow = iw * ih * unclip / (2 * (iw + ih))
        if grow > s:
            lo = s
        else:
            hi = s
    return (lo + hi) / 2


def detection_maps(page: Page, detect_size: int, pad_mult: int,
                   unclip_ratio: float, prob: float, mask: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(probability map (Hp, Wp), text mask (Hp/2, Wp/2)), uint8 scaled by
    255, at the DBNet canvas of a page of the strokes' size: the page
    resized so that its long side is ``detect_size`` and zero-padded to
    multiples of ``pad_mult``, as ``detection.default`` feeds the network.
    The probability map holds each line's box inset so that the DB
    postprocess's unclip gives the box back (value ``prob``); the mask holds
    the glyph strokes, dilated (value ``mask``)."""
    h, w = page.strokes.shape
    ratio = detect_size / max(h, w)
    th, tw = int(round(h * ratio)), int(round(w * ratio))
    hp, wp = th + (-th) % pad_mult, tw + (-tw) % pad_mult
    pmap = np.zeros((hp, wp), np.uint8)
    for x0, y0, x1, y1 in page.lines * ratio:
        s = _shrink(x1 - x0, y1 - y0, unclip_ratio)
        pts = np.array([[x0 + s, y0 + s], [x1 - s, y0 + s], [x1 - s, y1 - s],
                        [x0 + s, y1 - s]])
        cv2.fillPoly(pmap, [np.round(pts).astype(np.int32)],
                     int(round(prob * 255)))
    small = cv2.resize(page.strokes, (tw // 2, th // 2),
                       interpolation=cv2.INTER_AREA)
    small = cv2.dilate((small > 32).astype(np.uint8), np.ones((3, 3),
                                                              np.uint8))
    mmap = np.zeros((hp // 2, wp // 2), np.uint8)
    mmap[:th // 2, :tw // 2] = small * int(round(mask * 255))
    return pmap, mmap


def map_density(pmap: np.ndarray, threshold: float) -> float:
    """Share of the map's pixels above the detector's text threshold."""
    return float((pmap > threshold * 255).mean())
