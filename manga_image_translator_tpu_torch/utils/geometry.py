"""Host-side 2-D geometry for textline handling.

Behavioral contract follows the reference's ``manga_translator/utils/generic.py``
(BBox :294, sort_pnts :324, Quadrilateral :356-615, merge predicates :653-715),
re-implemented from scratch with numpy + OpenCV only (the reference additionally
uses shapely and a hand-rolled GJK solver; here convex-polygon distance/area are
computed directly, which is exact for quads).

These run on the host: textline geometry is full of data-dependent branching,
and a page's few dozen lines are too few to be worth a launch and a readback.
It is not cheap next to the device work: decided one pair at a time, the
textline merge predicate over a 24-40 line dialogue page cost about as much
host time as every kernel of the page together. So the two line graphs of a
page (the OCR's reading directions and the textline merge) decide it for all
pairs at once (``merge_graph_edges``), and every polygon distance, batched or
single, is the same array arithmetic (``_pair_distances``).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

from .profiling import count

__all__ = [
    "BBox",
    "Quadrilateral",
    "sort_points",
    "convex_area",
    "convex_polygon_distance",
    "point_segment_distance",
    "can_merge_textline",
    "merge_graph_edges",
    "can_merge_region_coarse",
]

# pairs ``merge_graph_edges`` screens at once, in (rows, N) arrays of at
# most 128 KiB, and pairs it measures at once, in (4, 1024, 4, 4) float64
# temporaries of 512 KiB
_PAIRS_PER_BLOCK = 16384
_DISTANCES_PER_CALL = 1024
# px a pair's bounding-box gap may exceed its distance limit and still be
# decided in full: the gap is a lower bound of the polygon distance, and
# this covers the rounding of either side
_CULL_SLACK = 1e-6


# --------------------------------------------------------------------------
# Primitive helpers
# --------------------------------------------------------------------------

def point_segment_distance(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    """Distance from point ``p`` to segment ``ab``."""
    p = np.asarray(p, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ab = b - a
    denom = float(ab @ ab)
    if denom == 0.0:
        return float(np.linalg.norm(p - a))
    t = float(np.clip((p - a) @ ab / denom, 0.0, 1.0))
    return float(np.linalg.norm(p - (a + t * ab)))


def _hull(points: np.ndarray) -> np.ndarray:
    """Convex hull vertices (CCW) of an (N,2) float array."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 1, 2)
    return cv2.convexHull(pts).reshape(-1, 2).astype(np.float64)


def convex_area(points: np.ndarray) -> float:
    """Area of the convex hull of a point set."""
    h = _hull(points)
    if len(h) < 3:
        return 0.0
    return float(cv2.contourArea(h.astype(np.float32)))


def _padded_hull(points: np.ndarray) -> np.ndarray:
    """``_hull(points)`` with its last vertex repeated up to 4 vertices, so
    that every quad's hull has the shape (4, 2). A repeated vertex adds an
    edge of length 0, which changes no distance and no containment."""
    h = _hull(points)
    if len(h) < 4:
        h = np.concatenate([h, np.repeat(h[-1:], 4 - len(h), axis=0)])
    return h


def _contains_first_vertex(hull: np.ndarray, other: np.ndarray) -> np.ndarray:
    """Whether ``hull[k]`` holds ``other[k, 0]`` or has it on its boundary,
    for (P, V, 2) hulls: ``cv2.pointPolygonTest(hull, pt, False) >= 0``
    computed as OpenCV computes it (an even-odd crossing count with float32
    differences and float64 products), for all P at once."""
    h = hull.astype(np.float32)
    vx, vy = h[..., 0], h[..., 1]                        # edge ends
    v0x, v0y = np.roll(vx, 1, axis=1), np.roll(vy, 1, axis=1)  # edge starts
    p = other[:, 0].astype(np.float32)
    px, py = p[:, :1], p[:, 1:]
    skip = (((v0y <= py) & (vy <= py)) | ((v0y > py) & (vy > py))
            | ((v0x < px) & (vx < px)))
    on_skipped = skip & (py == vy) & (
        (px == vx) | ((py == v0y) & (((v0x <= px) & (px <= vx))
                                     | ((vx <= px) & (px <= v0x)))))
    f64 = np.float64
    cross = ((py - v0y).astype(f64) * (vx - v0x).astype(f64)
             - (px - v0x).astype(f64) * (vy - v0y).astype(f64))
    on_edge = ~skip & (cross == 0)
    crossings = (~skip & (np.where(vy < v0y, -cross, cross) > 0)).sum(axis=1)
    return (on_skipped | on_edge).any(axis=1) | (crossings % 2 == 1)


def _pair_distances(ha: np.ndarray, hb: np.ndarray) -> np.ndarray:
    """Distances between the convex polygons ``ha[k]`` and ``hb[k]``, (P, V,
    2) and (P, W, 2) float64 hulls (``_padded_hull``), 0 where they overlap.

    Exact for convex sets: 0 where one holds the other's first vertex or
    two edges cross, else the least distance from an edge's end to an edge
    of the other polygon. Each pair's number comes from its own elements by
    the same operations whatever P is, so a batch reads what single calls
    read, to the bit. Replaces shapely's ``Polygon.distance`` and the
    reference's GJK solver (generic.py:723-828)."""
    n = len(ha)
    a0, a1, b0, b1 = np.broadcast_arrays(
        ha[:, :, None], np.roll(ha, -1, axis=1)[:, :, None],
        hb[:, None], np.roll(hb, -1, axis=1)[:, None])   # (P, V, W, 2) each
    # each edge pair four ways: the end of one edge against the other edge
    p = np.stack([b0, b1, a0, a1])
    s0 = np.stack([a0, a0, b0, b0])
    s1 = np.stack([a1, a1, b1, b1])
    px, py = p[..., 0], p[..., 1]
    ax, ay, bx, by = s0[..., 0], s0[..., 1], s1[..., 0], s1[..., 1]
    # the side of the edge's line that the end lies on: -1, 0 or 1
    abx, aby = bx - ax, by - ay
    side = abx * (py - ay) - aby * (px - ax)
    side = np.where(np.abs(side) < 1e-12, 0.0, np.sign(side))
    crossed = (side[0] != side[1]) & (side[2] != side[3])
    # the distance from the end to the edge (to its start where it has
    # length 0)
    denom = abx * abx + aby * aby
    t = np.divide((px - ax) * abx + (py - ay) * aby, denom,
                  out=np.zeros_like(denom), where=denom > 0)
    t = np.clip(t, 0.0, 1.0)
    dx, dy = px - (ax + t * abx), py - (ay + t * aby)
    d = np.sqrt(dx * dx + dy * dy).min(axis=0)
    d = np.where(crossed, 0.0, d).min(axis=(1, 2))
    inside = _contains_first_vertex(np.concatenate([hb, ha]),
                                    np.concatenate([ha, hb]))
    return np.where(inside[:n] | inside[n:], 0.0, d)


def convex_polygon_distance(pts_a: np.ndarray, pts_b: np.ndarray) -> float:
    """Minimum distance between the convex hulls of two point sets (0 when
    they overlap): ``_pair_distances`` of one pair."""
    return float(_pair_distances(_padded_hull(pts_a)[None],
                                 _padded_hull(pts_b)[None])[0])


def sort_points(pts: np.ndarray) -> Tuple[np.ndarray, bool]:
    """Canonicalize 4 corner points to (tl, tr, br, bl) order.

    The dominant (long-side) direction of the quad decides whether the line is
    vertical; matches reference ``sort_pnts`` (generic.py:324-353) so box
    orientation decisions are bit-identical.
    """
    pts = np.asarray(pts)
    assert pts.shape == (4, 2), pts.shape
    pairwise = (pts[:, None, :] - pts[None, :, :]).reshape(16, 2).astype(np.float64)
    norms = np.linalg.norm(pairwise, axis=1)
    # indices 8 and 10 in the sorted order pick the two long sides
    long_ids = np.argsort(norms, kind="stable")[[8, 10]]
    v = pairwise[long_ids]
    if float(v[0] @ v[1]) < 0:
        v[0] = -v[0]
    struc = np.abs(v.mean(axis=0))
    is_vertical = bool(struc[0] <= struc[1])

    if is_vertical:
        pts = pts[np.argsort(pts[:, 1], kind="stable")]
        order = [*np.argsort(pts[:2, 0], kind="stable"),
                 *(np.argsort(pts[2:, 0], kind="stable")[::-1] + 2)]
        return pts[order], True
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    out = np.zeros_like(pts)
    left = pts[[0, 1]][np.argsort(pts[[0, 1]][:, 1], kind="stable")]
    right = pts[[2, 3]][np.argsort(pts[[2, 3]][:, 1], kind="stable")]
    out[0], out[3] = left[0], left[1]
    out[1], out[2] = right[0], right[1]
    return out, False


# --------------------------------------------------------------------------
# BBox / Quadrilateral
# --------------------------------------------------------------------------

class BBox:
    """Axis-aligned box with OCR payload (reference generic.py:294-321)."""

    def __init__(self, x, y, w, h, text: str = '', prob: float = 1.0,
                 fg_r=0, fg_g=0, fg_b=0, bg_r=0, bg_g=0, bg_b=0):
        self.x, self.y, self.w, self.h = x, y, w, h
        self.text, self.prob = text, prob
        self.fg_r, self.fg_g, self.fg_b = fg_r, fg_g, fg_b
        self.bg_r, self.bg_g, self.bg_b = bg_r, bg_g, bg_b

    def width(self):
        return self.w

    def height(self):
        return self.h

    def to_points(self):
        return (np.array([self.x, self.y]),
                np.array([self.x + self.w, self.y]),
                np.array([self.x + self.w, self.y + self.h]),
                np.array([self.x, self.y + self.h]))

    @property
    def xywh(self):
        return np.array([self.x, self.y, self.w, self.h], dtype=np.int32)


class Quadrilateral:
    """A single detected textline: 4 corner points + OCR text/colors.

    Mirrors reference ``Quadrilateral`` (generic.py:356-615) in behavior; all
    derived quantities are recomputed here from first principles.
    """

    def __init__(self, pts: np.ndarray, text: str = '', prob: float = 1.0,
                 fg_r=0, fg_g=0, fg_b=0, bg_r=0, bg_g=0, bg_b=0):
        self.pts, is_vertical = sort_points(np.asarray(pts))
        self.direction = 'v' if is_vertical else 'h'
        self.text = text
        self.prob = prob
        self.fg_r, self.fg_g, self.fg_b = fg_r, fg_g, fg_b
        self.bg_r, self.bg_g, self.bg_b = bg_r, bg_g, bg_b
        self.assigned_direction: Optional[str] = None
        self.textlines: List["Quadrilateral"] = []

    # -- structure vectors --------------------------------------------------
    @functools.cached_property
    def structure(self) -> List[np.ndarray]:
        p = self.pts
        return [((p[0] + p[1]) / 2).astype(int), ((p[2] + p[3]) / 2).astype(int),
                ((p[1] + p[2]) / 2).astype(int), ((p[3] + p[0]) / 2).astype(int)]

    def _axes(self):
        l1a, l1b, l2a, l2b = [a.astype(np.float64) for a in self.structure]
        return l1b - l1a, l2b - l2a  # (vertical-ish axis, horizontal-ish axis)

    @functools.cached_property
    def valid(self) -> bool:
        v1, v2 = self._axes()
        n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
        if n1 == 0 or n2 == 0:
            return False
        angle = np.degrees(np.arccos(np.clip(v1 @ v2 / (n1 * n2), -1, 1)))
        return abs(angle - 90) < 10

    @property
    def fg_colors(self):
        return np.array([self.fg_r, self.fg_g, self.fg_b])

    @property
    def bg_colors(self):
        return np.array([self.bg_r, self.bg_g, self.bg_b])

    @functools.cached_property
    def aspect_ratio(self) -> float:
        v1, v2 = self._axes()
        return float(np.linalg.norm(v2) / max(np.linalg.norm(v1), 1e-9))

    @functools.cached_property
    def font_size(self) -> float:
        v1, v2 = self._axes()
        return float(min(np.linalg.norm(v1), np.linalg.norm(v2)))

    def width(self) -> int:
        return self.aabb.w

    def height(self) -> int:
        return self.aabb.h

    @functools.cached_property
    def xyxy(self):
        b = self.aabb
        return b.x, b.y, b.x + b.w, b.y + b.h

    def clip(self, width, height):
        self.pts[:, 0] = np.clip(np.round(self.pts[:, 0]), 0, width)
        self.pts[:, 1] = np.clip(np.round(self.pts[:, 1]), 0, height)

    @functools.cached_property
    def aabb(self) -> BBox:
        lo = self.pts.min(axis=0)
        hi = self.pts.max(axis=0)
        return BBox(lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1], self.text,
                    self.prob, self.fg_r, self.fg_g, self.fg_b,
                    self.bg_r, self.bg_g, self.bg_b)

    @functools.cached_property
    def hull(self) -> np.ndarray:
        """The convex hull of the corners, (4, 2) float64 (``_padded_hull``)."""
        return _padded_hull(self.pts)

    @functools.cached_property
    def centroid(self) -> np.ndarray:
        return self.pts.mean(axis=0)

    @functools.cached_property
    def area(self) -> float:
        return convex_area(self.pts)

    @functools.cached_property
    def angle(self) -> float:
        v1, _ = self._axes()
        u = v1 / max(np.linalg.norm(v1), 1e-9)
        return float(np.fmod(np.arccos(np.clip(u[0], -1, 1)) + np.pi, np.pi))

    @functools.cached_property
    def is_axis_aligned(self) -> bool:
        v1, _ = self._axes()
        u = v1 / max(np.linalg.norm(v1), 1e-9)
        return abs(u @ [0, 1]) < 1e-2 or abs(u @ [1, 0]) < 1e-2

    @functools.cached_property
    def is_approximate_axis_aligned(self) -> bool:
        v1, v2 = self._axes()
        u1 = v1 / max(np.linalg.norm(v1), 1e-9)
        u2 = v2 / max(np.linalg.norm(v2), 1e-9)
        return (abs(u1 @ [0, 1]) < 0.05 or abs(u1 @ [1, 0]) < 0.05
                or abs(u2 @ [0, 1]) < 0.05 or abs(u2 @ [1, 0]) < 0.05)

    def distance_to_point(self, p: np.ndarray) -> float:
        best = np.inf
        for i in range(4):
            best = min(best, point_segment_distance(p, self.pts[i], self.pts[(i + 1) % 4]))
        return best

    def poly_distance(self, other: "Quadrilateral") -> float:
        return float(_pair_distances(self.hull[None], other.hull[None])[0])

    # -- perspective crop ----------------------------------------------------
    def get_transformed_region(self, img: np.ndarray, direction: str,
                               textheight: int) -> np.ndarray:
        """Perspective-rectify this quad out of ``img`` to a fixed text height.

        Vertical lines are rotated CCW so the output always reads left→right
        (reference generic.py:445-481).
        """
        v1, v2 = self._axes()
        ratio = max(np.linalg.norm(v1), 1e-6) / max(np.linalg.norm(v2), 1e-6)

        src = self.pts.astype(np.int64).copy()
        im_h, im_w = img.shape[:2]
        x1 = int(np.clip(src[:, 0].min(), 0, im_w))
        y1 = int(np.clip(src[:, 1].min(), 0, im_h))
        x2 = int(np.clip(src[:, 0].max(), 0, im_w))
        y2 = int(np.clip(src[:, 1].max(), 0, im_h))
        crop = img[y1:y2, x1:x2]
        src = src - np.array([x1, y1])

        self.assigned_direction = direction
        if direction == 'h':
            h = max(int(textheight), 2)
            w = max(int(round(textheight / ratio)), 2)
        else:
            w = max(int(textheight), 2)
            h = max(int(round(textheight * ratio)), 2)
        if crop.size == 0:  # degenerate quad fully outside the image
            out = np.zeros((h, w) + img.shape[2:], dtype=img.dtype)
            if direction == 'v':
                out = np.swapaxes(out, 0, 1)
            return out
        dst = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                       dtype=np.float32)
        M = cv2.getPerspectiveTransform(src.astype(np.float32), dst)
        region = cv2.warpPerspective(crop, M, (w, h))
        if direction == 'v':
            region = cv2.rotate(region, cv2.ROTATE_90_COUNTERCLOCKWISE)
        return region

    # -- pairwise distance used by line sorting ------------------------------
    def distance(self, other: "Quadrilateral", rho: float = 0.5) -> float:
        """Reading-flow distance between two lines of the same region
        (reference generic.py:545-597): pick an alignment pattern (left/right/
        middle edge for horizontal, top/bottom for vertical) by comparing
        swept-area gaps, then return the distance between the aligned corners.
        """
        fs = max(self.font_size, other.font_size)
        if self.assigned_direction == 'h':
            d1 = convex_area(np.stack([self.pts[0], self.pts[3],
                                       other.pts[0], other.pts[3]])) / fs
            d2 = convex_area(np.stack([self.pts[2], self.pts[1],
                                       other.pts[2], other.pts[1]])) / fs
            d3 = convex_area(np.stack([self.structure[0], self.structure[1],
                                       other.structure[0], other.structure[1]])) / fs
            pattern = 'h_left'
            if d2 < fs * rho and d2 < d1:
                pattern = 'h_right'
            if d3 < fs * rho and d3 < d1 and d3 < d2:
                pattern = 'h_middle'
            if pattern == 'h_left':
                return float(np.linalg.norm(self.pts[0] - other.pts[0]))
            if pattern == 'h_right':
                return float(np.linalg.norm(self.pts[1] - other.pts[1]))
            return float(np.linalg.norm(
                np.asarray(self.structure[0], np.float64)
                - np.asarray(other.structure[0], np.float64)))
        d1 = convex_area(np.stack([self.pts[0], self.pts[1],
                                   other.pts[0], other.pts[1]])) / fs
        d2 = convex_area(np.stack([self.pts[2], self.pts[3],
                                   other.pts[2], other.pts[3]])) / fs
        pattern = 'v_top'
        if d2 < fs * rho and d2 < d1:
            pattern = 'v_bottom'
        if pattern == 'v_top':
            return float(np.linalg.norm(self.pts[0] - other.pts[0]))
        return float(np.linalg.norm(self.pts[2] - other.pts[2]))

    def copy(self, new_pts: np.ndarray) -> "Quadrilateral":
        return Quadrilateral(new_pts, self.text, self.prob,
                             *self.fg_colors, *self.bg_colors)

    def __repr__(self):
        return f'Quadrilateral({self.pts.tolist()}, {self.text!r}, {self.prob:.3f})'


# --------------------------------------------------------------------------
# Merge predicates (reference generic.py:653-715)
# --------------------------------------------------------------------------

def can_merge_textline(a: Quadrilateral, b: Quadrilateral, ratio: float = 1.9,
                       discard_connection_gap: float = 2,
                       char_gap_tolerance: float = 0.6,
                       char_gap_tolerance2: float = 1.5,
                       font_size_ratio_tol: float = 1.5,
                       aspect_ratio_tol: float = 2) -> bool:
    """Decide if two textlines belong to the same region."""
    char_size = min(a.font_size, b.font_size)
    if char_size <= 0:
        return False
    dist = a.poly_distance(b)
    if dist > discard_connection_gap * char_size:
        return False
    if max(a.font_size, b.font_size) / char_size > font_size_ratio_tol:
        return False
    if a.aspect_ratio > aspect_ratio_tol and b.aspect_ratio < 1.0 / aspect_ratio_tol:
        return False
    if b.aspect_ratio > aspect_ratio_tol and a.aspect_ratio < 1.0 / aspect_ratio_tol:
        return False
    ba, bb = a.aabb, b.aabb
    x1, y1, w1, h1 = ba.x, ba.y, ba.w, ba.h
    x2, y2, w2, h2 = bb.x, bb.y, bb.w, bb.h
    if a.is_approximate_axis_aligned and b.is_approximate_axis_aligned:
        if dist >= char_size * char_gap_tolerance:
            return False
        if abs(x1 + w1 // 2 - (x2 + w2 // 2)) < char_gap_tolerance2:
            return True
        if w1 > h1 * ratio and h2 > w2 * ratio:
            return False
        if w2 > h2 * ratio and h1 > w1 * ratio:
            return False
        if w1 > h1 * ratio or w2 > h2 * ratio:  # horizontal lines
            return (abs(x1 - x2) < char_size * char_gap_tolerance2
                    or abs(x1 + w1 - (x2 + w2)) < char_size * char_gap_tolerance2)
        if h1 > w1 * ratio or h2 > w2 * ratio:  # vertical lines
            return (abs(y1 - y2) < char_size * char_gap_tolerance2
                    or abs(y1 + h1 - (y2 + h2)) < char_size * char_gap_tolerance2)
        return False
    if abs(a.angle - b.angle) < 15 * np.pi / 180:
        fs = min(a.font_size, b.font_size)
        if a.poly_distance(b) > fs * char_gap_tolerance2:
            return False
        if abs(a.font_size - b.font_size) / fs > 0.25:
            return False
        return True
    return False


def merge_graph_edges(quads: Sequence[Quadrilateral], ratio: float = 1.9,
                      discard_connection_gap: float = 2,
                      char_gap_tolerance: float = 0.6,
                      char_gap_tolerance2: float = 1.5,
                      font_size_ratio_tol: float = 1.5,
                      aspect_ratio_tol: float = 2) -> List[Tuple[int, int]]:
    """The pairs ``(u, v)``, ``u < v``, in ``itertools.combinations`` order,
    for which ``can_merge_textline(quads[u], quads[v], ...)`` holds, decided
    for all pairs at once.

    Each quad's font size, aspect ratio, angle, alignment, box and hull are
    read once. Each block of rows screens its pairs with every test that
    needs no distance, and with the bounding-box gap of the two hulls (a
    lower bound of their distance) against the pair's distance limit; the
    pairs left get their polygon distances (``_pair_distances``) and the
    rest of the predicate, branch for branch, as arrays. Corners are taken
    as integers or float64. Counts the pairs decided in ``geom.pairs``."""
    n = len(quads)
    count('geom.pairs', n * (n - 1) // 2)
    if n < 2:
        return []
    fs = np.array([q.font_size for q in quads], np.float64)
    ar = np.array([q.aspect_ratio for q in quads], np.float64)
    angle = np.array([q.angle for q in quads], np.float64)
    aligned = np.array([q.is_approximate_axis_aligned for q in quads], bool)
    box = np.array([(q.aabb.x, q.aabb.y, q.aabb.w, q.aabb.h) for q in quads],
                   np.float64)
    hulls = np.stack([q.hull for q in quads])
    lo, hi = hulls.min(axis=1), hulls.max(axis=1)
    # the distance a pair may not pass: the first test's, or its branch's
    aligned_limit = min(discard_connection_gap, char_gap_tolerance)
    rotated_limit = min(discard_connection_gap, char_gap_tolerance2)
    inv_tol = 1.0 / aspect_ratio_tol
    near_angle = 15 * np.pi / 180

    edges: List[Tuple[int, int]] = []
    rows = max(1, _PAIRS_PER_BLOCK // n)
    cols = np.arange(n)
    for r0 in range(0, n - 1, rows):
        r = np.arange(r0, min(r0 + rows, n - 1))[:, None]
        cs = np.minimum(fs[r], fs)
        both = aligned[r] & aligned
        gap = np.maximum(np.maximum(lo[None] - hi[r], lo[r] - hi[None]),
                         0.0).max(axis=2)
        with np.errstate(divide='ignore', invalid='ignore'):
            keep = ((cols > r) & (cs > 0)
                    & ~(np.maximum(fs[r], fs) / cs > font_size_ratio_tol)
                    & ~((ar[r] > aspect_ratio_tol) & (ar < inv_tol))
                    & ~((ar > aspect_ratio_tol) & (ar[r] < inv_tol))
                    & (both | (np.abs(angle[r] - angle) < near_angle))
                    & (gap <= cs * np.where(both, aligned_limit,
                                            rotated_limit) + _CULL_SLACK))
        u, v = np.nonzero(keep)
        if len(u) == 0:
            continue
        u += r0
        cs, both = cs[u - r0, v], both[u - r0, v]
        dist = np.concatenate([
            _pair_distances(hulls[u[i:i + _DISTANCES_PER_CALL]],
                            hulls[v[i:i + _DISTANCES_PER_CALL]])
            for i in range(0, len(u), _DISTANCES_PER_CALL)])
        x1, y1, w1, h1 = box[u].T
        x2, y2, w2, h2 = box[v].T
        tol2 = cs * char_gap_tolerance2
        wide1, wide2 = w1 > h1 * ratio, w2 > h2 * ratio
        tall1, tall2 = h1 > w1 * ratio, h2 > w2 * ratio
        same_x = (np.abs(x1 - x2) < tol2) | (np.abs(x1 + w1 - (x2 + w2)) < tol2)
        same_y = (np.abs(y1 - y2) < tol2) | (np.abs(y1 + h1 - (y2 + h2)) < tol2)
        aligned_ok = ~(dist >= cs * char_gap_tolerance) & (
            (np.abs(x1 + w1 // 2 - (x2 + w2 // 2)) < char_gap_tolerance2)
            | (~(wide1 & tall2) & ~(wide2 & tall1)
               & np.where(wide1 | wide2, same_x, (tall1 | tall2) & same_y)))
        rotated_ok = (~(dist > tol2)
                      & ~(np.abs(fs[u] - fs[v]) / cs > 0.25))
        ok = (~(dist > discard_connection_gap * cs)
              & np.where(both, aligned_ok, rotated_ok))
        edges.extend(zip(u[ok].tolist(), v[ok].tolist()))
    return edges


def can_merge_region_coarse(a: Quadrilateral, b: Quadrilateral,
                            discard_connection_gap: float = 2,
                            font_size_ratio_tol: float = 0.7) -> bool:
    if a.assigned_direction != b.assigned_direction:
        return False
    if abs(a.angle - b.angle) > 15 * np.pi / 180:
        return False
    fs_a, fs_b = a.font_size, b.font_size
    fs = min(fs_a, fs_b)
    if fs <= 0 or abs(fs_a - fs_b) / fs > font_size_ratio_tol:
        return False
    if a.poly_distance(b) > discard_connection_gap * max(fs_a, fs_b):
        return False
    return True
