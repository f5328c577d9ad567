"""PyTorch port, the batched textline merge predicate
(``utils/geometry.merge_graph_edges``) and the one polygon distance every
caller reads (``_pair_distances``).

``merge_graph_edges`` must give exactly the pairs that the scalar
``can_merge_textline`` accepts, in ``itertools.combinations`` order, under
the three tolerance sets the port uses (the default, the OCR's reading
directions, the textline merge), on: the benchmark's own chapters
(``benchmark/pages.make_chapter``) at integer corners, the same lines
jittered and turned a little, random turned quads, degenerate quads,
nested, touching and overlapping quads, and a 300-line layout. The
polygon distance keeps to the formula it replaces (an edge-pair loop with
``cv2.pointPolygonTest``), written out here, within 1e-9; a batch reads
what single pairs read, to the bit. The OCR's directions and the merged
regions read as with a pairwise loop over ``can_merge_textline``, and the
merged regions equal the JAX package's."""
import asyncio
import functools
import itertools
import json
import os

import cv2
import numpy as np
import pytest

from manga_image_translator_tpu.textline_merge import dispatch as jax_dispatch
from manga_image_translator_tpu.utils.geometry import \
    Quadrilateral as JaxQuadrilateral
from manga_image_translator_tpu_torch import textline_merge
from manga_image_translator_tpu_torch.config import Ocr
from manga_image_translator_tpu_torch.ocr import common as ocr_common
from manga_image_translator_tpu_torch.ocr import get_ocr
from manga_image_translator_tpu_torch.utils import geometry
from manga_image_translator_tpu_torch.utils.geometry import (
    Quadrilateral,
    can_merge_textline,
    merge_graph_edges,
)

from benchmark import pages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOLERANCES = {
    'default': {},
    'ocr': {'aspect_ratio_tol': 1},
    'merge': textline_merge.MERGE_TOLERANCES,
}


def box(x, y, w, h):
    return np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])


def turned(cx, cy, w, h, degrees):
    a = np.deg2rad(degrees)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
    return corners @ rot.T + [cx, cy]


@functools.lru_cache(maxsize=None)
def chapter(traffic: str):
    with open(os.path.join(ROOT, 'benchmark', 'traffic',
                           f'{traffic}.json')) as f:
        mix = json.load(f)
    return [page.lines for page in pages.make_chapter(mix, 0)]


def from_boxes(lines):
    return [box(x0, y0, x1 - x0, y1 - y0) for x0, y0, x1, y1 in lines]


def jittered(seed=0):
    """A dialogue page's lines moved up to 2 px a corner and turned up to
    3 degrees about their centres (float64 corners)."""
    rng = np.random.default_rng(seed)
    out = []
    for x0, y0, x1, y1 in chapter('text_heavy')[0]:
        pts = turned((x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0,
                     rng.uniform(-3, 3))
        out.append(pts + rng.uniform(-2, 2, (4, 2)))
    return out


def random_turned(seed=1, n=70):
    """Lines of 10-40 px glyphs, 2-12 glyphs long, at any angle, packed
    in a 900 px square so that many pairs are near."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = rng.uniform(10, 40)
        long = g * rng.integers(2, 12)
        w, h = (g, long) if rng.random() < 0.5 else (long, g)
        pts = turned(*rng.uniform(0, 900, 2), w, h, rng.uniform(-180, 180))
        out.append(np.round(pts) if rng.random() < 0.3 else pts)
    return out


def degenerate():
    """Zero-size, zero-width and collinear quads, hulls of 1, 2 and 3
    vertices, beside ordinary lines they could merge with."""
    return [
        box(100, 100, 0, 0),                                  # a point
        box(100, 100, 0, 60),                                 # zero width
        box(104, 100, 20, 0),                                 # zero height
        np.array([[0, 0], [10, 0], [20, 0], [30, 0]]),        # collinear
        np.array([[0, 30], [12, 42], [24, 54], [40, 70]]),    # collinear
        np.array([[0.0, 80], [15.5, 80], [31, 80], [31, 80]]),
        np.array([[50, 0], [80, 0], [80, 30], [80, 30]]),     # 3 vertices
        np.array([[50, 40], [90, 40], [70, 70], [70, 50]]),   # 3 vertices
        np.array([[40, 60], [90, 60], [90, 60], [40, 60]]),   # 2 vertices
        box(60, 100, 1, 80),                                  # 1 px wide
        box(62, 100, 20, 80),
        box(84, 100, 20, 80),
        box(30, 0, 20, 20),
        box(30, 0, 20, 20),                                   # duplicate
        box(0, 90, 30, 10),
    ]


def nested():
    """Lines inside lines, lines sharing an edge or a corner, overlapping
    lines, at integer and float corners."""
    return [
        box(0, 0, 40, 200),
        box(10, 20, 20, 100),              # inside the first
        box(40, 0, 40, 200),               # shares an edge
        box(80, 200, 40, 200),             # shares a corner
        box(110, 180, 40, 200),            # overlaps the last
        box(300, 0, 200, 40),
        box(300, 40, 200, 40),             # shares an edge
        box(320.5, 75.25, 150, 40),        # overlaps
        turned(400, 300, 40, 200, 45),
        turned(400, 300, 20, 100, 45),     # nested, turned
        turned(430, 330, 40, 200, 45),     # overlapping, turned
        box(600, 0, 40, 40),
        box(601, 1, 38, 38),               # nested square
        box(640, 0, 40, 40),
    ]


def near_limits():
    """Pairs of long lines turned 10 degrees, side by side, whose angles
    differ by a little less or more than the predicate's 15 degrees, and
    whose glyph sizes differ by a little less or more than its 25%."""
    out = []
    for i, (turn, size) in enumerate(itertools.product(
            (0.0, 14.9, 15.1, 30.0), (1.0, 1.24, 1.26))):
        cx, cy = 1500 + (i % 4) * 3000, 1500 + (i // 4) * 3000
        out.append(turned(cx, cy, 100, 2000, 10))
        out.append(turned(cx + 110 * size, cy, 100 * size, 2000, 10 + turn))
    return out


def layout_300(seed=2):
    """300 lines in 30 bubbles of 10 columns or rows on a 4000x6000 page,
    some turned, as a long strip of pages would give."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(30):
        bx, by = 200 + (b % 5) * 760, 200 + (b // 5) * 950
        g = int(rng.integers(18, 30))
        angle = rng.uniform(-10, 10) if b % 4 == 0 else 0.0
        vertical = rng.random() < 0.7
        for j in range(10):
            n = int(rng.integers(2, 16))
            if vertical:
                cx, cy, w, h = bx + 600 - j * (g + 6), by + n * g / 2, g, n * g
            else:
                cx, cy, w, h = bx + n * g / 2, by + j * (g + 6), n * g, g
            pts = turned(cx, cy, w, h, angle)
            out.append(np.round(pts) if angle == 0 else pts)
    return out


CASES = {
    'text_heavy_0': lambda: from_boxes(chapter('text_heavy')[0]),
    'text_heavy_4': lambda: from_boxes(chapter('text_heavy')[4]),
    'text_heavy_7': lambda: from_boxes(chapter('text_heavy')[7]),
    'art_heavy': lambda: from_boxes(np.concatenate(chapter('art_heavy'))),
    'jittered': jittered,
    'random_turned': random_turned,
    'degenerate': degenerate,
    'nested': nested,
    'near_limits': near_limits,
    'layout_300': layout_300,
}


def quads(case):
    return [Quadrilateral(np.asarray(pts)) for pts in CASES[case]()]


@functools.lru_cache(maxsize=None)
def scalar_edges(case):
    """{tolerance set: the pairs ``can_merge_textline`` accepts, one call
    a pair}. A pair's polygon distance is the same under every tolerance
    set, so it is computed once a pair here."""
    qs = quads(case)
    real = Quadrilateral.poly_distance
    memo = {}

    def poly_distance(a, b):
        key = (id(a), id(b))
        if key not in memo:
            memo[key] = real(a, b)
        return memo[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(Quadrilateral, 'poly_distance', poly_distance)
    try:
        return qs, {name: [(u, v) for u, v in
                           itertools.combinations(range(len(qs)), 2)
                           if can_merge_textline(qs[u], qs[v], **tol)]
                    for name, tol in TOLERANCES.items()}
    finally:
        mp.undo()


def pairwise_edges(bboxes, **tol):
    return [(u, v) for u, v in itertools.combinations(range(len(bboxes)), 2)
            if can_merge_textline(bboxes[u], bboxes[v], **tol)]


@pytest.mark.parametrize('tol', list(TOLERANCES))
@pytest.mark.parametrize('case', list(CASES))
def test_edges_equal_scalar_predicate(case, tol):
    qs, expected = scalar_edges(case)
    assert merge_graph_edges(qs, **TOLERANCES[tol]) == expected[tol]


def test_cases_reach_every_branch():
    """The cases hold accepted and refused pairs in both branches of the
    predicate (both lines axis-aligned, or turned alike)."""
    accepted = {True: 0, False: 0}
    for case in CASES:
        qs, expected = scalar_edges(case)
        for u, v in expected['merge']:
            both = (qs[u].is_approximate_axis_aligned
                    and qs[v].is_approximate_axis_aligned)
            accepted[bool(both)] += 1
    assert accepted[True] > 100 and accepted[False] > 10


@pytest.mark.parametrize('case', ['random_turned', 'layout_300'])
def test_block_size_changes_nothing(case, monkeypatch):
    qs = quads(case)
    whole = {name: merge_graph_edges(qs, **tol)
             for name, tol in TOLERANCES.items()}
    monkeypatch.setattr(geometry, '_PAIRS_PER_BLOCK', 7)
    monkeypatch.setattr(geometry, '_DISTANCES_PER_CALL', 5)
    assert {name: merge_graph_edges(qs, **tol)
            for name, tol in TOLERANCES.items()} == whole


def test_no_pairs():
    assert merge_graph_edges([]) == []
    assert merge_graph_edges(quads('nested')[:1]) == []


# -- the polygon distance ---------------------------------------------------

def old_point_segment(p, a, b):
    ab = b - a
    denom = float(ab @ ab)
    if denom == 0.0:
        return float(np.linalg.norm(p - a))
    t = float(np.clip((p - a) @ ab / denom, 0.0, 1.0))
    return float(np.linalg.norm(p - (a + t * ab)))


def old_segment_distance(a0, a1, b0, b1):
    def orient(p, q, r):
        v = (q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)
    if (orient(a0, a1, b0) != orient(a0, a1, b1)
            and orient(b0, b1, a0) != orient(b0, b1, a1)):
        return 0.0
    return min(old_point_segment(a0, b0, b1), old_point_segment(a1, b0, b1),
               old_point_segment(b0, a0, a1), old_point_segment(b1, a0, a1))


def old_polygon_distance(pts_a, pts_b):
    """The scalar formula the batched one replaces: hulls, two
    ``cv2.pointPolygonTest`` calls, every edge pair in a loop."""
    def hull(pts):
        return cv2.convexHull(np.asarray(pts, np.float32).reshape(-1, 1, 2)
                              ).reshape(-1, 2).astype(np.float64)

    def inside(p, h):
        return cv2.pointPolygonTest(h.astype(np.float32),
                                    (float(p[0]), float(p[1])), False) >= 0
    ha, hb = hull(pts_a), hull(pts_b)
    if inside(ha[0], hb) or inside(hb[0], ha):
        return 0.0
    na, nb = len(ha), len(hb)
    return min(old_segment_distance(ha[i], ha[(i + 1) % na],
                                    hb[j], hb[(j + 1) % nb])
               for i in range(na) for j in range(nb))


def some_pairs(n, limit, seed=3):
    pairs = list(itertools.combinations(range(n), 2))
    if len(pairs) <= limit:
        return pairs
    rng = np.random.default_rng(seed)
    return [pairs[i] for i in sorted(rng.choice(len(pairs), limit, False))]


@pytest.mark.parametrize('case', list(CASES))
def test_poly_distance_keeps_the_old_formula(case):
    qs = quads(case)
    pairs = some_pairs(len(qs), 600)
    new = np.array([qs[u].poly_distance(qs[v]) for u, v in pairs])
    old = np.array([old_polygon_distance(qs[u].pts, qs[v].pts)
                    for u, v in pairs])
    np.testing.assert_allclose(new, old, rtol=0, atol=1e-9)
    # an overlap reads exactly 0 in both
    assert ((new == 0) == (old == 0)).all()
    assert geometry.convex_polygon_distance(qs[0].pts, qs[-1].pts) == \
        qs[0].poly_distance(qs[-1])


@pytest.mark.parametrize('case', ['jittered', 'random_turned', 'nested',
                                  'degenerate'])
def test_batch_reads_single_pairs_to_the_bit(case):
    qs = quads(case)
    u, v = map(np.array, zip(*itertools.combinations(range(len(qs)), 2)))
    hulls = np.stack([q.hull for q in qs])
    batch = geometry._pair_distances(hulls[u], hulls[v])
    single = np.array([qs[a].poly_distance(qs[b]) for a, b in zip(u, v)])
    assert np.array_equal(batch, single)


def test_containment_is_opencvs():
    """Points on vertices, on edges, inside and outside hulls of 1-4
    vertices, on a small grid where every such case occurs."""
    rng = np.random.default_rng(4)
    hulls, points = [], []
    for k in range(4000):
        pts = rng.integers(0, [3, 5, 2][k % 3], (4, 2)).astype(np.float64)
        if k % 5 == 0:
            pts = pts / 2 + 0.25
        hulls.append(geometry._padded_hull(pts))
        points.append(rng.integers(0, 4, 2) / [1, 2][k % 2])
    hulls = np.stack(hulls)
    points = np.array(points, np.float64)
    got = geometry._contains_first_vertex(hulls, points[:, None])
    want = [cv2.pointPolygonTest(geometry._hull(h).astype(np.float32),
                                 (float(p[0]), float(p[1])), False) >= 0
            for h, p in zip(hulls, points)]
    assert got.tolist() == want
    assert 0 < sum(want) < len(want)


# -- the two graphs ---------------------------------------------------------

GRAPH_CASES = ['text_heavy_0', 'art_heavy', 'jittered', 'random_turned',
               'nested', 'degenerate']


def with_pairwise_loop(monkeypatch):
    monkeypatch.setattr(ocr_common, 'merge_graph_edges', pairwise_edges)
    monkeypatch.setattr(textline_merge, 'merge_graph_edges', pairwise_edges)


@pytest.mark.parametrize('case', GRAPH_CASES)
def test_ocr_directions_match_pairwise_loop(case, monkeypatch):
    ocr = get_ocr(Ocr.ocr48px)
    qs = quads(case)
    got = [(id(q), d) for q, d in ocr._generate_text_direction(qs)]
    with_pairwise_loop(monkeypatch)
    assert got == [(id(q), d) for q, d in ocr._generate_text_direction(qs)]
    assert sorted(i for i, _ in got) == sorted(map(id, qs))


@pytest.mark.parametrize('case', GRAPH_CASES)
def test_merge_regions_match_pairwise_loop(case, monkeypatch):
    qs = quads(case)

    def regions():
        return [([id(q) for q in lines], fg, bg) for lines, fg, bg in
                textline_merge.merge_bboxes_text_region(qs, 4000, 6000)]
    got = regions()
    with_pairwise_loop(monkeypatch)
    assert got == regions()


def random_layout(seed):
    """Bubbles of 2-6 lines, axis-aligned or turned alike, with colours
    and probabilities, at integer or float corners."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(int(rng.integers(4, 9))):
        bx, by = rng.uniform(0, 1400, 2)
        g = rng.uniform(14, 36)
        angle = 0.0 if rng.random() < 0.6 else rng.uniform(-20, 20)
        vertical = rng.random() < 0.6
        for j in range(int(rng.integers(2, 7))):
            n = int(rng.integers(2, 14))
            step = j * (g + rng.uniform(3, 9))
            if vertical:
                cx, cy, w, h = bx - step, by + n * g / 2, g, n * g
            else:
                cx, cy, w, h = bx + n * g / 2, by + step, n * g, g
            pts = turned(cx, cy, w, h, angle)
            lines.append(np.round(pts) if seed % 2 else pts)
    extra = [dict(text=f'l{i}', prob=float(rng.uniform(0.2, 1)),
                  colors=rng.integers(0, 256, 6).tolist())
             for i in range(len(lines))]
    return lines, extra


@pytest.mark.parametrize('seed', range(6))
def test_merged_regions_equal_jax_package(seed):
    lines, extra = random_layout(seed)

    def regions(cls, dispatch):
        qs = [cls(pts, e['text'], e['prob'], *e['colors'])
              for pts, e in zip(lines, extra)]
        return asyncio.run(dispatch(qs, 1600, 1800))
    port = regions(Quadrilateral, textline_merge.dispatch)
    ref = regions(JaxQuadrilateral, jax_dispatch)
    assert len(port) == len(ref) > 1
    for a, b in zip(port, ref):
        assert np.array_equal(a.lines, b.lines)
        assert a.texts == b.texts
        assert (a.font_size, a.angle, a.prob) == (b.font_size, b.angle,
                                                  b.prob)
        assert np.array_equal(a.fg_colors, b.fg_colors)
        assert np.array_equal(a.bg_colors, b.bg_colors)
