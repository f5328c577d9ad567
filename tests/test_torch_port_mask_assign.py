"""PyTorch port: ``mask_refinement.assign_components``, which decides the
component -> line assignment of a page for all pairs at once, against the
scalar assignment it replaced (one ``cv2.intersectConvexConvex`` and one
``cv2.pointPolygonTest`` for each component x line pair, kept here as
``scalar_assign``): the same per-line masks and rectangles, bit for bit,
ties included. And ``complete_mask`` against the JAX package's on a page of
24 lines."""
import cv2
import numpy as np
import pytest
import torch

from manga_image_translator_tpu import mask_refinement as jax_mask
from manga_image_translator_tpu.utils.geometry import Quadrilateral as JQuad
from manga_image_translator_tpu_torch import mask_refinement
from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral

torch.set_num_threads(2)

# the scale mask refinement works at on a page whose mask has the image's
# size (``dispatch``'s scale factor)
SCALE = 2 / 3


def scalar_assign(mask, textlines, keep_threshold):
    """The assignment as it was: every component over 9 px against every
    line, one pair at a time."""
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
            overlap, _ = cv2.intersectConvexConvex(
                poly_pts[tl_idx].astype(np.float32), cc_pts.astype(np.float32))
            ratios[tl_idx] = float(overlap) / max(min(area1, area2), 1e-9)
            d = cv2.pointPolygonTest(poly_pts[tl_idx].astype(np.float32),
                                     (float(cc_centroid[0]),
                                      float(cc_centroid[1])), True)
            dists[tl_idx] = 0.0 if d >= 0 else -d
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


def assert_same(mask, quads, keep_threshold=1e-2):
    """Both assignments on copies of ``mask``; returns the scalar one."""
    ref = scalar_assign(mask.copy(), quads, keep_threshold)
    got = mask_refinement.assign_components(mask.copy(), quads,
                                            keep_threshold)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert len(got[0]) == len(ref[0])
        for g, r in zip(got[0], ref[0]):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[1].dtype == ref[1].dtype
    return ref


def column_page(seed, n_lines=24, glyph=20, gaps=(2, 4), chars=(3, 12),
                size=(900, 1200)):
    """A dialogue page as the benchmark draws it, at full scale: bubbles of
    vertical columns (and one of horizontal lines) 2-3 px apart, random
    strokes in each glyph cell, the mask the strokes grown by a pixel; then
    page and mask at mask refinement's scale (the mask thresholded as
    ``dispatch`` does) and the line boxes scaled with them. The grown
    strokes cross the narrow gaps between columns: erasing the boxes'
    outlines leaves slivers between two columns, for the fallback's
    distances."""
    rng = np.random.default_rng(seed)
    w, h = size
    img = np.full((h, w, 3), 245, np.uint8)
    strokes = np.zeros((h, w), np.uint8)
    boxes = []
    x0, y0 = 30, 30
    while len(boxes) < n_lines:
        n = min(int(rng.integers(3, 6)), n_lines - len(boxes))
        vertical = len(boxes) > 0
        gap = int(rng.integers(*gaps))
        for j in range(n):
            k = int(rng.integers(*chars))
            if vertical:
                bx, by = x0 + j * (glyph + gap), y0
                bw, bh = glyph, k * glyph
            else:
                bx, by = x0, y0 + j * (glyph + gap)
                bw, bh = k * glyph, glyph
            boxes.append((bx, by, bx + bw, by + bh))
            for c in range(k):
                cx, cy = (bx, by + c * glyph) if vertical else (bx + c * glyph,
                                                               by)
                for _ in range(int(rng.integers(2, 5))):
                    p, q = rng.integers(0, glyph, (2, 2))
                    cv2.line(strokes, (int(cx + p[0]), int(cy + p[1])),
                             (int(cx + q[0]), int(cy + q[1])), 255,
                             int(rng.integers(1, 3)))
        x0 += (n + 1) * (glyph + gap) + 30 if vertical else 0
        if not vertical:
            y0 += n * (glyph + gap) + 30
        if x0 > w - 8 * glyph:
            x0, y0 = 30, y0 + 12 * glyph + 40
    img[strokes > 0] = 20
    mask = cv2.dilate(strokes, np.ones((5, 5), np.uint8))
    dsize = (int(w * SCALE), int(h * SCALE))
    img = cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)
    mask = cv2.resize(mask, dsize, interpolation=cv2.INTER_LINEAR)
    mask[mask > 0] = 255
    return img, mask, [np.array([[a, b], [c, b], [c, d], [a, d]],
                                np.float64) * SCALE
                       for a, b, c, d in boxes]


def blob_page(seed, kind):
    """Rectangles and speckle on a small page, and quads of ``kind``:
    'int' (axis-aligned, integer corners, so component rectangles touch
    and share their sides), 'rotated', 'skewed' (sheared, then rotated),
    'wild' (four random corners: concave or crossed quads, whose overlaps
    only cv2 can tell), each with a copy of one quad (overlap ties) and a
    shifted copy of another (distance ties)."""
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(120, 360)), int(rng.integers(120, 360))
    mask = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(20, 80))):
        x, y = (int(v) for v in rng.integers(0, (w, h)))
        cv2.rectangle(mask, (x, y), (x + int(rng.integers(1, 25)),
                                     y + int(rng.integers(1, 25))), 255, -1)
    mask[rng.random((h, w)) < 0.05] = 255
    quads = []
    for _ in range(int(rng.integers(4, 12))):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        qw, qh = rng.uniform(8, 60), rng.uniform(8, 160)
        if kind == 'int':
            x, y = int(cx), int(cy)
            quads.append(np.array([[x, y], [x + int(qw), y],
                                   [x + int(qw), y + int(qh)],
                                   [x, y + int(qh)]], np.float64))
            continue
        base = np.array([[-qw, -qh], [qw, -qh], [qw, qh], [-qw, qh]]) / 2
        if kind == 'wild':
            base = rng.uniform(-40, 40, (4, 2))
        if kind == 'skewed':
            base[:, 0] += base[:, 1] * rng.uniform(-0.6, 0.6)
        a = rng.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
        quads.append(base @ rot + (cx, cy))
    quads.append(quads[0].copy())
    shifted = quads[1].copy()
    shifted[:, 0] += int(rng.integers(2, 20))
    quads.insert(1, shifted)
    return mask, quads


def quads_of(cls, pts):
    return [cls(p, '', 1.0) for p in pts]


@pytest.fixture(params=['exact', 'noise', 'low', 'high'])
def perturbed(request, monkeypatch):
    """Other than 'exact', every overlap the port clips and every distance
    it computes moves by up to 0.9 of the error it allows for it: at random
    ('noise'; ties then break either way), or all down ('low') or up
    ('high'; values on a threshold then cross it). The guard's cv2 calls
    must still settle every tie and threshold as the scalar assignment
    decides it."""
    if request.param == 'exact':
        return
    rng = np.random.default_rng(0)

    def shift(n):
        if request.param == 'noise':
            return rng.uniform(-0.9, 0.9, n)
        return np.full(n, -0.9 if request.param == 'low' else 0.9)

    clip = mask_refinement._clip_areas
    distances = mask_refinement._centroid_distances

    def clip_areas(quads, boxes):
        area = clip(quads, boxes)
        room = mask_refinement._AREA_TOL * (boxes[:, 2] - boxes[:, 0]
                                            + boxes[:, 3] - boxes[:, 1])
        return np.maximum(area + room * shift(len(area)), 0.0)

    def centroid_distances(pt, quads):
        dist = distances(pt, quads)
        room = mask_refinement._DIST_TOL * (1.0 + dist)
        return np.where(dist > 0, dist + room * shift(len(dist)), dist)

    monkeypatch.setattr(mask_refinement, '_clip_areas', clip_areas)
    monkeypatch.setattr(mask_refinement, '_centroid_distances',
                        centroid_distances)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_columns_page_equal(seed, perturbed):
    """Benchmark-like pages: slivers between columns 1-2 px apart take the
    fallback, and some of them lie as near to one column as to the next."""
    _, mask, pts = column_page(seed)
    ref = assert_same(mask, quads_of(Quadrilateral, pts))
    assert ref is not None and sum(m.any() for m in ref[0]) >= 20


@pytest.mark.parametrize('kind', ['int', 'rotated', 'skewed', 'wild'])
@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('keep_threshold', [1e-2, 0.5])
def test_blob_page_equal(kind, seed, keep_threshold, perturbed):
    mask, pts = blob_page(seed, kind)
    assert_same(mask, quads_of(Quadrilateral, pts), keep_threshold)


def test_crossed_quad_overlap_from_cv2():
    """Four corners that sort into a crossed quad: cv2's overlap of it with
    a bar is not the area clipping finds, and decides that the bar goes to
    no line; the port takes cv2's."""
    mask = np.zeros((120, 120), np.uint8)
    mask[25:35, 53:78] = 255
    pts = [np.array([[87., 109.], [59., 82.], [50., 96.], [79., 14.]])]
    lines = quads_of(Quadrilateral, pts)
    assert not mask_refinement._Lines(lines).regular[0]
    assert assert_same(mask, lines) is None


@pytest.mark.parametrize('decision', ['keep_threshold', 'half_glyph'])
def test_decisions_on_their_thresholds(decision, perturbed):
    """Values that sit exactly on a threshold: a ring 30 px square whose
    corner a diamond's side cuts off 32 px^2 of its 116 px, at a
    ``keep_threshold`` of float32(32 / 116) (the scalar test is ``<=``: the
    ring takes the fallback and lies 15.6 px off, past half its 30 px
    unit); and a bar 8 px wide 1 px off a line's side, whose centre lies 5
    px off, half its unit of 10 (``>=``: dropped)."""
    mask = np.zeros((300, 300), np.uint8)
    if decision == 'keep_threshold':
        cv2.rectangle(mask, (190, 68), (219, 97), 255, 1)
        pts = [np.array([[150., 50.], [250., 150.], [150., 250.],
                         [50., 150.]])]
        keep_threshold = float(np.float32(32 / 116))
    else:
        mask[100:112, 61:69] = 255
        pts = [np.array([[20., 80.], [60., 80.], [60., 140.], [20., 140.]])]
        keep_threshold = 1e-2
    assert assert_same(mask, quads_of(Quadrilateral, pts),
                       keep_threshold) is None


def test_half_scale_and_many_blocks(monkeypatch):
    """The column page at half the size, decided in blocks of two
    components."""
    monkeypatch.setattr(mask_refinement, '_PAIRS_PER_BLOCK', 2 * 24)
    _, mask, pts = column_page(3, size=(900, 1200))
    mask = cv2.resize(mask, (mask.shape[1] // 2, mask.shape[0] // 2),
                      interpolation=cv2.INTER_LINEAR)
    mask[mask > 0] = 255
    assert assert_same(mask, quads_of(Quadrilateral, [p / 2 for p in pts]))


def test_component_larger_than_every_line_skipped():
    """A blot over a line: the part inside the line's erased outline is
    given to it, the ring outside, larger than every line, to none; a
    stroke inside another line is given to that line."""
    mask = np.zeros((200, 200), np.uint8)
    mask[20:180, 20:180] = 255                       # the blot
    mask[190:196, 40:60] = 255                       # a stroke in line 1
    pts = [np.array([[30., 30.], [90., 30.], [90., 60.], [30., 60.]]),
           np.array([[35., 186.], [70., 186.], [70., 199.], [35., 199.]])]
    ref = assert_same(mask, quads_of(Quadrilateral, pts))
    assert ref is not None
    assert ref[0][0][45, 60] and not ref[0][0][100:180, 100:180].any()
    assert ref[0][1][192, 50]


def test_components_beyond_half_a_glyph_dropped():
    """Beside a line 26 px high, marks too small to set a unit above 10 px:
    one whose centre lies 2.5 px off the line's side is given to it, marks
    13 and 19 px off are dropped."""
    mask = np.zeros((120, 240), np.uint8)
    mask[44:62, 32:46] = 255                          # inside the line
    mask[46:58, 101:104] = 255                        # 2.5 px off: kept
    mask[46:58, 110:116] = 255                        # 13 px off: dropped
    mask[80:90, 60:68] = 255                          # 19 px below: dropped
    pts = [np.array([[30., 40.], [100., 40.], [100., 66.], [30., 66.]])]
    ref = assert_same(mask, quads_of(Quadrilateral, pts))
    assert ref is not None
    line = ref[0][0]
    assert line[50, 40] and line[50, 102]
    assert not line[50, 112] and not line[85, 64]


def test_no_component_given_returns_none():
    mask = np.zeros((100, 100), np.uint8)
    mask[80:95, 80:95] = 255                           # far from the line
    mask[10:12, 10:13] = 255                           # 6 px: too small
    pts = [np.array([[5., 5.], [40., 5.], [40., 20.], [5., 20.]])]
    assert assert_same(mask, quads_of(Quadrilateral, pts)) is None
    assert assert_same(np.zeros((100, 100), np.uint8),
                       quads_of(Quadrilateral, pts)) is None


def test_no_lines_returns_none():
    _, mask, _ = column_page(0, n_lines=4, size=(300, 300))
    assert assert_same(mask, []) is None


def test_complete_mask_equal_on_many_lines():
    """The whole of ``complete_mask`` (assignment, K1's plain version, the
    windowed CRF, dilation) against the JAX package's on a column page of
    24 lines at 600x800."""
    img, mask, pts = column_page(4, glyph=15, chars=(2, 6))
    assert mask.shape == (800, 600)
    ref = jax_mask.complete_mask(img, mask.copy(), quads_of(JQuad, pts),
                                 dilation_offset=0, kernel_size=3)
    got = mask_refinement.complete_mask(img, mask.copy(),
                                        quads_of(Quadrilateral, pts),
                                        dilation_offset=0, kernel_size=3)
    assert ref is not None and got is not None
    assert int((ref > 0).sum()) > 0
    np.testing.assert_array_equal(got, ref)
