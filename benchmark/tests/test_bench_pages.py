"""The page generator: deterministic by seed, every seed the same multiset
of line counts and lengths, all within the traffic's ranges."""
import json
import os

import numpy as np
import pytest

from benchmark import pages

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small(name):
    with open(os.path.join(HERE, 'traffic', f'{name}.json')) as f:
        tr = json.load(f)
    tr.update(page=[724, 1024], chapter_pages=4, glyph_px=11, margin_px=20)
    return tr


@pytest.mark.parametrize('name', ['text_heavy', 'art_heavy'])
def test_same_seed_same_chapter(name):
    a = pages.make_chapter(small(name), 2 ** 40 + 3)
    b = pages.make_chapter(small(name), 2 ** 40 + 3)
    for p, q in zip(a, b):
        assert np.array_equal(p.image, q.image)
        assert np.array_equal(p.lines, q.lines)


@pytest.mark.parametrize('name', ['text_heavy', 'art_heavy'])
def test_every_seed_sends_the_same_pages_in_its_own_order(name):
    tr = small(name)
    counts, images = [], []
    for seed in (1, 2, 3):
        chapter = pages.make_chapter(tr, seed)
        counts.append(sorted(p.n_lines for p in chapter))
        images.append(sorted(p.image.tobytes() for p in chapter))
        for p in chapter:
            lo, hi = tr['lines_per_page']
            assert lo <= p.n_lines <= hi
            assert p.chars.min() >= tr['chars_per_line'][0]
            assert p.chars.max() <= tr['chars_per_line'][1]
            x0, y0, x1, y1 = p.lines.T
            assert (x1 > x0).all() and (y1 > y0).all()
            assert (x1 <= tr['page'][0]).all() and (y1 <= tr['page'][1]).all()
    assert counts[0] == counts[1] == counts[2]
    assert images[0] == images[1] == images[2]
    assert [p.n_lines for p in pages.make_chapter(tr, 1)] != \
        [p.n_lines for p in pages.make_chapter(tr, 2)]


def test_low_resolution_scan_keeps_full_scale_boxes():
    tr = small('text_heavy')
    full = pages.make_chapter(tr, 5)
    half = pages.make_chapter(tr, 5, scale=0.5)
    assert half[0].image.shape[:2] == (512, 362)
    assert np.array_equal(full[0].lines, half[0].lines)


def test_detection_maps_give_back_the_lines():
    """The DB postprocess's unclip of each drawn kernel returns the line's
    box, to a pixel or two."""
    import cv2
    tr = small('text_heavy')
    page = pages.make_chapter(tr, 9)[0]
    pmap, mmap = pages.detection_maps(page, 1024, 256, 2.3, 0.94, 0.9)
    assert pmap.shape == (1024, 768) and mmap.shape == (512, 384)
    n, _, stats, _ = cv2.connectedComponentsWithStats(
        (pmap > 127).astype(np.uint8))
    assert n - 1 == page.n_lines
    for x0, y0, x1, y1 in page.lines:
        w, h = x1 - x0, y1 - y0
        s = pages._shrink(w, h, 2.3)
        iw, ih = w - 2 * s, h - 2 * s
        grow = iw * ih * 2.3 / (2 * (iw + ih))
        assert abs(iw + 2 * grow - w) < 0.01 and abs(ih + 2 * grow - h) < 0.01
    assert 0 < pages.map_density(pmap, 0.5) < 0.2
