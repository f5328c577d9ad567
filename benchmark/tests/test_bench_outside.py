"""The page check's pieces (``outside.py``) at small shapes, and a run
without a card: it exits with another code than 0 and prints no result."""
import os
import subprocess
import sys

import numpy as np

from benchmark import outside, pages

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def page(lines, shape=(100, 80)):
    return pages.Page(0, np.zeros(shape + (3,), np.uint8),
                      np.array(lines, np.int64), np.zeros(len(lines), bool),
                      np.ones(len(lines), np.int64),
                      np.zeros(shape, np.uint8), np.zeros((0, 4), np.int64))


def test_text_area_grows_the_lines_and_adds_the_rects():
    p = page([(20, 30, 30, 60)])
    area = outside.text_area(p, (100, 80, 3), 4.0, [(70, 90, 5, 5)])
    grow = int(outside.MARGIN_GLYPHS * 4)
    assert area[30 - grow, 20 - grow] and area[59 + grow, 29 + grow]
    assert not area[30 - grow - 1, 25] and not area[45, 30 + grow]
    assert area[90:95, 70:75].all() and not area[95, 75]
    assert area.sum() == (10 + 2 * grow) * (30 + 2 * grow) + 25


def test_text_area_follows_the_scale_of_the_page():
    p = page([(20, 30, 30, 60)])
    area = outside.text_area(p, (50, 40, 3), 0.0, [])
    assert area.sum() == 5 * 15 and area[15:30, 10:15].all()


def test_changed_counts_pixels_inside_where():
    a = np.zeros((4, 5, 3), np.uint8)
    b = a.copy()
    b[0, 0, 2] = 1
    b[3, 4] = 9
    where = np.ones((4, 5), bool)
    assert outside.changed(a, b, where) == 2
    where[0, 0] = False
    assert outside.changed(a, b, where) == 1
    assert outside.changed(a, b[:3], where) == where.size


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'default.art_heavy', '--seed', str(2 ** 31 + 5), '--seconds', '1',
         '--trace', '0'], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0
    assert out.stdout.strip() == ''
