"""PyTorch port, rendering: the port's copied renderers (``dispatch`` for
``Renderer.default``, ``dispatch_eng_render`` for manga2eng) against the
JAX package's on the same canvas and text regions: byte-identical."""
import asyncio

import numpy as np
import pytest

from manga_image_translator_tpu import rendering as jax_rendering
from manga_image_translator_tpu.utils.textblock import TextBlock as JTextBlock
from manga_image_translator_tpu_torch import rendering
from manga_image_translator_tpu_torch.rendering import hyphenation
from manga_image_translator_tpu_torch.utils.textblock import TextBlock

REGIONS = [
    # (lines, texts, translation, extra TextBlock arguments)
    ([[[30, 40], [260, 40], [260, 90], [30, 90]]], ['HELLO'],
     'Hello there, an extraordinarily unbelievable translation',
     {'font_size': 22, 'target_lang': 'ENG', 'fg_color': (10, 10, 10),
      'bg_color': (250, 250, 250)}),
    ([[[300, 30], [350, 30], [350, 260], [300, 260]]], ['縦書き'],
     '縦書きのテキストです', {'font_size': 24, 'direction': 'v',
                           'target_lang': 'JPN'}),
    ([[[40, 300], [220, 300], [220, 330], [40, 330]],
      [[40, 335], [220, 335], [220, 365], [40, 365]]], ['TWO', 'LINES'],
     'Two lines of text in one region', {'font_size': 18,
                                         'target_lang': 'ENG'}),
]


def make_canvas():
    rs = np.random.RandomState(0)
    canvas = np.full((400, 380, 3), 235, np.uint8)
    canvas[200:, :] = 60
    return np.clip(canvas.astype(int) + rs.randint(-8, 9, canvas.shape),
                   0, 255).astype(np.uint8)


def regions(cls):
    out = []
    for lines, texts, translation, kw in REGIONS:
        blk = cls(lines, texts=texts, **kw)
        blk.translation = translation
        out.append(blk)
    return out


@pytest.mark.parametrize('hyphenate', [True, False])
def test_default_renderer_matches_jax(hyphenate):
    canvas = make_canvas()
    got = asyncio.run(rendering.dispatch(
        np.copy(canvas), regions(TextBlock), '', None, 0, 0, hyphenate))
    ref = asyncio.run(jax_rendering.dispatch(
        np.copy(canvas), regions(JTextBlock), '', None, 0, 0, hyphenate))
    assert got.shape == canvas.shape and got.dtype == np.uint8
    assert (got != canvas).any(), 'nothing was drawn'
    np.testing.assert_array_equal(got, ref)


def test_manga2eng_renderer_matches_jax():
    canvas = make_canvas()
    eng = [r for r in regions(TextBlock) if r.target_lang == 'ENG']
    jeng = [r for r in regions(JTextBlock) if r.target_lang == 'ENG']
    got = asyncio.run(rendering.dispatch_eng_render(
        np.copy(canvas), canvas, eng))
    ref = asyncio.run(jax_rendering.dispatch_eng_render(
        np.copy(canvas), canvas, jeng))
    assert (got != canvas).any()
    np.testing.assert_array_equal(got, ref)


def test_hyphenation_copy_never_downloads():
    assert not hasattr(hyphenation, 'download_dictionaries')
    assert len(hyphenation.syllables('extraordinarily', 'en_US')) > 1
