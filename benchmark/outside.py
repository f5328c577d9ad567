"""The page away from its text is left as it was.

On the sampled pages the hooks keep the page as the pipeline received it
(at detection: after the upscaler, where there is one), the final text
mask, the inpainted page, the rectangles the renderer drew its regions
into, and the rendered page as ``translate`` hands it back. Two exact
comparisons follow, each a count of pixels summed over the sampled pages
(limit 0):

* ``inpaint_outside_mask_px``: pixels of the inpainted page that differ
  from the received page where the program's final mask is 0 (a blend or
  a write-back that reaches past the mask);
* ``page_outside_text_px``: pixels of the rendered page that differ from
  the received page outside the page's own text: the benchmark's line
  boxes (``pages.Page.lines``) grown by ``MARGIN_GLYPHS`` glyphs, which
  holds the mask refinement's reach (its CRF crop, its dilations and its
  resize come to under one glyph), and the rectangles the renderer was
  handed (the default renderer grows a region whose translation needs
  more rows, by design, so that geometry is the program's).
"""
from __future__ import annotations

import time

import cv2
import numpy as np

from . import seams

MARGIN_GLYPHS = 1.5


def copy(a) -> np.ndarray:
    """A host copy of ``a``, its time counted as the recording's
    (``seams.RECORD_S``)."""
    t0 = time.perf_counter()
    out = np.array(a)
    seams.RECORD_S[0] += time.perf_counter() - t0
    return out


def install(rec) -> None:
    from manga_image_translator_tpu_torch import manga_translator, rendering

    def make_detect(original):
        async def _run_detection(self, config, ctx):
            if rec.sampling:
                rec.samples['page'].append({'index': rec.page.index,
                                            'received': copy(ctx.img_rgb),
                                            'rects': []})
            return await original(self, config, ctx)
        return _run_detection

    def make_inpaint(original):
        async def _run_inpainting(self, config, ctx):
            out = await original(self, config, ctx)
            if rec.sampling:
                rec.samples['page'][-1].update(mask=copy(ctx.mask),
                                               inpainted=copy(out))
            return out
        return _run_inpainting

    def make_rects(original):
        def resize_regions_to_font_size(img, *args, **kwargs):
            quads = original(img, *args, **kwargs)
            if rec.sampling:
                rec.samples['page'][-1]['rects'] += [
                    cv2.boundingRect(np.asarray(q).astype(np.int32))
                    for q in quads]
            return quads
        return resize_regions_to_font_size

    def make_result(original):
        async def _revert_upscale(self, config, ctx):
            ctx = await original(self, config, ctx)
            if rec.sampling and ctx.result is not None:
                rec.samples['page'][-1]['result'] = copy(ctx.result)
            return ctx
        return _revert_upscale

    cls = manga_translator.MangaTranslator
    seams.wrap(cls, '_run_detection', make_detect)
    seams.wrap(cls, '_run_inpainting', make_inpaint)
    seams.wrap(cls, '_revert_upscale', make_result)
    seams.wrap(rendering, 'resize_regions_to_font_size', make_rects)


def text_area(page, shape, glyph_px: float, rects) -> np.ndarray:
    """Where the page may change: the page's line boxes, scaled from the
    drawn size to ``shape`` and grown by ``MARGIN_GLYPHS`` glyphs, and the
    renderer's rectangles (``cv2.boundingRect``, as ``rendering.render``
    bounds its write)."""
    h, w = shape[:2]
    sy, sx = h / page.strokes.shape[0], w / page.strokes.shape[1]
    grow = MARGIN_GLYPHS * glyph_px
    area = np.zeros((h, w), bool)
    for x0, y0, x1, y1 in page.lines:
        xa = int(np.floor((x0 - grow) * sx))
        ya = int(np.floor((y0 - grow) * sy))
        xb = int(np.ceil((x1 + grow) * sx))
        yb = int(np.ceil((y1 + grow) * sy))
        area[max(ya, 0):max(yb, 0), max(xa, 0):max(xb, 0)] = True
    for x, y, rw, rh in rects:
        area[max(y, 0):max(y + rh, 0), max(x, 0):max(x + rw, 0)] = True
    return area


def changed(a: np.ndarray, b: np.ndarray, where: np.ndarray) -> int:
    """Pixels inside ``where`` at which ``a`` and ``b`` differ in any
    channel (every pixel, where the shapes differ)."""
    if a.shape != b.shape:
        return int(where.size)
    return int((np.any(a != b, axis=-1) & where).sum())


def check(rec, traffic: dict) -> dict:
    pages = [s for s in rec.samples['page'] if 'result' in s]
    if not pages:
        return {}
    by_index = {p.index: p for p in rec.pages}
    outside_mask = outside_text = kept = 0
    for s in pages:
        received = s['received']
        outside_mask += changed(s['inpainted'], received, s['mask'] == 0)
        away = ~text_area(by_index[s['index']], received.shape,
                          float(traffic['glyph_px']), s['rects'])
        outside_text += changed(s['result'][..., :3], received, away)
        kept += int(away.sum())
    rec.compared['page pixels away from the text'] = kept
    return {'inpaint_outside_mask_px': outside_mask,
            'page_outside_text_px': outside_text}
