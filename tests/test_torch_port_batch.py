"""PyTorch port, batch mode: the batched detector, the pooled OCR, the
batched inpainting pre-pass and ``MangaTranslator.translate_batch`` against
the JAX package's, on the CPU with the same seeded weights (the JAX
package's init_params, bridged). Every JAX reference is computed once, in
the module's fixture."""
import asyncio

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax

from manga_image_translator_tpu import detection as jax_detection
from manga_image_translator_tpu import inpainting as jax_inpainting
from manga_image_translator_tpu import manga_translator as jax_mt
from manga_image_translator_tpu import ocr as jax_ocr
from manga_image_translator_tpu.config import Config as JConfig
from manga_image_translator_tpu.config import Detector as JDetector
from manga_image_translator_tpu.config import Inpainter as JInpainter
from manga_image_translator_tpu.config import Ocr as JOcr
from manga_image_translator_tpu.config import OcrConfig as JOcrConfig
from manga_image_translator_tpu.inpainting import inpainting_lama as jax_il
from manga_image_translator_tpu.models import dbnet as jax_dbnet
from manga_image_translator_tpu.models import lama as jax_lama
from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu.ocr.model_48px import _placeholder_dictionary
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.utils.geometry import \
    Quadrilateral as JQuadrilateral
from manga_image_translator_tpu.utils.generic import Context as JContext
from manga_image_translator_tpu_torch import detection, inpainting, ocr
from manga_image_translator_tpu_torch import manga_translator as port_mt
from manga_image_translator_tpu_torch.config import (Config, Detector,
                                                     Inpainter, Ocr,
                                                     OcrConfig)
from manga_image_translator_tpu_torch.models import dbnet, lama, ocr48
from manga_image_translator_tpu_torch.ocr import model_48px
from manga_image_translator_tpu_torch.utils.generic import Context
from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

DETECT_SIZE = 256
N_BLOCKS = 2
# translator, inpainter and renderer as tests/test_pipeline.py configures
# them; random OCR weights give probabilities ~1e-40: threshold 0 keeps
# the lines so that merge and mask refinement have work to compare
CONFIG = {
    'detector': {'detector': 'default', 'detection_size': DETECT_SIZE},
    'ocr': {'ocr': '48px', 'prob': 0.0},
    'translator': {'translator': 'none', 'target_lang': 'ENG',
                   'enable_post_translation_check': False,
                   'no_text_lang_skip': True},
    'inpainter': {'inpainter': 'none'},
    'render': {'renderer': 'none'},
}
WORDS = ('HELLO', 'BATCH', 'PAGES', 'OCR', 'POOL', 'LINES')


def make_pages():
    """Three 448x416 pages (large enough for the batched detector), three
    text lines each; returns the pages and each page's line boxes."""
    pages, quads = [], []
    for p in range(3):
        img = np.full((448, 416, 3), 255, np.uint8)
        boxes = []
        for i in range(3):
            text = WORDS[(p + i) % len(WORDS)]
            x, y = 30 + 20 * p, 90 + 120 * i
            cv2.putText(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 1.2 +
                        0.2 * i, (0, 0, 0), 3)
            (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                             1.2 + 0.2 * i, 3)
            boxes.append([[x - 4, y - th - 4], [x + tw + 4, y - th - 4],
                          [x + tw + 4, y + base + 4], [x - 4, y + base + 4]])
        pages.append(img)
        quads.append(boxes)
    return pages, quads


def blob_page(h, w, seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    page = np.stack([(xx * 255 // w), (yy * 255 // h),
                     np.full((h, w), 200)], -1).astype(np.uint8)
    page = np.clip(page.astype(int) + rs.randint(-20, 21, page.shape),
                   0, 255).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[30:50, 40:100] = 255
    mask[150 + 10 * seed:200 + 10 * seed, 180:330] = 255
    return page, mask


def _np(params):
    return {k: np.array(v) for k, v in params.items()}


def _lines(ctx_lines):
    return [(q.pts.tolist(), q.text) for q in ctx_lines]


async def _inpaint_pass(translator, context_cls, pages, config):
    contexts, configs = [], []
    for page, mask in pages:
        ctx = context_cls()
        ctx.img_rgb = page
        ctx.mask = mask
        ctx.text_regions = ['a region']
        contexts.append(ctx)
        configs.append(config)
    await translator._batch_inpaint(contexts, configs)
    return [c.img_inpainted for c in contexts]


@pytest.fixture(scope='module')
def runs():
    mp = pytest.MonkeyPatch()
    for key, val in (('MIT_TPU_OCR_PALLAS', '0'), ('MIT_TPU_MESH', '0'),
                     ('MIT_TPU_OCR_BF16_BACKBONE', '0'),
                     ('MIT_TPU_DEVICE_CROPS', '0'),
                     ('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')):
        mp.setenv(key, val)

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)
    mp.setattr(jax_il.LamaLargeInpainter, '_N_BLOCKS', N_BLOCKS)
    # registries of this module's own: other tests in this process may
    # have loaded the shared instances with other weights or devices
    for mod, name in ((jax_detection, '_detector_cache'),
                      (jax_ocr, '_ocr_cache'),
                      (jax_inpainting, '_inpainter_cache'),
                      (detection, '_detector_cache'), (ocr, '_ocr_cache'),
                      (inpainting, '_inpainter_cache')):
        mp.setattr(mod, name, {})
    jitted = (jax_ocr48.beam_decode, jax_ocr48.beam_decode_from_memory,
              jax_ocr48.compute_memory)
    for fn in jitted:
        fn._clear_cache()
    try:
        dictionary = _placeholder_dictionary()
        det = detection.get_detector(Detector.default)
        det.device = torch.device('cpu')
        det.model = dbnet.build_dbnet('cpu', torch_state_dict_from_jax(
            _np(jax_dbnet.init_params(jax.random.PRNGKey(0))),
            dbnet.TRANSPOSED_CONV_PATTERNS))
        det._loaded = True
        rec = ocr.get_ocr(Ocr.ocr48px)
        rec.dictionary = dictionary
        rec.device = torch.device('cpu')
        rec.model = ocr48.build_ocr48(len(dictionary), 'cpu',
                                      torch_state_dict_from_jax(
            _np(jax_ocr48.init_params(len(dictionary))),
            embedding_patterns=ocr48.EMBEDDING_PATTERNS))
        rec._loaded = True
        inp = inpainting.get_inpainter(Inpainter.lama_large)
        inp.device = torch.device('cpu')
        inp.set_model(lama.fold_bn(lama.build_lama(
            N_BLOCKS, torch_state_dict_from_jax(
                _np(jax_lama.init_params(N_BLOCKS)),
                lama.transposed_conv_patterns(N_BLOCKS)))))
        inp._loaded = True
        jdet = jax_detection.get_detector(JDetector.default)
        asyncio.run(jdet.load('cpu'))
        jrec = jax_ocr.get_ocr(JOcr.ocr48px)
        asyncio.run(jrec.load('cpu'))

        pages, quads = make_pages()
        out = {'pages': pages, 'quads': quads}
        # (a) the batched detector
        out['det'] = (
            asyncio.run(det.infer_batch(pages, DETECT_SIZE, 0.5, 0.7, 2.3)),
            asyncio.run(jdet.infer_batch(pages, DETECT_SIZE, 0.5, 0.7, 2.3)))
        handles = (asyncio.run(det.infer_batch_dispatch(pages, DETECT_SIZE)),
                   asyncio.run(jdet.infer_batch_dispatch(pages,
                                                         DETECT_SIZE)))
        out['maps'] = [(h['prob'], h['mask']) for h in handles]

        # (d) the pooled OCR on the pages' known boxes
        def port_quads():
            return [[Quadrilateral(np.array(b), '', 1.0) for b in page]
                    for page in quads]
        out['pooled'] = (
            asyncio.run(rec.infer_pooled(pages, port_quads(),
                                         OcrConfig(prob=0.0))),
            asyncio.run(jrec.infer_pooled(
                pages, [[JQuadrilateral(np.array(b), '', 1.0) for b in page]
                        for page in quads], JOcrConfig(prob=0.0))))

        # (e) translate_batch, three pages
        images = [Image.fromarray(p) for p in pages]
        out['batch'] = (
            asyncio.run(port_mt.MangaTranslator({'use_gpu': False})
                        .translate_batch([(im, Config(**CONFIG))
                                          for im in images])),
            asyncio.run(jax_mt.MangaTranslator({'use_gpu': False})
                        .translate_batch([(im, JConfig(**CONFIG))
                                          for im in images])))

        # (f) the batched inpainting pre-pass on two pages, 2-block
        # generator, f32
        lama_pages = [blob_page(256, 384, 1), blob_page(256, 384, 2)]
        jinp = jax_inpainting.get_inpainter(JInpainter.lama_large)
        asyncio.run(jinp.load('cpu'))
        lama_cfg = {'inpainter': {'inpainter': 'lama_large',
                                  'inpainting_precision': 'fp32'}}
        inp.forwards = []
        out['inpaint'] = (
            lama_pages,
            asyncio.run(_inpaint_pass(
                port_mt.MangaTranslator({'use_gpu': False}), Context,
                lama_pages, Config(**lama_cfg))),
            asyncio.run(_inpaint_pass(
                jax_mt.MangaTranslator({'use_gpu': False}), JContext,
                lama_pages, JConfig(**lama_cfg))),
            list(inp.forwards))

        # port per-page and port pooled, with chunks of 3 and 4 lines:
        # the pooled chunks then mix the pages' lines
        mp.setattr(model_48px, 'MAX_CHUNK', 3)
        mp.setattr(model_48px, 'BIG_CHUNK', 4)
        out['pooled_small_chunks'] = (
            [asyncio.run(rec._infer(page, q, OcrConfig(prob=0.0)))
             for page, q in zip(pages, port_quads())],
            asyncio.run(rec.infer_pooled(pages, port_quads(),
                                         OcrConfig(prob=0.0))))
    finally:
        mp.undo()
        for fn in jitted:
            fn._clear_cache()
    return out


def test_infer_batch_matches_jax(runs):
    """Equal line counts and boxes, raw masks within 1 level; the maps
    within 1e-3 (the tolerance after the bilateral prefilter)."""
    got, ref = runs['det']
    assert len(got) == len(ref) == 3
    for (lg, mg, _), (lr, mr, _) in zip(got, ref):
        assert len(lg) == len(lr)
        assert [q.pts.tolist() for q in lg] == [q.pts.tolist() for q in lr]
        assert mg.shape == mr.shape
        assert np.abs(mg.astype(int) - mr.astype(int)).max() <= 1
    (pg, mkg), (pr, mkr) = runs['maps']
    np.testing.assert_allclose(pg.numpy(), np.asarray(pr), atol=1e-3)
    np.testing.assert_allclose(mkg.numpy(), np.asarray(mkr), atol=1e-3)


def test_pooled_ocr_matches_jax(runs):
    """Equal texts per page; probabilities and colours at the tolerances
    of tests/test_torch_port_ocr.py (colours as fractions of 255)."""
    got, ref = runs['pooled']
    assert [len(p) for p in got] == [3, 3, 3]
    for pg, pr in zip(got, ref):
        assert [q.text for q in pg] == [q.text for q in pr]
        assert [q.pts.tolist() for q in pg] == [q.pts.tolist() for q in pr]
        np.testing.assert_allclose([q.prob for q in pg],
                                   [q.prob for q in pr], rtol=2e-2, atol=1e-3)
        colours = [[q.fg_r, q.fg_g, q.fg_b, q.bg_r, q.bg_g, q.bg_b]
                   for q in pg]
        colours_ref = [[q.fg_r, q.fg_g, q.fg_b, q.bg_r, q.bg_g, q.bg_b]
                       for q in pr]
        np.testing.assert_allclose(np.array(colours) / 255,
                                   np.array(colours_ref) / 255, rtol=5e-2,
                                   atol=2e-2)


def test_pooled_ocr_matches_per_page(runs):
    """Chunks of 3-4 lines that mix the pages' lines read the same texts,
    in the same order, as each page on its own."""
    per_page, pooled = runs['pooled_small_chunks']
    assert ([[q.text for q in p] for p in pooled]
            == [[q.text for q in p] for p in per_page])
    assert all(p for p in pooled)


def test_translate_batch_matches_jax(runs):
    got, ref = runs['batch']
    assert len(got) == len(ref) == 3
    assert any(c.textlines for c in ref), 'the reference found no lines'
    for g, r in zip(got, ref):
        assert _lines(g.textlines) == _lines(r.textlines)
        assert ([x.text for x in g.text_regions]
                == [x.text for x in r.text_regions])
        assert np.abs(g.mask_raw.astype(int)
                      - r.mask_raw.astype(int)).max() <= 1
        np.testing.assert_array_equal(g.mask, r.mask)
        assert g.result.size == r.result.size == (416, 448)
        np.testing.assert_array_equal(np.asarray(g.result),
                                      np.asarray(r.result))


def test_batch_inpaint_matches_jax(runs):
    """Two pages' crops in shared buckets: outside the mask byte-identical
    to the page and to the JAX result, inside within 1 gray of it."""
    pages, got, ref, forwards = runs['inpaint']
    assert forwards and any(n == 2 for n, _, _ in forwards), forwards
    for (page, mask), g, r in zip(pages, got, ref):
        inside = mask >= 127
        np.testing.assert_array_equal(g[~inside], page[~inside])
        np.testing.assert_array_equal(g[~inside], r[~inside])
        assert np.abs(g.astype(int) - r.astype(int))[inside].max() <= 1
        assert (g[inside] != page[inside]).any()


@pytest.fixture()
def port_detector(runs, monkeypatch):
    """The port's default detector with the seeded weights, in a registry
    of the test's own."""
    monkeypatch.setattr(detection, '_detector_cache', {})
    det = detection.get_detector(Detector.default)
    det.device = torch.device('cpu')
    det.model = dbnet.build_dbnet('cpu', torch_state_dict_from_jax(
        _np(jax_dbnet.init_params(jax.random.PRNGKey(0))),
        dbnet.TRANSPOSED_CONV_PATTERNS))
    det._loaded = True
    return det


def test_batch_predetect_chunking_keeps_results(runs, port_detector,
                                                monkeypatch):
    """Two chunks of 2 (chunk j dispatched before chunk j-1 is collected)
    give what one chunk of 4 gives."""
    translator = port_mt.MangaTranslator({'use_gpu': False})
    pages = [(Image.fromarray(p), Config(**CONFIG))
             for p in runs['pages'] + runs['pages'][:1]]
    monkeypatch.setenv('MIT_TPU_DET_CHUNK', '1')
    calls = []
    dispatch = port_detector.infer_batch_dispatch

    async def counted(images, size):
        calls.append(len(images))
        return await dispatch(images, size)
    monkeypatch.setattr(port_detector, 'infer_batch_dispatch', counted)
    pre2 = asyncio.run(translator._batch_predetect(pages, batch_size=2))
    pre4 = asyncio.run(translator._batch_predetect(pages, batch_size=4))
    assert calls == [2, 2, 4]
    assert set(pre2) == set(pre4) == {0, 1, 2, 3}
    for i in pre2:
        (l2, m2, _), (l4, m4, _) = pre2[i], pre4[i]
        assert [q.pts.tolist() for q in l2] == [q.pts.tolist() for q in l4]
        assert m2.shape == m4.shape
        assert np.abs(m2.astype(int) - m4.astype(int)).max() <= 1


def test_batch_predetect_skips_small_and_filtered_pages(port_detector):
    translator = port_mt.MangaTranslator({'use_gpu': False})
    small = Image.fromarray(np.full((300, 300, 3), 255, np.uint8))
    big = Image.fromarray(np.full((448, 448, 3), 255, np.uint8))
    inverted = Config(**CONFIG)
    inverted.detector.det_invert = True
    pages = [(small, Config(**CONFIG)), (big, inverted),
             (big, Config(**CONFIG)), (big, Config(**CONFIG))]
    pre = asyncio.run(translator._batch_predetect(pages, batch_size=4))
    # only the two plain big pages batch together
    assert set(pre) == {2, 3}
