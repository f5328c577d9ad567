"""PyTorch port, the whole slice colorize → upscale → detect → OCR 32px:
one synthetic 192x256 page through the JAX package's
``MangaTranslator.translate`` and the port's with colorizer ``mc2``,
upscaler ``esrgan`` at ratio 2 (384x512 after upscaling), detector
``default``, OCR ``32px`` and translator, inpainter and renderer ``none``,
on the same weights: each package's seeded random init (the port's
detector holds the JAX draws, as in test_torch_port_pipeline.py) and one
narrow Real-ESRGAN checkpoint that the module writes into the model
directory both packages read. Then each orchestrator's OCR stage reads the
page's known lines, scaled 2x, on its own upscaled page."""
import asyncio

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax

from manga_image_translator_tpu import colorization as jax_colorization
from manga_image_translator_tpu import manga_translator as jax_mt
from manga_image_translator_tpu import ocr as jax_ocr
from manga_image_translator_tpu import upscaling as jax_upscaling
from manga_image_translator_tpu.config import Config as JConfig
from manga_image_translator_tpu.models import dbnet as jax_dbnet
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.utils.geometry import \
    Quadrilateral as JQuadrilateral
from manga_image_translator_tpu_torch import (colorization, detection,
                                              ocr, upscaling)
from manga_image_translator_tpu_torch import manga_translator as port_mt
from manga_image_translator_tpu_torch.config import Config, Detector
from manga_image_translator_tpu_torch.models import dbnet
from manga_image_translator_tpu_torch.utils import inference
from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax
from test_torch_port_upscale import _realesrgan_state_dict

torch.set_num_threads(2)

PAGE_W, PAGE_H = 192, 256
CONFIG = {
    # colorization_size = the page's width: the colorizer keeps its size
    'colorizer': {'colorizer': 'mc2', 'colorization_size': PAGE_W,
                  'denoise_sigma': 30},
    'upscale': {'upscaler': 'esrgan', 'upscale_ratio': 2},
    'detector': {'detector': 'default', 'detection_size': 256},
    # random OCR weights give probabilities far below 0.2: 0 keeps the
    # lines
    'ocr': {'ocr': '32px', 'prob': 0.0},
    'translator': {'translator': 'none', 'target_lang': 'ENG',
                   'enable_post_translation_check': False,
                   'no_text_lang_skip': True},
    'inpainter': {'inpainter': 'none'},
    'render': {'renderer': 'none'},
}


def make_page():
    """The page (dark lines on a light, slightly tinted ground) and its
    lines' boxes."""
    img = np.full((PAGE_H, PAGE_W, 3), (236, 232, 226), np.uint8)
    boxes = []
    for i, text in enumerate(('HELLO', 'MANGA', 'PAGE')):
        x, y = 16, 60 + 70 * i
        cv2.putText(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 1.1,
                    (20, 20, 20), 2)
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                         1.1, 2)
        boxes.append([[x - 4, y - th - 4], [x + tw + 4, y - th - 4],
                      [x + tw + 4, y + base + 4], [x - 4, y + base + 4]])
    return Image.fromarray(img), boxes


async def _run(translator, config, page, boxes, quad_cls):
    ctx = await translator.translate(page, config)
    ctx.textlines = [quad_cls(np.array(b) * 2, '', 1.0) for b in boxes]
    known = await translator._run_ocr(config, ctx)
    return ctx, known


@pytest.fixture(scope='module')
def contexts(tmp_path_factory):
    root = tmp_path_factory.mktemp('models')
    (root / 'upscaling').mkdir()
    torch.save({'params_ema': _realesrgan_state_dict(
        np.random.RandomState(0))},
        root / 'upscaling' / 'RealESRGAN_x4plus_anime_6B.pth')
    mp = pytest.MonkeyPatch()
    for key, val in (('MIT_TPU_MESH', '0'), ('MIT_TPU_DEVICE_CROPS', '0'),
                     ('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')):
        mp.setenv(key, val)

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)
    mp.setattr(jax_inference, 'MODULE_DIR', root)
    mp.setattr(inference, 'MODULE_DIR', root)
    for mod, attr in ((jax_colorization, '_colorizer_cache'),
                      (colorization, '_colorizer_cache'),
                      (jax_upscaling, '_upscaler_cache'),
                      (upscaling, '_upscaler_cache'),
                      (jax_ocr, '_ocr_cache'), (ocr, '_ocr_cache'),
                      (detection, '_detector_cache')):
        mp.setattr(mod, attr, {})
    try:
        det = detection.get_detector(Detector.default)
        det.device = torch.device('cpu')
        det.model = dbnet.build_dbnet('cpu', torch_state_dict_from_jax(
            {k: np.array(v) for k, v in
             jax_dbnet.init_params(jax.random.PRNGKey(0)).items()},
            dbnet.TRANSPOSED_CONV_PATTERNS))
        det._loaded = True
        page, boxes = make_page()
        port = asyncio.run(_run(port_mt.MangaTranslator({'use_gpu': False}),
                                Config(**CONFIG), page, boxes,
                                Quadrilateral))
        ref = asyncio.run(_run(jax_mt.MangaTranslator({'use_gpu': False}),
                               JConfig(**CONFIG), page, boxes,
                               JQuadrilateral))
    finally:
        mp.undo()
    return ref, port


def _close(a, b):
    a, b = np.asarray(a, int), np.asarray(b, int)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()


def test_colorized_and_upscaled_pages_match(contexts):
    (ref, _), (port, _) = contexts
    assert port.img_colorized.size == (PAGE_W, PAGE_H)
    _close(port.img_colorized, ref.img_colorized)
    assert port.upscaled.size == (2 * PAGE_W, 2 * PAGE_H)
    _close(port.upscaled, ref.upscaled)


def test_detected_lines_match(contexts):
    (ref, _), (port, _) = contexts
    assert ref.textlines, 'the reference detected no line'
    assert ([q.pts.tolist() for q in port.textlines]
            == [q.pts.tolist() for q in ref.textlines])


def test_known_lines_read_alike(contexts):
    """The 32px OCR on the known lines of the upscaled page: the same
    texts and colours (within one level); probabilities within 1e-3."""
    (_, ref), (_, port) = contexts
    assert len(ref) == 3
    assert [q.pts.tolist() for q in port] == [q.pts.tolist() for q in ref]
    assert [q.text for q in port] == [q.text for q in ref]
    np.testing.assert_allclose([q.prob for q in port], [q.prob for q in ref],
                               rtol=1e-3, atol=np.finfo(np.float32).tiny)
    for p, r in zip(port, ref):
        cp = (p.fg_r, p.fg_g, p.fg_b, p.bg_r, p.bg_g, p.bg_b)
        cr = (r.fg_r, r.fg_g, r.fg_b, r.bg_r, r.bg_g, r.bg_b)
        assert np.abs(np.subtract(cp, cr)).max() <= 1, (cp, cr)
