"""PyTorch port, inpainting and rendering in the whole pipeline: one
synthetic page through the JAX package's MangaTranslator.translate and the
port's, with the same seeded weights (the JAX package's init_params,
bridged), on the CPU: detector
``default`` at 256, OCR ``48px``, translator ``original``, inpainter
``lama_large`` (2 resnet blocks, f32) and renderer ``default``.

Random DBNet weights give a raw mask over almost the whole page, which
mask refinement rejects (an empty final mask, so nothing would be
inpainted). Both orchestrators' mask-refinement stage is therefore
replaced by the same mask, the page's dark strokes dilated; the stage's own
parity is test_torch_port_mask.py's."""
import asyncio

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax

from manga_image_translator_tpu import inpainting as jax_inpainting
from manga_image_translator_tpu import manga_translator as jax_mt
from manga_image_translator_tpu.config import Config as JConfig
from manga_image_translator_tpu.inpainting import inpainting_lama as jax_il
from manga_image_translator_tpu.models import dbnet as jax_dbnet
from manga_image_translator_tpu.models import lama as jax_lama
from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu.ocr.model_48px import _placeholder_dictionary
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu_torch import detection, inpainting, ocr
from manga_image_translator_tpu_torch import manga_translator as port_mt
from manga_image_translator_tpu_torch.config import (Config, Detector,
                                                     Inpainter, Ocr)
from manga_image_translator_tpu_torch.models import dbnet, lama, ocr48
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

N_BLOCKS = 2

CONFIG = {
    'detector': {'detector': 'default', 'detection_size': 256},
    # random OCR weights give probabilities ~1e-40: threshold 0 keeps the
    # lines, so that there is text to inpaint and to draw
    'ocr': {'ocr': '48px', 'prob': 0.0},
    'translator': {'translator': 'original', 'target_lang': 'ENG',
                   'enable_post_translation_check': False,
                   'no_text_lang_skip': True},
    'inpainter': {'inpainter': 'lama_large', 'inpainting_precision': 'fp32'},
    'render': {'renderer': 'default'},
}


def make_page():
    img = np.full((400, 300, 3), 255, np.uint8)
    cv2.putText(img, 'HELLO', (40, 100), cv2.FONT_HERSHEY_SIMPLEX, 1.5,
                (0, 0, 0), 3)
    cv2.putText(img, 'WORLD', (40, 200), cv2.FONT_HERSHEY_SIMPLEX, 1.5,
                (0, 0, 0), 3)
    return Image.fromarray(img)


async def stroke_mask(self, config, ctx):
    gray = cv2.cvtColor(ctx.img_rgb, cv2.COLOR_RGB2GRAY)
    return cv2.dilate(((gray < 128) * 255).astype(np.uint8),
                      np.ones((7, 7), np.uint8))


def _np(params):
    return {k: np.array(v) for k, v in params.items()}


@pytest.fixture(scope='module')
def contexts():
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
    # a JAX inpainter of its own: another test in this process may have
    # loaded the shared one with another block count
    mp.setattr(jax_inpainting, '_inpainter_cache', {})
    for mt in (jax_mt, port_mt):
        mp.setattr(mt.MangaTranslator, '_run_mask_refinement', stroke_mask)
    jitted = (jax_ocr48.beam_decode, jax_ocr48.beam_decode_from_memory,
              jax_ocr48.compute_memory)
    for fn in jitted:
        fn._clear_cache()
    try:
        # the port, with the JAX package's seeded weights
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
        port = asyncio.run(port_mt.MangaTranslator({'use_gpu': False})
                           .translate(make_page(), Config(**CONFIG)))
        ref = asyncio.run(jax_mt.MangaTranslator({'use_gpu': False})
                          .translate(make_page(), JConfig(**CONFIG)))
    finally:
        mp.undo()
        for fn in jitted:
            fn._clear_cache()
        # the port's registry keeps no 2-block generator for later tests
        inpainting._inpainter_cache.pop(Inpainter.lama_large, None)
    return ref, port


def test_same_regions_and_mask(contexts):
    ref, port = contexts
    assert ref.text_regions, 'the reference found no text regions'
    assert ([r.translation for r in port.text_regions]
            == [r.translation for r in ref.text_regions])
    np.testing.assert_array_equal(port.mask, ref.mask)
    assert (port.mask > 0).any()


def test_same_inpainted_page(contexts):
    """Outside the mask equal (and equal to the input); inside within 1
    gray."""
    ref, port = contexts
    inside = port.mask >= 127
    np.testing.assert_array_equal(port.img_inpainted[~inside],
                                  ref.img_inpainted[~inside])
    np.testing.assert_array_equal(port.img_inpainted[~inside],
                                  port.img_rgb[~inside])
    diff = np.abs(port.img_inpainted.astype(int)
                  - ref.img_inpainted.astype(int))[inside]
    assert diff.max() <= 1


def test_same_rendered_page(contexts):
    """The final image: equal outside the mask, within 1 gray inside;
    text was drawn."""
    ref, port = contexts
    got, want = np.asarray(port.result), np.asarray(ref.result)
    assert got.shape == want.shape == (400, 300, 3)
    inside = port.mask >= 127
    np.testing.assert_array_equal(got[~inside], want[~inside])
    assert np.abs(got.astype(int) - want.astype(int))[inside].max() <= 1
    assert (port.img_rendered != port.img_inpainted).any()
