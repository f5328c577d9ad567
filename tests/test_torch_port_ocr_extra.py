"""PyTorch port, the other OCRs: ``48px_ctc``, ``32px`` and ``mocr``
against the JAX package's on the CPU, on the same seeded weights (each
package's registry loads its own random init, and the port's
``init_state_dict`` are the JAX draws bridged, see
test_torch_port_weights.py): each network's tensors, the 32px beam search,
each backend through ``ocr.dispatch`` on a page with three known lines, and
mocr's box merge and colour path with its text model stubbed (neither its
weights nor a network are available). Every JAX reference is computed once,
in the module's fixture."""
import asyncio
import sys
import types

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu import ocr as jax_ocr
from manga_image_translator_tpu.config import Ocr as JOcr
from manga_image_translator_tpu.config import OcrConfig as JOcrConfig
from manga_image_translator_tpu.models import ocr32 as jax_ocr32
from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu.models import ocr48_ctc as jax_ctc
from manga_image_translator_tpu.models.functional import P
from manga_image_translator_tpu.ocr import model_manga_ocr as jax_mocr
from manga_image_translator_tpu.ocr.model_48px import _placeholder_dictionary
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.utils.geometry import \
    Quadrilateral as JQuadrilateral
from manga_image_translator_tpu_torch import ocr
from manga_image_translator_tpu_torch.config import Ocr, OcrConfig
from manga_image_translator_tpu_torch.models import ocr32, ocr48, ocr48_ctc
from manga_image_translator_tpu_torch.ocr import model_manga_ocr
from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

V = 64                       # the network tests' dictionary
MOCR_TEXT = '漫画'            # the stubbed text model's answer
# the page's lines: (text, origin, scale); the third one's box is tall
LINES = (('HELLO', (20, 60), 1.2), ('WORLD', (20, 130), 1.2),
         ('OCR', (200, 200), 0.9))


def _np(params):
    return {k: np.array(v) for k, v in params.items()}


def make_page():
    """A 320x240 page with three printed lines; returns it and their
    boxes."""
    img = np.full((240, 320, 3), 255, np.uint8)
    boxes = []
    for text, (x, y), scale in LINES:
        cv2.putText(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                    (0, 0, 0), 2)
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                         scale, 2)
        x0, y0, x1, y1 = x - 4, y - th - 4, x + tw + 4, y + base + 4
        boxes.append([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    return img, boxes


def _lines(cls, boxes):
    return [cls(np.array(b), '', 1.0) for b in boxes]


def _summary(regions):
    return [(q.pts.tolist(), q.text, q.prob,
             (q.fg_r, q.fg_g, q.fg_b, q.bg_r, q.bg_g, q.bg_b))
            for q in regions]


def _network_refs():
    """The networks' tensors through the JAX package, with their inputs."""
    rs = np.random.RandomState(5)
    out = {}
    p = jax_ctc.init_params(V)
    for w in (256, 384):
        x = rs.uniform(-1, 1, (2, 48, w, 3)).astype(np.float32)
        lp, col = jax_ctc.ctc_forward(p, jnp.asarray(x))
        out['ctc', w] = (x, np.asarray(lp), np.asarray(col))

    def first_step(p, x, vw):
        """The memory, its mask and the first step's log-probs."""
        mem = jax_ocr32.resnet_features(P(p).scope('backbone.ConvNet'), x)
        mask = (jnp.arange(mem.shape[1])[None, :]
                >= jnp.minimum((vw + 3) // 4 + 2, mem.shape[1])[:, None])
        mem = jax_ocr32.encoder_forward(p, mem, mask)
        caches = jax_ocr32.init_caches(p, mem, 2, 8)
        tok = jnp.full((2,), jax_ocr32.START_TOK, jnp.int32)
        dec, _ = jax_ocr32.decode_step(p, caches, tok, jnp.int32(0), mask)
        return mem, mask, jax_ocr32.char_logprobs(p, dec)

    p = jax_ocr32.init_params(V)
    x = rs.uniform(-1, 1, (2, 32, 128, 3)).astype(np.float32)
    vw = np.array([128, 72], np.int32)
    mem, mask, lp = jax.jit(first_step)(p, jnp.asarray(x), jnp.asarray(vw))
    beam = jax_ocr32.beam_decode(p, jnp.asarray(x), jnp.asarray(vw),
                                 beams_k=3, max_len=10)
    out['ocr32'] = (x, vw, np.asarray(mem), np.asarray(mask), np.asarray(lp),
                    {k: np.asarray(v) for k, v in beam.items()})
    return out


@pytest.fixture(scope='module')
def refs():
    mp = pytest.MonkeyPatch()
    for key, val in (('MIT_TPU_OCR_PALLAS', '0'), ('MIT_TPU_MESH', '0'),
                     ('MIT_TPU_OCR_BF16_BACKBONE', '0'),
                     ('MIT_TPU_DEVICE_CROPS', '0'),
                     ('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1'),
                     ('HF_HUB_OFFLINE', '1')):
        mp.setenv(key, val)

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)
    mp.setattr(jax_ocr, '_ocr_cache', {})
    mp.setattr(ocr, '_ocr_cache', {})
    jitted = (jax_ocr48.beam_decode, jax_ocr48.beam_decode_from_memory,
              jax_ocr48.compute_memory)
    for fn in jitted:
        fn._clear_cache()

    # mocr: the text model is stubbed on both sides; the colours come from
    # each package's 48px model, the port's holding the JAX draws
    async def jax_load(self, device):
        await self.color_model.load(device)
    mp.setattr(jax_mocr.ModelMangaOCR, '_load', jax_load)
    mp.setattr(jax_mocr.ModelMangaOCR, '_mocr_text',
               lambda self, img: MOCR_TEXT)
    mp.setattr(model_manga_ocr.ModelMangaOCR, '_load_text_model',
               lambda self: None)
    mp.setattr(model_manga_ocr.ModelMangaOCR, '_mocr_text',
               lambda self, img: MOCR_TEXT)
    try:
        out = {'nets': _network_refs()}
        page, boxes = make_page()
        out['page'] = (page, boxes)
        dictionary = _placeholder_dictionary()
        pm = ocr.get_ocr(Ocr.mocr)
        cm = pm.color_model
        cm.dictionary = dictionary
        cm.device = torch.device('cpu')
        cm.model = ocr48.build_ocr48(len(dictionary), 'cpu',
                                     torch_state_dict_from_jax(
            _np(jax_ocr48.init_params(len(dictionary))),
            embedding_patterns=ocr48.EMBEDDING_PATTERNS))
        cm._loaded = True
        for key in ('48px_ctc', '32px', 'mocr'):
            # random weights give probabilities far below the thresholds:
            # 0 keeps every line
            got = asyncio.run(ocr.dispatch(
                Ocr(key), page, _lines(Quadrilateral, boxes),
                OcrConfig(prob=0.0), device='cpu'))
            want = asyncio.run(jax_ocr.dispatch(
                JOcr(key), page, _lines(JQuadrilateral, boxes),
                JOcrConfig(prob=0.0), device='cpu'))
            out[key] = (got, want)
    finally:
        mp.undo()
        for fn in jitted:
            fn._clear_cache()
    return out


@pytest.fixture(scope='module')
def ctc_model():
    return ocr48_ctc.build_ocr48_ctc(V, 'cpu', ocr48_ctc.init_state_dict(V))


@pytest.fixture(scope='module')
def ocr32_model():
    return ocr32.build_ocr32(V, 'cpu', ocr32.init_state_dict(V))


@pytest.mark.parametrize('width', [256, 384])
def test_ocr48_ctc_network_matches_jax(refs, ctc_model, width):
    """Log-probs and colours within the JAX suite's oracle bound for this
    network (tests/test_model_oracle.py:376-378)."""
    x, lp, col = refs['nets']['ctc', width]
    got_lp, got_col = ocr48_ctc.ctc_forward(ctc_model, torch.from_numpy(x))
    np.testing.assert_allclose(got_lp.numpy(), lp, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got_col.numpy(), col, rtol=1e-3, atol=2e-3)
    assert np.array_equal(got_lp.numpy().argmax(-1), lp.argmax(-1))


def test_ocr32_memory_and_first_step_match_jax(refs, ocr32_model):
    x, vw, mem, mask, lp, _ = refs['nets']['ocr32']
    model = ocr32_model
    got_mem, got_mask = ocr32.compute_memory(model, torch.from_numpy(x),
                                             torch.from_numpy(vw))
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    np.testing.assert_allclose(got_mem.numpy(), mem, rtol=1e-3, atol=2e-3)
    dec = ocr32._Decoder(model, got_mem, got_mask, 8)
    got_lp = ocr32.char_logprobs(model, dec.step(
        torch.full((2,), ocr32.START_TOK), 0))
    np.testing.assert_allclose(got_lp.numpy(), lp, rtol=1e-3, atol=2e-3)


def test_ocr32_beam_decode_matches_jax(refs, ocr32_model):
    """Equal sequences; probabilities and colours within the oracle
    bound."""
    x, vw, _, _, _, beam = refs['nets']['ocr32']
    got = ocr32.beam_decode(ocr32_model, torch.from_numpy(x),
                            torch.from_numpy(vw), beams_k=3, max_len=10)
    np.testing.assert_array_equal(got['sequences'].numpy(),
                                  beam['sequences'])
    np.testing.assert_allclose(got['probs'].numpy(), beam['probs'],
                               rtol=1e-3)
    np.testing.assert_allclose(got['colors'].numpy(), beam['colors'],
                               rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize('key', ['48px_ctc', '32px', 'mocr'])
def test_dispatch_matches_jax(refs, key):
    """Each backend through ``ocr.dispatch`` on the page's three known
    lines: the same lines, texts and colours (within one level), the
    probabilities within 1e-3 (random weights give probabilities down to
    f32's subnormal range, which XLA's CPU flushes to zero: below the
    least normal f32 both count as equal)."""
    got, want = refs[key]
    assert len(want) > 0, f'{key}: the reference read no line'
    got, want = _summary(got), _summary(want)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-3, atol=np.finfo(np.float32).tiny)
    for g, w in zip(got, want):
        assert np.abs(np.subtract(g[3], w[3])).max() <= 1, (g, w)
    if key == 'mocr':
        assert all(g[1] == MOCR_TEXT for g in got)


def test_mocr_merge_bboxes_matches_jax(refs):
    _, boxes = refs['page']
    # two lines that merge (stacked, same height) and the page's three
    boxes = boxes + [[[20, 150], [120, 150], [120, 172], [20, 172]],
                     [[20, 176], [110, 176], [110, 198], [20, 198]]]
    got, got_idx = asyncio.run(model_manga_ocr.merge_bboxes(
        _lines(Quadrilateral, boxes), 320, 240))
    want, want_idx = asyncio.run(jax_mocr.merge_bboxes(
        _lines(JQuadrilateral, boxes), 320, 240))
    assert got_idx == want_idx
    assert any(len(i) > 1 for i in got_idx), got_idx
    assert [q.pts.tolist() for q in got] == [q.pts.tolist() for q in want]



def _fake_transformers(seen):
    """A stand-in ``transformers`` module: records where the model is put
    and where ``generate``'s inputs lie; ``seen['fail']`` makes
    ``generate`` raise."""
    class Model:
        @classmethod
        def from_pretrained(cls, name):
            seen['name'] = name
            return cls()

        def to(self, device):
            seen['model'] = torch.device(device)
            return self

        def eval(self):
            return self

        def generate(self, pixel_values, max_length):
            seen['inputs'] = pixel_values.device
            if seen.get('fail'):
                raise RuntimeError('the text model failed')
            return torch.zeros((1, 4), dtype=torch.long)

    class Processor:
        @classmethod
        def from_pretrained(cls, name):
            return cls()

        def __call__(self, pil, return_tensors):
            return types.SimpleNamespace(
                pixel_values=torch.zeros((1, 3, 8, 8)))

    class Tokenizer:
        @classmethod
        def from_pretrained(cls, name):
            return cls()

        def decode(self, ids, skip_special_tokens):
            return MOCR_TEXT[0] + ' ' + MOCR_TEXT[1:]

    fake = types.ModuleType('transformers')
    fake.VisionEncoderDecoderModel = Model
    fake.AutoImageProcessor = Processor
    fake.AutoTokenizer = Tokenizer
    return fake


def test_mocr_text_model_runs_on_its_device(monkeypatch):
    """mocr's text model and its inputs go to the device the backend is
    loaded on (``meta`` here, so that a tensor left on the host shows), and
    a failure of that model raises instead of keeping the 48px text."""
    seen = {}
    monkeypatch.setitem(sys.modules, 'transformers',
                        _fake_transformers(seen))
    monkeypatch.setattr(model_manga_ocr, 'device_named',
                        lambda name: torch.device('meta'))
    page, boxes = make_page()
    m = model_manga_ocr.ModelMangaOCR()

    async def color_load(device):
        seen['color'] = device

    async def color_infer(image, textlines, config, verbose):
        for q in textlines:
            q.text = '48px'
        return textlines
    monkeypatch.setattr(m.color_model, 'load', color_load)
    monkeypatch.setattr(m.color_model, '_infer', color_infer)
    asyncio.run(m._load('cuda'))
    assert seen['name'] == model_manga_ocr.MOCR_HF_ID
    assert seen['model'] == torch.device('meta')
    assert seen['color'] == 'cuda'
    found = asyncio.run(m._infer(page, _lines(Quadrilateral, boxes),
                                 OcrConfig(prob=0.0)))
    assert [q.text for q in found] == [MOCR_TEXT] * len(boxes)
    assert seen['inputs'] == torch.device('meta')
    seen['fail'] = True
    with pytest.raises(RuntimeError, match='the text model failed'):
        asyncio.run(m._infer(page, _lines(Quadrilateral, boxes),
                             OcrConfig(prob=0.0)))
