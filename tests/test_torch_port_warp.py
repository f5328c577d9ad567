"""PyTorch port: the device OCR crops (``ops/warp.py``) against the JAX
package's, and the OCRs' crop routing under ``MIT_TPU_DEVICE_CROPS``.

Every warp function runs on the cases of tests/test_warp_crops.py
(horizontal, rotated, vertical, partly off the page, a TextBlock line,
degenerate, too tall to be separable, a mixed chunk) and must agree with
the JAX function within that suite's tolerance, atol 2e-5 and rtol 1e-5.
Then the 48px OCR's ``_infer`` of both packages on their default crop
setting (the variable unset: ``auto``) must feed the model the same crops,
within the same tolerance, and read the same lines; 32px and 48px_ctc must
do so at ``MIT_TPU_DEVICE_CROPS=1``."""
import asyncio
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_image_translator_tpu import ocr as jax_ocr
from manga_image_translator_tpu.config import Ocr as JOcr
from manga_image_translator_tpu.config import OcrConfig as JOcrConfig
from manga_image_translator_tpu.models import ocr32 as jax_ocr32
from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu.models import ocr48_ctc as jax_ctc
from manga_image_translator_tpu.ocr import model_48px as jax_m48
from manga_image_translator_tpu.ops import warp as jwarp
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.utils.geometry import \
    Quadrilateral as JQuadrilateral
from manga_image_translator_tpu.utils.textblock import TextBlock as JTextBlock
from manga_image_translator_tpu_torch import ocr
from manga_image_translator_tpu_torch.config import Ocr, OcrConfig
from manga_image_translator_tpu_torch.models import ocr32, ocr48, ocr48_ctc
from manga_image_translator_tpu_torch.ocr import model_48px as m48
from manga_image_translator_tpu_torch.ops import warp
from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
from manga_image_translator_tpu_torch.utils.textblock import TextBlock
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

TH = 48
TOL = dict(atol=2e-5, rtol=1e-5)       # tests/test_warp_crops.py:166
TINY = np.finfo(np.float32).tiny


def _page(h=400, w=600, seed=0):
    """tests/test_warp_crops.py's smooth page: a low-frequency gradient
    with mild noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 0.3 + yy * 0.2) % 256
    img = np.stack([base, 255 - base, (xx * 0.1) % 256], -1)
    img += rs.randn(h, w, 3) * 3
    return np.clip(img, 0, 255).astype(np.uint8)


def _rotated(angle, centre, half=(120, 25)):
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    hx, hy = half
    base = np.array([[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]])
    return base @ R.T + np.array(centre)


# (points, direction) of tests/test_warp_crops.py's cases
QUADS = {
    'horizontal': ([[50, 100], [350, 100], [350, 160], [50, 160]], 'h'),
    'rotated': (_rotated(0.2, (300, 200)), 'h'),
    'vertical': ([[200, 40], [260, 40], [260, 340], [200, 340]], 'v'),
    'off_page': ([[-30, 100], [200, 100], [200, 150], [-30, 150]], 'h'),
    'off_page_corner': ([[-40, -20], [260, -20], [260, 40], [-40, 40]], 'h'),
    'degenerate': ([[10, 10], [10, 10], [10, 10], [10, 10]], 'h'),
    'too_tall': ([[0, 0], [400, 0], [400, 200], [0, 200]], 'h'),
}


def _pair(pts):
    pts = np.asarray(pts, np.float64)
    return JQuadrilateral(pts, '', 0.9), Quadrilateral(pts, '', 0.9)


def _both(fn_name, img, *args, **kwargs):
    """The JAX function and the port's on the same page and arguments."""
    want = np.asarray(getattr(jwarp, fn_name)(jnp.asarray(img), *args,
                                              **kwargs))
    got = getattr(warp, fn_name)(torch.from_numpy(img), *args, **kwargs)
    return got.numpy(), want


@pytest.mark.parametrize('case', sorted(QUADS))
def test_crop_plan_and_gather_match_jax(case):
    """crop_plan_quad gives the same width and homography (and sets the
    direction on the quad); crop_batch the same crop."""
    img = _page()
    pts, direction = QUADS[case]
    jq, q = _pair(pts)
    w_j, H_j = jwarp.crop_plan_quad(jq, direction, TH)
    w, H = warp.crop_plan_quad(q, direction, TH)
    assert w == w_j
    np.testing.assert_array_equal(H, H_j)
    assert q.assigned_direction == jq.assigned_direction
    got, want = _both('crop_batch', img, H[None], np.asarray([w], np.int32),
                      out_h=TH, out_w=w)
    np.testing.assert_allclose(got, want, **TOL)
    if case == 'degenerate':
        assert np.allclose(got, -1.0)


@pytest.mark.parametrize('case', sorted(QUADS))
def test_separable_plan_and_auto_match_jax(case):
    """separable_plan decides alike; crop_batch_auto takes the same route
    and gives the same crop, twice as wide as the quad's own width (the
    padding columns included)."""
    img = _page()
    pts, direction = QUADS[case]
    jq, q = _pair(pts)
    w, H = warp.crop_plan_quad(q, direction, TH)
    plan = warp.separable_plan(H, TH, w, warp.SEP_SRC_H, 2 * w)
    assert plan == jwarp.separable_plan(H, TH, w, jwarp.SEP_SRC_H, 2 * w)
    if case in ('rotated', 'too_tall', 'vertical'):
        # a vertical line's output rows run along the page's x axis
        assert plan is None
    else:
        assert plan is not None
    got, want = _both('crop_batch_auto', img, H[None],
                      np.asarray([w], np.int32), out_h=TH, out_w=2 * w)
    np.testing.assert_allclose(got, want, **TOL)


def test_separable_batch_and_patch_match_jax():
    """crop_batch_separable and its patched form on two axis-aligned
    quads, one row patched twice (duplicate rows)."""
    img = _page()
    plans = []
    for pts in ([[50, 100], [350, 100], [350, 160], [50, 160]],
                [[10, 20], [210, 20], [210, 60], [10, 60]]):
        plans.append(warp.crop_plan_quad(_pair(pts)[1], 'h', TH))
    bw = 384
    sep = [warp.separable_plan(H, TH, bw, warp.SEP_SRC_H, 2 * bw)
           for _w, H in plans]
    origins = np.asarray([p[0] for p in sep], np.int32)
    ycoef = np.asarray([p[1] for p in sep], np.float32)
    xcoef = np.asarray([p[2] for p in sep], np.float32)
    valid = np.asarray([w for w, _H in plans], np.int32)
    kw = dict(out_h=TH, out_w=bw, src_h=warp.SEP_SRC_H, src_w=2 * bw)
    got = warp.crop_batch_separable(torch.from_numpy(img), origins, ycoef,
                                    xcoef, valid, **kw)
    want = jwarp.crop_batch_separable(
        jnp.asarray(img), jnp.asarray(origins), jnp.asarray(ycoef),
        jnp.asarray(xcoef), jnp.asarray(valid), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rows = np.asarray([1, 1], np.int32)
    vals = np.random.RandomState(1).uniform(
        -1, 1, (1, TH, bw, 3)).astype(np.float32).repeat(2, 0)
    got = warp.crop_batch_separable_patched(
        torch.from_numpy(img), origins, ycoef, xcoef, valid, rows, vals,
        **kw)
    want = jwarp.crop_batch_separable_patched(
        jnp.asarray(img), jnp.asarray(origins), jnp.asarray(ycoef),
        jnp.asarray(xcoef), jnp.asarray(valid), jnp.asarray(rows),
        jnp.asarray(vals), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), vals[0])


@pytest.mark.parametrize('vertical', [False, True])
def test_textblock_plan_matches_jax(vertical):
    img = _page()
    line = [[60, 60], [300, 60], [300, 110], [60, 110]]
    blocks = []
    for cls in (JTextBlock, TextBlock):
        blk = cls(lines=[line])
        blk.src_is_vertical = vertical
        blocks.append(blk)
    w_j, H_j = jwarp.crop_plan_textblock(blocks[0], 0, TH)
    w, H = warp.crop_plan_textblock(blocks[1], 0, TH)
    assert w == w_j
    np.testing.assert_array_equal(H, H_j)
    got, want = _both('crop_batch', img, H[None], np.asarray([w], np.int32),
                      out_h=TH, out_w=w)
    np.testing.assert_allclose(got, want, **TOL)


def test_warp_primitives_match_jax():
    """homography_from_quad, warp_perspective, warp_quads_batch and
    bilinear_sample on a float image (tests/test_ops.py's TestWarp)."""
    rs = np.random.RandomState(2)
    img = rs.rand(100, 120, 3).astype(np.float32)
    quad = np.array([[20, 10], [90, 15], [88, 45], [18, 40]], np.float32)
    H = warp.homography_from_quad(quad, 64, 32)
    np.testing.assert_array_equal(H, jwarp.homography_from_quad(quad, 64, 32))
    got, want = _both('warp_perspective', img, H.astype(np.float32),
                      (32, 64))
    np.testing.assert_allclose(got, want, **TOL)
    Hs = np.stack([H, warp.homography_from_quad(quad + 7, 64, 32)])
    got, want = _both('warp_quads_batch', img, Hs.astype(np.float32),
                      (32, 64))
    np.testing.assert_allclose(got, want, **TOL)
    xs = rs.uniform(-3, 123, (5, 7)).astype(np.float32)
    ys = rs.uniform(-3, 103, (5, 7)).astype(np.float32)
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(img),
                                            jnp.asarray(xs), jnp.asarray(ys)))
    got = warp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xs),
                               torch.from_numpy(ys)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


MIXED = [[[50, 100], [350, 100], [350, 160], [50, 160]],
         _rotated(0.25, (300, 250)),
         [[10, 20], [210, 20], [210, 60], [10, 60]]]


def test_mixed_chunk_matches_jax():
    """crop_chunk_mixed: two separable rows, one host-warped row patched
    in and one padding row, as tests/test_warp_crops.py's
    TestMixedChunkRouting; and the all-separable chunk."""
    img = _page(500, 600)
    jquads, quads = zip(*(_pair(p) for p in MIXED))
    plans = [warp.crop_plan_quad(q, 'h', TH) for q in quads]
    jplans = [jwarp.crop_plan_quad(q, 'h', TH) for q in jquads]
    ws = [p[0] for p in plans]
    host = {1: quads[1].get_transformed_region(img, 'h', TH)}
    jhost = {1: jquads[1].get_transformed_region(img, 'h', TH)}
    np.testing.assert_array_equal(host[1], jhost[1])
    bw = max(ws)
    valid = np.zeros((4,), np.int32)
    valid[:3] = [min(w, bw) for w in ws]
    got = warp.crop_chunk_mixed(torch.from_numpy(img), plans, [0, 1, 2],
                                host, valid, TH, bw, 4).numpy()
    want = np.asarray(jwarp.crop_chunk_mixed(
        jnp.asarray(img), jplans, [0, 1, 2], jhost, valid, TH, bw, 4))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.allclose(got[3], -1.0)
    got = warp.crop_chunk_mixed(torch.from_numpy(img), plans, [0, 2], {},
                                valid[[0, 2]], TH, bw, 2).numpy()
    want = np.asarray(jwarp.crop_chunk_mixed(
        jnp.asarray(img), jplans, [0, 2], {}, valid[[0, 2]], TH, bw, 2))
    np.testing.assert_allclose(got, want, **TOL)


# -- the OCRs' crop routing ---------------------------------------------------

def _offline(mp):
    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)


JITTED = (jax_ocr48.beam_decode, jax_ocr48.beam_decode_from_memory,
          jax_ocr48.compute_memory)

# the 48px pages: (page size, quads); every quad reads 'h'
PAGES_48 = {
    # every quad axis-aligned: the separable resampler
    'separable': ((256, 384), [[[40, 60], [300, 60], [300, 104], [40, 104]],
                               [[50, 150], [260, 150], [260, 190],
                                [50, 190]]]),
    # one rotated quad among axis-aligned ones: warped by cv2, patched in
    'patched': ((500, 600), MIXED),
    # more rotated than axis-aligned quads: host crops
    'host': ((500, 600), [MIXED[0], _rotated(0.25, (300, 250)),
                          _rotated(-0.3, (300, 400), (100, 20))]),
}
ROUTES_48 = {'separable': ['separable'],
             'patched': ['patched', 'separable'],
             'host': []}


def _record(mp, module, name, log, tag=None, arg=1):
    """Wrap ``module.name`` to log its ``arg``-th argument (or ``tag``)."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        log.append(tag if tag is not None else np.array(args[arg]))
        return fn(*args, **kwargs)
    mp.setattr(module, name, wrapped)


@pytest.fixture(scope='module')
def ocr48_runs():
    """The 48px ``_infer`` of both packages on each page, on their default
    crop setting (MIT_TPU_DEVICE_CROPS unset), with the images each model
    was fed and the port's resampler routes."""
    mp = pytest.MonkeyPatch()
    mp.delenv('MIT_TPU_DEVICE_CROPS', raising=False)
    for key, val in (('MIT_TPU_OCR_PALLAS', '0'), ('MIT_TPU_MESH', '0'),
                     ('MIT_TPU_OCR_BF16_BACKBONE', '0')):
        mp.setenv(key, val)
    for mod in (jax_m48, m48):
        mp.setattr(mod, 'MAX_SEQ_LEN', 8)
        mp.setattr(mod, 'FAST_SEQ_LEN', 8)
    for fn in JITTED:
        fn._clear_cache()
    params = jax_ocr48.init_params(dict_size=64)
    ref = jax_m48.Model48pxOCR.__new__(jax_m48.Model48pxOCR)
    ref.params = jax_ocr48.fuse_qkv_params(jax_ocr48.fold_bn(params))
    ref.dictionary = jax_m48._placeholder_dictionary()[:64]
    ref.logger = logging.getLogger('test')
    port = m48.Model48pxOCR()
    port.device = torch.device('cpu')
    port.dictionary = ref.dictionary
    port.model = ocr48.build_ocr48(64, 'cpu', torch_state_dict_from_jax(
        {k: np.array(v) for k, v in params.items()},
        embedding_patterns=ocr48.EMBEDDING_PATTERNS))
    fed_j, fed_p, routes = [], [], []
    _record(mp, jax_ocr48, 'sharded_compute_memory', fed_j)
    _record(mp, port, '_compute_memory', fed_p, arg=0)
    for name, tag in (('crop_batch_separable', 'separable'),
                      ('crop_batch_separable_patched', 'patched'),
                      ('crop_batch', 'gather')):
        _record(mp, warp, name, routes, tag=tag)
    out = {}
    try:
        for case, ((h, w), quads) in PAGES_48.items():
            img = _page(h, w, seed=3)
            for log in (fed_j, fed_p, routes):
                log.clear()
            want = asyncio.run(ref._infer(
                img, [JQuadrilateral(np.asarray(q, np.float64), '', 0.9)
                      for q in quads], JOcrConfig(prob=0.0)))
            got = asyncio.run(port._infer(
                img, [Quadrilateral(np.asarray(q, np.float64), '', 0.9)
                      for q in quads], OcrConfig(prob=0.0)))
            out[case] = (got, want, list(fed_p), list(fed_j), list(routes))
    finally:
        mp.undo()
        for fn in JITTED:
            fn._clear_cache()
    return out


def _summary(regions):
    return [(q.pts.tolist(), q.text, q.prob,
             (q.fg_r, q.fg_g, q.fg_b, q.bg_r, q.bg_g, q.bg_b))
            for q in regions]


def _same_lines(got, want):
    """The same lines and texts, probabilities within 1e-3 (subnormal ones
    count as equal: XLA's CPU flushes them to zero), colours within one
    level."""
    assert len(want) > 0, 'the reference read no line'
    got, want = _summary(got), _summary(want)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-3, atol=TINY)
    for g, w in zip(got, want):
        assert np.abs(np.subtract(g[3], w[3])).max() <= 1, (g, w)


@pytest.mark.parametrize('case', sorted(PAGES_48))
def test_ocr48_default_reads_the_same_crops_as_jax(ocr48_runs, case):
    """The default 48px OCR cuts the crops the JAX package cuts on its
    default ``auto`` path (within 2e-5), by the same route, and reads the
    same lines."""
    got, want, fed_p, fed_j, routes = ocr48_runs[case]
    assert routes == ROUTES_48[case]
    assert len(fed_p) == len(fed_j) == 1
    assert fed_p[0].shape == fed_j[0].shape
    np.testing.assert_allclose(fed_p[0], fed_j[0], **TOL)
    _same_lines(got, want)


@pytest.mark.parametrize('env,route', [('0', []), ('1', ['separable'])])
def test_ocr48_forced_settings(env, route, monkeypatch):
    """``0`` forces host crops, ``1`` the device (``crop_batch_auto``: the
    separable resampler for an axis-aligned page)."""
    monkeypatch.setenv('MIT_TPU_DEVICE_CROPS', env)
    monkeypatch.setattr(m48, 'MAX_SEQ_LEN', 8)
    monkeypatch.setattr(m48, 'FAST_SEQ_LEN', 8)
    (h, w), quads = PAGES_48['separable']
    img = _page(h, w, seed=3)
    port = m48.Model48pxOCR()
    port.device = torch.device('cpu')
    port.dictionary = m48._placeholder_dictionary()[:64]
    port.model = ocr48.build_ocr48(64, 'cpu', ocr48.init_state_dict(64))
    fed, routes = [], []
    _record(monkeypatch, port, '_compute_memory', fed, arg=0)
    for name, tag in (('crop_batch_separable', 'separable'),
                      ('crop_batch_separable_patched', 'patched'),
                      ('crop_batch', 'gather')):
        _record(monkeypatch, warp, name, routes, tag=tag)
    lines = [Quadrilateral(np.asarray(q, np.float64), '', 0.9)
             for q in quads]
    asyncio.run(port._infer(img, lines, OcrConfig(prob=0.0)))
    assert routes == route
    host = np.zeros_like(fed[0])
    crops = sorted((q.get_transformed_region(img, 'h', TH) for q in lines),
                   key=lambda c: c.shape[1])
    for i, crop in enumerate(crops):
        host[i, :, :crop.shape[1]] = crop
    host = host / 127.5 - 1.0
    if env == '0':
        np.testing.assert_array_equal(fed[0], host)
    else:
        # the two resamplers differ (tests/test_warp_crops.py:37)
        assert not np.allclose(fed[0], host, **TOL)


# a page with three axis-aligned lines and a rotated one, for 32px and
# 48px_ctc at MIT_TPU_DEVICE_CROPS=1 (the gather path: one rotated quad)
EXTRA_QUADS = [[[20, 30], [200, 30], [200, 62], [20, 62]],
               [[20, 90], [150, 90], [150, 118], [20, 118]],
               [[40, 150], [280, 150], [280, 190], [40, 190]],
               _rotated(0.15, (160, 215), (90, 14))]


@pytest.fixture(scope='module')
def extra_runs():
    """32px and 48px_ctc through both packages' ``ocr.dispatch`` at
    MIT_TPU_DEVICE_CROPS=1, each registry on its random init (the port's
    init_state_dict are the JAX draws), with the images each network was
    fed."""
    mp = pytest.MonkeyPatch()
    for key, val in (('MIT_TPU_DEVICE_CROPS', '1'), ('MIT_TPU_MESH', '0'),
                     ('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')):
        mp.setenv(key, val)
    _offline(mp)
    mp.setattr(jax_ocr, '_ocr_cache', {})
    mp.setattr(ocr, '_ocr_cache', {})
    fed = {k: ([], []) for k in ('32px', '48px_ctc')}
    _record(mp, jax_ocr32, 'beam_decode', fed['32px'][1])
    _record(mp, ocr32, 'beam_decode', fed['32px'][0])
    _record(mp, jax_ctc, 'ctc_forward', fed['48px_ctc'][1])
    _record(mp, ocr48_ctc, 'ctc_forward', fed['48px_ctc'][0])
    img = _page(240, 320, seed=4)
    out = {}
    try:
        for key in fed:
            got = asyncio.run(ocr.dispatch(
                Ocr(key), img, [Quadrilateral(np.asarray(q, np.float64), '',
                                              1.0) for q in EXTRA_QUADS],
                OcrConfig(prob=0.0), device='cpu'))
            want = asyncio.run(jax_ocr.dispatch(
                JOcr(key), img, [JQuadrilateral(np.asarray(q, np.float64),
                                                '', 1.0)
                                 for q in EXTRA_QUADS],
                JOcrConfig(prob=0.0), device='cpu'))
            out[key] = (got, want) + fed[key]
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize('key', ['32px', '48px_ctc'])
def test_device_crops_opt_in_matches_jax(extra_runs, key):
    got, want, fed_p, fed_j = extra_runs[key]
    assert len(fed_p) == len(fed_j) == 1
    assert fed_p[0].shape == fed_j[0].shape
    np.testing.assert_allclose(fed_p[0], fed_j[0], **TOL)
    _same_lines(got, want)
