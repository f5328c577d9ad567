"""PyTorch port, the other detectors: ctd, craft, dbconvnext and paddle
against the JAX package's on the CPU, on the same seeded weights (each
JAX detector loads its init_params; the port's detectors load their own
``init_state_dict``, which are those draws bridged, see
test_torch_port_weights.py): each network's forward, each detector's
``dispatch`` on a page with drawn text, each host postprocess fed the
JAX maps, ctd's tall-page tiling path and paddle loaded from a synthetic
ONNX file. Every JAX reference is computed once, in the module's
fixture."""
import asyncio

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu import detection as jax_detection
from manga_image_translator_tpu.config import Detector as JDetector
from manga_image_translator_tpu.detection import craft as jax_craft
from manga_image_translator_tpu.detection import ctd as jax_ctd
from manga_image_translator_tpu.detection import ctd_textmask as jax_tm
from manga_image_translator_tpu.detection import dbnet_convnext as jax_cnx
from manga_image_translator_tpu.detection import paddle as jax_paddle
from manga_image_translator_tpu.detection.db_postprocess import \
    DBPostprocess as JDBPostprocess
from manga_image_translator_tpu.detection.paddle_onnx import \
    convert_graph as jax_convert_graph
from manga_image_translator_tpu.models import paddle_det as jax_paddle_det
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.utils import onnx_lite as jax_onnx_lite
from manga_image_translator_tpu.utils.geometry import \
    Quadrilateral as JQuadrilateral
from manga_image_translator_tpu_torch import detection
from manga_image_translator_tpu_torch.config import Detector
from manga_image_translator_tpu_torch.detection import craft as port_craft
from manga_image_translator_tpu_torch.detection import ctd as port_ctd
from manga_image_translator_tpu_torch.detection import ctd_textmask
from manga_image_translator_tpu_torch.detection import \
    dbnet_convnext as port_cnx
from manga_image_translator_tpu_torch.detection import paddle as port_paddle
from manga_image_translator_tpu_torch.detection.db_postprocess import \
    DBPostprocess
from manga_image_translator_tpu_torch.detection.paddle_onnx import \
    convert_graph
from manga_image_translator_tpu_torch.models import paddle_det
from manga_image_translator_tpu_torch.utils import onnx_lite
from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
from test_paddle_onnx import build_paddle_like_onnx

torch.set_num_threads(2)

KEYS = ('ctd', 'craft', 'dbconvnext', 'paddle')
DETECT_SIZE = 256
CANVAS = 256          # the forwards' canvas (dbconvnext's total stride 128)
# dispatch arguments, as tests/test_detectors_extra.py passes them
ARGS = dict(detect_size=DETECT_SIZE, text_threshold=0.5, box_threshold=0.7,
            unclip_ratio=2.3, invert=False, gamma_correct=False,
            rotate=False)


def text_page():
    """tests/test_detectors_extra.py's page: 300x260, one drawn line."""
    img = np.full((300, 260, 3), 255, np.uint8)
    cv2.putText(img, 'TEXT', (40, 150), cv2.FONT_HERSHEY_SIMPLEX, 1.5,
                (0, 0, 0), 3)
    return img


def tall_page():
    """A webtoon strip (needs_tiling at input size 256), three lines."""
    img = np.full((1000, 150, 3), 255, np.uint8)
    for i, word in enumerate(('TALL', 'PAGE', 'TILES')):
        cv2.putText(img, word, (12, 200 + 300 * i), cv2.FONT_HERSHEY_SIMPLEX,
                    1.3, (0, 0, 0), 3)
    return img


def _canvas_u8():
    """The drawn page's 256x256 crop around its line."""
    return np.ascontiguousarray(text_page()[20:20 + CANVAS, :CANVAS])


def _jax_maps(key, jdet, canvas):
    """The JAX network's maps on a uint8 (1, H, W, 3) canvas."""
    x = jnp.asarray(canvas)
    if key == 'ctd':
        return jax_ctd._forward_batch(jdet.params, x)
    if key == 'craft':
        return jax_craft._forward(jdet.params, jdet.refiner_params, x)
    if key == 'dbconvnext':
        return jax_cnx._forward_batch(jdet.params, x)
    return jax_paddle._forward(jdet.params, x)


def _port_maps(key, pdet, canvas):
    x = torch.from_numpy(canvas)
    if key == 'ctd':
        return port_ctd._forward_batch(pdet.model, x)
    if key == 'craft':
        return port_craft._forward(pdet.craft, pdet.refiner, x)
    if key == 'dbconvnext':
        return port_cnx._forward_batch(pdet.model, x)
    return port_paddle._forward(pdet.model, x)


def _dispatch(mod, key_cls, key, page):
    return asyncio.run(mod.dispatch(key_cls(key), page, device='cpu',
                                    **ARGS))


@pytest.fixture(scope='module')
def runs():
    mp = pytest.MonkeyPatch()
    mp.setenv('MIT_TPU_MESH', '0')
    mp.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)
    mp.setattr(jax_detection, '_detector_cache', {})
    mp.setattr(detection, '_detector_cache', {})
    out = {}
    try:
        canvas = _canvas_u8()[None]
        page = text_page()
        for key in KEYS:
            jdet = jax_detection.get_detector(JDetector(key))
            asyncio.run(jdet.load('cpu'))
            pdet = detection.get_detector(Detector(key))
            asyncio.run(pdet.load('cpu'))
            maps = ([np.asarray(m, np.float32)
                     for m in _jax_maps(key, jdet, canvas)],
                    [m.float().numpy() for m in _port_maps(key, pdet,
                                                           canvas)])
            det = (_dispatch(detection, Detector, key, page),
                   _dispatch(jax_detection, JDetector, key, page))
            out[key] = {'maps': maps, 'dispatch': det}
            if key == 'ctd':
                for d in (jdet, pdet):
                    d.input_size = 256
                tall = tall_page()
                out['ctd_tall'] = (
                    asyncio.run(pdet._infer(tall, DETECT_SIZE, 0.5, 0.7,
                                            2.3)),
                    asyncio.run(jdet._infer(tall, DETECT_SIZE, 0.5, 0.7,
                                            2.3)))
            # free the large networks (dbconvnext: ~150 M parameters)
            asyncio.run(jax_detection.unload(JDetector(key)))
            asyncio.run(detection.unload(Detector(key)))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize('key', KEYS)
def test_forward_matches_jax(runs, key):
    """Each network on a 256x256 canvas in f32: the JAX oracle's bound
    (rtol 1e-3, atol 2e-3, tests/test_model_oracle.py:72)."""
    ref, got = runs[key]['maps']
    assert len(ref) == len(got) == 2
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=2e-3)


def _assert_same_detection(got, ref, page_hw=None):
    """Equal lines (quads within 2 px) and raw masks within 1 level. On a
    page that got a border (``page_hw``: under 400 px), the JAX package's
    lines that start right of or below the page, which it clips to
    zero-width lines, are left out: the port drops them (ROADMAP §C)."""
    (lines, raw, mask), (jlines, jraw, jmask) = got, ref
    if page_hw is not None:
        h, w = page_hw
        jlines = [q for q in jlines if q.xyxy[0] < w and q.xyxy[1] < h]
    assert len(lines) == len(jlines)
    for q, jq in zip(sorted(lines, key=lambda q: q.pts.tolist()),
                     sorted(jlines, key=lambda q: q.pts.tolist())):
        assert np.abs(q.pts - jq.pts).max() <= 2
    assert raw.shape == jraw.shape and raw.dtype == jraw.dtype
    assert np.abs(raw.astype(int) - jraw.astype(int)).max() <= 1
    assert (mask is None) == (jmask is None)


@pytest.mark.parametrize('key', KEYS)
def test_dispatch_matches_jax(runs, key):
    """The 300x260 page through ``detection.dispatch`` (border added, the
    detector's own preprocessing and postprocess): equal line counts,
    quads within 2 px, raw masks within 1 level."""
    got, ref = runs[key]['dispatch']
    _assert_same_detection(got, ref, text_page().shape[:2])


def test_ctd_tall_page_tiling_matches_jax(runs):
    got, ref = runs['ctd_tall']
    _assert_same_detection(got, ref)


def test_db_postprocess_on_jax_maps_is_identical(runs):
    """The DB postprocess (dbconvnext, paddle; ctd's thresholds) on the JAX
    maps, as they are and with their lower half damped (more contours),
    gives the JAX result exactly."""
    for key, thresh, box in (('dbconvnext', 0.5, 0.7), ('paddle', 0.5, 0.7),
                             ('ctd', 0.3, 0.6)):
        ref, _ = runs[key]['maps']
        prob = ref[1][0, ..., 0] if key == 'ctd' else ref[0][0]
        for pred in (prob, np.where(prob > np.median(prob), prob,
                                    prob * 0.1)):
            boxes, scores = DBPostprocess(thresh, box, unclip_ratio=2.3)(
                pred, 260, 300)
            jboxes, jscores = JDBPostprocess(thresh, box, unclip_ratio=2.3)(
                pred, 260, 300)
            np.testing.assert_array_equal(boxes, jboxes)
            np.testing.assert_array_equal(scores, jscores)


def test_craft_boxes_on_jax_maps_are_identical(runs):
    ref, _ = runs['craft']['maps']
    text, link = ref[0][0], ref[1][0]
    for low in (0.3, 0.5):
        got = port_craft.get_det_boxes(text, link, 0.5, 0.7, low)
        want = jax_craft.get_det_boxes(text, link, 0.5, 0.7, low)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # a map with components: drawn blobs
    blobs = np.zeros((160, 160), np.float32)
    blobs[20:40, 10:90] = 0.9
    blobs[70:80, 30:150] = 0.8
    blobs[110:150, 60:70] = 0.95
    got = port_craft.get_det_boxes(blobs, blobs * 0.5, 0.7, 0.4, 0.4)
    want = jax_craft.get_det_boxes(blobs, blobs * 0.5, 0.7, 0.4, 0.4)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ctd_refine_mask_is_identical(runs):
    """ctd's textmask refinement on a drawn mask and on the JAX ctd mask
    map of the canvas, in each refine mode."""
    page = text_page()
    drawn = np.zeros(page.shape[:2], np.uint8)
    drawn[110:165, 30:230] = 200
    ref, _ = runs['ctd']['maps']
    canvas = _canvas_u8()
    jax_map = np.clip(ref[0][0] * 255, 0, 255).astype(np.uint8)
    quads = [[[35, 105], [225, 105], [225, 165], [35, 165]],
             [[0, 0], [40, 0], [40, 30], [0, 30]]]
    for img, mask in ((page, drawn), (canvas, jax_map)):
        for mode in (None, ctd_textmask.REFINEMASK_INPAINT,
                     ctd_textmask.REFINEMASK_ANNOTATION):
            got = ctd_textmask.refine_mask(
                img, mask, [Quadrilateral(np.array(q), '', 1.0)
                            for q in quads], refine_mode=mode)
            want = jax_tm.refine_mask(
                img, mask, [JQuadrilateral(np.array(q), '', 1.0)
                            for q in quads], refine_mode=mode)
            np.testing.assert_array_equal(got, want)
    assert got.shape == jax_map.shape


@pytest.mark.parametrize('fold_bn,skip_thresh', [(False, False),
                                                 (True, False),
                                                 (False, True)])
def test_paddle_from_onnx_matches_jax(fold_bn, skip_thresh):
    """A synthetic PP-OCR det ONNX file (tests/test_paddle_onnx.py's
    builder): both packages' converters, then both forwards, agree; the
    port's state dict loads strictly."""
    rs = np.random.RandomState(1)
    model_bytes, _ = build_paddle_like_onnx(rs, fold_bn=fold_bn,
                                            skip_thresh=skip_thresh)
    jparams = jax_convert_graph(jax_onnx_lite.parse_model(model_bytes))
    sd = {k: torch.from_numpy(v.copy()) for k, v in
          convert_graph(onnx_lite.parse_model(model_bytes)).items()}
    model = paddle_det.build_paddle_det('cpu', sd)
    x = np.random.RandomState(2).rand(1, 128, 96, 3).astype(np.float32)
    ref = np.asarray(jax.jit(jax_paddle_det.paddle_det_forward)(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(x)))
    with torch.no_grad():
        got = paddle_det.paddle_det_forward(model,
                                            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-3)
    assert ref[..., 0].std() > 1e-3


def test_paddle_loads_onnx_file(tmp_path, monkeypatch):
    """``PaddleDetector`` reads ``paddle-det.onnx`` from its model
    directory; without it and without the opt-in it refuses."""
    from manga_image_translator_tpu_torch.utils.inference import \
        MissingWeightsError
    rs = np.random.RandomState(3)
    model_bytes, inits = build_paddle_like_onnx(rs)
    (tmp_path / 'paddle-det.onnx').write_bytes(model_bytes)
    monkeypatch.setattr(port_paddle.PaddleDetector, 'model_dir',
                        property(lambda self: tmp_path))
    det = port_paddle.PaddleDetector()
    asyncio.run(det.load('cpu'))
    assert not det.using_random_weights
    np.testing.assert_array_equal(
        det.model.neck.p3.weight.detach().numpy(), inits['neck.p3.w'])
    (tmp_path / 'paddle-det.onnx').unlink()
    monkeypatch.delenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', raising=False)
    with pytest.raises(MissingWeightsError):
        asyncio.run(port_paddle.PaddleDetector().load('cpu'))


def test_ctd_loads_a_nested_checkpoint(tmp_path, monkeypatch):
    """The ctd checkpoint's three parts (``blk_det`` wrapped under
    ``weights``) flatten onto the port's module names, strictly."""
    from manga_image_translator_tpu_torch.models import ctd as ctd_model
    flat = ctd_model.init_state_dict()
    nested = {part: {k[len(part) + 1:]: v for k, v in flat.items()
                     if k.startswith(part + '.')}
              for part in port_ctd.PARTS}
    nested['blk_det'] = {'weights': nested['blk_det'], 'cfg': 'yolov5s'}
    torch.save(nested, tmp_path / 'comictextdetector.pt')
    monkeypatch.setattr(port_ctd.ComicTextDetector, 'model_dir',
                        property(lambda self: tmp_path))
    det = port_ctd.ComicTextDetector()
    asyncio.run(det.load('cpu'))
    assert not det.using_random_weights
    got = det.model.state_dict()
    for k, v in flat.items():
        assert torch.equal(got[k], v), k


def test_every_detector_is_ported():
    from manga_image_translator_tpu_torch.detection.default import \
        DefaultDetector
    from manga_image_translator_tpu_torch.detection.none_detector import \
        NoneDetector
    want = {Detector.default: DefaultDetector,
            Detector.ctd: port_ctd.ComicTextDetector,
            Detector.craft: port_craft.CRAFTDetector,
            Detector.dbconvnext: port_cnx.DBConvNextDetector,
            Detector.paddle: port_paddle.PaddleDetector,
            Detector.none: NoneDetector}
    assert set(want) == set(Detector)
    for key, cls in want.items():
        det = detection.DETECTORS[key]()
        assert type(det) is cls
        assert not hasattr(det, 'infer_batch') or key == Detector.default


def test_crf_refines_a_crop_past_the_bucket_cap():
    """A textline crop taller than the CRF buckets' cap (1024; ctd's random
    boxes give such crops on the card) is refined in tiles and keeps its
    shape: its rows past 1024 are the refinement of that tile alone. The
    JAX package's ``refine_masks_batched`` returns the first 1024 rows
    only, and its ``complete_mask`` then raises (ROADMAP §C: fixed in the
    port only)."""
    from manga_image_translator_tpu_torch.mask_refinement import \
        refine_masks_batched
    rs = np.random.RandomState(4)
    rgb = rs.randint(0, 256, (1100, 40, 3)).astype(np.uint8)
    raw = np.zeros((1100, 40), np.uint8)
    raw[100:1050, 10:30] = 255
    got, tail = refine_masks_batched([(rgb, raw),
                                      (rgb[1024:], raw[1024:])])
    assert got.shape == raw.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got[1024:], tail)
    assert got[:1024].max() == 255 and tail.max() == 255


def test_border_quads_right_of_the_page_are_dropped():
    """A page under 400 px gets a border; a quad found in the border right
    of the page (but not below it) is dropped. The JAX package keeps it,
    clipped to a zero-width line whose OCR crop would ask for a
    (816 M, 48, 3) array (ROADMAP §C: fixed in the port only)."""
    from manga_image_translator_tpu.detection.common import \
        CommonDetector as JCommon
    from manga_image_translator_tpu_torch.detection.common import \
        CommonDetector
    image = np.zeros((400, 400, 3), np.uint8)
    quads = [[[300, 40], [380, 40], [380, 60], [300, 60]],    # right of it
             [[20, 360], [90, 360], [90, 380], [20, 380]],    # below it
             [[20, 40], [120, 40], [120, 60], [20, 60]],      # on the page
             [[200, 40], [320, 40], [320, 60], [200, 60]]]    # straddles
    got, _, _ = CommonDetector._remove_border(
        None, image, 260, 300,
        [Quadrilateral(np.array(q), '', 1.0) for q in quads], None, None)
    want, _, _ = JCommon._remove_border(
        None, image, 260, 300,
        [JQuadrilateral(np.array(q), '', 1.0) for q in quads], None, None)
    assert [q.pts.tolist() for q in got] == [
        [[20, 40], [120, 40], [120, 60], [20, 60]],
        [[200, 40], [260, 40], [260, 60], [200, 60]]]
    assert len(want) == 4 and want[0].pts[:, 0].tolist() == [260] * 4
