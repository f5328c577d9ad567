"""PyTorch port: ``parallel/mesh.py`` on an explicit mesh of eight CPU
devices (``make_mesh(devices=[cpu] * 8)``: the CPU stands in for eight
cards, and shards of one device run in turn) against the plain single-device
calls, and against the JAX package's mesh functions on the conftest's
virtual 8-device mesh, on the same seeded weights and inputs.

Tolerances: split against unsplit on the CPU in f32, 1e-5 (the OCR's
sequences equal); against the JAX package, the parity tolerances of the
port's other tests: detection maps 1e-3 after the bilateral prefilter
(ROADMAP §C), the AOT composite in f32 equal outside the mask (to the f32
rounding of /127.5 - 1) and within one grey level inside, 48px
probabilities within 1e-3 (subnormals equal), the DBNet training step's
loss within 1e-4 and each updated parameter within 1e-4 of its largest
|value| plus 1e-3 of the step's largest update, the tp encoder
within 2e-4 (tests/test_mesh.py:87)."""
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu.inpainting import inpainting_aot as jax_ia
from manga_image_translator_tpu.models import aot as jax_aot
from manga_image_translator_tpu.models import dbnet as jax_dbnet
from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu.models.functional import P as Pscope
from manga_image_translator_tpu.parallel import mesh as jmesh
from manga_image_translator_tpu_torch.config import InpainterConfig
from manga_image_translator_tpu_torch.detection import default
from manga_image_translator_tpu_torch.inpainting import (inpainting_aot,
                                                         inpainting_lama)
from manga_image_translator_tpu_torch.models import aot, dbnet, lama, ocr48
from manga_image_translator_tpu_torch.parallel import mesh
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

CPU8 = [torch.device('cpu')] * 8
TINY = np.finfo(np.float32).tiny


def _np(params):
    return {k: np.array(v) for k, v in params.items()}


@pytest.fixture()
def cpu_mesh(monkeypatch):
    """The serving mesh set to eight CPU devices for one test."""
    monkeypatch.setenv('MIT_TPU_MESH', 'auto')
    m = mesh.make_mesh(devices=CPU8)
    mesh.set_mesh(m)
    yield m
    mesh.set_mesh(None)


@pytest.fixture(scope='module')
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    return jmesh.make_mesh(8)


@pytest.fixture(scope='module')
def db_params():
    params = jax_dbnet.init_params(jax.random.PRNGKey(2))
    sd = torch_state_dict_from_jax(_np(params),
                                   dbnet.TRANSPOSED_CONV_PATTERNS)
    return params, sd


@pytest.fixture(scope='module')
def ocr_params():
    params = jax_ocr48.init_params(dict_size=48)
    model = ocr48.build_ocr48(48, 'cpu', torch_state_dict_from_jax(
        _np(params), embedding_patterns=ocr48.EMBEDDING_PATTERNS))
    return params, model


def _pages(n, size=256, seed=6):
    """Pages with white borders (the two packages' bilateral border rules
    agree there) around random pixels."""
    rs = np.random.RandomState(seed)
    pages = np.full((n, size, size, 3), 255, np.uint8)
    m = size // 8
    pages[:, m:-m, m:-m] = rs.randint(0, 256, (n, size - 2 * m,
                                               size - 2 * m, 3))
    return pages


# -- the mesh -----------------------------------------------------------------

def test_make_mesh_covers_its_devices():
    m = mesh.make_mesh(devices=CPU8)
    assert m.shape == {'dp': 4, 'tp': 2}
    assert mesh.mesh_devices(m) == 8 and len(m.devices) == 8
    m = mesh.make_mesh(4, tp=1, devices=CPU8)
    assert m.shape == {'dp': 4, 'tp': 1}
    m = mesh.make_mesh(devices=[torch.device('cpu')] * 3)
    assert m.shape == {'dp': 3, 'tp': 1}


def test_make_mesh_refuses_truncation(monkeypatch):
    with pytest.raises(ValueError):
        mesh.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError):
        mesh.make_mesh(8, tp=3, devices=CPU8)
    # by default the mesh covers the CUDA devices: none here
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(ValueError):
        mesh.make_mesh(2)


def test_get_mesh_none_on_one_card_or_when_off(monkeypatch):
    mesh.set_mesh(None)
    try:
        for count in (0, 1):
            monkeypatch.setattr(torch.cuda, 'device_count', lambda: count)
            mesh.set_mesh(None)
            assert mesh.get_mesh() is None
        mesh.set_mesh(mesh.make_mesh(devices=CPU8))
        assert mesh.get_mesh() is not None
        monkeypatch.setenv('MIT_TPU_MESH', '0')
        assert mesh.get_mesh() is None
    finally:
        mesh.set_mesh(None)


def test_sharded_batch_pads_and_crops_back(cpu_mesh):
    seen = []

    def fn(params, x, y):
        seen.append((x.shape[0], y.shape[0]))
        return {'sum': x + y + params, 'pair': (x * 2, y)}

    x = torch.arange(3 * 2, dtype=torch.float32).view(3, 2)
    y = torch.ones((3, 2))
    out = mesh.sharded_batch(fn, 'test.pad', torch.tensor(1.0), x, y)
    assert seen == [(1, 1)] * 8
    assert out['sum'].shape == (3, 2) and out['pair'][0].shape == (3, 2)
    np.testing.assert_array_equal(out['sum'].numpy(), (x + y + 1).numpy())
    np.testing.assert_array_equal(out['pair'][0].numpy(), (x * 2).numpy())
    mesh.set_mesh(None)
    seen.clear()
    out = mesh.sharded_batch(fn, 'test.pad', torch.tensor(1.0), x, y,
                             jit_fallback=lambda p, a, b: 'plain')
    assert out == 'plain' and seen == []


def test_run_on_devices_threads():
    """Jobs of one device run in turn on the caller's thread; distinct
    devices (here the CPU and the meta device) each on a thread of its
    own, and the results come back in order."""
    seen = []

    def job(i, barrier=None):
        seen.append((i, threading.get_ident()))
        if barrier is not None:
            # both devices' first jobs must be running at once
            barrier.wait(timeout=10)
        return i
    cpu, meta = torch.device('cpu'), torch.device('meta')
    assert mesh.run_on_devices([lambda i=i: job(i) for i in range(3)],
                               [cpu] * 3) == [0, 1, 2]
    assert {t for _, t in seen} == {threading.get_ident()}
    seen.clear()
    barrier = threading.Barrier(2)
    jobs = [lambda: job(0, barrier), lambda: job(1, barrier),
            lambda: job(2), lambda: job(3)]
    assert mesh.run_on_devices(jobs, [cpu, meta, cpu, meta]) == [0, 1, 2, 3]
    by_job = dict(seen)
    assert by_job[0] == by_job[2] != by_job[1] == by_job[3]
    assert threading.get_ident() not in by_job.values()


# -- the call sites, split against unsplit ------------------------------------

def test_detect_maps_split_matches_plain(db_params, cpu_mesh):
    _, sd = db_params
    model = dbnet.build_dbnet('cpu', sd)
    canvases = torch.from_numpy(_pages(3))
    got = default._detect_maps(model, canvases)
    mesh.set_mesh(None)
    want = default._detect_maps(model, canvases)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 3
        # f32 convolutions at another batch size: the maps' parity bound
        # at f32 (ROADMAP §C)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4)


def test_ocr48_memory_and_decode_split_match_plain(ocr_params, cpu_mesh):
    _, model = ocr_params
    rs = np.random.RandomState(5)
    images = torch.from_numpy(rs.rand(3, 48, 64, 3).astype(np.float32)
                              * 2 - 1)
    widths = torch.tensor([64, 40, 52], dtype=torch.int32)

    def run():
        mem, mask = ocr48.sharded_compute_memory(model, images, widths,
                                                 False)
        dec = ocr48.sharded_beam_decode_from_memory(model, mem, mask,
                                                    beams_k=2, max_len=6)
        return mem, mask, dec
    got = run()
    mesh.set_mesh(None)
    want = run()
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert got[2]['sequences'].shape[0] == 3
    np.testing.assert_array_equal(got[2]['sequences'].numpy(),
                                  want[2]['sequences'].numpy())
    np.testing.assert_allclose(got[2]['probs'].numpy(),
                               want[2]['probs'].numpy(), rtol=1e-5,
                               atol=TINY)


def _lama_inpainter():
    inp = inpainting_lama.LamaLargeInpainter()
    inp.device = torch.device('cpu')
    inp.model = lama.build_lama(2, lama.init_state_dict(2))
    inp._N_BLOCKS = 2
    return inp


def _aot_inpainter():
    inp = inpainting_aot.AotInpainter()
    inp.device = torch.device('cpu')
    inp.model = aot.build_aot('cpu', aot.init_state_dict())
    return inp


@pytest.mark.parametrize('make', [_lama_inpainter, _aot_inpainter],
                         ids=['lama', 'aot'])
def test_inpainter_batch_split_matches_plain(make, cpu_mesh):
    inp = make()
    rs = np.random.RandomState(7)
    imgs = rs.randint(0, 255, (3, 64, 64, 3)).astype(np.uint8)
    masks = np.zeros((3, 64, 64), np.uint8)
    masks[:, 16:40, 12:50] = 255
    cfg = InpainterConfig()
    got = inp._batch_forward(imgs, masks, cfg)
    mesh.set_mesh(None)
    want = inp._batch_forward(imgs, masks, cfg)
    assert got.shape == want.shape == (3, 64, 64, 3)
    # uint8 rounding of f32 / bf16 results: one level on isolated pixels
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.mean(got != want) < 1e-3


# -- against the JAX package's mesh functions ---------------------------------

def test_pipeline_step_matches_jax(mesh8, db_params, ocr_params,
                                   monkeypatch):
    """The page step on the port's 8-device CPU mesh against the JAX
    package's on its 8-device mesh (tests/test_mesh.py:91-115, at 256 px:
    DBNet's total stride), the OCR backbone in f32, AOT in f32."""
    for key, val in (('MIT_TPU_OCR_PALLAS', '0'),
                     ('MIT_TPU_OCR_BF16_BACKBONE', '0')):
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(jax_ia, '_aot_body',
                        functools.partial(jax_ia._aot_body,
                                          dtype=jnp.float32))
    monkeypatch.setattr(inpainting_aot, 'COMPUTE_DTYPE', torch.float32)
    jdb, sd = db_params
    jocr, ocr_model = ocr_params
    jaot = jax_aot.init_params()
    batch = 8
    rs = np.random.RandomState(8)
    pages = _pages(batch, seed=9)
    crops = rs.randint(0, 255, (batch, 48, 64, 3)).astype(np.uint8)
    widths = rs.randint(24, 65, batch).astype(np.int32)
    masks = np.zeros((batch, 256, 256, 1), np.float32)
    masks[:, 64:160, 80:200] = 1.0

    jstep = jmesh.pipeline_step(mesh8, jdb, jocr, jaot)
    with mesh8:
        want = [np.asarray(o) for o in jstep(
            (jdb, jocr, jaot), jnp.asarray(pages), jnp.asarray(crops),
            jnp.asarray(widths), jnp.asarray(masks))]
    pm = mesh.make_mesh(devices=CPU8)
    step = mesh.pipeline_step(pm, None, None, None)
    models = (dbnet.build_dbnet('cpu', sd), ocr_model,
              aot.build_aot('cpu', aot.init_state_dict()))
    got = [o.numpy() for o in step(
        models, torch.from_numpy(pages), torch.from_numpy(crops),
        torch.from_numpy(widths), torch.from_numpy(masks))]
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-3, atol=TINY)
    # the composite: outside the mask the page itself, inside within one
    # grey level of the JAX result (as test_torch_port_inpainters.py)
    inside = np.broadcast_to(masks > 0.5, got[3].shape)
    np.testing.assert_allclose(got[3][~inside], want[3][~inside], rtol=0,
                               atol=1e-6)
    assert np.abs(got[3] - want[3])[inside].max() <= 1 / 127.5


def test_train_step_matches_jax(mesh8, db_params):
    """One data-parallel SGD step (tests/test_mesh.py:118-140, at 256 px):
    the loss and every updated parameter, BatchNorm statistics included,
    against the JAX package's step on the same weights and batch; and the
    port's step on a mesh equal to one shard of the whole batch."""
    jparams, sd = db_params
    batch = mesh8.shape['dp']
    rng = np.random.default_rng(1)
    pages = rng.standard_normal((batch, 256, 256, 3)).astype(np.float32)
    tgt_prob = rng.random((batch, 256, 256)).astype(np.float32)
    tgt_mask = rng.random((batch, 128, 128)).astype(np.float32)
    lr = 1e-2
    jstep = jmesh.train_step_dbnet(mesh8)
    with mesh8:
        rep = jmesh.replicate(jparams, mesh8)
        jloss, jnew = jstep(rep, pages, tgt_prob, tgt_mask, jnp.float32(lr))
    jnew = torch_state_dict_from_jax(_np(jnew),
                                     dbnet.TRANSPOSED_CONV_PATTERNS)
    step = mesh.train_step_dbnet(mesh.make_mesh(devices=CPU8))
    args = (torch.from_numpy(pages), torch.from_numpy(tgt_prob),
            torch.from_numpy(tgt_mask), lr)
    loss, new = step(sd, *args)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert set(new) == set(jnew)
    # the f32 rounding of each parameter (1e-4 of its largest |value|)
    # plus 1e-3 of the step's largest update: gradients of 1e-8 differ
    # relatively by 1e-3 between the frameworks, far below what moves
    top = max(np.abs(jnew[k].numpy() - sd[k].numpy()).max() for k in new)
    moved = 0
    for k, v in new.items():
        w = jnew[k].numpy()
        np.testing.assert_allclose(
            v.numpy(), w, rtol=0,
            atol=1e-4 * np.abs(w).max() + 1e-3 * top, err_msg=k)
        moved += not np.array_equal(v.numpy(), sd[k].numpy())
    assert moved > len(new) // 2, f'only {moved} parameters moved'
    # one shard on one device: the same step
    loss1, new1 = mesh.train_step_dbnet(mesh.make_mesh(
        devices=[torch.device('cpu')], tp=1))(sd, *args)
    np.testing.assert_allclose(float(loss1), float(loss), rtol=1e-5)
    for k in new:
        np.testing.assert_allclose(new1[k].numpy(), new[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_ocr_params_tp_shard_shapes(ocr_params):
    """Each encoder feed-forward splits in two over tp=2: linear1 by its
    output columns, linear2 by its input rows (tests/test_mesh.py:44-59)."""
    _, model = ocr_params
    tp_model = mesh.shard_ocr_params_tp(model, mesh.make_mesh(devices=CPU8))
    assert len(tp_model.encoders) == len(model.encoders)
    for layer, ref in zip(tp_model.encoders, model.encoders):
        ff = layer.ff
        assert len(ff.w1) == len(ff.w2) == 2
        assert ff.w1[0].shape[0] * 2 == ref.linear1.weight.shape[0]
        assert ff.w2[0].shape[1] * 2 == ref.linear2.weight.shape[1]
    # the model itself is unchanged
    assert all(hasattr(layer, 'linear1') for layer in model.encoders)


def test_tp_sharded_encoder_matches_replicated_and_jax(ocr_params):
    """The tp-split encoder equals the whole one within 2e-4 and the JAX
    encoder on the same weights (tests/test_mesh.py:62-88)."""
    jparams, model = ocr_params
    rng = np.random.default_rng(0)
    crops = rng.integers(0, 255, (8, 48, 64, 3), dtype=np.uint8)
    mask = np.zeros((8, 16), bool)
    x = torch.from_numpy(crops).float() / 127.5 - 1.0
    feats = ocr48.convnext_features(model.backbone, x)
    tp_model = mesh.shard_ocr_params_tp(model, mesh.make_mesh(devices=CPU8))
    with torch.no_grad():
        want = ocr48.encoder_forward(model.encoders, feats,
                                     torch.from_numpy(mask))
        got = ocr48.encoder_forward(tp_model.encoders, feats,
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)

    def encode(p, crops, mask):
        feats = jax_ocr48.convnext_features(
            Pscope(p).scope('backbone'),
            crops.astype(jnp.float32) / 127.5 - 1.0)
        return jax_ocr48.encoder_forward(p, feats, mask)
    ref = np.asarray(jax.jit(encode)(jax_ocr48.fold_bn(jparams), crops,
                                     mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_serving_call_sites_keep_one_device_without_mesh(db_params,
                                                         monkeypatch):
    """With one card (or none) get_mesh is None and the call sites run
    their plain single-device bodies: nothing reaches data_parallel."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    mesh.set_mesh(None)

    def refuse(*a, **k):
        raise AssertionError('data_parallel reached without a mesh')
    monkeypatch.setattr(mesh, 'data_parallel', refuse)
    try:
        _, sd = db_params
        prob, _ = default._detect_maps(dbnet.build_dbnet('cpu', sd),
                                       torch.from_numpy(_pages(1)))
        assert prob.shape == (1, 256, 256)
        inp = _aot_inpainter()
        out = inp._batch_forward(np.zeros((1, 32, 32, 3), np.uint8),
                                 np.zeros((1, 32, 32), np.uint8),
                                 InpainterConfig())
        assert out.shape == (1, 32, 32, 3)
    finally:
        mesh.set_mesh(None)
