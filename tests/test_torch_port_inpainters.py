"""PyTorch port, the other inpainters: AOT (``Inpainter.default``) and
LaMa-MPE (``lama_mpe``) against the JAX package's on the CPU, on the same
seeded weights (the JAX package's init_params, bridged): the masked
position encoding, the MPE generator, ``inpaint()`` on crops and on the
full-page path, and ``MangaTranslator._batch_inpaint`` on two pages.

Random AOT weights in bf16 are chaotic: the JAX package's own bf16 result
is as far from its f32 result (up to 2.0 on [-1, 1], 0.35 on average at
96x128) as from the port's bf16 result, so both packages' AOT forward is
held in f32 here (``COMPUTE_DTYPE`` of the port, the JAX ``_aot_forward``'s
dtype); LaMa-MPE runs at precision fp32, as the LaMa-large tests do."""
import asyncio

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_image_translator_tpu import inpainting as jax_inpainting
from manga_image_translator_tpu import manga_translator as jax_mt
from manga_image_translator_tpu.config import Config as JConfig
from manga_image_translator_tpu.config import Inpainter as JInpainter
from manga_image_translator_tpu.config import InpainterConfig as JICfg
from manga_image_translator_tpu.inpainting import inpainting_aot as jax_ia
from manga_image_translator_tpu.models import aot as jax_aot
from manga_image_translator_tpu.models import lama as jax_lama
from manga_image_translator_tpu.models.torch_loader import convert_state_dict
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.utils.generic import Context as JContext
from manga_image_translator_tpu_torch import inpainting
from manga_image_translator_tpu_torch import manga_translator as port_mt
from manga_image_translator_tpu_torch.config import (Config, Inpainter,
                                                     InpainterConfig)
from manga_image_translator_tpu_torch.inpainting import (inpainting_aot,
                                                         inpainting_lama)
from manga_image_translator_tpu_torch.models import aot, lama
from manga_image_translator_tpu_torch.utils import profiling
from manga_image_translator_tpu_torch.utils.generic import Context
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

SIZE = 2048          # the default inpainting size: crops at native scale
ALPHA = 0.5          # MPE scales: the init's 0 would switch MPE off


def make_page(h, w, seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    page = np.stack([(xx * 255 // w), (yy * 255 // h),
                     np.full((h, w), 200)], -1).astype(np.uint8)
    return np.clip(page.astype(int) + rs.randint(-20, 21, page.shape),
                   0, 255).astype(np.uint8)


def two_blob_mask(h, w, shift=0):
    mask = np.zeros((h, w), np.uint8)
    mask[30:50, 40:100] = 255
    mask[150 + shift:200 + shift, 180:330] = 255
    return mask


def border_mask(h, w, b):
    mask = np.zeros((h, w), np.uint8)
    mask[b:h - b, b:w - b] = 255
    return mask


PAGES = {
    'two_crops': (make_page(256, 384, 1), two_blob_mask(256, 384)),
    'full_page': (make_page(136, 200, 2), border_mask(136, 200, 8)),
}
# full-page path at 48x64: AOT's /4 trunk is 12x16, so its rate-16 reflect
# pad reaches past both edges (numpy reflects again; F.pad would raise)
TINY = (make_page(48, 64, 3), border_mask(48, 64, 4))
BATCH_PAGES = [(make_page(256, 384, 4), two_blob_mask(256, 384, 0)),
               (make_page(256, 384, 5), two_blob_mask(256, 384, 20))]


def _np(params):
    return {k: np.array(v) for k, v in params.items()}


def _alphas(mpe_params):
    out = dict(mpe_params)
    out['alpha5'] = jnp.asarray(ALPHA, jnp.float32)
    out['alpha6'] = jnp.asarray(ALPHA, jnp.float32)
    return out


def _port_mpe(mpe_params):
    return lama.build_mpe(torch_state_dict_from_jax(
        _np(mpe_params), embedding_patterns=lama.EMBEDDING_PATTERNS))


async def _batch_inpaint(translator, context_cls, config):
    contexts, configs = [], []
    for page, mask in BATCH_PAGES:
        ctx = context_cls()
        ctx.img_rgb = page
        ctx.mask = mask
        ctx.text_regions = ['a region']
        contexts.append(ctx)
        configs.append(config)
    await translator._batch_inpaint(contexts, configs)
    return [c.img_inpainted for c in contexts]


@pytest.fixture(scope='module')
def results():
    mp = pytest.MonkeyPatch()
    mp.setenv('MIT_TPU_MESH', '0')
    mp.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)
    mp.setattr(jax_inpainting, '_inpainter_cache', {})
    mp.setattr(inpainting, '_inpainter_cache', {})
    f32_forward = jax_ia._aot_forward
    mp.setattr(jax_ia, '_aot_forward',
               lambda params, img, mask, dtype=None:
               f32_forward(params, img, mask, jnp.float32))
    mp.setattr(inpainting_aot, 'COMPUTE_DTYPE', torch.float32)
    try:
        # JAX: the registry's instances, random init, MPE scales set
        jaot = jax_inpainting.get_inpainter(JInpainter.default)
        asyncio.run(jaot.load('cpu'))
        jmpe = jax_inpainting.get_inpainter(JInpainter.lama_mpe)
        asyncio.run(jmpe.load('cpu'))
        jmpe.mpe_params = _alphas(jmpe.mpe_params)
        # the port: the same weights through the bridge
        paot = inpainting.get_inpainter(Inpainter.default)
        paot.device = torch.device('cpu')
        paot.model = aot.build_aot('cpu', torch_state_dict_from_jax(
            _np(jax_aot.init_params()), aot.TRANSPOSED_CONV_PATTERNS))
        paot._loaded = True
        pmpe = inpainting.get_inpainter(Inpainter.lama_mpe)
        pmpe.device = torch.device('cpu')
        pmpe.set_model(lama.fold_bn(lama.build_lama(
            9, torch_state_dict_from_jax(
                _np(jax_lama.init_params(9)),
                lama.transposed_conv_patterns(9)))))
        pmpe.set_mpe(_port_mpe(jmpe.mpe_params))
        pmpe._loaded = True

        out = {}
        # the tracer on: the MPE mask encodings are its spans
        with profiling.forced(), profiling.page() as traced:
            for key, port, ref, pages in (
                    ('aot', paot, jaot, dict(PAGES, tiny=TINY)),
                    ('mpe', pmpe, jmpe, PAGES)):
                for name, (page, mask) in pages.items():
                    port.forwards = []
                    got = asyncio.run(port.inpaint(
                        page, mask,
                        InpainterConfig(inpainting_precision='fp32'), SIZE))
                    want = asyncio.run(ref.inpaint(
                        page, mask, JICfg(inpainting_precision='fp32'),
                        SIZE))
                    out[key, name] = (page, mask, got, want,
                                      list(port.forwards))
                cfg = {'inpainter': {'inpainter': port_key(key),
                                     'inpainting_precision': 'fp32'}}
                port.forwards = []
                out[key, 'batch'] = (
                    asyncio.run(_batch_inpaint(
                        port_mt.MangaTranslator({'use_gpu': False}), Context,
                        Config(**cfg))),
                    asyncio.run(_batch_inpaint(
                        jax_mt.MangaTranslator({'use_gpu': False}), JContext,
                        JConfig(**cfg))),
                    list(port.forwards))
        out['mpe_page'] = traced
    finally:
        mp.undo()
    return out


def port_key(key):
    return 'default' if key == 'aot' else 'lama_mpe'


CASES = [('aot', 'two_crops'), ('aot', 'full_page'), ('aot', 'tiny'),
         ('mpe', 'two_crops'), ('mpe', 'full_page')]


@pytest.mark.parametrize('key,name', CASES)
def test_inpaint_matches_jax(results, key, name):
    """Outside the mask byte-identical (to the JAX result and to the
    input); inside within 1 gray of the JAX result."""
    page, mask, got, ref, forwards = results[key, name]
    assert got.shape == ref.shape == page.shape and got.dtype == np.uint8
    inside = mask >= 127
    np.testing.assert_array_equal(got[~inside], ref[~inside])
    np.testing.assert_array_equal(got[~inside], page[~inside])
    assert np.abs(got.astype(int) - ref.astype(int))[inside].max() <= 1
    assert (got[inside] != page[inside]).any()
    if name == 'two_crops':       # the crop path: two buckets
        assert len(forwards) == 2 and all(n == 1 for n, _, _ in forwards)
    else:                         # the full-page path
        assert forwards == [(1,) + page.shape[:2]]


@pytest.mark.parametrize('key', ['aot', 'mpe'])
def test_batch_inpaint_matches_jax(results, key):
    """``_batch_inpaint`` on two pages: their crops pooled into shared
    buckets; outside the mask byte-identical, inside within 1 gray."""
    got, ref, forwards = results[key, 'batch']
    assert forwards and any(n == 2 for n, _, _ in forwards), forwards
    for (page, mask), g, r in zip(BATCH_PAGES, got, ref):
        inside = mask >= 127
        np.testing.assert_array_equal(g[~inside], page[~inside])
        np.testing.assert_array_equal(g[~inside], r[~inside])
        assert np.abs(g.astype(int) - r.astype(int))[inside].max() <= 1
        assert (g[inside] != page[inside]).any()


def test_mpe_encodes_every_crop(results):
    """One host encoding of the masks (``inpaint.mpe_encode``) inside each
    LaMa-MPE generator forward (``inpaint.forward``), the pooled two-row
    batch bucket among them."""
    forwards = [f for k, case in results.items() if k[:1] == ('mpe',)
                for f in case[-1]]
    spans = results['mpe_page'].spans
    fwd = [sp for sp in spans if sp.name == 'inpaint.forward']
    enc = [sp for sp in spans if sp.name == 'inpaint.mpe_encode']
    assert len(fwd) == len(enc) == len(forwards) > 0
    assert sorted(id(sp.parent) for sp in enc) == sorted(map(id, fwd))
    assert all(sp.parent.t0 <= sp.t0 <= sp.t1 <= sp.parent.t1 for sp in enc)
    assert any(n == 2 for n, _, _ in forwards)    # the pooled batch bucket


def _masks():
    rs = np.random.RandomState(7)
    blobs = np.zeros((96, 96), np.float32)
    blobs[10:30, 12:50] = 1
    blobs[60:90, 50:80] = 1
    page = (rs.rand(300, 180) < 0.02).astype(np.float32)
    page[100:160, 40:120] = 1
    return {'empty': np.zeros((64, 64), np.float32),
            'full': np.ones((64, 64), np.float32),
            'two_blobs': blobs, 'non_square': page}


@pytest.mark.parametrize('name', list(_masks()))
def test_masked_position_encoding_matches_jax(name):
    mask = _masks()[name]
    rel, direct = lama.masked_position_encoding(mask)
    jrel, jdirect = jax_lama.masked_position_encoding(mask)
    np.testing.assert_array_equal(rel, jrel)
    np.testing.assert_array_equal(direct, jdirect)
    assert rel.shape == mask.shape and direct.shape == mask.shape + (4,)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_mpe_embeddings_match_jax(dtype):
    """The embeddings, and their sum into a stem output of the compute
    dtype (the generator's order: rel, then direct)."""
    mpe_params = _alphas({
        'rel_pos_emb.weight': jnp.asarray(
            jax_lama.sinusoidal_embedding_table(128, 64)),
        'direct_emb.weight': jnp.asarray(
            np.random.RandomState(3).randn(4, 64).astype(np.float32))})
    np.testing.assert_array_equal(lama.sinusoidal_embedding_table(),
                                  jax_lama.sinusoidal_embedding_table())
    rel, direct = lama.masked_position_encoding(_masks()['two_blobs'])
    jr, jd = jax_lama.mpe_embeddings(mpe_params, jnp.asarray(rel)[None],
                                     jnp.asarray(direct)[None])
    with torch.no_grad():
        tr, td = _port_mpe(mpe_params)(torch.from_numpy(rel)[None],
                                       torch.from_numpy(direct)[None])
    assert tr.shape == td.shape == (1, 64, 96, 96)
    np.testing.assert_allclose(tr.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jd), rtol=0, atol=1e-6)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    base = np.random.RandomState(4).rand(1, 96, 96, 64).astype(np.float32)
    jsum = (jnp.asarray(base).astype(jdt) + jr.astype(jdt)) + jd.astype(jdt)
    tsum = ((torch.from_numpy(base).to(dtype).permute(0, 3, 1, 2)
             + tr.to(dtype)) + td.to(dtype))
    np.testing.assert_allclose(
        tsum.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(jsum, np.float32), rtol=0,
        atol=1e-6 if dtype == torch.float32 else 2 ** -7)


def test_mpe_generator_matches_jax():
    """The 2-block generator with both embeddings (scales 0.5) on the JAX
    init_params weights, f32, plain routes: below 1e-4 on the sigmoid
    output, as LaMa-large's generator test."""
    n_blocks = 2
    params = jax_lama.init_params(n_blocks)
    mpe_params = _alphas({
        'rel_pos_emb.weight': jnp.asarray(
            jax_lama.sinusoidal_embedding_table(128, 64)),
        'direct_emb.weight': jnp.asarray(
            np.random.RandomState(3).randn(4, 64).astype(np.float32))})
    rs = np.random.RandomState(8)
    img = rs.rand(1, 64, 96, 3).astype(np.float32)
    mask = np.zeros((1, 64, 96, 1), np.float32)
    mask[0, 10:40, 20:70] = 1
    img = img * (1 - mask)
    rel, direct = lama.masked_position_encoding(mask[0, ..., 0])
    jr, jd = jax_lama.mpe_embeddings(mpe_params, jnp.asarray(rel)[None],
                                     jnp.asarray(direct)[None])
    ref = np.asarray(jax_lama.lama_generator_forward(
        params, jnp.asarray(img), jnp.asarray(mask), n_blocks=n_blocks,
        rel_pos_emb=jr, direct_emb=jd))
    plain = np.asarray(jax_lama.lama_generator_forward(
        params, jnp.asarray(img), jnp.asarray(mask), n_blocks=n_blocks))
    model = lama.build_lama(n_blocks, torch_state_dict_from_jax(
        _np(params), lama.transposed_conv_patterns(n_blocks)))
    with torch.no_grad():
        emb = _port_mpe(mpe_params)(torch.from_numpy(rel)[None],
                                    torch.from_numpy(direct)[None])
        got = model(torch.from_numpy(img), torch.from_numpy(mask),
                    *emb).numpy()
    assert np.abs(ref - plain).max() > 1e-2       # the MPE does something
    assert np.abs(got - ref).max() < 1e-4


def test_lama_mpe_loads_torch_layout_tables(tmp_path, monkeypatch):
    """A checkpoint's ``str_state_dict`` is in torch layout: the port
    loads it as it is and gives 64-channel embeddings. The JAX loader
    passes it through ``convert_state_dict`` without embedding patterns,
    which transposes both tables to (64, 128) and (64, 4) (ROADMAP §C:
    fixed in the port only); asserted here as it stands."""
    n_blocks = 2
    rs = np.random.RandomState(9)
    str_sd = {'rel_pos_emb.weight': torch.from_numpy(
                  rs.randn(128, 64).astype(np.float32)),
              'direct_emb.weight': torch.from_numpy(
                  rs.randn(4, 64).astype(np.float32)),
              'alpha5': torch.tensor(0.25), 'alpha6': torch.tensor(0.75)}
    inp = inpainting_lama.LamaMPEInpainter()
    monkeypatch.setattr(inpainting_lama.LamaMPEInpainter, '_N_BLOCKS',
                        n_blocks)
    monkeypatch.setattr(inpainting_lama.LamaMPEInpainter, 'model_dir',
                        property(lambda self: tmp_path))
    torch.save({'gen_state_dict': lama.init_state_dict(n_blocks),
                'str_state_dict': str_sd},
               tmp_path / 'inpainting_lama_mpe.ckpt')
    asyncio.run(inp.load('cpu'))
    assert not inp.using_random_weights
    for key, val in str_sd.items():
        assert torch.equal(inp.mpe.state_dict()[key], val)
    rel, direct = lama.masked_position_encoding(_masks()['two_blobs'])
    with torch.no_grad():
        er, ed = inp.mpe(torch.from_numpy(rel)[None],
                         torch.from_numpy(direct)[None])
    assert er.shape == ed.shape == (1, 64, 96, 96)
    torch.testing.assert_close(
        er[0, :, 20, 20], str_sd['rel_pos_emb.weight'][rel[20, 20]] * 0.25)
    jax_tables = convert_state_dict(str_sd)
    assert tuple(jax_tables['rel_pos_emb.weight'].shape) == (64, 128)
    assert tuple(jax_tables['direct_emb.weight'].shape) == (64, 4)


@pytest.mark.parametrize('n,p', [(5, 2), (5, 7), (12, 16), (16, 16),
                                 (1, 3), (2, 5)])
def test_reflect_pad_matches_numpy(n, p):
    """AOT's reflect pad at and past the edge: numpy's (and
    ``jnp.pad``'s) repeated reflection."""
    x = np.arange(2 * 3 * n * (n + 1), dtype=np.float32).reshape(
        2, 3, n, n + 1)
    want = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)), mode='reflect')
    got = aot.reflect_pad(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (p, p), (p, p)),
                           mode='reflect')), want)


def test_aot_generator_matches_jax():
    """AOT's generator at 96x128 in f32 on the JAX init_params weights:
    within the JAX oracle's rtol 1e-3 / atol 2e-3."""
    params = jax_aot.init_params()
    rs = np.random.RandomState(10)
    img = rs.rand(1, 96, 128, 3).astype(np.float32) * 2 - 1
    mask = (rs.rand(1, 96, 128, 1) < 0.3).astype(np.float32)
    img = img * (1 - mask)
    ref = np.asarray(jax_aot.aot_generator_forward(
        params, jnp.asarray(img), jnp.asarray(mask)))
    model = aot.build_aot('cpu', torch_state_dict_from_jax(
        _np(params), aot.TRANSPOSED_CONV_PATTERNS))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-3)
    assert (np.abs(ref) < 0.99).mean() > 0.5      # not saturated


def test_every_inpainter_but_sd_is_ported():
    """Every inpainter is served now, ``sd`` (ROADMAP A.13) included."""
    from manga_image_translator_tpu_torch.inpainting.inpainting_sd import \
        StableDiffusionInpainter
    from manga_image_translator_tpu_torch.inpainting.none_inpainter import (
        NoneInpainter, OriginalInpainter)
    want = {Inpainter.default: inpainting_aot.AotInpainter,
            Inpainter.lama_large: inpainting_lama.LamaLargeInpainter,
            Inpainter.lama_mpe: inpainting_lama.LamaMPEInpainter,
            Inpainter.sd: StableDiffusionInpainter,
            Inpainter.none: NoneInpainter,
            Inpainter.original: OriginalInpainter}
    assert set(want) == set(Inpainter)
    for key, cls in want.items():
        assert type(inpainting.INPAINTERS[key]()) is cls
    assert type(inpainting.get_inpainter(Inpainter.sd)) \
        is StableDiffusionInpainter
