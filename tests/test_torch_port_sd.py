"""PyTorch port, Stable Diffusion inpainting: the UNet, the VAE, the CLIP
text tower, the DDIM schedule, both samplers and ``_infer`` end to end
against the JAX package on the CPU, at ``SDConfig.tiny()`` with the JAX
package's ``init_params`` bridged into the port. Every Gaussian draw of the
port goes through its ``draw`` callable; here that callable replays the
JAX package's key splits (``JaxDraw``), so both packages see the same
noise. The networks are held within rtol 1e-4 / atol 1e-5 (the JAX
suite's ONNX bounds); the samplers and ``_infer`` within 1e-4 of the
output's range. The host code (``_fill_mask_input``, the tokenizer) is
equal; ``safetensors_lite`` round-trips F32, F16 and BF16.

Each JAX reference is jitted (an eager tiny UNet call costs seconds of
per-op compiles on the CPU). Neither package may reach
``transformers.CLIPTokenizer.from_pretrained``: a stand-in module that
raises takes its place, so both use the hash tokenizer."""
import asyncio
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu.inpainting import inpainting_sd as jax_isd
from manga_image_translator_tpu.models import sd as jsd
from manga_image_translator_tpu_torch.config import InpainterConfig
from manga_image_translator_tpu_torch.inpainting import inpainting_sd as isd
from manga_image_translator_tpu_torch.models import sd
from manga_image_translator_tpu_torch.utils import safetensors_lite
from manga_image_translator_tpu_torch.utils.inference import \
    MissingWeightsError
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

JCFG = jsd.SDConfig.tiny()
CFG = sd.SDConfig.tiny()
SEED = 1234
SAMPLER_STEPS = 3          # two sampler iterations: DPM++'s 2nd order runs
INFER_STEPS = 2
RTOL, ATOL = 1e-4, 1e-5


class JaxDraw:
    """The port's ``draw(shape)`` replaying the JAX package's keys: the
    three draws of ``_infer`` (VAE sample, latent init, conditioning VAE
    sample) from ``split(PRNGKey(seed), 3)`` and ``split(rng)``, then one
    ``split`` per draw of the sampler (its first noise, each step's
    re-noising). Shapes come NCHW, JAX draws NHWC."""

    def __init__(self, key, infer: bool):
        self.keys = []
        if infer:
            key, r_enc, r_init = jax.random.split(key, 3)
            key, r_c = jax.random.split(key)
            self.keys = [r_enc, r_init, r_c]
        self.key = key

    def __call__(self, shape):
        if self.keys:
            k = self.keys.pop(0)
        else:
            self.key, k = jax.random.split(self.key)
        n, c, h, w = shape
        x = np.asarray(jax.random.normal(k, (n, h, w, c), jnp.float32))
        return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _stub_transformers():
    class CLIPTokenizer:
        @staticmethod
        def from_pretrained(*a, **k):
            raise OSError('offline test: no tokenizer files')
    mod = types.ModuleType('transformers')
    mod.CLIPTokenizer = CLIPTokenizer
    return mod


def make_page(h, w, seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    page = np.stack([(xx * 255 // w), (yy * 255 // h),
                     np.full((h, w), 200)], -1).astype(np.uint8)
    return np.clip(page.astype(int) + rs.randint(-20, 21, page.shape),
                   0, 255).astype(np.uint8)


def page_mask(h, w):
    mask = np.zeros((h, w), np.uint8)
    mask[10:40, 20:70] = 255
    mask[50:60, 5:30] = 255
    return mask


@pytest.fixture(scope='module')
def setup():
    """JAX params, the port's model holding them, and the inputs."""
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, 'transformers', _stub_transformers())
    params = {k: np.asarray(v) for k, v in jsd.init_params(JCFG).items()}
    model = sd.build_sd(CFG, 'cpu', torch_state_dict_from_jax(
        params, embedding_patterns=sd.EMBEDDING_PATTERNS))
    rs = np.random.RandomState(0)
    inputs = {
        'x': rs.randn(1, 8, 8, 9).astype(np.float32),
        't': np.array([501], np.int32),
        'ctx': rs.randn(1, CFG.max_tokens, CFG.context_dim)
        .astype(np.float32),
        'img': rs.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
        'z': rs.randn(1, 4, 4, 4).astype(np.float32),
        'tokens': rs.randint(0, CFG.vocab_size,
                             (1, CFG.max_tokens)).astype(np.int32),
    }
    yield params, model, inputs
    mp.undo()


@pytest.fixture(scope='module')
def jax_nets(setup):
    params, _, inp = setup
    return {
        'unet': np.asarray(jax.jit(
            lambda p, x, t, c: jsd.unet_forward(p, x, t, c, JCFG))(
                params, inp['x'], inp['t'], inp['ctx'])),
        'moments': np.asarray(jax.jit(
            lambda p, x: jsd.vae_encode_moments(p, x, JCFG))(
                params, inp['img'])),
        'decode': np.asarray(jax.jit(
            lambda p, z: jsd.vae_decode(p, z, JCFG))(params, inp['z'])),
        'clip': np.asarray(jax.jit(
            lambda p, t: jsd.clip_text_forward(p, t, JCFG))(
                params, inp['tokens'])),
    }


@torch.no_grad()
def _port_net(name, model, inp):
    if name == 'unet':
        return _nhwc(model.unet(_nchw(inp['x']), torch.from_numpy(inp['t']),
                                torch.from_numpy(inp['ctx'])))
    if name == 'moments':
        return _nhwc(model.vae.encode_moments(_nchw(inp['img'])))
    if name == 'decode':
        return _nhwc(model.vae.decode(_nchw(inp['z'])))
    return model.clip(torch.from_numpy(inp['tokens']).long()).numpy()


@pytest.mark.parametrize('name', ['unet', 'moments', 'decode', 'clip'])
def test_network_matches_jax(setup, jax_nets, name):
    _, model, inp = setup
    got = _port_net(name, model, inp)
    assert got.shape == jax_nets[name].shape
    np.testing.assert_allclose(got, jax_nets[name], rtol=RTOL, atol=ATOL)


def test_vae_sample_matches_jax(setup, jax_nets):
    key = jax.random.PRNGKey(3)
    moments = jax_nets['moments']
    ref = np.asarray(jsd.vae_sample(jnp.asarray(moments), key,
                                    CFG.scale_factor))
    noise = JaxDraw(key, infer=False)
    noise.keys = [key]
    n, h, w, c = moments.shape
    got = sd.vae_sample(_nchw(moments), noise((n, c // 2, h, w)),
                        CFG.scale_factor)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=RTOL, atol=ATOL)


def test_timestep_embedding_and_schedule():
    t = np.array([0, 1, 501, 999], np.int32)
    ref = np.asarray(jsd.timestep_embedding(jnp.asarray(t), 32))
    got = sd.timestep_embedding(torch.from_numpy(t), 32).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    for steps in (2, 15, 50):
        a, b = sd.make_ddim_schedule(steps), jsd.make_ddim_schedule(steps)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_chunked_attention_at_a_non_multiple_length(monkeypatch):
    """13 queries in chunks of 5 (5, 5, 3) equal one unchunked pass and
    the JAX ``_attention`` (which chunks only multiples of its chunk)."""
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, n, 16).astype(np.float32) for n in (13, 7, 7))
    ref = np.asarray(jsd._attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    whole = sd.attention(tq, tk, tv, 2)
    monkeypatch.setattr(sd, 'ATTN_QCHUNK', 5)
    chunked = sd.attention(tq, tk, tv, 2)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(chunked.numpy(), ref, rtol=RTOL, atol=ATOL)


def _sampler_inputs(setup):
    params, model, _ = setup
    rs = np.random.RandomState(7)
    init = rs.randn(1, 8, 8, 4).astype(np.float32)
    nmask = np.zeros((1, 8, 8, 1), np.float32)
    nmask[:, 2:6, 1:5] = 1
    cond = rs.randn(1, CFG.max_tokens, CFG.context_dim).astype(np.float32)
    uncond = rs.randn(1, CFG.max_tokens, CFG.context_dim).astype(np.float32)
    cdt = rs.randn(1, 8, 8, 5).astype(np.float32)
    return params, model, (init, nmask, cond, uncond, cdt)


@pytest.mark.parametrize('sampler', ['ddim', 'dpmpp_2m'])
def test_sampler_matches_jax(setup, sampler):
    params, model, (init, nmask, cond, uncond, cdt) = _sampler_inputs(setup)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax_isd._SAMPLERS[sampler](
        params, jnp.asarray(init), jnp.asarray(nmask), jnp.asarray(cond),
        jnp.asarray(uncond), jnp.asarray(cdt), key, JCFG, SAMPLER_STEPS,
        7.0))
    got = isd.SAMPLERS[sampler](
        model, _nchw(init), _nchw(nmask), torch.from_numpy(cond),
        torch.from_numpy(uncond), _nchw(cdt), JaxDraw(key, infer=False),
        SAMPLER_STEPS)
    assert got.shape == (1, 3, 16, 16)          # the tiny VAE: x2
    np.testing.assert_allclose(_nhwc(got), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope='module')
def infer_results(setup):
    """Both packages' ``_infer`` on a 96x80 page at inpainting_size 64
    (resized to 64x53, padded to 64x64), dpmpp_2m at 2 steps, the same
    seed; the JAX VAE and CLIP calls jitted."""
    params, model, _ = setup
    mp = pytest.MonkeyPatch()
    mp.setenv('MIT_TPU_SD_SEED', str(SEED))
    mp.setenv('MIT_TPU_SD_STEPS', str(INFER_STEPS))
    mp.delenv('MIT_TPU_SD_SAMPLER', raising=False)
    mp.setitem(sys.modules, 'transformers', _stub_transformers())
    mp.setattr(jax_isd.sd, 'vae_encode_moments', jax.jit(
        jsd.vae_encode_moments, static_argnums=2))
    mp.setattr(jax_isd.sd, 'clip_text_forward', jax.jit(
        jsd.clip_text_forward, static_argnums=2))
    page, mask = make_page(96, 80, 1), page_mask(96, 80)

    jinp = jax_isd.StableDiffusionInpainter()
    jinp.cfg, jinp.params = JCFG, params
    jinp.tokenizer = jax_isd.SimpleCLIPTokenizer(JCFG.vocab_size,
                                                 JCFG.max_tokens)
    ref = asyncio.run(jinp._infer(page, mask, None, 64))

    inp = isd.StableDiffusionInpainter()
    inp.cfg, inp.model, inp.device = CFG, model, torch.device('cpu')
    inp.tokenizer = isd.SimpleCLIPTokenizer(CFG.vocab_size, CFG.max_tokens)
    inp.make_draw = lambda seed, device: JaxDraw(jax.random.PRNGKey(seed),
                                                 infer=True)
    got = asyncio.run(inp._infer(page, mask, InpainterConfig(), 64))
    mp.undo()
    return page, mask, ref, got, inp


def test_infer_matches_jax(infer_results):
    page, mask, ref, got, inp = infer_results
    assert got.shape == ref.shape == page.shape and got.dtype == np.uint8
    assert inp.forwards == [(1, 64, 64)]
    inside = mask >= 127
    assert (got[inside] != page[inside]).any()
    # uint8 rounding of values within 1e-4 of the range: at most 1 apart
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_infer_keeps_pixels_outside_the_mask(infer_results):
    page, mask, ref, got, _ = infer_results
    outside = mask < 127
    np.testing.assert_array_equal(got[outside], page[outside])
    np.testing.assert_array_equal(ref[outside], page[outside])


def test_fill_mask_input_equal():
    page = make_page(70, 90, 4)
    mask = page_mask(70, 90)
    blur = __import__('cv2').GaussianBlur(mask, (0, 0), 16 / 3.0)
    np.testing.assert_array_equal(isd._fill_mask_input(page, blur),
                                  jax_isd._fill_mask_input(page, blur))


def test_hash_tokenizer_ids_equal(monkeypatch):
    """The hash fallback (``PYTHONHASHSEED``-dependent, so compared within
    one process) and its padding give equal ids; with real weights a
    missing vocabulary raises."""
    monkeypatch.setitem(sys.modules, 'transformers', _stub_transformers())
    for vocab, length in ((97, 16), (49408, 77)):
        a = isd.SimpleCLIPTokenizer(vocab, length)
        b = jax_isd.SimpleCLIPTokenizer(vocab, length)
        for text in ('masterpiece,best quality,1girl,long hair',
                     isd.NEG_PROMPT, ','.join(['w%d' % i for i in range(90)])):
            np.testing.assert_array_equal(a(text), b(text))
            assert a(text).shape == (1, length)
    with pytest.raises(MissingWeightsError, match='tokenizer'):
        isd.SimpleCLIPTokenizer(97, 16, require_real=True)


def test_tokenizer_rejects_a_cached_vocabulary_of_another_size(
        monkeypatch):
    """A cached tokenizer whose vocabulary is not the text tower's is not
    taken: the hash fallback with random weights, an error with real
    ones."""
    class Wrong:
        def __len__(self):
            return 1000

        def __call__(self, text, **kw):
            return {'input_ids': [0] + [2] * 15}
    mod = types.ModuleType('transformers')
    mod.CLIPTokenizer = type('CLIPTokenizer', (), {
        'from_pretrained': staticmethod(lambda *a, **k: Wrong())})
    monkeypatch.setitem(sys.modules, 'transformers', mod)
    tok = isd.SimpleCLIPTokenizer(97, 16)
    assert tok._hf is None
    assert tok('a,b')[0, 0] == 1
    with pytest.raises(MissingWeightsError, match='1000 ids'):
        isd.SimpleCLIPTokenizer(97, 16, require_real=True)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_round_trip(tmp_path, dtype):
    gen = torch.Generator().manual_seed(0)
    tensors = {'a.weight': torch.randn(3, 5, generator=gen).to(dtype),
               'b.bias': torch.randn(7, generator=gen).to(dtype),
               'c.scalar': torch.tensor(1.5, dtype=dtype),
               'd.empty': torch.zeros(0, 4, dtype=dtype)}
    path = tmp_path / 'm.safetensors'
    safetensors_lite.save(tensors, path, metadata={'format': 'pt'})
    back = safetensors_lite.load(path)
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == dtype and back[k].shape == v.shape
        assert torch.equal(back[k], v), k


def test_checkpoint_loads_as_released(tmp_path, setup):
    """A checkpoint in the released layout (the three networks' keys, the
    text tower's position_ids, EMA and schedule buffers), written in f16,
    loads into ``build_sd`` with the other keys dropped."""
    _, model, inp = setup
    state = {k: v.half() for k, v in model.state_dict().items()}
    state['cond_stage_model.transformer.text_model.embeddings.'
          'position_ids'] = torch.arange(CFG.max_tokens)[None].float()
    state['model_ema.decay'] = torch.tensor(0.999)
    state['alphas_cumprod'] = torch.ones(1000)
    path = tmp_path / isd.CHECKPOINT
    safetensors_lite.save(state, path)
    loaded = sd.build_sd(CFG, 'cpu', safetensors_lite.load(path))
    for k, v in loaded.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, model.state_dict()[k].half().float()), k


def test_random_weight_fallback_and_missing_weights(tmp_path, monkeypatch):
    """Without the checkpoint the port's inpainter refuses to serve unless
    random weights are allowed; allowed, it loads the tiny config on the
    device it is given and inpaints only inside the mask."""
    from manga_image_translator_tpu_torch.utils import inference
    monkeypatch.setitem(sys.modules, 'transformers', _stub_transformers())
    monkeypatch.setattr(inference, 'MODULE_DIR', tmp_path)
    monkeypatch.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '0')
    with pytest.raises(MissingWeightsError):
        asyncio.run(isd.StableDiffusionInpainter().load('cpu'))
    monkeypatch.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')
    monkeypatch.setenv('MIT_TPU_SD_STEPS', '2')
    inp = isd.StableDiffusionInpainter()
    asyncio.run(inp.load('cpu'))
    assert inp.using_random_weights and inp.cfg == CFG
    assert inp.tagger is None
    assert all(p.device.type == 'cpu' for p in inp.model.parameters())
    page, mask = make_page(48, 40, 2), page_mask(48, 40)
    out = asyncio.run(inp.inpaint(page, mask, InpainterConfig(), 64))
    np.testing.assert_array_equal(out[mask < 127], page[mask < 127])
