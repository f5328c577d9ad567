"""PyTorch port, the mc2 colorizer: FFDNet, its space-to-depth pair, the
generator (with and without its decoder guide) and the whole colorizer
through ``colorization.dispatch`` against the JAX package's on the CPU, on
the same seeded weights (each package's random init; the port's are the
JAX draws bridged, see test_torch_port_weights.py). Every JAX reference is
computed once, in the module's fixture."""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from manga_image_translator_tpu import colorization as jax_colorization
from manga_image_translator_tpu.config import Colorizer as JColorizer
from manga_image_translator_tpu.models import mc2 as jax_mc2
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu_torch import colorization
from manga_image_translator_tpu_torch.config import Colorizer
from manga_image_translator_tpu_torch.models import mc2

torch.set_num_threads(2)

# (page height, width): tests/test_colorization.py's 96x80 case (tall:
# rows padded to a multiple of 32) and an odd-sized wide page (FFDNet's
# edge pad to even sides, columns padded)
PAGES = ((96, 80), (71, 101))
SIZE = 64                     # colorization_size
SIGMA = 25                    # denoise_sigma


def _page(h, w, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 255, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope='module')
def refs():
    mp = pytest.MonkeyPatch()
    mp.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)
    mp.setattr(jax_colorization, '_colorizer_cache', {})
    mp.setattr(colorization, '_colorizer_cache', {})
    try:
        out = {}
        rs = np.random.RandomState(0)
        x = rs.rand(1, 64, 48, 3).astype(np.float32)
        out['ffdnet'] = (x, np.asarray(jax_mc2.ffdnet_rgb_forward(
            jax_mc2.init_ffdnet_params(), jnp.asarray(x),
            jnp.asarray([0.1], jnp.float32))))
        x = rs.rand(1, 8, 6, 3).astype(np.float32)
        down = jax_mc2._space_to_depth2(jnp.asarray(x))
        out['s2d'] = (x, np.asarray(down),
                      np.asarray(jax_mc2._depth_to_space2(down)))
        sketch = rs.rand(1, 64, 64, 5).astype(np.float32)
        fake, guide = jax.jit(jax_mc2.generator_forward)(
            jax_mc2.init_generator_params(), jnp.asarray(sketch))
        out['generator'] = (sketch, np.asarray(fake), np.asarray(guide))
        for i, (h, w) in enumerate(PAGES):
            img = Image.fromarray(_page(h, w, i))
            kw = dict(image=img, colorization_size=SIZE,
                      denoise_sigma=SIGMA)
            got = asyncio.run(colorization.dispatch(Colorizer.mc2,
                                                    device='cpu', **kw))
            want = asyncio.run(jax_colorization.dispatch(JColorizer.mc2,
                                                         device='cpu', **kw))
            forwards = list(colorization.get_colorizer(
                Colorizer.mc2).forwards)
            out['page', h, w] = (got, want, forwards)
    finally:
        mp.undo()
    return out


def test_ffdnet_matches_jax(refs):
    """Within the JAX suite's oracle bound for FFDNet
    (tests/test_model_oracle.py:220)."""
    x, want = refs['ffdnet']
    model = mc2.build_ffdnet(mc2.init_ffdnet_state_dict())
    got = mc2.ffdnet_rgb_forward(model, torch.from_numpy(x),
                                 torch.tensor([0.1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-3)


def test_space_to_depth_pair_matches_jax(refs):
    """Input channel k's phase idx at output channel 4k+idx, and back."""
    x, down, up = refs['s2d']
    got = mc2.space_to_depth2(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), down)
    back = mc2.depth_to_space2(got)
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(), up)
    np.testing.assert_array_equal(up, x)


@pytest.fixture(scope='module')
def generator():
    return mc2.build_generator(mc2.init_generator_state_dict())


@pytest.mark.parametrize('guide', [False, True])
def test_generator_matches_jax(refs, generator, guide):
    """The generator at 64x64 within the oracle bound
    (tests/test_model_oracle.py:196); the decoder guide (transposed convs
    with output padding) only when asked."""
    sketch, fake, want_guide = refs['generator']
    got, got_guide = mc2.generator_forward(generator,
                                           torch.from_numpy(sketch), guide)
    np.testing.assert_allclose(got.numpy(), fake, rtol=1e-3, atol=2e-3)
    if guide:
        np.testing.assert_allclose(got_guide.numpy(), want_guide, rtol=1e-3,
                                   atol=2e-3)
    else:
        assert got_guide is None


@pytest.mark.parametrize('h,w', PAGES)
def test_colorizer_matches_jax(refs, h, w):
    """The whole colorizer: FFDNet at the page's size, resize_pad to a
    multiple of 32, the generator, the crop back to the resized page (the
    output keeps the colorization size, as in the reference); at most one
    level apart."""
    got, want, forwards = refs['page', h, w]
    assert got.size == want.size
    assert min(got.size) in (SIZE, int(SIZE * 1.5))
    diff = np.abs(np.asarray(got, int) - np.asarray(want, int))
    assert diff.max() <= 1, diff.max()
    assert [k for k, _ in forwards[-2:]] == ['ffdnet', 'generator']
    assert forwards[-2][1] == (h + h % 2, w + w % 2)
    assert all(s % 32 == 0 for s in forwards[-1][1])
