"""PyTorch port, the LaMa-large inpainter: the port's LamaLargeInpainter
against the JAX package's on the CPU, both at 2 resnet blocks with f32
compute and the JAX package's init_params weights: a page whose mask plans
two crops in two buckets, and a page whose plan falls back to the
full-page path."""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from manga_image_translator_tpu.inpainting import inpainting_lama as jax_il
from manga_image_translator_tpu.inpainting.crop_plan import \
    plan_crops as jax_plan_crops
from manga_image_translator_tpu.models import lama as jax_lama
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.config import InpainterConfig as JConfig
from manga_image_translator_tpu_torch.config import InpainterConfig
from manga_image_translator_tpu_torch.inpainting import inpainting_lama
from manga_image_translator_tpu_torch.inpainting.crop_plan import plan_crops
from manga_image_translator_tpu_torch.models import lama
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

N_BLOCKS = 2
SIZE = 2048          # the default inpainting size: crops at native scale


def make_page(h, w, seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    page = np.stack([(xx * 255 // w), (yy * 255 // h),
                     np.full((h, w), 200)], -1).astype(np.uint8)
    return np.clip(page.astype(int) + rs.randint(-20, 21, page.shape),
                   0, 255).astype(np.uint8)


def two_blob_mask(h, w):
    mask = np.zeros((h, w), np.uint8)
    mask[30:50, 40:100] = 255           # a short line: 128x128 bucket
    mask[180:230, 180:350] = 255        # a wider block: a larger bucket
    return mask


def full_page_mask(h, w):
    mask = np.zeros((h, w), np.uint8)
    mask[8:h - 8, 8:w - 8] = 255
    return mask


PAGES = {
    'two_crops': (make_page(256, 384, 1), two_blob_mask(256, 384)),
    'full_page': (make_page(136, 200, 2), full_page_mask(136, 200)),
}


@pytest.fixture(scope='module')
def results():
    mp = pytest.MonkeyPatch()
    mp.setenv('MIT_TPU_MESH', '0')
    mp.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)
    mp.setattr(jax_il.LamaLargeInpainter, '_N_BLOCKS', N_BLOCKS)
    try:
        ref_inp = jax_il.LamaLargeInpainter()
        asyncio.run(ref_inp.load('cpu'))
        port_inp = inpainting_lama.LamaLargeInpainter()
        port_inp.device = torch.device('cpu')
        sd = torch_state_dict_from_jax(
            {k: np.array(v) for k, v in
             jax_lama.init_params(N_BLOCKS).items()},
            lama.transposed_conv_patterns(N_BLOCKS))
        port_inp.set_model(lama.fold_bn(lama.build_lama(N_BLOCKS, sd)))
        port_inp._loaded = True
        out = {}
        for name, (page, mask) in PAGES.items():
            port_inp.forwards = []
            got = asyncio.run(port_inp.inpaint(
                page, mask, InpainterConfig(inpainting_precision='fp32'),
                SIZE))
            ref = asyncio.run(ref_inp.inpaint(
                page, mask, JConfig(inpainting_precision='fp32'), SIZE))
            out[name] = (page, mask, got, ref, list(port_inp.forwards))
        page, mask = PAGES['two_crops']
        out['bf16'] = asyncio.run(port_inp.inpaint(
            page, mask, InpainterConfig(), SIZE))
        pages = [p for p, _ in PAGES.values()]
        masks = [m for _, m in PAGES.values()]
        out['batch'] = (
            asyncio.run(port_inp.infer_batch(
                pages, masks, InpainterConfig(inpainting_precision='fp32'),
                SIZE)),
            asyncio.run(ref_inp.infer_batch(
                pages, masks, JConfig(inpainting_precision='fp32'), SIZE)))
    finally:
        mp.undo()
    return out


def test_plans_are_the_jax_plans():
    for page, mask in PAGES.values():
        a = plan_crops(mask, scale=1.0)
        b = jax_plan_crops(mask, scale=1.0)
        assert (a is None) == (b is None)
        if a is not None:
            assert ([dataclasses.astuple(c) for c in a[0]]
                    == [dataclasses.astuple(c) for c in b[0]])


def test_two_crops_two_buckets(results):
    *_, forwards = results['two_crops']
    assert len(forwards) == 2 and all(n == 1 for n, _, _ in forwards)
    assert forwards[0][1:] != forwards[1][1:]
    *_, forwards = results['full_page']
    assert forwards == [(1, 136, 200)]   # the full-page path ran instead


@pytest.mark.parametrize('name', list(PAGES))
def test_inpainted_page_matches_jax(results, name):
    """Outside the mask byte-identical (to the JAX result and to the
    input); inside within 1 gray of the JAX result."""
    page, mask, got, ref, _ = results[name]
    assert got.shape == ref.shape == page.shape and got.dtype == np.uint8
    inside = mask >= 127
    np.testing.assert_array_equal(got[~inside], ref[~inside])
    np.testing.assert_array_equal(got[~inside], page[~inside])
    diff = np.abs(got.astype(int) - ref.astype(int))[inside]
    assert diff.max() <= 1
    assert (got[inside] != page[inside]).any()


def test_infer_batch_matches_jax(results):
    """Two pages in one call: crops pooled, the fallback page through
    the letterboxed full-page batch."""
    got, ref = results['batch']
    for (page, mask), g, r in zip(PAGES.values(), got, ref):
        inside = mask >= 127
        np.testing.assert_array_equal(g[~inside], page[~inside])
        np.testing.assert_array_equal(g[~inside], r[~inside])
        assert np.abs(g.astype(int) - r.astype(int))[inside].max() <= 1


def test_default_bf16_precision_runs(results):
    """The default precision (bf16 convs, f32 FourierUnits): the page
    changes inside the mask only, near the f32 result."""
    page, mask, f32, _, _ = results['two_crops']
    got = results['bf16']
    inside = mask >= 127
    np.testing.assert_array_equal(got[~inside], page[~inside])
    assert (got[inside] != page[inside]).any()
    assert np.abs(got.astype(int) - f32.astype(int))[inside].mean() < 8


def test_lama_mpe_waits_for_its_item():
    """No inpainter waits any more: ``sd`` builds the port's
    ``StableDiffusionInpainter``; ``default`` (AOT) and ``lama_mpe``
    resolve to the port's classes."""
    from manga_image_translator_tpu_torch import inpainting
    from manga_image_translator_tpu_torch.config import Inpainter
    from manga_image_translator_tpu_torch.inpainting.inpainting_aot import \
        AotInpainter
    from manga_image_translator_tpu_torch.inpainting.inpainting_sd import \
        StableDiffusionInpainter
    assert set(inpainting.INPAINTERS) == set(Inpainter)
    assert (type(inpainting.INPAINTERS[Inpainter.sd]())
            is StableDiffusionInpainter)
    assert type(inpainting.INPAINTERS[Inpainter.default]()) is AotInpainter
    assert (type(inpainting.INPAINTERS[Inpainter.lama_mpe]())
            is inpainting_lama.LamaMPEInpainter)
