"""PyTorch port: ``ops/morphology.py`` and ``ops/image.py`` against the JAX
package's and cv2, with the tolerances of tests/test_ops.py (cv2 equality
for the ellipse element, dilation and erosion; one grey level for luma) and
1e-5 (1e-4 for resizes) of the JAX package's floats."""
import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_image_translator_tpu import ops as jops
from manga_image_translator_tpu_torch import ops

torch.set_num_threads(2)


def _both(name, x, *args, **kwargs):
    want = np.asarray(getattr(jops, name)(jnp.asarray(x), *args, **kwargs))
    got = getattr(ops, name)(torch.from_numpy(np.asarray(x)), *args,
                             **kwargs)
    return got.numpy(), want


def _mask(shape=(64, 80), seed=0, density=0.9):
    return (np.random.RandomState(seed).rand(*shape) > density).astype(
        np.float32)


@pytest.mark.parametrize('k', [1, 3, 5, 7, 9, 15])
def test_ellipse_kernel_matches_cv2_and_jax(k):
    ours = ops.ellipse_kernel(k)
    np.testing.assert_array_equal(ours, jops.ellipse_kernel(k))
    if k > 1:
        ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
        np.testing.assert_array_equal(ours.astype(np.uint8), ref)


@pytest.mark.parametrize('k', [3, 7, 11])
def test_dilate_erode_match_cv2_and_jax(k):
    se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
    mask = _mask()
    got, want = _both('dilate', mask, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.uint8),
                                  cv2.dilate(mask.astype(np.uint8), se))
    solid = np.zeros((32, 40), np.float32)
    solid[8:24, 6:30] = 1
    solid[14, 12] = 0
    got, want = _both('erode', solid, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.astype(np.uint8),
        cv2.erode(solid.astype(np.uint8), se, borderType=cv2.BORDER_CONSTANT,
                  borderValue=0))


@pytest.mark.parametrize('name', ['dilate', 'erode'])
@pytest.mark.parametrize('k', [2, 4, 5])
def test_rect_and_batched_match_jax(name, k):
    """The rectangular element (even sizes centre as XLA's reduce_window)
    and a (2, 3, H, W) batch of uint8 masks."""
    mask = _mask((2, 3, 24, 30), seed=1, density=0.8)
    got, want = _both(name, mask, k, shape='rect')
    np.testing.assert_array_equal(got, want)
    u8 = mask.astype(np.uint8)
    got, want = _both(name, u8, k)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', ['open_', 'close_'])
def test_open_close_match_jax(name):
    got, want = _both(name, _mask(seed=2, density=0.6), 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('k', [1, 3, 4])
def test_box_blur_matches_jax(k):
    img = np.random.RandomState(3).rand(2, 20, 24).astype(np.float32)
    got, want = _both('box_blur', img, k)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('sigma,radius', [(2.0, None), (0.8, 3)])
def test_gaussian_blur_matches_jax(sigma, radius):
    img = np.random.RandomState(1).rand(2, 40, 36).astype(np.float32)
    np.testing.assert_array_equal(ops.morphology.gaussian_kernel_1d(sigma, 4),
                                  jops.morphology.gaussian_kernel_1d(sigma, 4))
    got, want = _both('gaussian_blur', img, sigma, radius)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got.mean() - img.mean()) < 0.02


@pytest.mark.parametrize('shape,out_hw', [((37, 52, 3), (64, 80)),
                                          ((2, 64, 48, 3), (20, 30)),
                                          ((40, 40, 1), (40, 17))])
@pytest.mark.parametrize('antialias', [False, True])
def test_resize_bilinear_matches_jax(shape, out_hw, antialias):
    img = np.random.RandomState(4).randint(0, 256, shape).astype(np.uint8)
    got, want = _both('resize_bilinear', img, out_hw, antialias=antialias)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    got, want = _both('resize_area', img, out_hw)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_resize_bilinear_matches_cv2_upscale():
    """Upscaling without antialias is cv2's INTER_LINEAR inside the
    page (the borders clamp alike too)."""
    img = np.random.RandomState(5).randint(0, 256, (30, 40, 3)).astype(
        np.uint8)
    got = ops.resize_bilinear(torch.from_numpy(img), (60, 80)).numpy()
    ref = cv2.resize(img.astype(np.float32), (80, 60),
                     interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(got, ref, atol=1e-3)


@pytest.mark.parametrize('shape', [(100, 50, 3), (2, 30, 70, 3)])
def test_pad_and_letterbox_match_jax(shape):
    img = np.random.RandomState(6).rand(*shape).astype(np.float32)
    (got, pads), (want, wpads) = [
        (np.asarray(o[0]), o[1]) for o in (
            ops.pad_to_multiple(torch.from_numpy(img), 8, 0.5),
            jops.pad_to_multiple(jnp.asarray(img), 8, 0.5))]
    assert pads == wpads
    np.testing.assert_array_equal(got, want)
    out, ratio, hw = ops.letterbox(torch.from_numpy(img), 64, pad_value=-1)
    wout, wratio, whw = jops.letterbox(jnp.asarray(img), 64, pad_value=-1)
    assert out.shape == wout.shape
    assert (ratio, hw) == (wratio, whw)
    np.testing.assert_allclose(out.numpy(), np.asarray(wout), atol=1e-5)


def test_letterbox_and_pad_shapes():
    """tests/test_ops.py's TestImage shapes."""
    out, ratio, (nh, nw) = ops.letterbox(torch.zeros((100, 50, 3)), 64)
    assert out.shape == (64, 64, 3)
    assert nh == 64 and nw == 32
    assert ratio == pytest.approx(0.64)
    out, (ph, pw) = ops.pad_to_multiple(torch.zeros((100, 50, 3)), 8)
    assert out.shape == (104, 56, 3) and (ph, pw) == (4, 6)


def test_pixel_conversions_match_jax_and_cv2():
    img = np.random.RandomState(7).randint(0, 255, (16, 16, 3)).astype(
        np.uint8)
    for name in ('normalize_imagenet', 'to_unit', 'rgb_to_gray'):
        got, want = _both(name, img)
        np.testing.assert_allclose(got, want, atol=1e-5)
    ref = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32)
    np.testing.assert_allclose(ops.rgb_to_gray(torch.from_numpy(img)).numpy(),
                               ref, atol=1.0)
    unit = np.random.RandomState(8).uniform(-0.1, 1.1, (8, 8, 3)).astype(
        np.float32)
    got = ops.image.from_unit(torch.from_numpy(unit)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jops.image.from_unit(unit)))


@pytest.mark.parametrize('scale', [0.3, 1.0])
def test_gamma_correct_matches_jax(scale):
    img = (np.random.RandomState(9).randint(0, 255, (24, 20, 3))
           * scale).astype(np.uint8)
    got, want = _both('gamma_correct', img)
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_canonical_size():
    for hw, size in (((800, 600), 1024), ((1300, 700), 1536),
                     ((4000, 700), 2048)):
        assert ops.pick_canonical_size(*hw) == size
        assert jops.pick_canonical_size(*hw) == size
