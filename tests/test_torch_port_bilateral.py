"""PyTorch port: the bilateral filter's plain version (K1's reference)
against the JAX package's XLA formulation and its Pallas kernel (interpret
mode), and a CPU emulation of the CUDA kernel's order of work
(``csrc/bilateral.cu``) against both. Tolerance: 1 gray level, the bound the
JAX suite holds its own kernel variants to (f32 sums in another order round
differently)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from manga_image_translator_tpu.ops.bilateral import bilateral_filter_xla
from manga_image_translator_tpu.ops.pallas_bilateral import (
    bilateral_filter_pallas,
)
from manga_image_translator_tpu_torch.ops import bilateral

torch.set_num_threads(2)

CASES = {
    # (shape, d, sigma_color, sigma_space)
    'odd_radius_40x56': ((40, 56, 3), 9, 40.0, 40.0),
    'even_radius_production_d17': ((40, 56, 3), 17, 80.0, 80.0),
    # H and W one past a multiple of the kernel's 8-row strip, W not a
    # multiple of its 32-column tile
    'ragged_33x41_d17': ((33, 41, 3), 17, 80.0, 80.0),
    # sigma_color != sigma_space: the kernel multiplies by the space weight
    'unequal_sigmas_24x30_d9': ((24, 30, 3), 9, 60.0, 25.0),
}


@pytest.fixture(scope='module')
def refs():
    out = {}
    for i, (name, (shape, d, sc, ss)) in enumerate(CASES.items()):
        rs = np.random.RandomState(10 + i)
        img = rs.randint(0, 256, shape).astype(np.uint8)
        with pltpu.force_tpu_interpret_mode():
            pal = np.asarray(bilateral_filter_pallas(jnp.asarray(img), d, sc,
                                                     ss, variant='v6'))
        xla = np.asarray(bilateral_filter_xla(jnp.asarray(img), d, sc, ss))
        out[name] = (img, pal, xla)
    return out


@pytest.mark.parametrize('name', list(CASES))
def test_plain_matches_pallas_kernel_everywhere(refs, name):
    """Same edge-replicated borders as the Pallas kernel: the whole image
    agrees."""
    img, pal, _ = refs[name]
    _, d, sc, ss = CASES[name]
    ours = bilateral.bilateral_filter_ref(torch.from_numpy(img), d, sc,
                                          ss).numpy()
    assert np.abs(ours.astype(int) - pal.astype(int)).max() <= 1


@pytest.mark.parametrize('name', list(CASES))
def test_plain_matches_xla_interior(refs, name):
    """The XLA formulation wraps around at the borders (jnp.roll); the
    interior, one radius in, agrees."""
    img, _, xla = refs[name]
    _, d, sc, ss = CASES[name]
    r = d // 2
    ours = bilateral.bilateral_filter_ref(torch.from_numpy(img), d, sc,
                                          ss).numpy()
    diff = np.abs(ours[r:-r, r:-r].astype(int) - xla[r:-r, r:-r].astype(int))
    assert diff.max() <= 1


def test_batch_wrapper_matches_single_pages():
    rs = np.random.RandomState(3)
    imgs = torch.from_numpy(rs.randint(0, 256, (2, 20, 24, 3)).astype(np.uint8))
    batch = bilateral.bilateral_filter_batch(imgs, 7, 30.0, 30.0)
    for i in range(2):
        assert torch.equal(batch[i],
                           bilateral.bilateral_filter(imgs[i], 7, 30.0, 30.0))


# ---------------------------------------------------------------------------
# K1's order of work, emulated in numpy
# ---------------------------------------------------------------------------

STRIP = 8          # output rows a thread owns (csrc/bilateral.cu: S)
SFU_EVERY = 2      # outputs i % SFU_EVERY == 0 take exp2 (csrc: SFU_EVERY)


def _f32_fma(a, b, c):
    """fl(a * b + c) in f32: the product of an f32 and a byte is exact in
    f64, so one rounding to f32 is the FMA's (up to a double-rounding
    tie)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def k1_weight(c, p, g, sp, rho=None):
    """The kernel's weight of two packed pixels: vabsdiff4 gives the integer
    L1 distance d; fl(g * d^2) (the fma of 2^23 + d^2 with g and -2^23 g is
    exact up to that rounding); ex2.approx, modelled as exp2 rounded to f32;
    times the space weight sp. With ``rho`` (sigma_color == sigma_space)
    the space term folds into the exponent instead: fl(g * (d^2 + rho)),
    no multiply."""
    d = np.zeros(np.broadcast(c, p).shape, np.int64)
    for sh in (0, 8, 16):
        d += np.abs(((c >> sh) & 255).astype(np.int64)
                    - ((p >> sh) & 255).astype(np.int64))
    m = d * d if rho is None else d * d + rho
    t = (np.float32(g).astype(np.float64) * m).astype(np.float32)
    e = np.exp2(t.astype(np.float64)).astype(np.float32)
    return e if rho is not None else (np.float32(sp) * e).astype(np.float32)


def k1_emulate(img, d, sigma_color, sigma_space):
    """(H, W, 3) uint8 through K1's order of work: each thread owns a
    vertical strip of STRIP outputs in one column and walks the window's
    columns left to right, each top to bottom; one weight per tap, except
    that the centre column's pairs inside the strip share one weight (met
    when the lower row is walked); odd outputs read the colour weight from a
    table by distance, even ones take one exp2, folded with the space
    weight when the sigmas are equal; f32 FMA sums per output in that order,
    then times the norm's reciprocal, round half to even, clip. Returns
    (output, number of weights computed)."""
    r = d // 2
    h, w, _ = img.shape
    ns = -(-h // STRIP)
    # the staged tile: edge-clamped rows -r .. ns*STRIP + r, cols -r .. w + r
    ys = np.clip(np.arange(-r, ns * STRIP + r), 0, h - 1)
    xs = np.clip(np.arange(-r, w + r), 0, w - 1)
    pix = img[ys][:, xs].astype(np.uint32)
    fpix = pix.astype(np.float32)
    packed = pix[..., 0] | (pix[..., 1] << 8) | (pix[..., 2] << 16)
    sp = np.exp(-np.arange(r * r + 1) / (2.0 * sigma_space ** 2)
                ).astype(np.float32)
    g = np.float32(-np.log2(np.e) / (2.0 * sigma_color ** 2))
    fold = sigma_color == sigma_space
    rows0 = np.arange(ns) * STRIP          # each strip's first source row

    def weight(i, ci, qp, rho):
        # odd outputs: the table's colour weight times the space weight;
        # even ones: exp2 on the special-function unit, folded when the
        # sigmas are equal
        return k1_weight(ci, qp, g, sp[rho],
                         rho if fold and i % SFU_EVERY == 0 else None)

    def source(j, dx):       # source row j of every strip, column x + dx
        return (fpix[rows0 + j][:, r + dx:r + dx + w],
                packed[rows0 + j][:, r + dx:r + dx + w])

    centre = [source(i + r, 0) for i in range(STRIP)]
    acc = [centre[i][0].copy() for i in range(STRIP)]
    nrm = [np.ones((ns, w), np.float32) for _ in range(STRIP)]
    c = [centre[i][1] for i in range(STRIP)]
    n_weights = 0

    def tap(i, wt, q):
        acc[i] = _f32_fma(wt[..., None], q, acc[i])
        nrm[i] = (nrm[i] + wt).astype(np.float32)

    for dx in range(-r, r + 1):
        hh = 0
        while (hh + 1) ** 2 + dx * dx <= r * r:
            hh += 1
        for j in range(r - hh, r + STRIP + hh):
            q, qp = source(j, dx)
            k = j - r
            for i in range(STRIP):
                dy = k - i
                if abs(dy) > hh:
                    continue
                if dx == 0 and 0 <= k < STRIP:
                    if i < k:
                        wt = weight(i, c[i], qp, dy * dy)
                        n_weights += 1
                        tap(i, wt, q)
                        tap(k, wt, centre[i][0])
                    continue
                n_weights += 1
                tap(i, weight(i, c[i], qp, dy * dy + dx * dx), q)
    out = np.empty((ns * STRIP, w, 3), np.uint8)
    for i in range(STRIP):
        inv = (np.float32(1) / np.maximum(nrm[i], np.float32(1e-8)))
        v = acc[i] * inv.astype(np.float32)[..., None]
        out[rows0 + i] = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out[:h], n_weights


@pytest.mark.parametrize('name', list(CASES))
def test_k1_emulation_matches_pallas_and_plain(refs, name):
    """The kernel's strips, shared centre-column pairs, integer distance
    with exp2 and f32 sum order stay within 1 gray of the JAX v6 Pallas
    kernel (interpret mode) and of the plain version, everywhere."""
    img, pal, _ = refs[name]
    _, d, sc, ss = CASES[name]
    emu, _ = k1_emulate(img, d, sc, ss)
    plain = bilateral.bilateral_filter_ref(torch.from_numpy(img), d, sc,
                                           ss).numpy()
    assert np.abs(emu.astype(int) - pal.astype(int)).max() <= 1
    assert np.abs(emu.astype(int) - plain.astype(int)).max() <= 1


@pytest.mark.parametrize('d', [17, 9])
def test_k1_emulation_weights_per_strip(d):
    """One weight per tap, less one per pair of the centre column inside
    the strip: at d=17, 196 * 8 - 28 = 1,540 weights a strip."""
    r = d // 2
    taps = len(bilateral.window_offsets(r)) - 1
    shared = sum(STRIP - dy for dy in range(1, min(r, STRIP - 1) + 1))
    img = np.zeros((STRIP, 5, 3), np.uint8)
    _, n = k1_emulate(img, d, 80.0, 80.0)
    assert n == taps * STRIP - shared
    if d == 17:
        assert n == 1540


def test_k1_shared_weight_is_bit_equal_to_a_fresh_one():
    """A pair's weight is symmetric to the bit (the distance is an integer),
    so the weight reused for the -o tap equals the one its output would
    compute afresh."""
    rs = np.random.RandomState(5)
    a = rs.randint(0, 256, (4096, 3)).astype(np.uint32)
    b = rs.randint(0, 256, (4096, 3)).astype(np.uint32)
    pa = a[:, 0] | (a[:, 1] << 8) | (a[:, 2] << 16)
    pb = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    g = np.float32(-np.log2(np.e) / (2.0 * 80.0 ** 2))
    for rho in (None, 13):
        wab = k1_weight(pa, pb, g, np.float32(0.9), rho)
        wba = k1_weight(pb, pa, g, np.float32(0.9), rho)
        assert np.array_equal(wab.view(np.uint32), wba.view(np.uint32))
