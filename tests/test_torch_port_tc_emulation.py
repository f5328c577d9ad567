"""PyTorch port, the tensor-core designs of kernels K4 and K5 emulated on
the CPU: the arithmetic each CUDA kernel does (csrc/fourier_unit.cu,
csrc/conv_stream.cu), in the same operand types and the same K order, in
torch, against f64 and f32 references and the JAX package.

* K4 runs every product as 3xTF32: each f32 operand a = hi + lo with both
  rounded to TF32 (10 mantissa bits, to nearest, ties away from zero, as
  ``cvt.rna.tf32.f32``), a.b = ah.bl + al.bh + ah.bh with f32 sums. A
  product of two TF32 values is exact in f32, so f32 matmuls of the parts
  emulate the tensor cores' products.
* K5 runs bf16 inputs as an implicit GEMM on the weights rounded to bf16:
  per (channel chunk, dy) an A row is the KW taps x CK channels of one
  input row, padded to k16 steps, f32 sums.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_image_translator_tpu.models import lama as jax_lama
from manga_image_translator_tpu.models.lama import P
from manga_image_translator_tpu_torch.models import lama
from manga_image_translator_tpu_torch.ops import conv_stream, fourier_unit
from manga_image_translator_tpu_torch.weights import (load_state_dict_into,
                                                      torch_state_dict_from_jax)

torch.set_num_threads(2)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 (kept in f32): round to nearest on the 13 dropped bits,
    ties away from zero (the carry may reach the exponent, as it should)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a.float() - ah), tf32(b.float() - bh)
    return ah @ bl + al @ bh + ah @ bh


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def mm_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.double() @ b.double()


def fourier_unit_route(x, w_spec, b_spec, mm):
    """The kernel's five products (W stage, H stage, spectral conv + bias
    + ReLU, inverse H, inverse W) over its tables and [re | im] layout,
    each product through ``mm``."""
    n, h, w, c = x.shape
    k = w // 2 + 1
    tabs = {name: torch.from_numpy(v)
            for name, v in fourier_unit.dft_tables(h, w).items()}
    wq, bq = fourier_unit.spectral_weights(w_spec, b_spec)

    def stacked(s):        # (N, H, K, 2C) -> (2H, N * K * C)
        s = s.reshape(n, h, k, 2, c).permute(3, 1, 0, 2, 4)
        return s.reshape(2 * h, n * k * c)

    def unstacked(s):      # (2H, N * K * C) -> (N, H, K, 2C)
        return (s.reshape(2, h, n, k, c).permute(2, 1, 3, 0, 4)
                .reshape(n, h, k, 2 * c))

    xs = x.permute(2, 0, 1, 3).reshape(w, n * h * c)         # (W, NHC)
    f = mm(tabs['fwd_w'], xs).reshape(2, k, n, h, c)          # (2K, NHC)
    s = f.permute(2, 3, 1, 0, 4).reshape(n, h, k, 2 * c)
    s = unstacked(mm(tabs['fwd_h'], stacked(s)))
    y = torch.relu(mm(s.reshape(-1, 2 * c), wq) + bq).reshape(n, h, k, 2 * c)
    g = unstacked(mm(tabs['inv_h'], stacked(y)))
    g = g.reshape(n, h, k, 2, c).permute(3, 2, 0, 1, 4).reshape(2 * k, -1)
    out = mm(tabs['inv_w'], g).reshape(w, n, h, c)
    return out.permute(1, 2, 0, 3)


def _fu_inputs(shape, seed):
    n, h, w, c = shape
    rs = np.random.RandomState(seed)
    x = rs.rand(n, h, w, c).astype(np.float32)           # post-ReLU input
    w_spec = (rs.randn(2 * c, 2 * c) * np.sqrt(2.0 / (2 * c))).astype(
        np.float32)
    b_spec = (rs.randn(2 * c) * 0.1).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(w_spec),
            torch.from_numpy(b_spec))


def _f64_reference(x, w_spec, b_spec):
    """The FourierUnit in float64 (``fourier_unit_ref``'s steps; that
    function itself computes in f32)."""
    n, h, w, c = x.shape
    spec = torch.fft.rfft2(x.double(), dim=(1, 2), norm='ortho')
    inter = torch.view_as_real(spec).reshape(n, h, w // 2 + 1, 2 * c)
    y = torch.relu(inter @ w_spec.double().t() + b_spec.double())
    y = torch.view_as_complex(y.reshape(n, h, w // 2 + 1, c, 2).contiguous())
    return torch.fft.irfft2(y, s=(h, w), dim=(1, 2), norm='ortho').numpy()


FU_SHAPES = [(1, 16, 16, 192), (2, 24, 21, 192)]


@pytest.mark.parametrize('shape', FU_SHAPES, ids=['16x16', '2x24x21'])
def test_3xtf32_fourier_unit_meets_f32_accuracy(shape):
    """The kernel's arithmetic: 1e-5 of the output's max against the f64
    function; the plain f32 version lands at the same level."""
    x, w_spec, b_spec = _fu_inputs(shape, sum(shape))
    ref = _f64_reference(x, w_spec, b_spec)
    got = fourier_unit_route(x, w_spec, b_spec, mm_3xtf32)
    assert got.dtype == torch.float32
    assert _rel(got, ref) < 1e-5
    assert _rel(fourier_unit.fourier_unit_ref(x, w_spec, b_spec), ref) < 1e-5
    # the route in f64 is the function, up to the tables' f32 rounding
    assert _rel(fourier_unit_route(x, w_spec, b_spec, mm_f64), ref) < 1e-6


@pytest.mark.parametrize('shape', FU_SHAPES, ids=['16x16', '2x24x21'])
def test_1xtf32_fourier_unit_misses_the_tolerance(shape):
    """Plain TF32 (one pass, ~3 digits) misses the kernel's 1e-4: the
    reason the kernel splits every operand."""
    x, w_spec, b_spec = _fu_inputs(shape, sum(shape))
    ref = _f64_reference(x, w_spec, b_spec)
    assert _rel(fourier_unit_route(x, w_spec, b_spec, mm_1xtf32), ref) > 1e-4


def test_tf32_rounding():
    """10 mantissa bits, ties away from zero, carry into the exponent."""
    one = 1.0
    ulp = 2.0 ** -10
    vals = torch.tensor([one + ulp / 2, one + ulp / 4, -(one + ulp / 2),
                         one + 3 * ulp / 2, 2 - ulp / 2, 3.0, 0.0],
                        dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 2.0,
                         3.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32(vals), want)
    a = torch.randn(1000)
    hi = tf32(a)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((a - hi).abs() <= a.abs() * 2.0 ** -11).all()


def test_3xtf32_fourier_unit_matches_jax_pallas_kernel():
    """Against the JAX package's Pallas FourierUnit (interpret mode) on
    the same weights at (1, 16, 16, 192): 1e-4 of the output's max."""
    c = 192
    rs = np.random.RandomState(11)
    params = {
        'conv_layer.weight': (rs.randn(1, 1, 2 * c, 2 * c)
                              * np.sqrt(2.0 / (2 * c))).astype(np.float32),
        'conv_layer.bias': (rs.randn(2 * c) * 0.01).astype(np.float32),
        'bn.running_mean': (rs.randn(2 * c) * 0.05).astype(np.float32),
        'bn.running_var': (rs.rand(2 * c) + 0.5).astype(np.float32),
        'bn.weight': (rs.rand(2 * c) + 0.5).astype(np.float32),
        'bn.bias': (rs.randn(2 * c) * 0.05).astype(np.float32),
    }
    x = rs.rand(1, 16, 16, c).astype(np.float32)
    jp = P({k: jnp.asarray(v) for k, v in params.items()})
    want = np.asarray(jax_lama._fourier_unit_pallas(jp, jnp.asarray(x),
                                                    interpret=True))
    fu = lama.FourierUnit(c)
    fu.conv_layer.bias = torch.nn.Parameter(torch.zeros(2 * c))
    load_state_dict_into(fu, torch_state_dict_from_jax(params))
    w_spec, b_spec = fu.eval().spectral_weights()
    got = fourier_unit_route(torch.from_numpy(x), w_spec, b_spec, mm_3xtf32)
    assert _rel(got, want) < 1e-4


def k5_tc_route(x, w, bias, relu, out_dtype):
    """The tensor-core route of csrc/conv_stream.cu: bf16 input and bf16-
    rounded weights; CK = cin for cin 4 or 8, else chunks of 16 channels;
    per (chunk, dy) one product whose K is the KW taps x CK channels of an
    input row (A row of output pixel x: pixel x + k // CK, channel k % CK),
    zero-padded to k16 steps; N padded to 8 lanes (cout <= 8) or 64; f32
    sums; bias, ReLU, cast. Returns the output and (CK, K per product)."""
    n, hp, wp, cin = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    ck = cin if cin in (4, 8) else 16
    kpad = -(-kw * ck // 16) * 16
    npad = 8 if cout <= 8 else 64
    wb = w.to(torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    acc = torch.zeros((n, ho, wo, npad))
    for c in range(cin // ck):
        chunk = xb[..., c * ck:(c + 1) * ck]
        for dy in range(kh):
            # B (N x K): row o is w[dy, dx, c * ck + i, o] at k = dx * ck + i
            b = wb[dy, :, c * ck:(c + 1) * ck].reshape(kw * ck, cout).t()
            b = torch.nn.functional.pad(b, (0, kpad - kw * ck,
                                            0, npad - cout))
            a = torch.cat([chunk[:, dy:dy + ho, dx:dx + wo]
                           for dx in range(kw)], dim=-1)
            a = torch.nn.functional.pad(a, (0, kpad - kw * ck))
            acc = acc + a @ b.t()
    y = acc[..., :cout] + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype), (ck, kpad)


def _k5_case(cin, cout, kh, kw, seed, size=(2, 70, 83)):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(*size, cin).astype(np.float32))
    w = torch.from_numpy((rs.randn(kh, kw, cin, cout) * 0.05)
                         .astype(np.float32))
    b = torch.from_numpy(rs.randn(cout).astype(np.float32))
    return x, w, b


def _k5_reference(x, w, b, relu):
    """The plain version given the same bf16 input and bf16-rounded
    weights, in f32."""
    return conv_stream.conv2d_stream_ref(
        x.to(torch.bfloat16), w.to(torch.bfloat16).float(), b, relu=relu,
        out_dtype=torch.float32)


@pytest.mark.parametrize('case', ['stem', 'final'])
def test_k5_tensor_core_order_matches_plain(case):
    """The stem (7x7, 4 -> 64: the row-im2col, 7 taps x 4 channels = 28
    padded to 32, two k16 steps) and the final conv (7x7, 64 -> 3: per tap
    K = 64 as four chunks of 16 channels, one k16 step each; N padded to 8)
    on a ragged 70x83 input, against the plain version given the same bf16
    input and bf16-rounded weights: 1e-5 of the output's max in f32."""
    cin, cout, relu = (4, 64, True) if case == 'stem' else (64, 3, False)
    x, w, b = _k5_case(cin, cout, 7, 7, cin)
    got, (ck, kpad) = k5_tc_route(x, w, b, relu, torch.float32)
    assert (ck, kpad) == ((4, 32) if case == 'stem' else (16, 7 * 16))
    ref = _k5_reference(x, w, b, relu)
    assert got.shape == ref.shape == (2, 64, 77, cout)
    assert _rel(got, ref) < 1e-5
    # the bf16 output the stem writes on the main path: within its rounding
    got16, _ = k5_tc_route(x, w, b, relu, torch.bfloat16)
    assert _rel(got16.float(), ref) < 1e-2


@pytest.mark.parametrize('cin,cout,kh,kw', [(8, 16, 3, 3), (32, 6, 5, 5),
                                            (16, 64, 1, 1)],
                         ids=['ck8-3x3', 'two-chunks-5x5', 'ck16-1x1'])
def test_k5_tensor_core_order_other_shapes(cin, cout, kh, kw):
    """The route's other channel chunkings and kernel sizes (CK = 8; two
    chunks of 16 with K = 5 x 16 = 80 per product; a 1x1 conv whose K of 16
    is one k16 step) against the same plain reference: 1e-5."""
    x, w, b = _k5_case(cin, cout, kh, kw, cin + kh, size=(1, 19, 37))
    got, _ = k5_tc_route(x, w, b, False, torch.float32)
    ref = _k5_reference(x, w, b, False)
    assert got.shape == ref.shape == (1, 20 - kh, 38 - kw, cout)
    assert _rel(got, ref) < 1e-5


def test_k5_pack_weights_is_none_off_the_card():
    """Off the card there is nothing to pack: the plain version takes the
    HWIO weights as they are, and ignores ``packed``."""
    x, w, b = _k5_case(4, 64, 7, 7, 0, size=(1, 9, 10))
    assert conv_stream.pack_weights(w) is None
    assert torch.equal(conv_stream.conv2d_stream(x, w, b, packed=None),
                       conv_stream.conv2d_stream_ref(x, w, b))
