"""PyTorch port, LaMa-large: kernel K4's and K5's plain versions, the
kernel's DFT tables, the generator and its weights, against the JAX
package on the CPU with the same seeded inputs and weights."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_image_translator_tpu.models import lama as jax_lama
from manga_image_translator_tpu.models.lama import P
from manga_image_translator_tpu.models.torch_loader import convert_state_dict
from manga_image_translator_tpu.ops import pallas_conv
from manga_image_translator_tpu_torch.models import lama
from manga_image_translator_tpu_torch.ops import conv_stream, fourier_unit
from manga_image_translator_tpu_torch.weights import (load_state_dict_into,
                                                      torch_state_dict_from_jax)

torch.set_num_threads(2)

N_BLOCKS = 2


def _rel_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()) / max(
        float(np.abs(ref).max()), 1e-6)


def _fu_params(c, rs):
    """A FourierUnit's weights in the JAX layout, unfolded BN (as
    tests/test_pallas_spectral.py builds them)."""
    return {
        'conv_layer.weight': rs.randn(1, 1, 2 * c, 2 * c).astype(np.float32)
        * 0.1,
        'conv_layer.bias': rs.randn(2 * c).astype(np.float32) * 0.01,
        'bn.running_mean': rs.randn(2 * c).astype(np.float32) * 0.05,
        'bn.running_var': rs.rand(2 * c).astype(np.float32) + 0.5,
        'bn.weight': rs.rand(2 * c).astype(np.float32) + 0.5,
        'bn.bias': rs.randn(2 * c).astype(np.float32) * 0.05,
    }


def _port_fu(params, c):
    """The port's FourierUnit module holding the same weights."""
    fu = lama.FourierUnit(c)
    fu.conv_layer.bias = torch.nn.Parameter(torch.zeros(2 * c))
    load_state_dict_into(fu, torch_state_dict_from_jax(params))
    return fu.eval()


FU_SHAPES = [(16, 16, 16), (24, 21, 16)]    # (H, W, C): even and odd W


@pytest.fixture(scope='module')
def fu_cases():
    """Per shape: input, weights, the JAX XLA path and the Pallas kernel in
    interpret mode (computed once)."""
    cases = {}
    for h, w, c in FU_SHAPES:
        rs = np.random.RandomState(h * 100 + w)
        params = _fu_params(c, rs)
        x = rs.rand(1, h, w, c).astype(np.float32)
        jp = P({k: jnp.asarray(v) for k, v in params.items()})
        xla = np.asarray(jax_lama._fourier_unit(jp, jnp.asarray(x)))
        pallas = np.asarray(jax_lama._fourier_unit_pallas(
            jp, jnp.asarray(x), interpret=True))
        cases[(h, w, c)] = (x, params, xla, pallas)
    return cases


@pytest.mark.parametrize('shape', FU_SHAPES, ids=['16x16', '24x21'])
def test_fourier_unit_plain_matches_jax(fu_cases, shape):
    """1e-5 of the output's max: the JAX suite's bound for its f32
    kernel (test_pallas_spectral.py)."""
    x, params, xla, pallas = fu_cases[shape]
    fu = _port_fu(params, shape[2])
    w_spec, b_spec = fu.spectral_weights()
    got = fourier_unit.fourier_unit_ref(torch.from_numpy(x), w_spec,
                                        b_spec).numpy()
    assert _rel_err(got, xla) < 1e-5
    assert _rel_err(got, pallas) < 1e-5
    # the module's NCHW route (the generator's) gives the same
    with torch.no_grad():
        via_module = fu(torch.from_numpy(x).permute(0, 3, 1, 2)
                        ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(via_module, got)


@pytest.mark.parametrize('h,w', [(16, 16), (24, 21), (8, 10), (7, 9)])
def test_fourier_unit_kernel_tables(h, w):
    """The kernel's route on the CPU: its twiddle tables, its [re | im]
    weight order and its five products (csrc/fourier_unit.cu), in f64
    matmuls, against the plain version (1e-5 of the output's max). The
    tables zero the imaginary parts of the DC and Nyquist bins as irfft2
    ignores them: the ReLU'd spectrum has them non-zero."""
    c = 3
    rs = np.random.RandomState(h + w)
    x = rs.randn(2, h, w, c).astype(np.float32)
    w_spec = torch.from_numpy(rs.randn(2 * c, 2 * c).astype(np.float32) * .3)
    b_spec = torch.from_numpy(rs.randn(2 * c).astype(np.float32) * .1)
    ref = fourier_unit.fourier_unit_ref(torch.from_numpy(x), w_spec,
                                        b_spec).numpy()
    t = {k: v.astype(np.float64)
         for k, v in fourier_unit.dft_tables(h, w).items()}
    wq, bq = (v.double().numpy()
              for v in fourier_unit.spectral_weights(w_spec, b_spec))
    k = w // 2 + 1

    def stack_h(s):        # (N, H, K, 2C) -> (N, 2H, K, C)
        return np.concatenate([s[..., :c], s[..., c:]], axis=1)

    def unstack_h(s):      # (N, 2H, K, C) -> (N, H, K, 2C)
        return np.concatenate([s[:, :h], s[:, h:]], axis=-1)

    f = np.einsum('kw,nhwc->nhkc', t['fwd_w'], x)            # (N, H, 2K, C)
    s = np.concatenate([f[:, :, :k], f[:, :, k:]], axis=-1)
    s = unstack_h(np.einsum('jh,nhkc->njkc', t['fwd_h'], stack_h(s)))
    y = np.maximum(s @ wq + bq, 0)
    assert np.abs(y[:, :, 0, c:]).max() > 0     # non-zero imag at DC
    g = unstack_h(np.einsum('jh,nhkc->njkc', t['inv_h'], stack_h(y)))
    g = np.concatenate([g[..., :c], g[..., c:]], axis=2)     # (N, H, 2K, C)
    out = np.einsum('wk,nhkc->nhwc', t['inv_w'], g)
    assert _rel_err(out, ref) < 1e-5


@pytest.fixture(scope='module')
def conv_cases():
    """(x, w, bias, relu) per case and the JAX Pallas kernel's output in
    interpret mode."""
    rs = np.random.RandomState(5)
    cases = {}
    for name, cin, cout, relu in (('stem_7x7_cin4_relu', 4, 8, True),
                                  ('final_7x7_cout3', 8, 3, False)):
        x = rs.randn(1, 22, 22, cin).astype(np.float32)
        w = (rs.randn(7, 7, cin, cout) * 0.1).astype(np.float32)
        b = (rs.randn(cout) * 0.1).astype(np.float32)
        ref = np.asarray(pallas_conv.conv2d_stream(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu,
            interpret=True))
        cases[name] = (x, w, b, relu, ref)
    return cases


@pytest.mark.parametrize('name', ['stem_7x7_cin4_relu', 'final_7x7_cout3'])
def test_conv_stream_plain_matches_jax(conv_cases, name):
    """1e-5 of the output's max (f32 sums in another order)."""
    x, w, b, relu, ref = conv_cases[name]
    got = conv_stream.conv2d_stream(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), relu=relu)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel_err(got.numpy(), ref) < 1e-5
    assert torch.equal(got, conv_stream.conv2d_stream_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        relu=relu))


def test_conv_stream_cast_epilogue():
    x = torch.randn(1, 9, 9, 4).to(torch.bfloat16)
    w = torch.randn(3, 3, 4, 5)
    out = conv_stream.conv2d_stream(x, w, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (1, 7, 7, 5)
    assert conv_stream.conv2d_stream(x, w).dtype == torch.bfloat16


@pytest.fixture(scope='module')
def jax_params():
    return {k: np.array(v) for k, v in jax_lama.init_params(N_BLOCKS).items()}


@pytest.fixture(scope='module')
def jax_folded(jax_params):
    return {k: np.array(v)
            for k, v in jax_lama.fold_bn(jax_params, N_BLOCKS).items()}


def _sd(params):
    return torch_state_dict_from_jax(
        {k: v for k, v in params.items() if not k.startswith('pallas.')},
        lama.transposed_conv_patterns(N_BLOCKS))


GEN_SHAPES = [(64, 64), (64, 96)]


@pytest.fixture(scope='module')
def gen_cases(jax_params, jax_folded):
    """Per (fold, shape): masked image, mask and the JAX generator's
    output."""
    cases = {}
    for fold, params in ((False, jax_params), (True, jax_folded)):
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        for h, w in GEN_SHAPES:
            rs = np.random.RandomState(h + w)
            img = rs.rand(1, h, w, 3).astype(np.float32)
            mask = (rs.rand(1, h, w, 1) < 0.2).astype(np.float32)
            img = img * (1 - mask)
            ref = np.asarray(jax_lama.lama_generator_forward(
                jp, jnp.asarray(img), jnp.asarray(mask), n_blocks=N_BLOCKS))
            cases[(fold, h, w)] = (img, mask, ref)
    return cases


@pytest.mark.parametrize('fold', [False, True], ids=['bn', 'folded'])
@pytest.mark.parametrize('shape', GEN_SHAPES, ids=['64x64', '64x96'])
def test_generator_matches_jax(gen_cases, jax_params, fold, shape):
    """The port's generator (plain routes on the CPU, f32) on the JAX
    init_params weights, with BN and with BN folded by the port's own
    fold_bn: 1e-4 absolute on the sigmoid output (ROADMAP §C's
    cross-framework tolerance)."""
    img, mask, ref = gen_cases[(fold,) + shape]
    model = lama.build_lama(N_BLOCKS, _sd(jax_params))
    if fold:
        lama.fold_bn(model)
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (1,) + shape + (3,)
    assert np.abs(got - ref).max() < 1e-4


def test_fold_bn_matches_jax_fold(jax_params, jax_folded):
    """The port's fold_bn gives the JAX fold_bn's weights, key for key
    (its Pallas-only packed keys aside)."""
    model = lama.fold_bn(lama.build_lama(N_BLOCKS, _sd(jax_params)))
    want = _sd(jax_folded)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, val in want.items():
        torch.testing.assert_close(got[key], val, rtol=1e-6, atol=1e-7,
                                   msg=key)


def test_lama_round_trip(jax_params):
    """JAX params → torch state dict → JAX params is exact, and the
    port's module takes every key strictly (checkpoint layout)."""
    sd = _sd(jax_params)
    back = convert_state_dict(sd, transposed_conv_patterns=(
        lama.transposed_conv_patterns(N_BLOCKS)))
    assert set(back) == set(jax_params)
    for k, v in jax_params.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    load_state_dict_into(lama.LamaGenerator(N_BLOCKS), sd)
    assert (lama.TRANSPOSED_CONV_PATTERNS_FOR_BLOCKS[18]
            == jax_lama.TRANSPOSED_CONV_PATTERNS_FOR_BLOCKS[18])
    assert (lama.TRANSPOSED_CONV_PATTERNS_FOR_BLOCKS[9]
            == jax_lama.TRANSPOSED_CONV_PATTERNS_FOR_BLOCKS[9])


def test_init_state_dict_is_the_jax_init(jax_params):
    """The port's random weights are the JAX package's, bit for bit."""
    want = _sd(jax_params)
    got = lama.init_state_dict(N_BLOCKS)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cast_for_compute_keeps_fourier_units_f32(jax_params):
    model = lama.fold_bn(lama.build_lama(N_BLOCKS, _sd(jax_params)))
    half = lama.cast_for_compute(model, torch.bfloat16)
    for name, p in half.named_parameters():
        want = torch.float32 if '.fu.' in name else torch.bfloat16
        assert p.dtype == want, name
    assert next(model.parameters()).dtype == torch.float32


def test_spectral_weights_packed_once_per_weight_set():
    """The wrapper's de-interleaved weights are cached per weight tensor,
    inference tensors included, and rebuilt after an in-place change."""
    w = torch.randn(8, 8)
    b = torch.randn(8)
    first = fourier_unit._packed(w, b)
    assert fourier_unit._packed(w, b) is first
    w.mul_(2)
    again = fourier_unit._packed(w, b)
    assert again is not first
    torch.testing.assert_close(again[0], 2 * first[0])
    with torch.inference_mode():
        wi, bi = torch.randn(8, 8), torch.randn(8)
        assert fourier_unit._packed(wi, bi) is fourier_unit._packed(wi, bi)


@pytest.mark.parametrize('p', [1, 3])
def test_reflect_pad_matches_torch_and_keeps_channels_last(p):
    """Every size from the smallest reflect allows (paired row/column
    copies where the pair's stride is >= 0, single ones below), on
    channels_last, NCHW and permuted-NHWC inputs."""
    for h in range(p + 1, 2 * p + 4):
        for w in (p + 1, 2 * p + 1, 11):
            x = torch.randn(2, 5, h, w)
            for xx in (x, x.contiguous(memory_format=torch.channels_last),
                       x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)):
                got = lama._reflect(xx, p)
                assert torch.equal(got, torch.nn.functional.pad(
                    xx, (p,) * 4, mode='reflect')), (h, w)
                assert got.is_contiguous(memory_format=torch.channels_last)
