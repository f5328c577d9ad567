"""PyTorch port, on the card only: each CUDA kernel (K1 bilateral, K2
decoder step, K3 char-head top-k, K4 FourierUnit, K5 streaming conv)
against its plain PyTorch version on the same CUDA inputs, at small,
ragged and full-width shapes, the wrappers' refusals, K2 and K3's one
launch per call, the beam search's ancestry table against a physical
reorder of the cache, and the ct2 transformer of the translators, the
networks of the other detectors and inpainters (plain PyTorch; LaMa-MPE
through K4 and K5) and those of the other OCRs, the upscalers and the
colorizer on the card against the CPU.

The kernels have no CPU mode, so every test here skips without a card. The
file imports neither JAX nor the JAX package, so that it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from manga_image_translator_tpu_torch.models import lama, ocr48
from manga_image_translator_tpu_torch.ops import (bilateral, charhead,
                                                  conv_stream, cuda_build,
                                                  fourier_unit)
from manga_image_translator_tpu_torch.ops import decode_step as dops

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    try:
        return torch.zeros(1, device='cuda').device
    except (AssertionError, RuntimeError) as e:
        pytest.skip(f'torch cannot build a CUDA tensor here: {e}')


@pytest.fixture(scope='module')
def model(dev):
    return ocr48.build_ocr48(300, dev, ocr48.init_state_dict(300))


def test_wrappers_refuse_rather_than_fall_back(dev):
    """A CUDA tensor the kernel cannot take raises; it never runs the plain
    version."""
    with pytest.raises(TypeError):
        bilateral.bilateral_filter_batch(
            torch.zeros((1, 8, 8, 3), dtype=torch.float32, device=dev))
    with pytest.raises((TypeError, ValueError)):
        charhead.char_topk(torch.zeros((4, 320), device=dev), {'w1': None}, 5)
    with pytest.raises((TypeError, ValueError, KeyError)):
        dops.decode_step(0, torch.zeros((4, 320), device=dev), {},
                         None, None, None, None, None, None)


@pytest.mark.parametrize('shape,d', [((2, 37, 61, 3), 17), ((1, 40, 56, 3), 9)])
def test_bilateral_kernel_matches_plain(dev, shape, d):
    """Within 1 gray: f32 sums in another order round differently."""
    rs = np.random.RandomState(0)
    imgs = torch.from_numpy(rs.randint(0, 256, shape).astype(np.uint8)).to(dev)
    before = cuda_build.LAUNCHES['bilateral']
    got = bilateral.bilateral_filter_batch(imgs, d, 80.0, 80.0)
    assert cuda_build.LAUNCHES['bilateral'] == before + 1
    ref = bilateral.bilateral_filter_ref(imgs, d, 80.0, 80.0)
    assert (got.int() - ref.int()).abs().max().item() <= 1


def _bilateral_one_launch(imgs, d, sigma_color, sigma_space):
    before = cuda_build.LAUNCHES['bilateral']
    got = bilateral.bilateral_filter_batch(imgs, d, sigma_color, sigma_space)
    assert cuda_build.LAUNCHES['bilateral'] == before + 1
    ref = bilateral.bilateral_filter_ref(imgs, d, sigma_color, sigma_space)
    return (got.int() - ref.int()).abs().max().item()


@pytest.mark.parametrize('shape,d', [
    ((1, 70, 90, 3), 3),        # radius 1, the generic instance
    ((1, 70, 90, 3), 17),       # radius 8, the unrolled instance
    ((1, 70, 90, 3), 33),       # radius 16, the largest the wrapper takes
    ((3, 40, 50, 3), 17),       # N = 3: the batch is the grid's z
    ((1, 5, 7, 3), 17),         # smaller than one 32x64 tile and its halo
    ((1, 5, 7, 3), 9),
    ((1, 65, 33, 3), 17),       # one past a multiple of the strip and tile
    ((2, 129, 97, 3), 11),
])
def test_bilateral_kernel_edges(dev, shape, d):
    """The redesigned K1 at its edges: both instances, the batch, images
    smaller than a tile and one past a multiple of it; within 1 gray of
    the plain version, one launch per call."""
    rs = np.random.RandomState(sum(shape) + d)
    imgs = torch.from_numpy(rs.randint(0, 256, shape).astype(np.uint8)).to(dev)
    assert _bilateral_one_launch(imgs, d, 80.0, 80.0) <= 1


def test_bilateral_space_weights_travel_with_each_launch(dev):
    """Two launches with different sigma_space in a row on one stream, no
    synchronisation between them: each matches its own plain result (the
    space weights are a kernel parameter, not shared state)."""
    rs = np.random.RandomState(7)
    imgs = torch.from_numpy(rs.randint(0, 256, (1, 96, 80, 3)).astype(
        np.uint8)).to(dev)
    outs = [bilateral.bilateral_filter_batch(imgs, 17, 30.0, ss)
            for ss in (2.0, 200.0)]
    torch.cuda.synchronize()
    refs = [bilateral.bilateral_filter_ref(imgs, 17, 30.0, ss)
            for ss in (2.0, 200.0)]
    for got, ref in zip(outs, refs):
        assert (got.int() - ref.int()).abs().max().item() <= 1
    assert not torch.equal(refs[0], refs[1])
    assert _bilateral_one_launch(imgs, 17, 30.0, 2.0) <= 1


def test_decode_step_kernel_matches_plain(dev, model):
    """Ragged N (10 rows), per-row memory lengths, 4 steps; bf16 storage
    rounds at the same places in both, f32 sums in another order: 5% of
    the output scale, the bound of the JAX suite's own kernel test."""
    n, s_len, m_len = 10, 16, 24
    w, _, embd = model.packed(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(0)
    memory = torch.randn((n, m_len, 320), generator=g, device=dev) * 0.5
    lens = torch.randint(1, m_len + 1, (n,), generator=g, device=dev)
    mask = torch.arange(m_len, device=dev)[None, :] >= lens[:, None]
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(model, memory, mask, 1,
                                                 torch.bfloat16)
    rot = ocr48.rot_table(s_len, dev)
    sk = torch.zeros((5, s_len, n, 320), dtype=torch.bfloat16, device=dev)
    sv = torch.zeros_like(sk)
    rk, rv = sk.clone(), sv.clone()
    for step in range(4):
        tok = torch.randint(3, 300, (n,), generator=g, device=dev)
        before = cuda_build.LAUNCHES['decode_step']
        out, kn, vn, _ = dops.decode_step(step, embd[tok], w, rot, sk, sv,
                                          mem_k, mem_v, mem_len)
        assert cuda_build.LAUNCHES['decode_step'] == before + 1
        rout, rkn, rvn = dops.decode_step_ref(step, embd[tok], w, rot, rk, rv,
                                              mem_k, mem_v, mem_len)
        for a, b in ((out, rout), (kn, rkn), (vn, rvn),
                     (sk[:, :step + 1], rk[:, :step + 1])):
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item() + 1e-6
            assert err / scale < 0.05, f'step {step}: rel err {err / scale}'


def test_decode_step_kernel_is_repeatable(dev, model):
    """The same inputs give the same bits (FF2's split-K partial sums are
    added in a fixed order), so the beam search is reproducible."""
    n, s_len, m_len = 24, 8, 16
    w, _, embd = model.packed(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(4)
    memory = torch.randn((n, m_len, 320), generator=g, device=dev)
    mask = torch.zeros((n, m_len), dtype=torch.bool, device=dev)
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(model, memory, mask, 1,
                                                 torch.bfloat16)
    rot = ocr48.rot_table(s_len, dev)
    tgt = embd[torch.randint(3, 300, (n,), generator=g, device=dev)]
    runs = []
    for _ in range(3):
        sk = torch.zeros((5, s_len, n, 320), dtype=torch.bfloat16, device=dev)
        sv = torch.zeros_like(sk)
        out = tgt
        for step in range(3):
            out, *_ = dops.decode_step(step, out, w, rot, sk, sv, mem_k,
                                       mem_v, mem_len)
        runs.append((out, sk, sv))
    for out, sk, sv in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert torch.equal(sk, runs[0][1]) and torch.equal(sv, runs[0][2])


@pytest.fixture(scope='module')
def full_models(dev):
    """OCR models at the released (7935) and the placeholder (2322)
    alphabet sizes."""
    return {v: ocr48.build_ocr48(v, dev, ocr48.init_state_dict(v))
            for v in (7935, 2322)}


@pytest.mark.parametrize('m_len', [96, 194, 386])
@pytest.mark.parametrize('n', [37, 80, 120])
def test_decode_step_kernel_ancestry_matches_plain(dev, full_models, n,
                                                   m_len):
    """A random non-identity ancestry table ``src`` at the port's chunk
    sizes (80, 120) and a ragged N, S=256, memory lengths of the 384-,
    768- and 1536-px width buckets (M 96, 194, 386; each row's length
    ragged between M/2 and M), steps 0, 1, 33, 128 and 255: 5% of the
    output scale against the plain version on the same table."""
    model = full_models[7935]
    s_len = 256
    w, _, embd = model.packed(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(n)
    memory = torch.randn((n, m_len, 320), generator=g, device=dev) * 0.5
    lens = torch.randint(m_len // 2, m_len + 1, (n,), generator=g, device=dev)
    mask = torch.arange(m_len, device=dev)[None, :] >= lens[:, None]
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(model, memory, mask, 1,
                                                 torch.bfloat16)
    rot = ocr48.rot_table(s_len, dev)
    sk = (torch.randn((5, s_len, n, 320), generator=g, device=dev) * 0.5
          ).to(torch.bfloat16)
    sv = (torch.randn((5, s_len, n, 320), generator=g, device=dev) * 0.5
          ).to(torch.bfloat16)
    src = torch.randint(0, n, (s_len, n), generator=g, device=dev,
                        dtype=torch.int32)
    for step in (0, 1, 33, 128, 255):
        tgt = embd[torch.randint(3, 7935, (n,), generator=g, device=dev)]
        rk, rv = sk.clone(), sv.clone()
        out, kn, vn, _ = dops.decode_step(step, tgt, w, rot, sk, sv, mem_k,
                                          mem_v, mem_len, src)
        rout, rkn, rvn = dops.decode_step_ref(step, tgt, w, rot, rk, rv,
                                              mem_k, mem_v, mem_len, src)
        for a, b in ((out, rout), (kn, rkn), (vn, rvn)):
            assert _rel(a, b) < 0.05, f'step {step}: rel err {_rel(a, b)}'


def _physical_reorder(decode_step):
    """``decode_step`` as a beam search without an ancestry table would run
    it: the history gathered into row order before the step (identity
    ``src``), the step's new k/v written back."""
    def step_fn(step, tgt, w, rot, self_k, self_v, mem_k, mem_v, mem_len,
                src=None):
        pk, pv = self_k.clone(), self_v.clone()
        if step:
            rows = src[:step].long()
            t = torch.arange(step, device=rows.device)[:, None]
            pk[:, :step] = self_k[:, t, rows]
            pv[:, :step] = self_v[:, t, rows]
        out = decode_step(step, tgt, w, rot, pk, pv, mem_k, mem_v, mem_len)
        self_k[:, step] = pk[:, step]
        self_v[:, step] = pv[:, step]
        return out
    return step_fn


def test_run_beam_ancestry_equals_physical_reorder(dev, model, monkeypatch):
    """The beam search on the card with the kernels (16 crops x 5 beams,
    40 steps): the ancestry table against the caches gathered by beam
    parent every step gives equal sequences and bit-equal log-probs and
    colour rows (the kernel reads the same values in the same order)."""
    g = torch.Generator(device=dev).manual_seed(9)
    memory = torch.randn((16, 48, 320), generator=g, device=dev)
    lens = torch.randint(8, 49, (16,), generator=g, device=dev)
    mask = torch.arange(48, device=dev)[None, :] >= lens[:, None]
    got = ocr48.run_beam(model, memory, mask, 5, 40, 2)
    monkeypatch.setattr(ocr48.decode_ops, 'decode_step',
                        _physical_reorder(dops.decode_step))
    ref = ocr48.run_beam(model, memory, mask, 5, 40, 2)
    for key in ('best_seq', 'best_logprob', 'best_colors'):
        assert torch.equal(got[key], ref[key]), key


def _kernels_per_call(fn):
    """Kernel launches on the card during one call of ``fn``
    (torch.profiler), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and ('decode_step' in e.name or 'char_topk' in e.name)]


def test_k2_and_k3_launch_one_kernel_per_call(dev, model):
    """One cooperative launch per wrapper call, by the profiler's count of
    the kernels that ran on the card."""
    n, s_len, m_len = 24, 8, 16
    w, ch, embd = model.packed(torch.bfloat16)
    memory = torch.randn((n, m_len, 320), device=dev)
    mask = torch.zeros((n, m_len), dtype=torch.bool, device=dev)
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(model, memory, mask, 1,
                                                 torch.bfloat16)
    rot = ocr48.rot_table(s_len, dev)
    sk = torch.zeros((5, s_len, n, 320), dtype=torch.bfloat16, device=dev)
    sv = torch.zeros_like(sk)
    tgt = embd[torch.arange(3, 3 + n, device=dev)]
    k2 = _kernels_per_call(lambda: dops.decode_step(
        2, tgt, w, rot, sk, sv, mem_k, mem_v, mem_len))
    k3 = _kernels_per_call(lambda: charhead.char_topk(tgt, ch, 5))
    assert len(k2) == 1, k2
    assert len(k3) == 1, k3


@pytest.mark.parametrize('vocab', [7935, 2322])
@pytest.mark.parametrize('n', [37, 80, 120])
def test_char_topk_kernel_full_vocab(dev, full_models, n, vocab):
    """The released and the placeholder alphabets at the port's chunk
    sizes and a ragged N: equal indices, or a near-tie whose logits agree
    within 2e-2; values within 2e-2; two calls give the same bits."""
    _, ch, _ = full_models[vocab].packed(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(n + vocab)
    dec = torch.randn((n, 320), generator=g, device=dev).to(torch.bfloat16)
    got_v, got_i = charhead.char_topk(dec, ch, 5)
    again_v, again_i = charhead.char_topk(dec, ch, 5)
    ref_v, ref_i = charhead.char_topk_ref(dec, ch, 5)
    assert torch.equal(got_v, again_v) and torch.equal(got_i, again_i)
    bad = got_i != ref_i
    if bad.any():
        h = torch.nn.functional.gelu(dec.float() @ ch['w1'].float()
                                     + ch['b1']).to(dec.dtype)
        logits = h.float() @ ch['wv'].float().t() + ch['bv']
        gap = (logits.gather(1, got_i) - logits.gather(1, ref_i)).abs()[bad]
        assert gap.max().item() < 2e-2
    torch.testing.assert_close(got_v, ref_v, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize('k', [1, 2, 5])
def test_char_topk_kernel_matches_plain(dev, model, k):
    """Ragged rows (7) and a ragged vocabulary (300 = 2 x 128 + 44):
    equal indices, or a near-tie whose logits agree within 2e-2; values
    within 2e-2."""
    _, ch, _ = model.packed(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(k)
    dec = torch.randn((7, 320), generator=g, device=dev).to(torch.bfloat16)
    before = cuda_build.LAUNCHES['charhead']
    got_v, got_i = charhead.char_topk(dec, ch, k)
    assert cuda_build.LAUNCHES['charhead'] == before + 1
    ref_v, ref_i = charhead.char_topk_ref(dec, ch, k)
    assert got_i.shape == (7, k) and got_i.dtype == torch.int64
    bad = got_i != ref_i
    if bad.any():
        h = torch.nn.functional.gelu(dec.float() @ ch['w1'].float()
                                     + ch['b1']).to(dec.dtype)
        logits = h.float() @ ch['wv'].float().t() + ch['bv']
        gap = (logits.gather(1, got_i) - logits.gather(1, ref_i)).abs()[bad]
        assert gap.max().item() < 2e-2
    torch.testing.assert_close(got_v, ref_v, rtol=2e-2, atol=2e-2)


@pytest.fixture
def f32_references():
    """Plain versions in true f32 on the card: no TF32 in matmuls (the
    port's default) nor in cuDNN convolutions (switched on by the port)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-6)).item()


def test_new_wrappers_refuse_rather_than_fall_back(dev):
    with pytest.raises(TypeError):
        fourier_unit.fourier_unit(
            torch.zeros((1, 8, 8, 4), dtype=torch.float16, device=dev),
            torch.zeros((8, 8), device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError):      # weights do not fit C
        fourier_unit.fourier_unit(torch.zeros((1, 8, 8, 4), device=dev),
                                  torch.zeros((6, 6), device=dev),
                                  torch.zeros(6, device=dev))
    with pytest.raises(ValueError):      # C not a multiple of 8
        fourier_unit.fourier_unit(torch.zeros((1, 8, 8, 4), device=dev),
                                  torch.zeros((8, 8), device=dev),
                                  torch.zeros(8, device=dev))
    with pytest.raises(ValueError):      # a kernel width it is not built for
        conv_stream.conv2d_stream(torch.zeros((1, 9, 9, 4), device=dev),
                                  torch.zeros((2, 2, 4, 4), device=dev))
    with pytest.raises(ValueError):      # bf16 outside the tensor cores
        conv_stream.conv2d_stream(
            torch.zeros((1, 9, 9, 3), dtype=torch.bfloat16, device=dev),
            torch.zeros((3, 3, 3, 4), device=dev))
    with pytest.raises(TypeError):       # f32 in, bf16 out is not served
        conv_stream.conv2d_stream(torch.zeros((1, 9, 9, 4), device=dev),
                                  torch.zeros((3, 3, 4, 4), device=dev),
                                  out_dtype=torch.bfloat16)


@pytest.mark.parametrize('shape', [(1, 32, 32, 192), (2, 24, 21, 192),
                                   (1, 17, 40, 40), (1, 128, 128, 192),
                                   (1, 256, 181, 192)],
                         ids=['even', 'odd-w', 'ragged', 'crop1024',
                              'page-odd-w'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_fourier_unit_kernel_matches_plain(dev, f32_references, shape,
                                           dtype):
    """3xTF32 products against the f32 plain version. f32: 1e-4 of the
    output's max (three TF32 passes keep f32's accuracy, the sums run in
    another order over the dense DFT); bf16 input and output: 1e-2 (the
    output's rounding). (1, 128, 128, 192) is a 1024² crop's trunk,
    (1, 256, 181, 192) the full-page path's odd width."""
    n, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(h * w)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w_spec = torch.randn((2 * c, 2 * c), generator=g, device=dev) * 0.05
    b_spec = torch.randn((2 * c,), generator=g, device=dev) * 0.1
    before = cuda_build.LAUNCHES['fourier_unit']
    got = fourier_unit.fourier_unit(x, w_spec, b_spec)
    assert cuda_build.LAUNCHES['fourier_unit'] == before + 1
    ref = fourier_unit.fourier_unit_ref(x, w_spec, b_spec)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, ref) < (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize('shape', [(2, 70, 83), (6, 75, 90), (1, 9, 8)],
                         ids=['ragged', 'n6-off-tile', 'one-tile'])
@pytest.mark.parametrize('case', ['stem', 'final'])
@pytest.mark.parametrize('dtypes', [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=['f32', 'bf16', 'bf16-f32out'])
def test_conv_stream_kernel_matches_plain(dev, f32_references, case,
                                          dtypes, shape):
    """The stem (7x7, 4 -> 64, ReLU) and final (7x7, 64 -> 3) convs on
    padded inputs whose outputs are no multiple of the tensor-core tile
    (8 rows x 32 or 64 columns) in either axis, N up to 6. f32 input: the
    CUDA-core body against the f32 conv, 1e-5 of the output's max. bf16
    input: the tensor-core route multiplies bf16 weights (rounded once per
    weight set, as the JAX kernel feeds its matrix unit the compute dtype),
    so the reference is the f32 conv of the same bf16 input with the same
    bf16-rounded weights: 1e-5 for an f32 output (only the sums' order
    differs), 1e-2 for a bf16 output (its rounding)."""
    in_dt, out_dt = dtypes
    n, hp, wp = shape
    cin, cout, relu = (4, 64, True) if case == 'stem' else (64, 3, False)
    g = torch.Generator(device=dev).manual_seed(cin + hp)
    x = torch.randn((n, hp, wp, cin), generator=g, device=dev).to(in_dt)
    w = torch.randn((7, 7, cin, cout), generator=g, device=dev) * 0.05
    b = torch.randn((cout,), generator=g, device=dev)
    before = cuda_build.LAUNCHES['conv_stream']
    got = conv_stream.conv2d_stream(x, w, b, relu=relu, out_dtype=out_dt)
    assert cuda_build.LAUNCHES['conv_stream'] == before + 1
    w_ref = w if in_dt == torch.float32 else w.to(torch.bfloat16).float()
    ref = conv_stream.conv2d_stream_ref(x, w_ref, b, relu=relu,
                                        out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.shape == (n, hp - 6, wp - 6, cout) and got.dtype == out_dt
    assert _rel(got, ref) < (1e-5 if out_dt == torch.float32 else 1e-2)


def test_conv_stream_packed_weights(dev):
    """Weights packed once by the caller (``pack_weights``, as the
    generator keeps them) give the output of a call that packs for itself;
    such a call reads the weights as they are (an in-place change shows);
    packing refuses a shape the tensor-core route does not serve."""
    x = torch.rand((1, 20, 40, 4), device=dev).to(torch.bfloat16)
    w = torch.randn((7, 7, 4, 64), device=dev) * 0.05
    first = conv_stream.conv2d_stream(x, w,
                                      packed=conv_stream.pack_weights(w))
    assert torch.equal(conv_stream.conv2d_stream(x, w), first)
    w.mul_(2)
    again = conv_stream.conv2d_stream(x, w)
    torch.cuda.synchronize()
    assert _rel(again, 2 * first.float()) < 1e-2
    with pytest.raises(ValueError):
        conv_stream.pack_weights(torch.zeros((3, 3, 3, 4), device=dev))


def test_generator_kernels_match_plain_routes(dev, f32_references,
                                              monkeypatch):
    """A 2-block generator (full widths) in f32 on a 64x96 crop: K4 and K5
    against the plain routes with the same weights, 1e-3 absolute on the
    sigmoid output; 4 K4 calls and 2 K5 calls per forward."""
    model = lama.fold_bn(lama.build_lama(2, lama.init_state_dict(2), dev))
    # (2 blocks of random weights keep the sigmoid unsaturated)
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand((1, 64, 96, 3), generator=g, device=dev)
    mask = (torch.rand((1, 64, 96, 1), generator=g, device=dev) < 0.3
            ).float()
    img = img * (1 - mask)
    cuda_build.reset_launch_counts()
    with torch.no_grad():
        got = model(img, mask)
    counts = cuda_build.launch_counts()
    assert counts['fourier_unit'] == 4 and counts['conv_stream'] == 2
    monkeypatch.setattr(lama, 'fourier_unit', fourier_unit.fourier_unit_ref)
    monkeypatch.setattr(lama, 'conv2d_stream', conv_stream.conv2d_stream_ref)
    with torch.no_grad():
        ref = model(img, mask)
    torch.cuda.synchronize()
    assert ((ref > 0.01) & (ref < 0.99)).float().mean().item() > 0.5
    assert (got - ref).abs().max().item() < 1e-3


def _ct2_variables(d=64, ffn=128, layers=2, vocab=50, seed=0):
    """A ct2 TransformerSpec variable dict (post-norm) from ``seed``."""
    rs = np.random.RandomState(seed)
    v = {'encoder/embeddings/weight': rs.randn(vocab, d) * 0.1,
         'decoder/embeddings/weight': rs.randn(vocab, d) * 0.1,
         'decoder/projection/weight': rs.randn(vocab, d) * 0.1,
         'decoder/projection/bias': rs.randn(vocab) * 0.01}
    linears = {'self_attention/linear_0': (3 * d, d),
               'self_attention/linear_1': (d, d),
               'ffn/linear_0': (ffn, d), 'ffn/linear_1': (d, ffn)}
    cross = {'attention/linear_0': (d, d), 'attention/linear_1': (2 * d, d),
             'attention/linear_2': (d, d)}
    for side, lin in (('encoder', linears), ('decoder', {**linears,
                                                         **cross})):
        for i in range(layers):
            for name, shape in lin.items():
                v[f'{side}/layer_{i}/{name}/weight'] = rs.randn(*shape) * 0.1
                v[f'{side}/layer_{i}/{name}/bias'] = rs.randn(shape[0]) * 0.01
            for sub in {n.split('/')[0] for n in lin}:
                v[f'{side}/layer_{i}/{sub}/layer_norm/gamma'] = (
                    1 + 0.1 * rs.randn(d))
                v[f'{side}/layer_{i}/{sub}/layer_norm/beta'] = 0.1 * rs.randn(d)
    return {k: a.astype(np.float32) for k, a in v.items()}


@pytest.mark.parametrize('beam', [1, 5])
def test_ct2_transformer_on_card_matches_cpu(dev, beam):
    """The ct2 transformer (the sugoi path, no hand-written kernel) at
    d=64: encoder states within 1e-4 of max |value| and equal tokens,
    forced prefixes included, between the card and the CPU."""
    from manga_image_translator_tpu_torch.translators import ct2_model
    vocab = ['<unk>', '<s>', '</s>'] + [f'▁w{i}' for i in range(47)]
    variables = _ct2_variables()
    cfg = {'num_heads': 4}
    card = ct2_model.Ct2Transformer(variables, cfg, vocab, None, device=dev)
    cpu = ct2_model.Ct2Transformer(variables, cfg, vocab, None, device='cpu')
    assert all(b.is_cuda for b in card.buffers())
    batch = [['▁w0', '▁w1', '▁w5'], ['▁w2'], ['▁w3', '▁w3', '▁w9', '▁w4']]
    tokens, lengths, _, _ = cpu.prepare(batch)
    with torch.inference_mode():
        ref, _ = cpu.encode(torch.from_numpy(tokens), torch.from_numpy(lengths))
        got, _ = card.encode(torch.from_numpy(tokens).to(dev),
                             torch.from_numpy(lengths).to(dev))
    assert (got.cpu() - ref).abs().max() <= 1e-4 * ref.abs().max()
    for prefix in (None, [['▁w7'], ['▁w9', '▁w2'], []]):
        kw = dict(beam_size=beam, max_len=24, target_prefix=prefix)
        assert card.translate_batch(batch, **kw) == cpu.translate_batch(
            batch, **kw)


def _backend_case(name, rs):
    """(model on the CPU in f32, forward(model, x), the input) of each
    network of the other detectors and inpainters, at test size; the MPE
    generator with both scales at 0.5."""
    from manga_image_translator_tpu_torch.models import (aot, craft, ctd,
                                                         dbnet_convnext,
                                                         paddle_det)
    if name == 'ctd':
        return (ctd.build_ctd('cpu', ctd.init_state_dict()),
                lambda m, x: ctd.ctd_forward(m, x),
                (rs.rand(1, 256, 192, 3).astype(np.float32),))
    if name == 'craft':
        nets = torch.nn.ModuleList([
            craft.build(craft.CRAFT, 'cpu', craft.init_state_dict()),
            craft.build(craft.RefineNet, 'cpu',
                        craft.init_refiner_state_dict())])
        return (nets, lambda m, x: craft.craft_forward(m[0], m[1], x),
                (rs.randn(1, 160, 128, 3).astype(np.float32),))
    if name == 'dbconvnext':
        return (dbnet_convnext.build_dbnet_convnext(
                    'cpu', dbnet_convnext.init_state_dict()),
                dbnet_convnext.dbnet_convnext_forward,
                (rs.rand(1, 128, 256, 3).astype(np.float32) * 2 - 1,))
    if name == 'paddle':
        return (paddle_det.build_paddle_det('cpu',
                                            paddle_det.init_state_dict()),
                paddle_det.paddle_det_forward,
                (rs.randn(1, 160, 96, 3).astype(np.float32),))
    mask = (rs.rand(1, 64, 96, 1) < 0.3).astype(np.float32)
    if name == 'aot':
        img = (rs.rand(1, 64, 96, 3).astype(np.float32) * 2 - 1) * (1 - mask)
        return (aot.build_aot('cpu', aot.init_state_dict()),
                lambda m, i, k: m(i, k), (img, mask))
    # lama_mpe: 9 blocks, the MPE embeddings of the mask; each block's
    # second FFC scaled by 0.1, as chip_smoke.py's scaled_generator: random
    # weights otherwise saturate the sigmoid (outputs 0 or 1) and amplify
    # what is left
    gen = lama.build_lama(9, lama.init_state_dict(9))
    with torch.no_grad():
        for i in range(9):
            ffc = gen.model[5 + i].conv2.ffc
            for conv in (ffc.convl2l, ffc.convg2l, ffc.convl2g,
                         ffc.convg2g.conv2):
                conv.weight.mul_(0.1)
    sd = lama.mpe_init_state_dict()
    sd['alpha5'] = sd['alpha6'] = torch.tensor(0.5)
    nets = torch.nn.ModuleList([gen, lama.build_mpe(sd)])
    rel, direct = lama.masked_position_encoding(mask[0, ..., 0])
    img = rs.rand(1, 64, 96, 3).astype(np.float32) * (1 - mask)
    return (nets, lambda m, i, k, r, d: m[0](i, k, *m[1](r, d)),
            (img, mask, rel[None], direct[None]))


@pytest.mark.parametrize('name', ['ctd', 'craft', 'dbconvnext', 'paddle',
                                  'aot', 'lama_mpe'])
def test_backend_network_on_card_matches_cpu(dev, name):
    """Each network of the other detectors and inpainters (plain PyTorch;
    the MPE generator through K4 and K5) on the card against the same
    weights on the CPU, f32 without TF32: max |card - cpu| within 1e-3 of
    max |cpu| (the JAX suite's bound between two frameworks)."""
    import copy
    rs = np.random.RandomState(0)
    model, fwd, inputs = _backend_case(name, rs)
    card = copy.deepcopy(model).to(dev)
    if name == 'lama_mpe':
        card[0].to(memory_format=lama.CHANNELS_LAST)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = fwd(model, *[torch.from_numpy(x) for x in inputs])
            got = fwd(card, *[torch.from_numpy(x).to(dev) for x in inputs])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for r, g in zip(ref, got):
        assert g.is_cuda and g.shape == r.shape
        err = float((g.cpu().float() - r.float()).abs().max())
        assert err <= 1e-3 * float(r.abs().max()), (name, err)
    if name == 'lama_mpe':
        assert float(((ref[0] > 0.01) & (ref[0] < 0.99)).float().mean()) > 0.5


_CUNET_STYLE = '\n'.join([
    '7767517', '9 10',
    'Input input 0 1 input',
    'Split split0 1 2 input in_a in_b',
    'Convolution conv1 1 1 in_a f1 0=8 1=3 5=1 6=216',
    'ReLU relu1 1 1 f1 f1r 0=0.100000',
    'Pooling gap 1 1 f1r pooled 0=1 4=1',
    'InnerProduct fc1 1 1 pooled fc1o 0=2 1=1 2=16 9=1',
    'InnerProduct fc2 1 1 fc1o fc2o 0=8 1=1 2=16',
    'Sigmoid sig 1 1 fc2o gate',
    'BinaryOp scale 2 1 f1r gate scaled 0=2',
    'Crop crop0 2 1 in_b scaled in_c',
    'Concat cat 2 1 in_c scaled out 0=0',
    'Deconvolution up 1 1 out y 0=3 1=4 3=2 4=3 5=1 6=528'])


class _Graph(torch.nn.Module):
    """An ncnn layer list as a module, so that it moves like the others."""

    def __init__(self, layers):
        super().__init__()
        self.layers = layers

    def forward(self, x):
        from manga_image_translator_tpu_torch.utils import ncnn_lite
        return ncnn_lite.run_graph(self.layers, x)


def _slice_case(name, rs):
    """(f32 model on the CPU, forward(model, *inputs), numpy inputs) of
    each network of the other OCRs, the upscalers and the colorizer, at
    small shapes."""
    from manga_image_translator_tpu_torch.models import (esrgan, mc2, ocr32,
                                                         ocr48_ctc, waifu2x)
    from manga_image_translator_tpu_torch.utils import ncnn_lite
    if name == 'ocr48_ctc':
        x = rs.uniform(-1, 1, (3, 48, 256, 3)).astype(np.float32)
        return (ocr48_ctc.build_ocr48_ctc(300, 'cpu',
                                          ocr48_ctc.init_state_dict(300)),
                ocr48_ctc.ctc_forward, (x,))
    if name == 'ocr32':
        x = rs.uniform(-1, 1, (3, 32, 128, 3)).astype(np.float32)
        vw = np.array([128, 90, 40], np.int64)

        def fwd(m, img, widths):
            mem, mask = ocr32.compute_memory(m, img, widths)
            dec = ocr32._Decoder(m, mem, mask, 4)
            step = dec.step(torch.full((3,), ocr32.START_TOK,
                                       device=img.device), 0)
            return mem, ocr32.char_logprobs(m, step)
        return (ocr32.build_ocr32(300, 'cpu', ocr32.init_state_dict(300)),
                fwd, (x, vw))
    if name == 'esrgan':
        x = rs.rand(2, 40, 48, 3).astype(np.float32)
        return (esrgan.build_esrgan(esrgan.init_state_dict(nb=2)),
                esrgan.esrgan_forward, (x,))
    if name == 'upconv7':
        x = rs.rand(1, 3, 38, 34).astype(np.float32)
        return (waifu2x.build_upconv7(waifu2x.init_state_dict()),
                lambda m, i: m(i), (x,))
    if name == 'ncnn_graph':
        layers = ncnn_lite.parse_param(_CUNET_STYLE)
        for layer in layers:
            if layer.type in ('Convolution', 'Deconvolution',
                              'InnerProduct'):
                n = int(layer.p(6 if layer.type != 'InnerProduct' else 2))
                layer.weights['weight'] = rs.randn(n).astype(np.float32) * .2
                layer.weights['bias'] = rs.randn(int(layer.p(0))).astype(
                    np.float32) * .01
        x = rs.rand(1, 3, 30, 26).astype(np.float32)
        return _Graph(layers), lambda m, i: m(i), (x,)
    if name == 'ffdnet':
        x = rs.rand(1, 64, 48, 3).astype(np.float32)
        return (mc2.build_ffdnet(mc2.init_ffdnet_state_dict()),
                mc2.ffdnet_rgb_forward,
                (x, np.array([30 / 255], np.float32)))
    x = rs.rand(1, 64, 96, 5).astype(np.float32)
    return (mc2.build_generator(mc2.init_generator_state_dict()),
            lambda m, s: mc2.generator_forward(m, s, guide=True), (x,))


@pytest.mark.parametrize('name', ['ocr48_ctc', 'ocr32', 'esrgan', 'upconv7',
                                  'ncnn_graph', 'ffdnet', 'mc2_generator'])
def test_slice_network_on_card_matches_cpu(dev, name):
    """Each network of the other OCRs, the upscalers and the colorizer
    (plain PyTorch) on the card against the same weights on the CPU, f32
    without TF32: max |card - cpu| within 1e-3 of max |cpu| (the JAX
    suite's bound between two frameworks)."""
    import copy
    rs = np.random.RandomState(0)
    model, fwd, inputs = _slice_case(name, rs)
    card = copy.deepcopy(model).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = fwd(model, *[torch.from_numpy(x) for x in inputs])
            got = fwd(card, *[torch.from_numpy(x).to(dev) for x in inputs])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for r, g in zip(ref, got):
        assert g.is_cuda and g.shape == r.shape
        err = float((g.cpu().float() - r.float()).abs().max())
        assert err <= 1e-3 * float(r.abs().max()), (name, err)
