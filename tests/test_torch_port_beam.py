"""PyTorch port: the beam search reads each beam's history through an
ancestry table (``src``) instead of reordering the K/V cache. Held against
the JAX package's beam decode on its TPU default path (the Pallas decoder
step in interpret mode, with the beam gather fused into the kernel and the
fused char-head top-k), and against the same step on a physically permuted
cache."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu_torch.models import ocr48
from manga_image_translator_tpu_torch.ops import decode_step as dops
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

from test_torch_port_cuda import _physical_reorder

torch.set_num_threads(2)

_ENV = {'MIT_TPU_OCR_PALLAS': 'interpret', 'MIT_TPU_OCR_FUSED_GATHER': '1',
        'MIT_TPU_OCR_KERNEL_TOPK': '1', 'MIT_TPU_OCR_KERNEL_CHARHEAD': '0',
        'MIT_TPU_OCR_BF16_BACKBONE': '0', 'MIT_TPU_MESH': '0'}


def _port_model(params, dict_size):
    sd = torch_state_dict_from_jax(
        {k: np.array(v) for k, v in params.items()},
        embedding_patterns=ocr48.EMBEDDING_PATTERNS)
    return ocr48.build_ocr48(dict_size, 'cpu', sd)


def _jax_beam(params, images, widths, env):
    """The JAX beam decode (k=2, max_len=12) under ``env``, traced afresh:
    ``beam_decode`` reads the kernel switches when it is traced, and its
    inner jitted ``beam_decode_from_memory`` keeps its first trace even
    after ``_clear_cache()``, so a new jit of the bodies is the only way to
    be sure the switches apply."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        fn = jax.jit(lambda p, im, w: jax_ocr48.beam_decode_from_memory
                     .__wrapped__(p, *jax_ocr48.compute_memory.__wrapped__(
                         p, im, w), beams_k=2, max_len=12,
                         max_finished_hypos=2))
        out = fn(params, jnp.asarray(images), jnp.asarray(widths))
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope='module')
def pallas_case():
    """The JAX beam decode through the Pallas harness (interpret mode, beam
    gather fused into the kernel, fused top-k) and through its XLA path,
    f32 backbone; n=2 48x32 crops, k=2, max_len=12 (the JAX suite's harness
    test setup)."""
    params = jax_ocr48.init_params(dict_size=48)
    rs = np.random.RandomState(7)
    images = rs.rand(2, 48, 32, 3).astype(np.float32) * 2 - 1
    widths = np.array([32, 20], np.int32)
    pallas = _jax_beam(params, images, widths, _ENV)
    xla = _jax_beam(params, images, widths, dict(_ENV, MIT_TPU_OCR_PALLAS='0'))
    return params, images, widths, pallas, xla


def test_beam_decode_matches_jax_fused_gather(pallas_case):
    """The port's plain beam search (ancestry table, f32) against the JAX
    kernel path, with the tolerances of the JAX suite's harness test
    (tests/test_pallas_decode.py): sequences equal, probs rtol 2e-2 /
    atol 1e-3. The colour rows come from the kernel's bf16 decoder outputs:
    the JAX package's own f32 path misses that test's fg tolerance (rtol
    5e-2, atol 2e-2) against them by 1.14x on this input. So the port's fg
    is held to the reference's own f32-to-kernel gap (within 10%), and to
    the stated tolerance against that f32 path."""
    params, images, widths, pallas, xla = pallas_case
    model = _port_model(params, 48)
    got = ocr48.beam_decode(model, torch.from_numpy(images),
                            torch.from_numpy(widths), beams_k=2, max_len=12,
                            bf16_backbone=False)
    np.testing.assert_array_equal(pallas['sequences'],
                                  got['sequences'].numpy())
    np.testing.assert_allclose(pallas['probs'], got['probs'].numpy(),
                               rtol=2e-2, atol=1e-3)
    fg = got['fg'].numpy()
    gap = np.abs(fg - pallas['fg']).max()
    ref_gap = np.abs(xla['fg'] - pallas['fg']).max()
    assert gap <= 1.1 * ref_gap, (gap, ref_gap)
    np.testing.assert_allclose(xla['fg'], fg, rtol=5e-2, atol=2e-2)


def _step_inputs(dtype, n=6, s_len=10, m_len=7, seed=0):
    model = ocr48.build_ocr48(40, 'cpu', ocr48.init_state_dict(40, seed))
    w, _, embd = model.packed(dtype)
    rs = np.random.RandomState(seed)
    memory = torch.from_numpy(rs.randn(n, m_len, 320).astype(np.float32))
    mask = torch.from_numpy(np.arange(m_len)[None, :]
                            >= rs.randint(1, m_len + 1, n)[:, None])
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(model, memory, mask, 1,
                                                 dtype)
    cache = torch.from_numpy(rs.randn(2, 5, s_len, n, 320).astype(np.float32)
                             ).to(dtype)
    src = torch.from_numpy(rs.randint(0, n, (s_len, n)).astype(np.int32))
    tgt = embd[torch.from_numpy(rs.randint(3, 40, n))]
    return w, tgt, ocr48.rot_table(s_len, 'cpu'), cache, src, mem_k, mem_v, \
        mem_len


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('step', [1, 6])
def test_ancestry_step_equals_permuted_cache(dtype, step):
    """A step that reads the history through a random non-identity ``src``
    gives the same bits as the same step on a cache whose rows were
    permuted into place (identity ``src``): same values, same order."""
    w, tgt, rot, cache, src, mem_k, mem_v, mem_len = _step_inputs(dtype)
    n = tgt.shape[0]
    assert not torch.equal(src[:step], torch.arange(n).expand(step, n))
    sk, sv = cache[0].clone(), cache[1].clone()
    pk, pv = cache[0].clone(), cache[1].clone()
    rows = src[:step].long()
    t = torch.arange(step)[:, None]
    pk[:, :step] = cache[0][:, t, rows]
    pv[:, :step] = cache[1][:, t, rows]
    got = dops.decode_step_ref(step, tgt, w, rot, sk, sv, mem_k, mem_v,
                               mem_len, src)
    ref = dops.decode_step_ref(step, tgt, w, rot, pk, pv, mem_k, mem_v,
                               mem_len)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(sk[:, step], pk[:, step])
    assert torch.equal(sk[:, :step], cache[0][:, :step])   # never moved


def test_run_beam_ancestry_equals_physical_reorder(monkeypatch):
    """The whole beam search (n=3, k=3, 10 steps, f32) with the ancestry
    table and with the caches gathered by beam parent every step: equal
    sequences, bit-equal log-probs and colour rows."""
    model = ocr48.build_ocr48(40, 'cpu', ocr48.init_state_dict(40, 3))
    rs = np.random.RandomState(5)
    memory = torch.from_numpy(rs.randn(3, 9, 320).astype(np.float32))
    mask = torch.from_numpy(np.arange(9)[None, :] >= np.array([9, 5, 7])[:, None])
    got = ocr48.run_beam(model, memory, mask, 3, 10, 2)
    monkeypatch.setattr(ocr48.decode_ops, 'decode_step',
                        _physical_reorder(dops.decode_step))
    ref = ocr48.run_beam(model, memory, mask, 3, 10, 2)
    for key in ('best_seq', 'best_logprob', 'best_colors'):
        assert torch.equal(got[key], ref[key]), key
