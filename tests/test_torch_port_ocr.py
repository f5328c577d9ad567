"""PyTorch port: the 48px OCR decoder step (K2's plain version), the
char-head top-k (K3's plain version) and the whole beam decode against the
JAX package, on the same seeded weights and inputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu_torch.models import ocr48
from manga_image_translator_tpu_torch.ops import decode_step as dops
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

N, S = 8, 32


def _port_model(params, dict_size, fold=True):
    sd = torch_state_dict_from_jax(
        {k: np.array(v) for k, v in params.items()},
        embedding_patterns=ocr48.EMBEDDING_PATTERNS)
    return ocr48.build_ocr48(dict_size, 'cpu', sd, fold=fold)


@pytest.fixture(scope='module')
def decoder():
    params = jax_ocr48.init_params(dict_size=64)
    return params, _port_model(params, 64, fold=False)


def _run_steps(params, model, m_len, dtype):
    """Three decode steps through the JAX decode_step and the port's plain
    version; returns the per-step (rel err of the outputs, of k_new)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pj = {k: (v.astype(jdt) if v.dtype == jnp.float32 else v)
          for k, v in params.items()}
    rs = np.random.RandomState(3)
    memory = rs.randn(N, m_len, 320).astype(np.float32) * 0.5
    mask = np.arange(m_len)[None, :] >= np.array([m_len - 2] * N)[:, None]
    caches = jax_ocr48.init_caches(pj, jnp.asarray(memory, jdt), N, S)
    tables = jax_ocr48.xpos_step_tables(S)

    w, _, embd = model.packed(dtype)
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(
        model, torch.from_numpy(memory), torch.from_numpy(mask), 1, dtype)
    self_k = torch.zeros((5, S, N, 320), dtype=dtype)
    self_v = torch.zeros_like(self_k)
    rot = ocr48.rot_table(S, 'cpu')
    errs = []
    jax_step = jax.jit(jax_ocr48.decode_step)
    for step, tok in enumerate(rs.randint(3, 60, (3, N))):
        out_j, caches = jax_step(
            pj, caches, jnp.asarray(tok), jnp.int32(step), jnp.asarray(mask),
            tables)
        out_t, k_new, _, _ = dops.decode_step(
            step, embd[torch.from_numpy(tok)], w, rot, self_k, self_v, mem_k,
            mem_v, mem_len)
        ref = np.asarray(out_j.astype(jnp.float32))
        got = out_t.float().numpy()
        # JAX keeps k head-major (L, N, H, S, hd)
        k_ref = np.asarray(caches.self_k[:, :, :, step].astype(jnp.float32)
                           ).reshape(5, N, 320)
        errs.append((np.abs(ref - got).max() / (np.abs(ref).max() + 1e-6),
                     np.abs(k_ref - k_new.float().numpy()).max()
                     / (np.abs(k_ref).max() + 1e-6)))
    return errs


@pytest.mark.parametrize('m_len', [16, 48])
def test_decode_step_f32_matches_jax(decoder, m_len):
    """In f32 the two implementations differ only by summation order."""
    for step, (err, kerr) in enumerate(_run_steps(*decoder, m_len,
                                                  torch.float32)):
        assert err < 1e-4, f'step {step}: rel err {err}'
        assert kerr < 1e-4, f'step {step}: k rel err {kerr}'


@pytest.mark.parametrize('m_len', [16, 48])
def test_decode_step_bf16_contract(decoder, m_len):
    """bf16 storage rounds at other places than JAX's bf16 graph: the
    bound of the JAX suite's own kernel test (tests/test_pallas_decode.py),
    5% of the output scale per step."""
    for step, (err, kerr) in enumerate(_run_steps(*decoder, m_len,
                                                  torch.bfloat16)):
        assert err < 0.05, f'step {step}: rel err {err}'
        assert kerr < 0.05, f'step {step}: k rel err {kerr}'


def test_char_topk_matches_jax():
    """The JAX suite's char-head test setup (dict 300, 16 bf16 rows):
    equal indices, log-probs within 2e-2."""
    params = jax_ocr48.init_params(dict_size=300)
    model = _port_model(params, 300, fold=False)
    rs = np.random.RandomState(11)
    dec = (rs.randn(16, 384).astype(np.float32) * 0.5)[:, :320]
    dec_b = jnp.asarray(dec, jnp.bfloat16)
    ref_v, ref_i = jax_ocr48.char_topk(params, dec_b, 5,
                                       params['embd.weight'].T)
    got_v, got_i = ocr48.char_topk(model, torch.from_numpy(dec).to(
        torch.bfloat16), 5)
    np.testing.assert_array_equal(np.asarray(ref_i), got_i.numpy())
    np.testing.assert_allclose(np.asarray(ref_v), got_v.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.fixture(scope='module')
def beam_case():
    """JAX reference beam decode, XLA path, f32 backbone (n=2, 48x32
    crops, k=2, max_len=12)."""
    import os
    old = {k: os.environ.get(k) for k in ('MIT_TPU_OCR_PALLAS',
                                          'MIT_TPU_OCR_BF16_BACKBONE',
                                          'MIT_TPU_MESH')}
    os.environ.update(MIT_TPU_OCR_PALLAS='0', MIT_TPU_OCR_BF16_BACKBONE='0',
                      MIT_TPU_MESH='0')
    for fn in (jax_ocr48.beam_decode, jax_ocr48.compute_memory):
        fn._clear_cache()
    try:
        params = jax_ocr48.init_params(dict_size=48)
        rs = np.random.RandomState(7)
        images = rs.rand(2, 48, 32, 3).astype(np.float32) * 2 - 1
        widths = np.array([32, 20], np.int32)
        ref = jax_ocr48.beam_decode(params, jnp.asarray(images),
                                    jnp.asarray(widths), beams_k=2,
                                    max_len=12)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for fn in (jax_ocr48.beam_decode, jax_ocr48.compute_memory):
            fn._clear_cache()
    return params, images, widths, ref


def test_beam_decode_matches_jax(beam_case):
    params, images, widths, ref = beam_case
    model = _port_model(params, 48)
    got = ocr48.beam_decode(model, torch.from_numpy(images),
                            torch.from_numpy(widths), beams_k=2, max_len=12,
                            bf16_backbone=False)
    np.testing.assert_array_equal(ref['sequences'], got['sequences'].numpy())
    np.testing.assert_allclose(ref['probs'], got['probs'].numpy(), rtol=2e-2,
                               atol=1e-3)
    np.testing.assert_allclose(ref['fg'], got['fg'].numpy(), rtol=5e-2,
                               atol=2e-2)


def test_compute_memory_matches_jax(beam_case, monkeypatch):
    """Backbone + encoder in f32 (the JAX function's body, eagerly: its jit
    reads the precision switch once, at its first trace)."""
    params, images, widths, _ = beam_case
    monkeypatch.setenv('MIT_TPU_OCR_BF16_BACKBONE', '0')
    mem_j, mask_j = jax_ocr48.compute_memory.__wrapped__(
        jax_ocr48.fold_bn(params), jnp.asarray(images), jnp.asarray(widths))
    model = _port_model(params, 48)
    memory, mask = ocr48.compute_memory(model, torch.from_numpy(images),
                                        torch.from_numpy(widths), False)
    np.testing.assert_array_equal(np.asarray(mask_j), mask.numpy())
    np.testing.assert_allclose(np.asarray(mem_j), memory.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('n,w,seed', [(2, 32, 7), (4, 64, 13)])
def test_bf16_memory_and_sequences_match_jax(n, w, seed, monkeypatch):
    """The default OCR path: backbone + encoder in bf16 activations
    (``MIT_TPU_OCR_BF16_BACKBONE`` unset on both sides). The memories agree
    within the JAX suite's bf16 bound, 0.15 x mean |memory|
    (tests/test_ocr48.py:323), and the beam sequences are equal, as that
    suite requires of its bf16 and f32 paths. The JAX side is traced afresh:
    its jitted functions read the switch at their first trace."""
    monkeypatch.delenv('MIT_TPU_OCR_BF16_BACKBONE', raising=False)
    monkeypatch.setenv('MIT_TPU_OCR_PALLAS', '0')
    monkeypatch.setenv('MIT_TPU_MESH', '0')
    params = jax_ocr48.init_params(dict_size=48)
    rs = np.random.RandomState(seed)
    images = rs.rand(n, 48, w, 3).astype(np.float32) * 2 - 1
    widths = rs.randint(w // 2, w + 1, n).astype(np.int32)

    def ref(p, im, wd):
        memory, mask = jax_ocr48.compute_memory.__wrapped__(p, im, wd)
        return memory, mask, jax_ocr48.beam_decode_from_memory.__wrapped__(
            p, memory, mask, beams_k=3, max_len=10, max_finished_hypos=2)

    mem_j, mask_j, out_j = jax.jit(ref)(params, jnp.asarray(images),
                                        jnp.asarray(widths))
    model = _port_model(params, 48)
    memory, mask = ocr48.compute_memory(model, torch.from_numpy(images),
                                        torch.from_numpy(widths), True)
    mem_j = np.asarray(mem_j, np.float32)
    drift = np.abs(mem_j - memory.float().numpy()).max()
    scale = np.abs(mem_j).mean()
    assert drift < 0.15 * max(scale, 1e-3), (drift, scale)
    np.testing.assert_array_equal(np.asarray(mask_j), mask.numpy())
    got = ocr48.beam_decode(model, torch.from_numpy(images),
                            torch.from_numpy(widths), beams_k=3, max_len=10,
                            bf16_backbone=True)
    np.testing.assert_array_equal(np.asarray(out_j['sequences']),
                                  got['sequences'].numpy())
