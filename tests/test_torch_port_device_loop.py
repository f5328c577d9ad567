"""PyTorch port: the decode loops on the device (``ops/device_loop.py``).

The two beam searches of the default path (the 48px OCR's ``run_beam``,
Sugoi's ``BeamSearch``) are fixed-shape bodies with a device step, which
the card replays as CUDA graphs and the CPU runs step by step. Here, on the
CPU: the runner's blocks run the steps of the per-step loop the port had
before (host step, an all-done read before every fourth step), with the
same stop step; ``decode_step_ref`` takes a 0-d step tensor; both searches
against the JAX package (``run_beam`` through ``beam_decode_from_memory``
on its XLA path, ``_beam_decode`` through ``translate_batch``) with the
tolerances of ``test_torch_port_beam.py`` and
``test_torch_port_translators.py``, Sugoi's across prefix-bucket edges and
with a forced prefix; and ``MIT_TPU_OCR_FAST_LEN`` read by both packages.
"""
import functools
import importlib.util
import logging
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu_torch.models import ocr48
from manga_image_translator_tpu_torch.ops import charhead as charhead_ops
from manga_image_translator_tpu_torch.ops import cuda_build
from manga_image_translator_tpu_torch.ops import decode_step as dops
from manga_image_translator_tpu_torch.ops import device_loop
from manga_image_translator_tpu_torch.translators import ct2_model
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

from test_ct2 import build_ct2_model
from test_torch_port_translators import BATCH, PREFIX, _models

torch.set_num_threads(2)


# -- the runner ----------------------------------------------------------------

def _per_step_loop(start, stop, every, body, finished):
    """The port's loop before the runner: a host read before every step
    that is a multiple of ``every``."""
    for step in range(start, stop):
        if step % every == 0 and finished():
            return step
        body(step)
    return stop


@pytest.mark.parametrize('stop', [64, 255])
@pytest.mark.parametrize('finish_at', [None, 1, 6, 8, 63, 100])
def test_runner_runs_the_steps_of_the_per_step_loop(stop, finish_at):
    """Steps 1..stop-1 in blocks of 4 (``run_beam``'s): the same steps, in
    order, and the same stop step as the per-step loop, for a batch that
    runs to the end and for one that finishes after ``finish_at`` steps;
    one host read a block."""
    def make():
        ran = []
        done = torch.zeros((), dtype=torch.bool)

        def body(step):
            ran.append(step)
            if finish_at is not None and len(ran) >= finish_at:
                done.fill_(True)
        return ran, done, body

    ref, ref_done, ref_body = make()
    ref_stop = _per_step_loop(1, stop, 4, ref_body, lambda: bool(ref_done))
    got, done, body = make()
    pos = torch.ones((), dtype=torch.int64)

    def device_body(variant):
        assert variant is None
        body(int(pos))
        pos.add_(1)
    loop = device_loop.DeviceLoop('cpu')
    assert loop.run(device_body, 1, stop, 4, lambda: done) == ref_stop
    assert got == ref
    assert not loop.stats.graphs and loop.stats.replays == 0
    assert loop.stats.eager_steps == len(ref)
    assert loop.stats.flag_reads == len([s for s in range(4, ref_stop + 1, 4)
                                         if s < stop])
    assert device_loop.history[-1] is loop.stats


def test_runner_picks_a_variant_per_block():
    """``variant(block_start, block_end)`` is asked once a block, and the
    body gets it at every step of that block."""
    seen, asked = [], []

    def variant(s, e):
        asked.append((s, e))
        return e

    loop = device_loop.DeviceLoop('cpu')
    stop = loop.run(seen.append, 0, 21, 8, lambda: torch.tensor(False),
                    variant)
    assert stop == 21
    assert asked == [(0, 8), (8, 16), (16, 21)]
    assert seen == [8] * 8 + [16] * 8 + [21] * 5


def test_eager_context_is_per_thread_and_restored():
    assert device_loop.replays_graphs('cuda')
    with device_loop.eager():
        assert not device_loop.replays_graphs('cuda')
        with device_loop.eager():
            pass
        assert not device_loop.replays_graphs('cuda:0')
        seen = []
        worker = threading.Thread(
            target=lambda: seen.append(device_loop.replays_graphs('cuda')))
        worker.start()
        worker.join()
        assert seen == [True]
    assert device_loop.replays_graphs('cuda')
    assert not device_loop.replays_graphs('cpu')


def test_capture_tally_is_per_thread(monkeypatch):
    """Launches counted while a thread captures go to that capture's tally
    only; another thread's launches meanwhile go to ``LAUNCHES``, once."""
    monkeypatch.setattr(cuda_build, 'LAUNCHES',
                        {name: 0 for name in cuda_build.LAUNCHES})
    inside, counted = threading.Event(), threading.Event()

    def other():
        inside.wait()
        cuda_build.count_launch('charhead')
        counted.set()
    worker = threading.Thread(target=other)
    worker.start()
    with cuda_build.capture_tally() as tally:
        cuda_build.count_launch('decode_step')
        cuda_build.count_launch('decode_step')
        inside.set()
        counted.wait()
    worker.join()
    assert tally == {'decode_step': 2}
    assert cuda_build.LAUNCHES['charhead'] == 1
    assert cuda_build.LAUNCHES['decode_step'] == 0
    cuda_build.count_launch('decode_step')            # the capture ended
    assert cuda_build.LAUNCHES['decode_step'] == 1


# -- K2's plain version with a device step -------------------------------------

@functools.lru_cache(maxsize=1)
def _step_case(seed=0, n=6, s_len=10, m_len=7):
    model = ocr48.build_ocr48(40, 'cpu', ocr48.init_state_dict(40, seed))
    w, _, embd = model.packed(torch.float32)
    rs = np.random.RandomState(seed)
    memory = torch.from_numpy(rs.randn(n, m_len, 320).astype(np.float32))
    mask = torch.from_numpy(np.arange(m_len)[None, :]
                            >= rs.randint(1, m_len + 1, n)[:, None])
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(model, memory, mask, 1,
                                                 torch.float32)
    cache = torch.from_numpy(rs.randn(2, 5, s_len, n, 320)
                             .astype(np.float32))
    src = torch.from_numpy(rs.randint(0, n, (s_len, n)).astype(np.int32))
    tgt = embd[torch.from_numpy(rs.randint(3, 40, n))]
    return (w, tgt, ocr48.rot_table(s_len, 'cpu'), cache, mem_k, mem_v,
            mem_len, src)


@pytest.mark.parametrize('step', [0, 4, 9])
def test_decode_step_ref_takes_a_step_tensor(step):
    """A 0-d int64 step gives the bits of the same ``int`` step, caches
    included."""
    w, tgt, rot, cache, mem_k, mem_v, mem_len, src = _step_case()
    a_k, a_v = cache[0].clone(), cache[1].clone()
    b_k, b_v = cache[0].clone(), cache[1].clone()
    ref = dops.decode_step(step, tgt, w, rot, a_k, a_v, mem_k, mem_v,
                           mem_len, src)
    got = dops.decode_step(torch.tensor(step), tgt, w, rot, b_k, b_v, mem_k,
                           mem_v, mem_len, src)
    for a, b in zip(ref[:3], got[:3]):
        assert torch.equal(a, b)
    assert torch.equal(a_k, b_k) and torch.equal(a_v, b_v)


@pytest.mark.parametrize('step', [-1, 10, torch.tensor(10),
                                  torch.tensor(-3)],
                         ids=['int-1', 'int10', 'tensor10', 'tensor-3'])
def test_decode_step_ref_refuses_a_step_outside_the_cache(step):
    w, tgt, rot, cache, mem_k, mem_v, mem_len, src = _step_case()
    with pytest.raises(ValueError, match='outside'):
        dops.decode_step_ref(step, tgt, w, rot, cache[0], cache[1], mem_k,
                             mem_v, mem_len, src)


# -- the 48px beam search --------------------------------------------------------

def _run_beam_per_step(model, memory, memory_mask, k, max_len, mfh):
    """``run_beam`` as the port ran it before the device loop: host
    ``int`` steps, reassigned buffers, the all-done flag read before every
    fourth step."""
    dev = memory.device
    n = memory.shape[0]
    nk = n * k
    dt = torch.float32
    w, ch, embd = model.packed(dt)
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(model, memory, memory_mask,
                                                 k, dt)
    self_k = torch.zeros((5, max_len, nk, 320), dtype=dt)
    self_v = torch.zeros_like(self_k)
    outc = torch.zeros((nk, max_len, 320), dtype=dt)
    rot = ocr48.rot_table(max_len, dev)
    ar_nk, ar_n = torch.arange(nk), torch.arange(n)
    src = ar_nk.to(torch.int32).expand(max_len, nk).contiguous()
    END = ocr48.END_TOK

    def step_fn(step, tok):
        out, _, _, _ = dops.decode_step(step, embd[tok], w, rot, self_k,
                                        self_v, mem_k, mem_v, mem_len, src)
        outc[:, step] = out
        return out

    out_idx = torch.full((nk, max_len + 1), END, dtype=torch.long)
    out_idx[:, 0] = ocr48.START_TOK
    top_v, top_i = charhead_ops.char_topk(step_fn(0, out_idx[:, 0]), ch, k)
    beam_pos = ar_nk % k
    out_idx[:, 1] = top_i[ar_nk, beam_pos]
    log_probs = top_v[ar_nk, beam_pos]
    done = torch.zeros(n, dtype=torch.bool)
    best_seq = torch.full((n, max_len + 1), END, dtype=torch.long)
    best_logprob = torch.full((n,), float('-inf'))
    row_src = ar_nk[:, None].expand(nk, max_len).clone()
    best_row_src = torch.zeros((n, max_len), dtype=torch.long)

    def latch(newly_done):
        lp = log_probs.view(n, k)
        best_beam = lp.argmax(dim=1)
        flat = ar_n * k + best_beam
        take = newly_done[:, None]
        best_seq.copy_(torch.where(take, out_idx[flat], best_seq))
        best_logprob.copy_(torch.where(newly_done, lp[ar_n, best_beam],
                                       best_logprob))
        best_row_src.copy_(torch.where(take, row_src[flat], best_row_src))
        done.logical_or_(newly_done)

    for step in range(1, max_len):
        if step % 4 == 0 and bool(done.all()):
            break
        last_tok = out_idx[:, step]
        top_v, top_i = charhead_ops.char_topk(step_fn(step, last_tok), ch, k)
        finished = (last_tok == END)[:, None]
        top_v = torch.where(finished, torch.zeros_like(top_v), top_v)
        top_i = torch.where(finished, torch.full_like(top_i, END), top_i)
        sel_v, sel_flat = charhead_ops.stable_topk(
            (log_probs[:, None] + top_v).view(n, k * k), k)
        parent = sel_flat // k
        parent_flat = (ar_n[:, None] * k + parent).view(-1)
        out_idx = out_idx[parent_flat]
        tok = top_i.view(n, k, k)[ar_n[:, None], parent,
                                  sel_flat % k].view(-1)
        out_idx[:, step + 1] = tok
        src[:step + 1] = src[:step + 1, parent_flat]
        row_src[:, step] = ar_nk
        row_src = row_src[parent_flat]
        log_probs = sel_v.reshape(-1)
        latch(((tok == END).view(n, k).sum(dim=1) >= mfh) & ~done)
    latch(~done)
    colors = outc[best_row_src, torch.arange(max_len)[None, :]]
    return {'best_seq': best_seq, 'best_logprob': best_logprob,
            'best_colors': colors}


def _counting(monkeypatch):
    steps = []
    inner = dops.decode_step

    def counted(step, *args):
        steps.append(int(step))
        return inner(step, *args)
    monkeypatch.setattr(ocr48.decode_ops, 'decode_step', counted)
    return steps


@functools.lru_cache(maxsize=2)
def _beam_model(end_bias):
    model = ocr48.build_ocr48(40, 'cpu', ocr48.init_state_dict(40, 3))
    with torch.no_grad():
        model.pred.bias[ocr48.END_TOK] = end_bias
    return model


@pytest.mark.parametrize('max_len,end_bias', [(64, 0.0), (64, 8.0),
                                              (255, 8.0)],
                         ids=['64-runs', '64-ends', '255-ends'])
def test_run_beam_equals_the_per_step_loop(monkeypatch, max_len, end_bias):
    """The fixed-shape ``run_beam`` (device step, in-place buffers, the
    runner's blocks) on the CPU: the decoder steps, their order, the stop
    step and every output's bits equal the per-step loop's, for beams that
    run to ``max_len`` and for a batch whose END logit is biased so that
    it finishes within a few steps (a cache of 255 positions; the runner's
    own test covers 255 steps run to the end)."""
    model = _beam_model(end_bias)
    rs = np.random.RandomState(5)
    memory = torch.from_numpy(rs.randn(2, 9, 320).astype(np.float32))
    mask = torch.from_numpy(np.arange(9)[None, :]
                            >= np.array([9, 6])[:, None])
    steps = _counting(monkeypatch)
    ref = _run_beam_per_step(model, memory, mask, 2, max_len, 2)
    ref_steps = list(steps)
    steps.clear()
    got = ocr48.run_beam(model, memory, mask, 2, max_len, 2)
    assert steps == ref_steps
    if end_bias:
        assert len(steps) < 12, len(steps)     # the batch finished early
    else:
        assert len(steps) == max_len
    for key in ('best_seq', 'best_logprob', 'best_colors'):
        assert torch.equal(got[key], ref[key]), key


def _jax_decode_from_memory(params, memory, mask, k, max_len):
    """The JAX decode on its XLA path, traced afresh (the kernel switches
    are read at trace time; see test_torch_port_beam._jax_beam)."""
    env = {'MIT_TPU_OCR_PALLAS': '0', 'MIT_TPU_MESH': '0'}
    old = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        fn = jax.jit(lambda p, m, mm: jax_ocr48.beam_decode_from_memory
                     .__wrapped__(p, m, mm, beams_k=k, max_len=max_len,
                                  max_finished_hypos=2))
        out = fn(params, jnp.asarray(memory), jnp.asarray(mask))
        return {key: np.asarray(v) for key, v in out.items()}
    finally:
        for key, v in old.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v


def test_run_beam_matches_jax_run_beam():
    """The fixed-shape beam search against the JAX package's ``run_beam``
    (``while_loop``) on the same seeded weights and memory, through both
    packages' ``beam_decode_from_memory`` (n=2, k=2, max_len=12, f32):
    sequences equal, probabilities within rtol 2e-2 / atol 1e-3 and the
    colour heads within rtol 5e-2 / atol 2e-2 (test_torch_port_beam's
    tolerances)."""
    params = jax_ocr48.init_params(dict_size=48)
    sd = torch_state_dict_from_jax(
        {key: np.array(v) for key, v in params.items()},
        embedding_patterns=ocr48.EMBEDDING_PATTERNS)
    model = ocr48.build_ocr48(48, 'cpu', sd)
    rs = np.random.RandomState(7)
    memory = rs.randn(2, 10, 320).astype(np.float32)
    mask = np.arange(10)[None, :] >= np.array([10, 7])[:, None]
    ref = _jax_decode_from_memory(params, memory, mask, 2, 12)
    got = ocr48.beam_decode_from_memory(model, torch.from_numpy(memory),
                                        torch.from_numpy(mask), beams_k=2,
                                        max_len=12)
    np.testing.assert_array_equal(ref['sequences'], got['sequences'].numpy())
    np.testing.assert_allclose(ref['probs'], got['probs'].numpy(),
                               rtol=2e-2, atol=1e-3)
    for key in ('fg', 'bg'):
        np.testing.assert_allclose(ref[key], got[key].numpy(), rtol=5e-2,
                                   atol=2e-2)


# -- Sugoi's beam search -------------------------------------------------------

MAX_LEN = 40        # the search of test_ct2's model ends within 32 steps


@pytest.fixture(scope='module')
def ct2_pair(tmp_path_factory):
    """The JAX and port transformers on test_ct2's synthetic model, and the
    JAX package's ``_beam_decode`` (through ``translate_batch``, beam 5,
    ``MAX_LEN`` steps) with and without forced prefixes."""
    path = tmp_path_factory.mktemp('ct2_loop')
    build_ct2_model(path)
    _, _, mj, mt = _models(path)
    refs = {prefix: mj.translate_batch(
        BATCH, beam_size=5, max_len=MAX_LEN,
        target_prefix=PREFIX if prefix else None)
        for prefix in (False, True)}
    return mt, refs


@pytest.mark.parametrize('prefix', [False, True], ids=['sugoi', 'forced'])
@pytest.mark.parametrize('block,buckets', [(8, (16, 24)), (4, (8, 16, 24)),
                                           (8, (8, 16, 64))])
def test_beam_search_matches_jax_across_bucket_edges(ct2_pair, monkeypatch,
                                                     prefix, block, buckets):
    """The fixed-shape ``BeamSearch`` against the JAX ``_beam_decode`` on
    the same synthetic model (beam 5, ``MAX_LEN`` steps, forced prefixes in
    the m2m100 style or none): equal token sequences, whatever the block
    and the prefix buckets, so across every bucket edge; and the search
    used the buckets it was given, up to ``max_len + 1``."""
    mt, refs = ct2_pair
    monkeypatch.setattr(ct2_model.BeamSearch, 'BLOCK', block)
    monkeypatch.setattr(ct2_model.BeamSearch, 'BUCKETS', buckets)
    prefixes = []
    inner = ct2_model.BeamSearch._body

    def body(self, prefix_len):
        prefixes.append(prefix_len)
        return inner(self, prefix_len)
    monkeypatch.setattr(ct2_model.BeamSearch, '_body', body)
    got = mt.translate_batch(BATCH, beam_size=5, max_len=MAX_LEN,
                             target_prefix=PREFIX if prefix else None)
    assert got == refs[prefix]
    ends = [min(MAX_LEN, (t // block + 1) * block)
            for t in range(mt.last_steps)]
    assert prefixes == [next((p for p in buckets if e <= p <= MAX_LEN),
                             MAX_LEN + 1) for e in ends]
    assert len(set(prefixes)) > 1               # an edge was crossed
    if prefix:
        assert [row[:len(p)] for row, p in zip(got, PREFIX)] == PREFIX


def test_beam_search_steps_after_the_end_change_nothing(ct2_pair):
    """Once every beam is done, further steps (the rest of a block) leave
    tokens, scores, lengths and done flags as they were, also while the
    forced prefix would still be on (a prefix that forces EOS first)."""
    mt, _ = ct2_pair
    args = mt.prepare(BATCH, [[mt.tgt_vocab[mt.eos_id], '▁w3']] * 3)
    with torch.inference_mode():
        search = ct2_model.BeamSearch(mt, *args, max_len=12, beam_size=1)
        search.run(stop=1)               # forces EOS: every beam is done
        assert search.t == 1 and bool(search.done.all())
        before = [x.clone() for x in (search.toks, search.scores,
                                      search.out_len, search.done)]
        search.run(stop=4)               # no flag read inside a block
        assert search.t == 4
        after = (search.toks, search.scores, search.out_len, search.done)
        for a, b in zip(before, after):
            assert torch.equal(a, b)


# -- the first-tier decode length ------------------------------------------------

def _fresh_module(name):
    """A new copy of module ``name`` (not registered in sys.modules), so
    that its import-time settings are read again."""
    spec = importlib.util.find_spec(name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('fast_len,passes', [('255', 1), (None, 2)])
def test_fast_len_variable_is_read_by_both_packages(monkeypatch, fast_len,
                                                    passes):
    """``MIT_TPU_OCR_FAST_LEN`` sets the first tier of both packages'
    two-tier 48px decode: at 255 (= the maximum) there is a single pass in
    both, at the default 64 a second one for rows that never ended."""
    monkeypatch.setenv('MIT_TPU_OCR_MAX_LEN', '255')
    if fast_len is None:
        monkeypatch.delenv('MIT_TPU_OCR_FAST_LEN', raising=False)
    else:
        monkeypatch.setenv('MIT_TPU_OCR_FAST_LEN', fast_len)
    port = _fresh_module('manga_image_translator_tpu_torch.ocr.model_48px')
    ref = _fresh_module('manga_image_translator_tpu.ocr.model_48px')
    expect = int(fast_len or 64)
    assert port.FAST_SEQ_LEN == ref.FAST_SEQ_LEN == expect

    def unfinished(n, max_len, log):
        log.append(max_len)
        return {'sequences': np.full((n, max_len), 5, np.int32),
                'probs': np.ones((n,), np.float32)}

    port_lens = []
    ocr = object.__new__(port.Model48pxOCR)
    ocr.logger = logging.getLogger('test')
    ocr._decode = lambda mem, mask, max_len: {
        key: torch.from_numpy(v) for key, v in
        unfinished(mem.shape[0], max_len, port_lens).items()}
    ocr._two_tier_decode((torch.zeros((2, 4, 320)),
                          torch.zeros((2, 4), dtype=torch.bool)))

    ref_lens = []

    class Stub:
        @staticmethod
        def sharded_beam_decode(params, images, widths, beams_k, max_len):
            return unfinished(images.shape[0], max_len, ref_lens)
        END_TOK = jax_ocr48.END_TOK
    monkeypatch.setattr(ref, 'ocr48', Stub)
    jocr = object.__new__(ref.Model48pxOCR)
    jocr.params = None
    jocr.logger = logging.getLogger('test')
    jocr._two_tier_decode(np.zeros((2, 48, 64, 3), np.float32),
                          np.full((2,), 64, np.int32))
    assert port_lens == ref_lens == [expect, 255][:passes]
