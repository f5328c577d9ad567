"""PyTorch port: the ct2 translators behind the default ``sugoi`` (the
``model.bin`` reader, the spm reader, the transformer, its beam search,
the sugoi / m2m100 translator classes, dispatch) and the translator
registry, against the JAX package on the same synthetic files.

The files are ``tests/test_ct2.py``'s: a v6 ``model.bin`` at d=32, 2 heads,
2 layers, vocab 23 (f32, or with the projection in int8), and a unigram spm
model; plus variants with separate ``.txt`` vocabularies and a
``'</s>'`` decoder start, and a pre-norm model with final layer norms.
Tolerances: the reader is exact; encoder states and teacher-forced decoder
log-probs within 1e-4 of max |value|; token sequences and strings equal.
"""
import asyncio
import json
import logging
import shutil
import struct
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu import config as jax_config
from manga_image_translator_tpu import translators as jax_translators
from manga_image_translator_tpu.translators import chatgpt as jax_chatgpt
from manga_image_translator_tpu.translators import ct2_model as jax_ct2
from manga_image_translator_tpu.translators import ct2_offline as jax_ct2_offline
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.utils import spm_lite as jax_spm

from manga_image_translator_tpu_torch import config
from manga_image_translator_tpu_torch import translators
from manga_image_translator_tpu_torch.device import CudaUnavailableError
from manga_image_translator_tpu_torch.translators import chatgpt
from manga_image_translator_tpu_torch.translators import ct2_model
from manga_image_translator_tpu_torch.translators import ct2_offline
from manga_image_translator_tpu_torch.translators import selective
from manga_image_translator_tpu_torch.translators.common import (
    CommonTranslator, MissingAPIKeyException)
from manga_image_translator_tpu_torch.utils import inference, spm_lite

from test_ct2 import _wstr, build_ct2_model, build_spm_model

torch.set_num_threads(2)

WORDS = [f'w{i}' for i in range(20)]        # the spm words of the vocab
BATCH = [['▁w0', '▁w1', '▁w5'], ['▁w2'], ['▁w3', '▁w3', '▁w9', '▁w4']]
PREFIX = [['▁w7'], ['▁w9', '▁w2'], []]


def _write_ct2(path, variables):
    """A v6 ``model.bin`` of f32 ``variables`` (the layout of
    ``build_ct2_model``)."""
    blob = struct.pack('<I', 6) + _wstr('TransformerSpec')
    blob += struct.pack('<I', 7) + struct.pack('<I', len(variables))
    for name, arr in variables.items():
        blob += _wstr(name) + struct.pack('<B', arr.ndim)
        blob += struct.pack(f'<{arr.ndim}I', *arr.shape)
        blob += _wstr('float32') + struct.pack('<I', arr.nbytes)
        blob += arr.astype(np.float32).tobytes()
    (path / 'model.bin').write_bytes(blob + struct.pack('<I', 0))


def _build(kind, path):
    """The synthetic model directory of one variant."""
    if kind == 'int8':
        build_ct2_model(path, quantize_one=True)
        return
    variables = build_ct2_model(path)
    if kind == 'txt_vocab':
        # separate source / target vocabularies, decoding from '</s>'
        (path / 'shared_vocabulary.json').unlink()
        src = ['<unk>', '<s>', '</s>'] + [f'▁w{i}' for i in range(20)]
        tgt = ['<unk>', '<s>', '</s>'] + [f'▁t{i}' for i in range(20)]
        (path / 'source_vocabulary.txt').write_text('\n'.join(src) + '\n')
        (path / 'target_vocabulary.txt').write_text('\n'.join(tgt) + '\n')
        (path / 'config.json').write_text(json.dumps(
            {'num_heads': 2, 'decoder_start_token': '</s>'}))
    elif kind == 'prenorm':
        rs = np.random.RandomState(1)
        for name in list(variables):
            if name.endswith('/gamma'):
                variables[name] = (1 + 0.2 * rs.randn(32)).astype(np.float32)
            elif name.endswith('/beta'):
                variables[name] = (0.1 * rs.randn(32)).astype(np.float32)
        for side in ('encoder', 'decoder'):
            variables[f'{side}/layer_norm/gamma'] = (
                1 + 0.2 * rs.randn(32)).astype(np.float32)
            variables[f'{side}/layer_norm/beta'] = (
                0.1 * rs.randn(32)).astype(np.float32)
        _write_ct2(path, variables)


def _models(path):
    vj = jax_ct2.read_ct2_model(str(path / 'model.bin'))
    vt = ct2_model.read_ct2_model(str(path / 'model.bin'))
    cfg = jax_ct2.read_config(str(path))
    src, tgt = jax_ct2.load_vocabulary(str(path))
    assert (src, tgt) == ct2_model.load_vocabulary(str(path))
    assert cfg == ct2_model.read_config(str(path))
    return (vj, vt, jax_ct2.Ct2Transformer(vj, cfg, src, tgt),
            ct2_model.Ct2Transformer(vt, cfg, src, tgt, device='cpu'))


@pytest.fixture(scope='module')
def variant(tmp_path_factory):
    cache = {}

    def get(kind):
        if kind not in cache:
            path = tmp_path_factory.mktemp(kind)
            _build(kind, path)
            cache[kind] = (path, *_models(path))
        return cache[kind]
    return get


def _close(ref, got, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert ref.shape == got.shape
    err = float(np.abs(ref - got).max())
    assert err <= rel * float(np.abs(ref).max()), (err, np.abs(ref).max())


# -- readers -----------------------------------------------------------------

def test_spm_lite_matches_jax(tmp_path):
    p = tmp_path / 'spm.model'
    build_spm_model(p, ['hello', 'world', 'test'] + WORDS)
    sj = jax_spm.SentencePieceModel.load(str(p))
    st = spm_lite.SentencePieceModel.load(str(p))
    assert st.pieces == sj.pieces and st.unk_id == sj.unk_id
    for text in ('hello world', 'held  test', 'w1 w12 w3@ w4', 'ｈｅｌｌｏ　x',
                 'こんにちは w0', ''):
        pieces = st.encode(text, out_type=str)
        assert pieces == sj.encode(text, out_type=str)
        assert st.encode(text, out_type=int) == sj.encode(text, out_type=int)
        assert st.decode(pieces) == sj.decode(pieces)


@pytest.mark.parametrize('kind', ['f32', 'int8'])
def test_read_ct2_model_matches_jax(variant, kind):
    _, vj, vt, _, _ = variant(kind)
    assert list(vt) == list(vj)
    for name in vj:
        assert vt[name].dtype == vj[name].dtype == np.float32, name
        np.testing.assert_array_equal(vt[name], vj[name], err_msg=name)


# -- the transformer ---------------------------------------------------------

def _jax_teacher_forced(m, tokens, lengths, tgt):
    """Encoder states and the decoder's log-probs at every position of the
    target inputs ``tgt`` (B, T), from the JAX model's own pieces with a
    causal mask: what its beam search computes one step at a time."""
    memory, pad = m.encode(jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(lengths, jnp.int32))
    t_len = tgt.shape[1]
    emb = m.params[m._emb_key('decoder')]
    x = emb[jnp.asarray(tgt)] * jnp.sqrt(jnp.float32(m.d_model))
    x = x + jnp.asarray(m._sinusoid(t_len))
    causal = (jnp.arange(t_len)[None, :] > jnp.arange(t_len)[:, None])
    mask_mem = pad[:, None, None, :]

    def sub(prefix, x, fn):
        if m.pre_norm:
            return x + fn(m._ln(f'{prefix}/layer_norm', x))
        return m._ln(f'{prefix}/layer_norm', x + fn(x))

    for i in range(m.n_dec):
        pre = f'decoder/layer_{i}'

        def self_att(xi):
            q, k, v = jnp.split(m._linear(f'{pre}/self_attention/linear_0',
                                          xi), 3, axis=-1)
            a = m._attention(q, k, v, causal[None, None], m.num_heads)
            return m._linear(f'{pre}/self_attention/linear_1', a)

        def cross_att(xi):
            q = m._linear(f'{pre}/attention/linear_0', xi)
            k, v = jnp.split(m._linear(f'{pre}/attention/linear_1', memory),
                             2, axis=-1)
            a = m._attention(q, k, v, mask_mem, m.num_heads)
            return m._linear(f'{pre}/attention/linear_2', a)

        def ffn(xi):
            h = jax.nn.relu(m._linear(f'{pre}/ffn/linear_0', xi))
            return m._linear(f'{pre}/ffn/linear_1', h)

        x = sub(f'{pre}/self_attention', x, self_att)
        x = sub(f'{pre}/attention', x, cross_att)
        x = sub(f'{pre}/ffn', x, ffn)
    if m.pre_norm and 'decoder/layer_norm/gamma' in m.params:
        x = m._ln('decoder/layer_norm', x)
    logits = m._linear('decoder/projection', x)
    return np.asarray(memory), np.asarray(jax.nn.log_softmax(logits, -1))


@pytest.mark.parametrize('kind', ['f32', 'int8', 'txt_vocab', 'prenorm'])
def test_encoder_and_decoder_steps_match_jax(variant, kind):
    """Encoder states, and the port's decoder run one cached step at a time
    (``BeamSearch.forward``) against the JAX pieces teacher-forced."""
    _, _, _, mj, mt = variant(kind)
    tokens, lengths, _, _ = mt.prepare(BATCH)
    rs = np.random.RandomState(5)
    tgt = np.concatenate([np.full((3, 1), mt.start_id),
                          rs.randint(3, 23, (3, 6))], axis=1)
    mem_j, logp_j = _jax_teacher_forced(mj, tokens, lengths, tgt)
    with torch.inference_mode():
        mem_t, pad = mt.encode(torch.from_numpy(tokens),
                               torch.from_numpy(lengths))
        _close(mem_j, mem_t.numpy())
        search = ct2_model.BeamSearch(mt, *mt.prepare(BATCH), max_len=8,
                                      beam_size=1)
        for t in range(tgt.shape[1]):
            logits = search.forward(torch.from_numpy(tgt[:, t]), t)
            _close(logp_j[:, t], torch.log_softmax(logits, -1).numpy())


@pytest.mark.parametrize('kind,beam,prefix,penalty', [
    ('f32', 1, False, 3.0), ('f32', 3, False, 3.0), ('f32', 5, False, 3.0),
    ('f32', 5, False, 1.0), ('int8', 5, False, 3.0),
    ('txt_vocab', 3, True, 3.0), ('prenorm', 5, False, 3.0),
    ('prenorm', 1, True, 3.0)])
def test_translate_batch_matches_jax(variant, kind, beam, prefix, penalty):
    """Equal token sequences at beam 1/3/5, with forced target prefixes
    (ties at -1e9 in every forced row), a '</s>' decoder start, the
    pre-norm variant, and without the repetition penalty."""
    _, _, _, mj, mt = variant(kind)
    pre = PREFIX if prefix else None
    if kind == 'txt_vocab':
        pre = [[p.replace('▁w', '▁t') for p in row] for row in PREFIX]
    kw = dict(beam_size=beam, max_len=10, repetition_penalty=penalty,
              target_prefix=pre)
    got = mt.translate_batch(BATCH, **kw)
    assert got == mj.translate_batch(BATCH, **kw)
    assert mt.last_steps == 10      # random weights: no beam ends early
    if prefix:
        assert [row[:len(p)] for row, p in zip(got, pre)] == pre
    if penalty == 1.0:              # the penalty changes this search
        assert got != mt.translate_batch(BATCH, **dict(
            kw, repetition_penalty=3.0))


@pytest.mark.parametrize('shape,ties', [((4, 15), 'neg'), ((3, 40), 'mixed')])
def test_top_k_breaks_ties_like_lax(shape, ties):
    rs = np.random.RandomState(2)
    x = rs.randint(-3, 3, shape).astype(np.float32)
    if ties == 'neg':
        x = np.where(x > 0, np.float32(-1e9), x)
    x[:, 1] = -0.0 if ties == 'mixed' else x[:, 1]
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 7)
    got_v, got_i = ct2_model.top_k_lower_index_first(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(np.asarray(ref_i), got_i.numpy())
    np.testing.assert_array_equal(np.asarray(ref_v), got_v.numpy())


def test_model_runs_on_the_card_unless_cpu_is_asked(variant):
    path, _, vt, _, _ = variant('f32')
    src, tgt = ct2_model.load_vocabulary(str(path))
    if torch.cuda.is_available():
        model = ct2_model.Ct2Transformer(vt, {}, src, tgt)
        assert model._buffers['decoder/projection/weight'].is_cuda
    else:
        with pytest.raises(CudaUnavailableError):
            ct2_model.Ct2Transformer(vt, {}, src, tgt)


# -- the translator classes ----------------------------------------------------

@pytest.fixture(scope='module')
def model_root(tmp_path_factory):
    """The tiny model and spm files in the released archives' unpacked
    layout (every path of sugoi's two archives, and m2m100_418m)."""
    root = tmp_path_factory.mktemp('models')
    base = root / 'translators'
    ct2 = tmp_path_factory.mktemp('ct2')
    build_ct2_model(ct2)
    spm = tmp_path_factory.mktemp('spm') / 'spm.model'
    build_spm_model(spm, WORDS)
    for d in ('sugoi/big-ja-en', 'jparacrawl/big-ja-en',
              'jparacrawl/big-en-ja'):
        shutil.copytree(ct2, base / d)
    for d in ('sugoi', 'jparacrawl'):
        for lang in ('ja', 'en'):
            shutil.copy(spm, base / d / f'spm.{lang}.nopretok.model')
    m2m = base / 'm2m100_418m'
    shutil.copytree(ct2, m2m)
    vocab = json.loads((ct2 / 'shared_vocabulary.json').read_text())
    vocab[-2:] = ['__ja__', '__en__']
    (m2m / 'shared_vocabulary.json').write_text(json.dumps(vocab))
    (m2m / 'config.json').write_text(json.dumps(
        {'num_heads': 2, 'decoder_start_token': '</s>'}))
    shutil.copy(spm, m2m / 'sentencepiece.model')
    return root


@pytest.fixture
def both_dirs(model_root, monkeypatch):
    """Both packages read ``model_root``; neither may fetch anything."""
    monkeypatch.setattr(jax_inference, 'MODULE_DIR', model_root)
    monkeypatch.setattr(inference, 'MODULE_DIR', model_root)

    def offline(*a, **k):
        raise jax_inference.ModelDownloadError('offline test')
    monkeypatch.setattr(jax_inference.ModelWrapper, '_download_file',
                        offline)
    monkeypatch.setattr(jax_translators, 'translator_cache', {})
    monkeypatch.setattr(translators, 'translator_cache', {})


QUERIES = ['w1 w2. w3 w4! w5 w6? w7 w8. w9 w10。w11', 'w12 w0 w0 w0',
           'w13. w14']


async def _translate(t, from_lang, device=None):
    if device is None:
        await t.load(from_lang, 'ENG')
    else:
        await t.load(from_lang, 'ENG', device)
    return await t.translate(from_lang, 'ENG', QUERIES)


def test_sugoi_translator_matches_jax(both_dirs):
    tj = jax_ct2_offline.SugoiTranslator()
    tt = ct2_offline.SugoiTranslator()
    got = asyncio.run(_translate(tt, 'JPN', 'cpu'))
    assert got == asyncio.run(_translate(tj, 'JPN'))
    assert sum(tt.query_split_sizes) > len(QUERIES)      # chunked
    assert tt.model.device.type == 'cpu' and all(got)


def test_m2m100_translator_matches_jax(both_dirs):
    tj = jax_ct2_offline.M2M100Translator()
    tt = ct2_offline.M2M100Translator()
    got = asyncio.run(_translate(tt, 'JPN', 'cpu'))
    assert got == asyncio.run(_translate(tj, 'JPN'))
    assert all(got)


def test_default_chain_dispatch_matches_jax(both_dirs):
    """The default Config's translator (sugoi) through both registries'
    ``dispatch``."""
    chain = config.Config().translator.translator_gen
    assert chain.translators == [config.Translator.sugoi]
    queries = ['w3 w1 w4. w1 w5', 'w9 w2 w6']
    got = asyncio.run(translators.dispatch(chain, queries, device='cpu'))
    ref = asyncio.run(jax_translators.dispatch(
        jax_config.Config().translator.translator_gen, queries))
    assert got == ref and all(got)


def test_missing_ct2_files_name_the_path(tmp_path, monkeypatch):
    """No random-weight fallback for ct2 models, even when the switch
    allows it for the other stages."""
    monkeypatch.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')
    monkeypatch.setattr(inference, 'MODULE_DIR', tmp_path)
    for cls, missing in ((ct2_offline.SugoiTranslator,
                          'sugoi/big-ja-en/model.bin'),
                         (ct2_offline.M2M100Translator,
                          'm2m100_418m/model.bin')):
        with pytest.raises(inference.MissingWeightsError, match=missing):
            asyncio.run(_translate(cls(), 'JPN', 'cpu'))


def test_selective_passes_the_callers_device(monkeypatch):
    loads = []

    class Fake(CommonTranslator):
        _LANGUAGE_CODE_MAP = {'JPN': 'ja', 'ENG': 'en'}

        async def load(self, from_lang, to_lang, device):
            loads.append(device)

        async def _translate(self, from_lang, to_lang, queries):
            return [q.upper() for q in queries]

    monkeypatch.setattr(selective, '_get_translator', lambda key: Fake())
    t = selective.SelectiveOfflineTranslator()
    asyncio.run(t.load('auto', 'ENG', 'cpu'))
    out = asyncio.run(t.translate('JPN', 'ENG', ['abc def']))
    assert out == ['ABC DEF'] and loads == ['cpu']


def test_hf_translators_import_transformers_only_to_load(monkeypatch):
    """A machine without ``transformers`` builds the HF translators and
    fails only when one loads, with an ImportError that names it."""
    from manga_image_translator_tpu_torch.translators import hf_offline
    monkeypatch.setitem(sys.modules, 'transformers', None)
    for cls in (hf_offline.NLLBTranslator, hf_offline.Qwen2Translator):
        t = cls()
        with pytest.raises(ImportError, match='transformers'):
            asyncio.run(t.load('auto', 'ENG', 'cpu'))


# -- the registry ----------------------------------------------------------------

def test_every_enum_value_registered():
    assert not hasattr(translators, '_not_ported')
    for t in config.Translator:
        assert t in translators.TRANSLATORS, f'{t} missing from registry'
        factory = translators.TRANSLATORS[t]
        assert factory.__name__ == jax_translators.TRANSLATORS[
            jax_config.Translator(t.value)].__name__


def test_instantiate_all_translators(monkeypatch):
    monkeypatch.setattr(translators, 'translator_cache', {})
    for key in translators.TRANSLATORS:
        try:
            translator = translators.get_translator(key)
            assert isinstance(translator, CommonTranslator)
        except MissingAPIKeyException:
            pass  # keyless CI


def test_chatgpt_prompt_matches_jax(monkeypatch):
    """The chat messages both packages send for one batch, with the request
    replaced (as tests/test_translators.py does)."""
    def run(cg):
        t = cg.OpenAITranslator.__new__(cg.OpenAITranslator)
        t.logger = logging.getLogger('test')
        t.api_key = 'k'
        t.model = 'primary'
        t.fallback_model = None
        t.chat_system_template = cg._CHAT_SYSTEM_TEMPLATE
        t.glossary_path = None
        t._glossary = {}
        t._glossary_is_regex = False
        t.prev_context = 'earlier page'
        t.chat_sample = {'English': ['<|1|>こんにちは', '<|1|>Hello']}
        sent = []

        async def fake_request(messages, model=None):
            sent.append(messages)
            return '<|1|>Hello\n<|2|>World'

        monkeypatch.setattr(t, '_request', fake_request)
        out = asyncio.run(t._translate('JPN', 'ENG', ['こんにちは', '世界']))
        return out, sent

    out, sent = run(chatgpt)
    assert (out, sent) == run(jax_chatgpt)
    assert out == ['Hello', 'World']
    assert [m['role'] for m in sent[0]][:2] == ['system', 'user']
