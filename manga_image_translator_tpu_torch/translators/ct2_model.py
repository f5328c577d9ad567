"""CTranslate2 model reader + PyTorch transformer seq2seq.

The reference's sugoi/jparacrawl/m2m100 translators run released
CTranslate2 model directories through the native ctranslate2 library
(translators/sugoi.py:60-113). The port reads the same directories itself:

* ``read_ct2_model``, ``load_vocabulary``, ``read_config``: numpy-only
  copies of the JAX package's reader. ``model.bin`` (binary versions 1-6:
  u32 version, null-terminated length-prefixed strings, per-variable
  name/rank/dims/dtype/payload, alias table) becomes ``{ct2 variable name:
  np.ndarray}``; int8/int16 variables are dequantised to f32 with their
  ``*_scale`` companions. Every parse step is validated and failures raise.
* ``Ct2Transformer``: the fairseq-style transformer as ct2-fairseq-converter
  writes it (post-layer-norm unless the spec carries final norms,
  sinusoidal positions, fused QKV self-attention, fused-KV cross-attention)
  as an ``nn.Module`` whose buffers are those variables on one device, all
  f32.
* ``BeamSearch``: the JAX package's fixed-shape beam search
  (``translators/ct2_model.py:368``), step for step, with per-layer K/V
  caches; its loop runs on the device as the JAX ``while_loop`` does
  (``ops.device_loop``: CUDA graphs on the card).

Vocabularies load from the model dir's ``*vocabulary.txt`` / ``.json``.
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_named
from ..ops.device_loop import DeviceLoop
from ..utils.profiling import span, to_host

_DTYPES = {
    'float32': (np.float32, 4), 'float': (np.float32, 4),
    'float16': (np.float16, 2), 'bfloat16': (np.uint16, 2),
    'int8': (np.int8, 1), 'int16': (np.int16, 2), 'int32': (np.int32, 4),
}


class Ct2FormatError(RuntimeError):
    pass


def _read_string(buf: memoryview, pos: int) -> Tuple[str, int]:
    (ln,) = struct.unpack_from('<H', buf, pos)
    pos += 2
    raw = bytes(buf[pos:pos + ln])
    pos += ln
    if not raw.endswith(b'\0'):
        raise Ct2FormatError(f'string at {pos - ln} not null-terminated')
    return raw[:-1].decode('utf-8'), pos


def read_ct2_model(path: str) -> Dict[str, np.ndarray]:
    """Parse model.bin -> {variable name: np.ndarray} (dequantized f32)."""
    with open(path, 'rb') as f:
        data = memoryview(f.read())
    pos = 0
    (version,) = struct.unpack_from('<I', data, pos)
    pos += 4
    if not 1 <= version <= 6:
        raise Ct2FormatError(f'unsupported binary version {version}')
    spec_name = ''
    revision = 0
    if version >= 2:
        spec_name, pos = _read_string(data, pos)
        (revision,) = struct.unpack_from('<I', data, pos)
        pos += 4
    (num_vars,) = struct.unpack_from('<I', data, pos)
    pos += 4
    if num_vars > 10000:
        raise Ct2FormatError(f'implausible variable count {num_vars}')

    variables: Dict[str, np.ndarray] = {}
    for _ in range(num_vars):
        name, pos = _read_string(data, pos)
        (rank,) = struct.unpack_from('<B', data, pos)
        pos += 1
        dims = struct.unpack_from(f'<{rank}I', data, pos)
        pos += 4 * rank
        if version >= 4:
            dtype_name, pos = _read_string(data, pos)
            if dtype_name not in _DTYPES:
                raise Ct2FormatError(f'{name}: unknown dtype {dtype_name}')
            np_dtype, item = _DTYPES[dtype_name]
            (nbytes,) = struct.unpack_from('<I', data, pos)
            pos += 4
        else:
            (item,) = struct.unpack_from('<B', data, pos)
            pos += 1
            (nbytes,) = struct.unpack_from('<I', data, pos)
            pos += 4
            np_dtype = {4: np.float32, 2: np.float16,
                        1: np.int8}.get(item)
            if np_dtype is None:
                raise Ct2FormatError(f'{name}: unknown item size {item}')
        expected = int(np.prod(dims)) * item if rank else nbytes
        if nbytes != expected:
            raise Ct2FormatError(
                f'{name}: payload {nbytes} != prod{tuple(dims)}*{item}')
        arr = np.frombuffer(data, np_dtype, count=nbytes // item,
                            offset=pos).reshape(dims)
        pos += nbytes
        variables[name] = arr

    # alias table (v2+)
    if version >= 2 and pos + 4 <= len(data):
        (num_aliases,) = struct.unpack_from('<I', data, pos)
        pos += 4
        if num_aliases <= 10000:
            try:
                for _ in range(num_aliases):
                    alias, pos = _read_string(data, pos)
                    target, pos = _read_string(data, pos)
                    if target in variables:
                        variables[alias] = variables[target]
            except (struct.error, Ct2FormatError):
                pass

    # dequantize int8/int16 weights with their *_scale companions
    out: Dict[str, np.ndarray] = {}
    for name, arr in variables.items():
        if name.endswith('_scale'):
            continue
        if arr.dtype in (np.int8, np.int16):
            scale = variables.get(name + '_scale')
            if scale is None:
                raise Ct2FormatError(f'{name}: quantized but no scale')
            arr = arr.astype(np.float32) / np.asarray(
                scale, np.float32).reshape(-1, *([1] * (arr.ndim - 1)))
        elif arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        out[name] = np.ascontiguousarray(arr)
    return out


def load_vocabulary(model_dir: str) -> Tuple[List[str], Optional[List[str]]]:
    """-> (source_vocab, target_vocab or None when shared)."""
    def read_txt(p):
        with open(p, encoding='utf-8') as f:
            return [line.rstrip('\n') for line in f]

    j = os.path.join(model_dir, 'shared_vocabulary.json')
    if os.path.isfile(j):
        return json.load(open(j, encoding='utf-8')), None
    t = os.path.join(model_dir, 'shared_vocabulary.txt')
    if os.path.isfile(t):
        return read_txt(t), None
    sj = os.path.join(model_dir, 'source_vocabulary.json')
    if os.path.isfile(sj):
        return (json.load(open(sj, encoding='utf-8')),
                json.load(open(os.path.join(model_dir,
                                            'target_vocabulary.json'),
                               encoding='utf-8')))
    st = os.path.join(model_dir, 'source_vocabulary.txt')
    if os.path.isfile(st):
        return (read_txt(st),
                read_txt(os.path.join(model_dir, 'target_vocabulary.txt')))
    raise Ct2FormatError(f'no vocabulary files in {model_dir}')


def read_config(model_dir: str) -> dict:
    p = os.path.join(model_dir, 'config.json')
    if os.path.isfile(p):
        with open(p, encoding='utf-8') as f:
            return json.load(f)
    return {}




# --------------------------------------------------------------------------
# PyTorch transformer over the ct2 TransformerSpec variable space
# --------------------------------------------------------------------------

NEG = -1e9      # the search's "impossible" score, as in the JAX package


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, D/H)."""
    b, length, d = x.shape
    return x.view(b, length, heads, d // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, Dh) -> (B, L, H*Dh)."""
    b, h, length, hd = x.shape
    return x.transpose(1, 2).reshape(b, length, h * hd)


def _attention(q, k, v, mask):
    """Softmax attention over heads: q (B, H, Lq, Dh), k/v (B, H, Lk, Dh);
    ``mask`` (broadcast to (B, H, Lq, Lk)) is True where a key is hidden."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        s = s.masked_fill(mask, float('-inf'))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def top_k_lower_index_first(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis of f32 ``x``: the ``k`` largest
    values in descending order, the lower index first among equal values.

    ``torch.topk`` promises no order among ties, and the beam search meets
    exact ties every step (-1e9 rows and scores). So each value is mapped to
    an int64 key that orders as (value, -index): the f32 bits made monotone
    in the value (negative floats have their magnitude bits flipped) in the
    high word, ``n - 1 - index`` in the low word. The keys are distinct, so
    their top-k is unique."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    low = n - 1 - torch.arange(n, device=x.device, dtype=torch.int64)
    _, idx = torch.topk((key << 32) | low, k, dim=-1)
    return x.gather(-1, idx), idx


class Ct2Transformer(nn.Module):
    """Encoder-decoder transformer running the ct2 variable dict in PyTorch.

    Naming (ct2 TransformerSpec): ``encoder/layer_<i>/self_attention/
    {linear_0,linear_1}`` (fused QKV in linear_0), ``.../ffn/{linear_0,
    linear_1}``, per-sublayer ``layer_norm/{gamma,beta}``; decoder adds
    ``attention/{linear_0,linear_1,linear_2}`` (Q, fused KV, out) and
    ``projection``. Embeddings: ``encoder/embeddings/weight`` (or
    ``embeddings_0``), ``decoder/embeddings/weight``.

    ``variables`` is what ``read_ct2_model`` returns; each becomes a buffer
    of that name on ``device`` (the card unless ``'cpu'`` is asked for).
    """

    def __init__(self, variables: Dict[str, np.ndarray], config: dict,
                 src_vocab: List[str], tgt_vocab: Optional[List[str]],
                 device=None):
        super().__init__()
        self.device = device_named(device)
        self.cfg = config
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab if tgt_vocab is not None else src_vocab
        self.src_index = {p: i for i, p in enumerate(src_vocab)}
        self.tgt_index = {p: i for i, p in enumerate(self.tgt_vocab)}
        self.unk_id = self.src_index.get('<unk>', 0)
        self.bos_id = self.tgt_index.get('<s>', 1)
        self.eos_id = self.tgt_index.get('</s>', 2)
        # ct2 config may override the decoder start token (m2m100 starts
        # from '</s>', fairseq-converted models from '<s>')
        start_tok = config.get('decoder_start_token')
        self.start_id = (self.tgt_index.get(start_tok, self.bos_id)
                         if start_tok else self.bos_id)

        names = list(variables)
        self.n_enc = 1 + max((int(m.group(1)) for n in names
                              for m in [re.match(r'encoder/layer_(\d+)/',
                                                 n)] if m), default=-1)
        self.n_dec = 1 + max((int(m.group(1)) for n in names
                              for m in [re.match(r'decoder/layer_(\d+)/',
                                                 n)] if m), default=-1)
        if self.n_enc == 0 or self.n_dec == 0:
            raise Ct2FormatError(
                f'no encoder/decoder layers among {names[:8]}...')
        for name, arr in variables.items():
            self.register_buffer(name, torch.tensor(arr, device=self.device))
        self.d_model = self._emb('encoder').shape[1]
        self.num_heads = int(config.get('num_heads')
                             or {512: 8, 1024: 16}.get(self.d_model, 8))
        self.pre_norm = bool(config.get('pre_norm', False)) or \
            'encoder/layer_norm/gamma' in variables
        # f32 sqrt(d), rounded as the JAX package rounds it
        self._emb_scale = float(np.sqrt(np.float32(self.d_model)))
        self.last_steps = 0         # decoder steps of the last search

    def _emb(self, side: str) -> torch.Tensor:
        for key in (f'{side}/embeddings/weight',
                    f'{side}/embeddings_0/weight', 'embeddings/weight'):
            if key in self._buffers:
                return self._buffers[key]
        raise Ct2FormatError(f'no {side} embeddings found')

    # ---- functional pieces -------------------------------------------------
    def _ln(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self._buffers[f'{prefix}/gamma'],
                            self._buffers[f'{prefix}/beta'], eps=1e-5)

    def _linear(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        # ct2 stores (out, in)
        return F.linear(x, self._buffers[f'{prefix}/weight'],
                        self._buffers.get(f'{prefix}/bias'))

    def _sinusoid(self, length: int) -> torch.Tensor:
        d = self.d_model
        pos = np.arange(length, dtype=np.float32)[:, None]
        half = d // 2
        inv = np.power(10000.0, -np.arange(half, dtype=np.float32) / half)
        ang = pos * inv[None]
        # ct2/fairseq layout: [sin | cos] concatenated
        return torch.from_numpy(np.concatenate(
            [np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)).to(
                self.device)

    def _embed(self, side: str, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self._emb(side)) * self._emb_scale

    def _sublayer(self, prefix: str, x, fn):
        """Residual sublayer, pre- or post-norm."""
        if self.pre_norm:
            return x + fn(self._ln(f'{prefix}/layer_norm', x))
        return self._ln(f'{prefix}/layer_norm', x + fn(x))

    def _ffn(self, prefix: str, x):
        return self._linear(f'{prefix}/linear_1',
                            F.relu(self._linear(f'{prefix}/linear_0', x)))

    def encode(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """tokens (B, L) int64 -> (encoder states (B, L, D), pad (B, L))."""
        heads = self.num_heads
        x = self._embed('encoder', tokens) + self._sinusoid(tokens.shape[1])
        pad = (torch.arange(tokens.shape[1], device=self.device)[None, :]
               >= lengths[:, None])            # (B, L) True = pad
        mask = pad[:, None, None, :]

        def self_attention(pre, xi):
            q, k, v = self._linear(f'{pre}/linear_0', xi).chunk(3, dim=-1)
            a = _attention(_split_heads(q, heads), _split_heads(k, heads),
                           _split_heads(v, heads), mask)
            return self._linear(f'{pre}/linear_1', _merge_heads(a))

        for i in range(self.n_enc):
            pre = f'encoder/layer_{i}'
            x = self._sublayer(f'{pre}/self_attention', x,
                               lambda xi: self_attention(
                                   f'{pre}/self_attention', xi))
            x = self._sublayer(f'{pre}/ffn', x,
                               lambda xi: self._ffn(f'{pre}/ffn', xi))
        if self.pre_norm and 'encoder/layer_norm/gamma' in self._buffers:
            x = self._ln('encoder/layer_norm', x)
        return x, pad

    def prepare(self, batch_tokens: List[List[str]],
                target_prefix: Optional[List[List[str]]] = None):
        """Pieces -> host int64 arrays: source ids with EOS, EOS-padded
        (B, S); lengths (B,); forced target ids (B, P); their lengths
        (B,)."""
        ids = [[self.src_index.get(t, self.unk_id) for t in toks]
               + [self.eos_id] for toks in batch_tokens]
        maxlen = max(len(t) for t in ids)
        arr = np.full((len(ids), maxlen), self.eos_id, np.int64)
        lengths = np.zeros((len(ids),), np.int64)
        for i, t in enumerate(ids):
            arr[i, :len(t)] = t
            lengths[i] = len(t)
        # forced decoder prefix (per-row, padded): position 0 is the
        # decoder start token, positions 1..P are forced
        if target_prefix is not None:
            if len(target_prefix) != len(ids):
                raise ValueError('target_prefix length != batch size')
            plen = max((len(p) for p in target_prefix), default=0)
            prefix = np.zeros((len(ids), max(plen, 1)), np.int64)
            prefix_len = np.zeros((len(ids),), np.int64)
            for i, p in enumerate(target_prefix):
                for j, tok in enumerate(p):
                    prefix[i, j] = self.tgt_index.get(tok, self.unk_id)
                prefix_len[i] = len(p)
        else:
            prefix = np.zeros((len(ids), 1), np.int64)
            prefix_len = np.zeros((len(ids),), np.int64)
        return arr, lengths, prefix, prefix_len

    @torch.inference_mode()
    def translate_batch(self, batch_tokens: List[List[str]],
                        beam_size: int = 5, max_len: int = 200,
                        repetition_penalty: float = 3.0,
                        target_prefix: Optional[List[List[str]]] = None
                        ) -> List[List[str]]:
        """Beam (or greedy) translate tokenized pieces -> target pieces.

        Mirrors the reference call contract (sugoi.py:104-113:
        translate_batch(beam_size=5, repetition_penalty=3, disable_unk);
        m2m100.py:82-91 adds target_prefix=[[lang]] forcing).
        """
        if not batch_tokens:
            return []
        with span('translate.encode'):
            search = BeamSearch(self, *self.prepare(batch_tokens,
                                                    target_prefix),
                                max_len=max_len,
                                rep_penalty=repetition_penalty,
                                beam_size=beam_size)
        with span('translate.beam'):
            out_ids = to_host(search.run()).numpy()
        self.last_steps = search.t
        results = []
        for row in out_ids:
            toks = []
            for tid in row:
                if tid == self.eos_id:
                    break
                if tid == self.unk_id:
                    continue                       # disable_unk semantics
                toks.append(self.tgt_vocab[int(tid)])
            results.append(toks)
        return results


class BeamSearch:
    """The JAX package's fixed-shape beam search, one ``step`` a decoder
    step (reference semantics: ``translators/ct2_model.py:368-524``).

    K beams per sentence flattened into a (B*K) decoder batch; finished
    beams emit only EOS at logprob 0; forced target prefixes (m2m100's
    ``target_prefix=[[lang]]``, reference m2m100.py:85) override the first
    ``prefix_len`` emissions of every beam. The repetition penalty (ct2
    semantics: divide positive / multiply negative scores of previously
    GENERATED tokens) sees only positions 1..t — never the EOS/BOS prefill
    of the fixed-shape token buffer. The top-K of each step breaks ties to
    the lower (beam, token) index as ``lax.top_k`` does. The final
    hypothesis maximizes score/length (ct2 length_penalty=1).

    As the JAX package's ``while_loop``, the loop lives on the device: the
    position ``t`` is a 0-d int64 tensor, and a step is one fixed-shape
    body over buffers updated in place (tokens, scores, done flags,
    lengths, caches), which ``ops.device_loop`` replays as CUDA graphs on
    the card (eagerly on the CPU), reading the all-done flag once every
    ``BLOCK`` steps. The JAX version attends over, and reorders, all
    ``max_len + 1`` cache positions under a mask; this one over a prefix
    of ``P`` positions, the least of ``BUCKETS`` that covers the block
    (``max_len + 1`` past them), one graph per bucket: positions past
    ``t`` are masked (exact zeros after the softmax), and later ones are
    never read before they are written. A bucket's graph costs ~14 ms to
    capture at Sugoi's width on the H100, so four buckets keep a 200-step
    decode's captures near 6% of its time (buckets of 32 took 11%). Steps run after
    every beam finished, up to the end of their block, change nothing:
    each beam extends with EOS at no cost, in its own place, and the forced
    prefix is off once every beam is done (the JAX loop stops there).
    """

    BLOCK = 8                 # steps between two reads of the done flag
    BUCKETS = (32, 64, 128)   # attention / cache-reorder prefix lengths

    def __init__(self, model: Ct2Transformer, tokens: np.ndarray,
                 lengths: np.ndarray, prefix: np.ndarray,
                 prefix_len: np.ndarray, max_len: int = 200,
                 rep_penalty: float = 3.0, beam_size: int = 5):
        dev = model.device
        self.model = model
        self.max_len = max_len
        self.rep_penalty = rep_penalty
        b = tokens.shape[0]
        K = max(int(beam_size), 1)
        self.b, self.K, self.bk = b, K, b * K
        self.L = L = max_len + 1
        self.heads = heads = model.num_heads
        d = model.d_model
        self.vocab = V = model._buffers['decoder/projection/weight'].shape[0]
        self.sin = model._sinusoid(L)
        self.positions = torch.arange(L, device=dev)
        # the forced prefix as a device table, built once: row j holds 0 at
        # each sentence's j-th forced token and NEG elsewhere
        self.forced_rows = self.prefix_len = None
        if int(prefix_len.max(initial=0)) > 0:
            rows = np.full((prefix.shape[1], b, V), NEG, np.float32)
            for j in range(prefix.shape[1]):
                rows[j, np.arange(b), prefix[:, j]] = 0.0
            self.forced_rows = torch.from_numpy(rows).to(dev)
            self.prefix_len = torch.from_numpy(
                prefix_len.astype(np.int64)).to(dev)

        memory, pad = model.encode(torch.from_numpy(tokens).to(dev),
                                   torch.from_numpy(lengths).to(dev))
        # the encoder memory's K/V, one copy per sentence in (B, H, S, Dh):
        # a sentence's K beams attend to it as K query rows
        self.cross_kv = []
        for i in range(model.n_dec):
            kv = model._linear(f'decoder/layer_{i}/attention/linear_1',
                               memory)
            self.cross_kv.append(tuple(
                _split_heads(c, heads).contiguous()
                for c in kv.chunk(2, dim=-1)))
        self.mask_mem = pad[:, None, None, :]
        self.caches = [(torch.zeros((self.bk, heads, L, d // heads),
                                    device=dev),
                        torch.zeros((self.bk, heads, L, d // heads),
                                    device=dev))
                       for _ in range(model.n_dec)]
        self.toks = torch.full((b, K, L), model.eos_id, dtype=torch.int64,
                               device=dev)
        self.toks[:, :, 0] = model.start_id
        self.scores = torch.full((b, K), NEG, device=dev)
        self.scores[:, 0] = 0.0
        self.done = torch.zeros((b, K), dtype=torch.bool, device=dev)
        self.out_len = torch.zeros((b, K), dtype=torch.int64, device=dev)
        self.eos_only = torch.full((V,), NEG, device=dev)
        self.eos_only[model.eos_id] = 0.0
        self.beam_base = torch.arange(b, device=dev)[:, None] * K
        self.t = 0                                   # steps run (host)
        self.t_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self.loop = DeviceLoop(dev)

    def bucket(self, end: int) -> int:
        """The prefix length for steps before ``end``: the least of
        ``BUCKETS`` that covers positions 0..end-1, else ``L``."""
        return next((p for p in self.BUCKETS if end <= p < self.L), self.L)

    def forward(self, last: torch.Tensor, t, prefix: Optional[int] = None
                ) -> torch.Tensor:
        """One decoder step on the flattened (B*K) batch: writes position
        ``t`` (an ``int`` or a 0-d int64 tensor on the model's device) of
        every layer's cache and returns the logits (B*K, V). Self-attention
        runs over the first ``prefix`` positions (default: all), those past
        ``t`` masked."""
        m = self.model
        heads = self.heads
        if not isinstance(t, torch.Tensor):
            t = torch.full((), t, dtype=torch.int64, device=m.device)
        at = t.view(1)
        prefix = self.L if prefix is None else prefix
        hidden = (self.positions[:prefix] > t)[None, None, None, :]
        x = m._embed('decoder', last)[:, None, :] + self.sin.index_select(
            0, at)

        for i in range(m.n_dec):
            pre = f'decoder/layer_{i}'
            ck, cv = self.caches[i]

            def self_attention(xi):
                q, k_new, v_new = m._linear(
                    f'{pre}/self_attention/linear_0', xi).chunk(3, dim=-1)
                ck.index_copy_(2, at, _split_heads(k_new, heads))
                cv.index_copy_(2, at, _split_heads(v_new, heads))
                a = _attention(_split_heads(q, heads), ck[:, :, :prefix],
                               cv[:, :, :prefix], hidden)
                return m._linear(f'{pre}/self_attention/linear_1',
                                 _merge_heads(a))

            def cross_attention(xi):
                # rows (sentence, beam) -> (B, H, K, Dh)
                q = m._linear(f'{pre}/attention/linear_0', xi).view(
                    self.b, self.K, heads, -1).transpose(1, 2)
                a = _attention(q, *self.cross_kv[i], self.mask_mem)
                return m._linear(f'{pre}/attention/linear_2',
                                 _merge_heads(a).view(self.bk, 1, -1))

            x = m._sublayer(f'{pre}/self_attention', x, self_attention)
            x = m._sublayer(f'{pre}/attention', x, cross_attention)
            x = m._sublayer(f'{pre}/ffn', x,
                            lambda xi: m._ffn(f'{pre}/ffn', xi))
        if m.pre_norm and 'decoder/layer_norm/gamma' in m._buffers:
            x = m._ln('decoder/layer_norm', x)
        return m._linear('decoder/projection', x)[:, 0]

    def _body(self, prefix: int) -> None:
        """Decoder step ``t_dev`` over a prefix of ``prefix`` positions:
        extend, score and select the beams in place; no host read."""
        m = self.model
        b, K, bk, L, V = self.b, self.K, self.bk, self.L, self.vocab
        rp = self.rep_penalty
        t = self.t_dev
        flat = self.toks.view(bk, L)
        logits = self.forward(flat.gather(1, t.expand(bk, 1)).view(bk), t,
                              prefix)

        # repetition penalty over emitted positions 1..t only (the others
        # scatter into a spare column V)
        pos = self.positions[:prefix]
        emitted = (pos >= 1) & (pos <= t)
        seen = torch.zeros((bk, V + 1), dtype=torch.bool, device=m.device)
        seen.scatter_(1, torch.where(emitted, flat[:, :prefix], V), True)
        penalized = torch.where(logits > 0, logits / rp, logits * rp)
        logits = torch.where(seen[:, :V], penalized, logits)
        logits[:, m.unk_id] = NEG

        logp = F.log_softmax(logits, dim=-1).view(b, K, V)
        # finished beams only extend with EOS at zero cost
        logp = torch.where(self.done[:, :, None], self.eos_only, logp)
        if self.forced_rows is not None:
            # forced prefix emission, off once every beam is done
            forced = (t < self.prefix_len) & ~self.done.all()
            row = self.forced_rows.index_select(
                0, t.clamp(max=self.forced_rows.shape[0] - 1).view(1))[0]
            logp = torch.where(forced[:, None, None], row[:, None, :], logp)

        total = self.scores[:, :, None] + logp
        top_scores, top_idx = top_k_lower_index_first(total.view(b, K * V), K)
        beam_idx = top_idx // V
        tok_idx = top_idx % V

        self.toks.copy_(self.toks.gather(
            1, beam_idx[:, :, None].expand(b, K, L)))
        done = self.done.gather(1, beam_idx)
        out_len = self.out_len.gather(1, beam_idx)
        self.scores.copy_(top_scores)
        flat.scatter_(1, (t + 1).expand(bk, 1), tok_idx.view(bk, 1))
        self.out_len.copy_(out_len + (~done).to(torch.int64))
        self.done.copy_(done | (tok_idx == m.eos_id))

        gather = (self.beam_base + beam_idx).view(bk)
        for ck, cv in self.caches:
            ck[:, :, :prefix] = ck[:, :, :prefix].index_select(0, gather)
            cv[:, :, :prefix] = cv[:, :, :prefix].index_select(0, gather)
        t.add_(1)

    def result(self) -> torch.Tensor:
        """Best hypothesis per sentence by score / length: (B, max_len)."""
        norm = self.scores / self.out_len.clamp(min=1).to(torch.float32)
        best = norm.argmax(dim=1)
        return self.toks[torch.arange(self.b, device=self.toks.device), best,
                         1:]

    def run(self, stop: Optional[int] = None) -> torch.Tensor:
        """Steps until ``t`` reaches ``stop`` (default ``max_len``) or, at
        the end of a block, every beam is done (one host read a block),
        then the best hypotheses. A later call goes on from ``t``,
        replaying the graphs the search has captured."""
        stop = self.max_len if stop is None else min(stop, self.max_len)
        self.t = self.loop.run(self._body, self.t, stop, self.BLOCK,
                               self.done.all,
                               lambda start, end: self.bucket(end))
        return self.result()
