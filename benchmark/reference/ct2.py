"""Plain reference of the Sugoi / JParaCrawl big translator: the fairseq
``transformer_vaswani_wmt_en_de_big`` (Vaswani et al., 2017; Morishita
et al., LREC 2020) as CTranslate2 stores it: post-norm layers, scaled
embeddings plus [sin | cos] positions, fused QKV (self) and KV (cross)
projections, a biased output projection.

``read_model`` parses a version-6 ``model.bin`` and dequantises int8
matrices by their per-row scales; ``encode`` runs the encoder;
``served_logprobs`` runs the decoder teacher-forced over a served target
sequence (causal, no cache, no beam) with the search's repetition penalty
and unknown-token ban, and returns the log-probability of each served
token. Plain PyTorch in float32; every product's operands pass through
``precision.r``. Imports nothing of the program.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..precision import r

NEG = -1e9
_DTYPES = {'float32': (np.float32, 4), 'int8': (np.int8, 1),
           'int16': (np.int16, 2), 'float16': (np.float16, 2)}


def _string(buf, pos):
    (n,) = struct.unpack_from('<H', buf, pos)
    pos += 2
    return bytes(buf[pos:pos + n - 1]).decode('utf-8'), pos + n


def read_model(path: str) -> Dict[str, np.ndarray]:
    with open(path, 'rb') as f:
        buf = memoryview(f.read())
    (version,) = struct.unpack_from('<I', buf, 0)
    if version != 6:
        raise ValueError(f'{path}: model.bin version {version}, expected 6')
    _spec, pos = _string(buf, 4)
    _rev, count = struct.unpack_from('<II', buf, pos)
    pos += 8
    raw = {}
    for _ in range(count):
        name, pos = _string(buf, pos)
        (rank,) = struct.unpack_from('<B', buf, pos)
        dims = struct.unpack_from(f'<{rank}I', buf, pos + 1)
        pos += 1 + 4 * rank
        dtype, pos = _string(buf, pos)
        (nbytes,) = struct.unpack_from('<I', buf, pos)
        pos += 4
        np_dt, item = _DTYPES[dtype]
        raw[name] = np.frombuffer(buf, np_dt, nbytes // item,
                                  pos).reshape(dims)
        pos += nbytes
    out = {}
    for name, arr in raw.items():
        if name.endswith('_scale'):
            continue
        if arr.dtype == np.int8:
            arr = arr.astype(np.float32) / raw[name + '_scale'].reshape(
                -1, *([1] * (arr.ndim - 1)))
        out[name] = np.array(arr, np.float32)
    return out


class Model:
    def __init__(self, variables: Dict[str, np.ndarray], heads: int,
                 device):
        self.v = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for k, a in variables.items()}
        self.heads = heads
        self.d = self.v['encoder/embeddings/weight'].shape[1]
        self.n_enc = 1 + max(int(k.split('/')[1][6:]) for k in self.v
                             if k.startswith('encoder/layer_'))
        self.n_dec = 1 + max(int(k.split('/')[1][6:]) for k in self.v
                             if k.startswith('decoder/layer_'))
        self.device = device

    def lowered(self, mode: str) -> 'Model':
        """The matrices rounded to ``mode`` (the activations are rounded
        at each product by ``precision.r``)."""
        from ..precision import round_to
        for k, t in self.v.items():
            if t.dim() == 2:
                self.v[k] = round_to(t, mode)
        return self

    def linear(self, name, x):
        y = torch.matmul(r(x), r(self.v[f'{name}/weight']).t())
        b = self.v.get(f'{name}/bias')
        return y if b is None else y + b

    def ln(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.v[f'{name}/gamma'],
                            self.v[f'{name}/beta'], eps=1e-5)

    def positions(self, n: int) -> torch.Tensor:
        half = self.d // 2
        pos = torch.arange(n, dtype=torch.float32, device=self.device)
        inv = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                               device=self.device) / half)
        ang = pos[:, None] * inv[None]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)

    def embed(self, side, tokens):
        scale = float(np.sqrt(np.float32(self.d)))
        return (self.v[f'{side}/embeddings/weight'][tokens] * scale
                + self.positions(tokens.shape[1]))

    def attend(self, q, k, v, hidden):
        b, tq, _ = q.shape
        h = self.heads
        split = lambda t: t.view(b, t.shape[1], h, -1).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        s = torch.matmul(r(q), r(k).transpose(-1, -2)) / math.sqrt(
            q.shape[-1])
        s = s.masked_fill(hidden, float('-inf'))
        o = torch.matmul(r(torch.softmax(s, dim=-1)), r(v))
        return o.transpose(1, 2).reshape(b, tq, -1)

    @torch.no_grad()
    def encode(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """tokens (B, S) with EOS, lengths (B,) -> (states (B, S, d),
        padding (B, S), True = pad)."""
        x = self.embed('encoder', tokens)
        pad = (torch.arange(tokens.shape[1], device=self.device)[None]
               >= lengths[:, None])
        hidden = pad[:, None, None, :]
        for i in range(self.n_enc):
            pre = f'encoder/layer_{i}'
            q, k, v = self.linear(f'{pre}/self_attention/linear_0',
                                  x).chunk(3, dim=-1)
            a = self.linear(f'{pre}/self_attention/linear_1',
                            self.attend(q, k, v, hidden))
            x = self.ln(f'{pre}/self_attention/layer_norm', x + a)
            f = self.linear(f'{pre}/ffn/linear_1', F.relu(
                self.linear(f'{pre}/ffn/linear_0', x)))
            x = self.ln(f'{pre}/ffn/layer_norm', x + f)
        return x, pad

    @torch.no_grad()
    def served_logprobs(self, states: torch.Tensor, pad: torch.Tensor,
                        served: List[int], start: int, unk: int,
                        rep_penalty: float) -> torch.Tensor:
        """Log-probability of each served token (the search's own scores:
        the repetition penalty over the tokens emitted before it, the
        unknown token banned), one sentence: states (1, S, d)."""
        inp = torch.tensor([[start] + served[:-1]], device=self.device)
        t_len = inp.shape[1]
        x = self.embed('decoder', inp)
        causal = torch.ones((t_len, t_len), dtype=torch.bool,
                            device=self.device).triu(1)[None, None]
        mem_hidden = pad[:, None, None, :]
        for i in range(self.n_dec):
            pre = f'decoder/layer_{i}'
            q, k, v = self.linear(f'{pre}/self_attention/linear_0',
                                  x).chunk(3, dim=-1)
            a = self.linear(f'{pre}/self_attention/linear_1',
                            self.attend(q, k, v, causal))
            x = self.ln(f'{pre}/self_attention/layer_norm', x + a)
            q = self.linear(f'{pre}/attention/linear_0', x)
            k, v = self.linear(f'{pre}/attention/linear_1',
                               states).chunk(2, dim=-1)
            a = self.linear(f'{pre}/attention/linear_2',
                            self.attend(q, k, v, mem_hidden))
            x = self.ln(f'{pre}/attention/layer_norm', x + a)
            f = self.linear(f'{pre}/ffn/linear_1', F.relu(
                self.linear(f'{pre}/ffn/linear_0', x)))
            x = self.ln(f'{pre}/ffn/layer_norm', x + f)
        logits = self.linear('decoder/projection', x)[0]       # (T, V)
        tgt = torch.tensor(served, device=self.device)
        seen = torch.zeros_like(logits, dtype=torch.bool)
        for t in range(1, t_len):
            seen[t:, served[t - 1]] = True
        penalized = torch.where(logits > 0, logits / rep_penalty,
                                logits * rep_penalty)
        logits = torch.where(seen, penalized, logits)
        logits[:, unk] = NEG
        logp = torch.log_softmax(logits, dim=-1)
        return logp[torch.arange(t_len, device=self.device), tgt]
