"""32px seq2seq OCR — PyTorch port.

Counterpart of the JAX package's ``models/ocr32.py`` (checkpoint
``ocr.ckpt`` in ocr.zip; reference ``ocr/model_32px.py``): the FAN ResNet
[3, 6, 7, 5] (``models/ocr48_ctc.ResNetFeatures`` with 2x2 tail convs) →
320-d tokens, sinusoidal PE, 3 post-LN transformer encoder layers and 2
post-LN decoder layers (torch defaults: 4 heads, FF 2048, ReLU), a
weight-tied char head and six scalar colour heads.

Decode is the JAX package's fixed-shape beam search (``ocr48.run_beam``'s
semantics: per-sample latching, ``max_finished_hypos``, END rows frozen,
top-k ties to the lower index, colour rows recovered after the loop from
``row_src``) as a Python loop of eager steps over per-layer K/V caches
(exact: standard attention has no length-dependent scaling). Each step
reorders the caches' written positions by beam parent. Plain PyTorch: no
TPU kernel stands behind this decoder.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.charhead import stable_topk
from .ocr48_ctc import (Backbone, PackedAttention, ResNetFeatures, _Layers,
                        _init_backbone, _init_helpers, attend, attention,
                        merge_heads, pe_table, split_heads)

EMBD_DIM = 320
N_HEADS = 4
HEAD_DIM = EMBD_DIM // N_HEADS
N_ENCODERS = 3
N_DECODERS = 2
FF_DIM = 2048
LAYERS = (3, 6, 7, 5)
START_TOK, END_TOK, PAD_TOK = 1, 2, 0
COLOR_HEADS = ('fg_r', 'fg_g', 'fg_b', 'bg_r', 'bg_g', 'bg_b')

EMBEDDING_PATTERNS = (r'^embd\.weight$', r'^pred\.weight$')
# how often the beam loop reads the all-done flag back to the host
_DONE_CHECK_EVERY = 4


class EncoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = PackedAttention()
        self.linear1 = nn.Linear(EMBD_DIM, FF_DIM)
        self.linear2 = nn.Linear(FF_DIM, EMBD_DIM)
        self.norm1 = nn.LayerNorm(EMBD_DIM, eps=1e-5)
        self.norm2 = nn.LayerNorm(EMBD_DIM, eps=1e-5)

    def ff(self, x):
        return self.linear2(F.relu(self.linear1(x)))

    def forward(self, x, key_mask):
        x = self.norm1(x + attention(self.self_attn, x, x, x, N_HEADS,
                                     key_mask))
        return self.norm2(x + self.ff(x))


class DecoderLayer(EncoderLayer):
    def __init__(self):
        super().__init__()
        self.multihead_attn = PackedAttention()
        self.norm3 = nn.LayerNorm(EMBD_DIM, eps=1e-5)


class _Bias(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(n))


class OCR32(nn.Module):
    def __init__(self, dict_size: int):
        super().__init__()
        self.backbone = Backbone(ResNetFeatures(LAYERS, 2, (0, 1)))
        self.encoders = _Layers([EncoderLayer() for _ in range(N_ENCODERS)])
        self.decoders = _Layers([DecoderLayer() for _ in range(N_DECODERS)])
        self.embd = nn.Embedding(dict_size, EMBD_DIM)
        self.pred1 = nn.Sequential(nn.Linear(EMBD_DIM, EMBD_DIM))
        self.pred = _Bias(dict_size)     # weight tied to embd
        self.color_pred1 = nn.Sequential(nn.Linear(EMBD_DIM, 64))
        for c in COLOR_HEADS:
            setattr(self, f'{c}_pred', nn.Linear(64, 1))


@torch.no_grad()
def compute_memory(model: OCR32, images: torch.Tensor,
                   valid_widths: torch.Tensor):
    """Backbone + encoder: images (N, 32, W, 3) in [-1, 1], valid_widths
    (N,) pixel widths → (memory (N, M, E), memory_mask (N, M) bool, True =
    masked)."""
    memory = model.backbone.ConvNet(images.permute(0, 3, 1, 2).contiguous())
    mem_len = memory.shape[1]
    valid_feats = (valid_widths.to(memory.device).long() + 3) // 4 + 2
    memory_mask = (torch.arange(mem_len, device=memory.device)[None, :]
                   >= valid_feats.clamp(max=mem_len)[:, None])
    x = memory + pe_table(mem_len, memory.device).to(memory.dtype)
    for layer in model.encoders.layers:
        x = layer(x, memory_mask)
    return x, memory_mask


@torch.no_grad()
def char_logprobs(model: OCR32, decoded: torch.Tensor) -> torch.Tensor:
    h = F.relu(model.pred1(decoded))
    logits = F.linear(h, model.embd.weight, model.pred.bias)
    return torch.log_softmax(logits.float(), -1)


@torch.no_grad()
def color_predictions(model: OCR32, decoded: torch.Tensor) -> torch.Tensor:
    feats = F.relu(model.color_pred1(decoded))
    return torch.cat([getattr(model, f'{c}_pred')(feats)
                      for c in COLOR_HEADS], dim=-1)


class _Decoder:
    """Per-layer K/V caches of one beam search: self K/V (L, N*k, S, E)
    written one position a step, cross K/V (L, N*k, M, E) computed once,
    and the last layer's output rows (N*k, S, E)."""

    def __init__(self, model: OCR32, memory_b: torch.Tensor,
                 memory_mask_b: torch.Tensor, max_len: int):
        self.model = model
        self.mask = memory_mask_b
        nk = memory_b.shape[0]
        dev, dt = memory_b.device, memory_b.dtype
        layers = model.decoders.layers
        self.mem_k = [split_heads(l.multihead_attn.project(memory_b, 1),
                                  N_HEADS) for l in layers]
        self.mem_v = [split_heads(l.multihead_attn.project(memory_b, 2),
                                  N_HEADS) for l in layers]
        shape = (len(layers), nk, max_len, EMBD_DIM)
        self.self_k = torch.zeros(shape, dtype=dt, device=dev)
        self.self_v = torch.zeros(shape, dtype=dt, device=dev)
        self.out = torch.zeros((nk, max_len, EMBD_DIM), dtype=dt, device=dev)
        self.pe = pe_table(2048, dev).to(dt)

    def step(self, token: torch.Tensor, step: int) -> torch.Tensor:
        """Decoder output (N*k, E) at position ``step`` for the tokens
        ``token`` (N*k,); writes position ``step`` of the caches."""
        model = self.model
        tgt = (model.embd.weight[token] + self.pe[step])[:, None, :]
        for li, layer in enumerate(model.decoders.layers):
            sa = layer.self_attn
            q = split_heads(sa.project(tgt, 0) * (HEAD_DIM ** -0.5), N_HEADS)
            self.self_k[li, :, step] = sa.project(tgt, 1)[:, 0]
            self.self_v[li, :, step] = sa.project(tgt, 2)[:, 0]
            k = split_heads(self.self_k[li, :, :step + 1], N_HEADS)
            v = split_heads(self.self_v[li, :, :step + 1], N_HEADS)
            tgt = layer.norm1(tgt + sa.out_proj(merge_heads(attend(q, k, v))))
            ca = layer.multihead_attn
            q2 = split_heads(ca.project(tgt, 0) * (HEAD_DIM ** -0.5), N_HEADS)
            attn2 = attend(q2, self.mem_k[li], self.mem_v[li], self.mask)
            tgt = layer.norm2(tgt + ca.out_proj(merge_heads(attn2)))
            tgt = layer.norm3(tgt + layer.ff(tgt))
        self.out[:, step] = tgt[:, 0]
        return tgt[:, 0]

    def reorder(self, parent_flat: torch.Tensor, step: int) -> None:
        """Each beam row takes its parent's history, positions 0..step."""
        for cache in (self.self_k, self.self_v):
            cache[:, :, :step + 1] = cache[:, parent_flat, :step + 1]


@torch.no_grad()
def run_beam(model: OCR32, memory: torch.Tensor, memory_mask: torch.Tensor,
             beams_k: int, max_len: int, max_finished_hypos: int) -> dict:
    """Fixed-shape beam search with per-sample latching (semantics of the
    JAX package's ``ocr48.run_beam`` with the 32px harness)."""
    dev = memory.device
    n = memory.shape[0]
    k = beams_k
    nk = n * k
    dec = _Decoder(model, memory.repeat_interleave(k, 0),
                   memory_mask.repeat_interleave(k, 0), max_len)
    ar_nk = torch.arange(nk, device=dev)
    ar_n = torch.arange(n, device=dev)

    def topk(decoded):
        return stable_topk(char_logprobs(model, decoded), k)

    out_idx = torch.full((nk, max_len + 1), END_TOK, dtype=torch.long,
                         device=dev)
    out_idx[:, 0] = START_TOK
    top_v, top_i = topk(dec.step(out_idx[:, 0], 0))
    beam_pos = ar_nk % k
    out_idx[:, 1] = top_i[ar_nk, beam_pos]
    log_probs = top_v[ar_nk, beam_pos]

    done = torch.zeros(n, dtype=torch.bool, device=dev)
    best_seq = torch.full((n, max_len + 1), END_TOK, dtype=torch.long,
                          device=dev)
    best_logprob = torch.full((n,), float('-inf'), device=dev)
    row_src = ar_nk[:, None].expand(nk, max_len).clone()
    best_row_src = torch.zeros((n, max_len), dtype=torch.long, device=dev)

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
        if step % _DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        last_tok = out_idx[:, step]
        top_v, top_i = topk(dec.step(last_tok, step))
        finished = (last_tok == END_TOK)[:, None]
        top_v = torch.where(finished, torch.zeros_like(top_v), top_v)
        top_i = torch.where(finished, torch.full_like(top_i, END_TOK), top_i)
        cand = (log_probs[:, None] + top_v).view(n, k * k)
        sel_v, sel_flat = stable_topk(cand, k)
        parent = sel_flat // k
        new_tok_idx = sel_flat % k
        parent_flat = (ar_n[:, None] * k + parent).view(-1)
        out_idx = out_idx[parent_flat]
        tok = top_i.view(n, k, k)[ar_n[:, None], parent,
                                  new_tok_idx].view(-1)
        out_idx[:, step + 1] = tok
        dec.reorder(parent_flat, step)
        row_src[:, step] = ar_nk
        row_src = row_src[parent_flat]
        log_probs = sel_v.reshape(-1)
        fin = (tok == END_TOK).view(n, k)
        latch((fin.sum(dim=1) >= max_finished_hypos) & ~done)
    latch(~done)
    colors = dec.out[best_row_src, torch.arange(max_len, device=dev)[None, :]]
    return {'best_seq': best_seq, 'best_logprob': best_logprob,
            'best_colors': colors}


@torch.no_grad()
def beam_decode(model: OCR32, images: torch.Tensor,
                valid_widths: torch.Tensor, beams_k: int = 5,
                max_len: int = 255, max_finished_hypos: int = 2) -> dict:
    """Full 32px OCR inference on (N, 32, W, 3) strips in [-1, 1]:
    sequences (N, max_len), probabilities (N,) and per-step colours (N,
    max_len, 6) clipped to [0, 1]."""
    memory, memory_mask = compute_memory(model, images, valid_widths)
    state = run_beam(model, memory, memory_mask, beams_k, max_len,
                     max_finished_hypos)
    colors = torch.clamp(color_predictions(model, state['best_colors']), 0, 1)
    return {'sequences': state['best_seq'][:, 1:],
            'probs': torch.exp(state['best_logprob']),
            'colors': colors}


def build_ocr32(dict_size: int, device='cpu', state_dict=None) -> OCR32:
    from ..weights import load_state_dict_into
    model = OCR32(dict_size).eval()
    if state_dict is not None:
        load_state_dict_into(model, state_dict)
    return model.to(device)


def init_state_dict(dict_size: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights with the checkpoint's keys and shapes: the
    JAX package's ``init_params`` draws, bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(37)
    params: Dict[str, np.ndarray] = {}
    conv, bn, dense, ln = _init_helpers(rs, params)
    _init_backbone(conv, bn, LAYERS, 2)
    for group, count in (('encoders', N_ENCODERS), ('decoders', N_DECODERS)):
        for i in range(count):
            pre = f'{group}.layers.{i}'
            attns = ['self_attn'] if group == 'encoders' else \
                ['self_attn', 'multihead_attn']
            for att in attns:
                params[f'{pre}.{att}.in_proj_weight'] = (
                    rs.randn(EMBD_DIM, 3 * EMBD_DIM).astype(np.float32)
                    / np.sqrt(EMBD_DIM)).astype(np.float32)
                params[f'{pre}.{att}.in_proj_bias'] = np.zeros(
                    (3 * EMBD_DIM,), np.float32)
                dense(f'{pre}.{att}.out_proj', EMBD_DIM, EMBD_DIM)
            dense(f'{pre}.linear1', EMBD_DIM, FF_DIM)
            dense(f'{pre}.linear2', FF_DIM, EMBD_DIM)
            norms = ['norm1', 'norm2'] if group == 'encoders' else \
                ['norm1', 'norm2', 'norm3']
            for nrm in norms:
                ln(f'{pre}.{nrm}', EMBD_DIM)
    params['embd.weight'] = (rs.randn(dict_size, EMBD_DIM).astype(np.float32)
                             * 0.02).astype(np.float32)
    dense('pred1.0', EMBD_DIM, EMBD_DIM)
    params['pred.bias'] = np.zeros((dict_size,), np.float32)
    dense('color_pred1.0', EMBD_DIM, 64)
    for c in COLOR_HEADS:
        dense(f'{c}_pred', 64, 1)
    return torch_state_dict_from_jax(params,
                                     embedding_patterns=EMBEDDING_PATTERNS)


def checkpoint_state_dict(sd: Dict[str, torch.Tensor],
                          ) -> Dict[str, torch.Tensor]:
    """A released ``ocr.ckpt`` state dict → this module's keys: the PE
    buffer is recomputed and ``pred.weight`` is the tied ``embd.weight``."""
    return {k: v for k, v in sd.items()
            if not k.endswith('pe.pe') and k != 'pred.weight'}
