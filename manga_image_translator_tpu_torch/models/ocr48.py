"""48px autoregressive OCR (default OCR backend) — PyTorch port.

Counterpart of the JAX package's ``models/ocr48.py`` (reference
``ocr/model_48px.py:183-855`` + ``ocr/xpos_relative_position.py``):
ConvNeXt feature extractor (48 px tall strips → W/4 tokens of dim 320),
4 pre-LN transformer encoder layers and 5 decoder layers with XPOS rotary
attention, weight-tied char head, per-timestep fg/bg colour heads.

Module names follow the checkpoint keys (``ocr_ar_48px.ckpt`` loads with
``load_state_dict``). The decode loop keeps the JAX package's design: per
layer K/V caches (exact, because XPOS's centring cancels between q and k),
cross-attention K/V computed once per sequence, a fixed-shape beam search
with per-sample latching and deferred colour rows. It runs as a Python loop
of eager steps; each step is one launch of the fused decoder-step kernel
(``ops.decode_step``, K2) and one of the fused char-head top-k kernel
(``ops.charhead``, K3); each beam row reads its history through an ancestry
table, so no step moves the K/V cache. Decode runs in bf16 on the card (the
kernels' contract) and in f32 on the CPU.
"""
from __future__ import annotations

import copy
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import charhead as charhead_ops
from ..ops import decode_step as decode_ops
from ..ops.charhead import stable_topk
from ..ops.device_loop import DeviceLoop
from ..utils.profiling import count

EMBD_DIM = 320
N_HEADS = 4
HEAD_DIM = EMBD_DIM // N_HEADS
N_ENCODERS = 4
N_DECODERS = 5
FF_DIM = 2048
XPOS_SCALE_BASE = EMBD_DIM

START_TOK, END_TOK, PAD_TOK = 1, 2, 0

TRANSPOSED_CONV_PATTERNS: Tuple[str, ...] = ()
EMBEDDING_PATTERNS = (r'^embd\.weight$', r'^pred\.weight$')


# --------------------------------------------------------------------------
# XPOS rotary position embedding (reference xpos_relative_position.py:8-72)
# --------------------------------------------------------------------------

def _xpos_scale_vec() -> np.ndarray:
    return ((np.arange(0, HEAD_DIM, 2) + 0.4 * HEAD_DIM)
            / (1.4 * HEAD_DIM)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _xpos_sincos(length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sin, cos) rotation tables for absolute positions 0..length-1, shape
    (length, head_dim/2)."""
    half = HEAD_DIM // 2
    pos = np.arange(length, dtype=np.float32)
    inv_freq = 1.0 / (10000 ** (np.arange(half, dtype=np.float32) / half))
    sinusoid = pos[:, None] * inv_freq[None, :]
    return np.sin(sinusoid), np.cos(sinusoid)


_XPOS_MAX_POS = 4096


def _rotate_mix(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
                ) -> torch.Tensor:
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return x * cos + rotated * sin


def apply_xpos(x: torch.Tensor, rot_positions: np.ndarray,
               scale_exponents: np.ndarray, downscale: bool) -> torch.Tensor:
    """XPOS rotary embedding over (..., L, head_dim)."""
    sin_np, cos_np = _xpos_sincos(_XPOS_MAX_POS)
    sin = torch.from_numpy(sin_np[rot_positions]).to(x.device)
    cos = torch.from_numpy(cos_np[rot_positions]).to(x.device)
    s = torch.from_numpy(_xpos_scale_vec()).to(x.device)
    exp = torch.from_numpy(np.asarray(scale_exponents, np.float32)
                           / XPOS_SCALE_BASE).to(x.device)
    if downscale:
        exp = -exp
    scale = torch.pow(s[None, :], exp[:, None])
    sin = torch.repeat_interleave(sin * scale, 2, dim=-1).to(x.dtype)
    cos = torch.repeat_interleave(cos * scale, 2, dim=-1).to(x.dtype)
    return _rotate_mix(x, sin, cos)


def xpos_step_tables(max_len: int) -> dict:
    """Per-step XPOS sin/cos tables (S, head_dim) for the decode loop:
      self q:  positions=t, exponents=+t   (upscale)
      self k:  positions=t, exponents=-t   (downscale)
      cross q: positions=t, exponents=+((t+1)//2 - 1)"""
    sin_np, cos_np = _xpos_sincos(_XPOS_MAX_POS)
    steps = np.arange(max_len)
    sin = sin_np[steps]
    cos = cos_np[steps]
    s = _xpos_scale_vec()[None, :]

    def table(exponents, negate):
        e = exponents.astype(np.float32) / XPOS_SCALE_BASE
        if negate:
            e = -e
        scale = np.power(s, e[:, None])
        return (np.repeat(sin * scale, 2, axis=-1),
                np.repeat(cos * scale, 2, axis=-1))

    return {'self_q': table(steps, False), 'self_k': table(steps, True),
            'cross_q': table((steps + 1) // 2 - 1, False)}


def rot_table(max_len: int, device) -> torch.Tensor:
    """(S, 6, head_dim) f32 rows for the decoder-step kernel: self-q
    sin/cos, self-k sin/cos, cross-q sin/cos."""
    t = xpos_step_tables(max_len)
    rows = [t['self_q'][0], t['self_q'][1], t['self_k'][0], t['self_k'][1],
            t['cross_q'][0], t['cross_q'][1]]
    return torch.from_numpy(np.stack(rows, axis=1).astype(np.float32)
                            ).to(device).contiguous()


# --------------------------------------------------------------------------
# ConvNeXt feature extractor (reference model_48px.py:183-280)
# --------------------------------------------------------------------------

class ConvNextBlock(nn.Module):
    def __init__(self, dim: int, ks: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, ks, padding=ks // 2, groups=dim)
        self.norm = nn.BatchNorm2d(dim, eps=1e-6)
        self.pwconv1 = nn.Conv2d(dim, dim * 4, 1)
        self.pwconv2 = nn.Conv2d(dim * 4, dim, 1)
        self.gamma = nn.Parameter(torch.full((1, dim, 1, 1), 1e-6))

    def forward(self, x):
        y = self.norm(self.dwconv(x))
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + y * self.gamma


def _conv_bn_relu(cin: int, cout: int, k, stride) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride), nn.BatchNorm2d(cout),
                         nn.ReLU())


class ConvNextFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        base = EMBD_DIM // 8
        self.stem = nn.Sequential(
            nn.Conv2d(3, base, 7, padding=3), nn.BatchNorm2d(base), nn.ReLU(),
            nn.Conv2d(base, base * 2, 2, 2), nn.BatchNorm2d(base * 2),
            nn.ReLU(),
            nn.Conv2d(base * 2, base * 2, 3, padding=1),
            nn.BatchNorm2d(base * 2), nn.ReLU())
        self.block1 = nn.Sequential(*[ConvNextBlock(base * 2, 7)
                                      for _ in range(4)])
        self.down1 = _conv_bn_relu(base * 2, base * 4, 2, 2)
        self.block2 = nn.Sequential(*[ConvNextBlock(base * 4, 7)
                                      for _ in range(12)])
        self.down2 = _conv_bn_relu(base * 4, base * 8, (2, 1), (2, 1))
        self.block3 = nn.Sequential(*[ConvNextBlock(base * 8, 5)
                                      for _ in range(10)])
        self.down3 = _conv_bn_relu(base * 8, base * 8, (2, 1), (2, 1))
        self.block4 = nn.Sequential(*[ConvNextBlock(base * 8, 3)
                                      for _ in range(8)])
        self.down4 = _conv_bn_relu(base * 8, base * 8, (3, 1), 1)

    def forward(self, x):
        """(N, 3, 48, W) → (N, W/4, 320) memory tokens."""
        for m in (self.stem, self.block1, self.down1, self.block2, self.down2,
                  self.block3, self.down3, self.block4, self.down4):
            x = m(x)
        return x[:, :, 0, :].transpose(1, 2)


def convnext_features(backbone: ConvNextFeatures, x: torch.Tensor
                      ) -> torch.Tensor:
    """NHWC interface: (N, 48, W, 3) → (N, W/4, 320)."""
    return backbone(x.permute(0, 3, 1, 2).contiguous())


# --------------------------------------------------------------------------
# Transformer layers
# --------------------------------------------------------------------------

class XposAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.q_proj = nn.Linear(EMBD_DIM, EMBD_DIM)
        self.k_proj = nn.Linear(EMBD_DIM, EMBD_DIM)
        self.v_proj = nn.Linear(EMBD_DIM, EMBD_DIM)
        self.out_proj = nn.Linear(EMBD_DIM, EMBD_DIM)


def _split_heads(x: torch.Tensor) -> torch.Tensor:
    n, l, _ = x.shape
    return x.view(n, l, N_HEADS, HEAD_DIM).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    n, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(n, l, h * hd)


def xpos_attention(attn: XposAttention, x: torch.Tensor,
                   key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Full self-attention with XPOS, both sides centred at ceil(L/2)
    (reference XposMultiheadAttention.forward, q_offset = k_offset = 0).
    Scores and softmax in f32."""
    length = x.shape[1]
    pos = np.arange(length)
    exp = pos - (length + 1) // 2
    q = attn.q_proj(x) * (HEAD_DIM ** -0.5)
    k = attn.k_proj(x)
    v = attn.v_proj(x)
    q, k, v = _split_heads(q), _split_heads(k), _split_heads(v)
    k = apply_xpos(k, pos, exp, downscale=True)
    q = apply_xpos(q, pos, exp, downscale=False)
    scores = torch.einsum('nhqd,nhkd->nhqk', q.float(), k.float())
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                    float('-inf'))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum('nhqk,nhkd->nhqd', w, v)
    return attn.out_proj(_merge_heads(out))


class EncoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = XposAttention()
        self.linear1 = nn.Linear(EMBD_DIM, FF_DIM)
        self.linear2 = nn.Linear(FF_DIM, EMBD_DIM)
        self.norm1 = nn.LayerNorm(EMBD_DIM, eps=1e-5)
        self.norm2 = nn.LayerNorm(EMBD_DIM, eps=1e-5)

    def forward(self, x, key_padding_mask):
        x = x + xpos_attention(self.self_attn, self.norm1(x), key_padding_mask)
        return x + self.linear2(F.relu(self.linear1(self.norm2(x))))


class DecoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = XposAttention()
        self.multihead_attn = XposAttention()
        self.linear1 = nn.Linear(EMBD_DIM, FF_DIM)
        self.linear2 = nn.Linear(FF_DIM, EMBD_DIM)
        self.norm1 = nn.LayerNorm(EMBD_DIM, eps=1e-5)
        self.norm2 = nn.LayerNorm(EMBD_DIM, eps=1e-5)
        self.norm3 = nn.LayerNorm(EMBD_DIM, eps=1e-5)


class _Bias(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(n))


class OCR48(nn.Module):
    def __init__(self, dict_size: int):
        super().__init__()
        self.backbone = ConvNextFeatures()
        self.encoders = nn.ModuleList([EncoderLayer()
                                       for _ in range(N_ENCODERS)])
        self.decoders = nn.ModuleList([DecoderLayer()
                                       for _ in range(N_DECODERS)])
        self.embd = nn.Embedding(dict_size, EMBD_DIM)
        self.pred1 = nn.Sequential(nn.Linear(EMBD_DIM, EMBD_DIM))
        self.pred = _Bias(dict_size)
        self.color_pred1 = nn.Sequential(nn.Linear(EMBD_DIM, 64))
        self.color_pred_fg = nn.Linear(64, 3)
        self.color_pred_bg = nn.Linear(64, 3)
        self.color_pred_fg_ind = nn.Linear(64, 2)
        self.color_pred_bg_ind = nn.Linear(64, 2)
        self._cache: Dict = {}

    def packed(self, dtype: torch.dtype):
        """Decoder and char-head weights in the kernels' layout (built once
        per dtype and device)."""
        key = ('packed', dtype, self.embd.weight.device)
        if key not in self._cache:
            self._cache[key] = (
                decode_ops.pack_decoder(self.decoders, dtype),
                charhead_ops.prepare_charhead(
                    self.pred1[0].weight, self.pred1[0].bias,
                    self.embd.weight, self.pred.bias, dtype),
                self.embd.weight.detach().to(dtype))
        return self._cache[key]

    def bf16_encoder(self) -> nn.Module:
        """A bf16 copy of backbone + encoders for the bf16-activation memory
        path (weights rounded once)."""
        key = ('bf16_encoder', self.embd.weight.device)
        if key not in self._cache:
            enc = nn.Module()
            enc.backbone = copy.deepcopy(self.backbone)
            enc.encoders = copy.deepcopy(self.encoders)
            self._cache[key] = enc.to(torch.bfloat16).eval()
        return self._cache[key]


def encoder_forward(encoders, memory: torch.Tensor,
                    key_padding_mask: torch.Tensor) -> torch.Tensor:
    x = memory
    for layer in encoders:
        x = layer(x, key_padding_mask)
    return x


def fold_bn(model: OCR48) -> OCR48:
    """Fold every inference-mode backbone BatchNorm into the conv before it
    (in place; the BN modules become identities)."""
    def fold(conv: nn.Conv2d, bn: nn.BatchNorm2d):
        s = bn.weight.detach().float() / torch.sqrt(
            bn.running_var.float() + bn.eps)
        t = bn.bias.detach().float() - bn.running_mean.float() * s
        with torch.no_grad():
            conv.weight.mul_(s.view(-1, 1, 1, 1).to(conv.weight.dtype))
            conv.bias.copy_((conv.bias.float() * s + t).to(conv.bias.dtype))

    bb = model.backbone
    for seq in (bb.stem, bb.down1, bb.down2, bb.down3, bb.down4):
        for i, m in enumerate(seq):
            if isinstance(m, nn.BatchNorm2d):
                fold(seq[i - 1], m)
                seq[i] = nn.Identity()
    for blocks in (bb.block1, bb.block2, bb.block3, bb.block4):
        for blk in blocks:
            if isinstance(blk.norm, nn.BatchNorm2d):
                fold(blk.dwconv, blk.norm)
                blk.norm = nn.Identity()
    model._cache.clear()
    return model


@torch.no_grad()
def compute_memory(model: OCR48, images: torch.Tensor,
                   valid_widths: torch.Tensor, bf16_backbone: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvNeXt backbone + transformer encoder.

    images: (N, 48, W, 3) float in [-1, 1]; valid_widths (N,) int pixel
    widths. ``bf16_backbone`` runs both in bf16 activations (f32
    accumulation). Returns (memory (N, M, E) in the images' dtype,
    memory_mask (N, M) bool, True = masked)."""
    in_dtype = images.dtype
    net = model.bf16_encoder() if bf16_backbone else model
    x = images.to(torch.bfloat16) if bf16_backbone else images
    memory = convnext_features(net.backbone, x)
    mem_len = memory.shape[1]
    valid_feats = (valid_widths.to(memory.device).long() + 3) // 4 + 2
    memory_mask = (torch.arange(mem_len, device=memory.device)[None, :]
                   >= valid_feats.clamp(max=mem_len)[:, None])
    memory = encoder_forward(net.encoders, memory, memory_mask)
    return memory.to(in_dtype), memory_mask


@torch.no_grad()
def init_memory_kv(model: OCR48, memory: torch.Tensor,
                   memory_mask: torch.Tensor, beams_k: int,
                   dtype: torch.dtype):
    """Cross-attention K/V of every decoder layer, XPOS-rotated keys,
    repeated per beam, in the kernel layout (L, M, N*k, E); plus the
    per-row valid lengths (N*k,) int32."""
    n, m, _ = memory.shape
    pos = np.arange(m)
    mem_exp = pos - (m + 1) // 2
    mks, mvs = [], []
    for layer in model.decoders:
        ca = layer.multihead_attn
        k = apply_xpos(_split_heads(ca.k_proj(memory)), pos, mem_exp,
                       downscale=True)
        v = _split_heads(ca.v_proj(memory))
        mks.append(_merge_heads(k))
        mvs.append(_merge_heads(v))
    mem_k = torch.stack(mks).repeat_interleave(beams_k, dim=1)
    mem_v = torch.stack(mvs).repeat_interleave(beams_k, dim=1)
    mem_k = mem_k.transpose(1, 2).to(dtype).contiguous()
    mem_v = mem_v.transpose(1, 2).to(dtype).contiguous()
    mem_len = (~memory_mask).sum(dim=1).to(torch.int32)
    return mem_k, mem_v, mem_len.repeat_interleave(beams_k).contiguous()


def char_topk(model: OCR48, decoded: torch.Tensor, k: int):
    """Top-k char log-probs of the decoder outputs (the K3 wrapper)."""
    _, ch, _ = model.packed(decoded.dtype)
    return charhead_ops.char_topk(decoded, ch, k)


@torch.no_grad()
def color_predictions(model: OCR48, decoded: torch.Tensor):
    """decoded: (..., E) → (fg, bg, fg_ind, bg_ind), f32."""
    feats = F.relu(model.color_pred1(decoded.float()))
    return (model.color_pred_fg(feats), model.color_pred_bg(feats),
            model.color_pred_fg_ind(feats), model.color_pred_bg_ind(feats))


def decode_dtype(device) -> torch.dtype:
    """bf16 on the card (the kernels' contract), f32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == 'cuda' \
        else torch.float32


# how often the beam loop reads the all-done flag back to the host (the
# block of ``ops.device_loop``, aligned to multiples: the flag is read
# before steps 4, 8, ...); the steps run after every sample latched change
# nothing (latching only takes newly finished samples)
_DONE_CHECK_EVERY = 4


class BeamLoop:
    """The fixed-shape beam search of one shape (n crops, k beams,
    ``max_len`` steps, M memory positions, dtype): every buffer the search
    updates, and the step body that ``ops.device_loop`` replays as a CUDA
    graph on the card. ``search`` copies its inputs into the buffers and
    returns copies of its results, so one object can serve several
    searches of its shape, replaying the graph it captured; ``run_beam``
    makes one per search: keeping one per shape saved 2.6-3.5% of the OCR
    stage on pages of many line widths and held 1.0-3.3 GB on the H100
    (PERF.md, the smoke's ``ocr_shapes``).

    The self-K/V caches are not reset between searches: step t writes
    position t of every row before any step reads it (through ``src``)."""

    def __init__(self, model: 'OCR48', device, n: int, k: int, max_len: int,
                 m_len: int, max_finished_hypos: int, dt: torch.dtype):
        self.n, self.k, self.nk = n, k, n * k
        self.max_len = max_len
        self.max_finished_hypos = max_finished_hypos
        self.w, self.ch, self.embd = model.packed(dt)
        nk, L = self.nk, decode_ops.L
        kw = dict(device=device)
        self.mem_k = torch.empty((L, m_len, nk, EMBD_DIM), dtype=dt, **kw)
        self.mem_v = torch.empty_like(self.mem_k)
        self.mem_len = torch.empty((nk,), dtype=torch.int32, **kw)
        self.self_k = torch.zeros((L, max_len, nk, EMBD_DIM), dtype=dt, **kw)
        self.self_v = torch.zeros_like(self.self_k)
        self.outc = torch.empty((nk, max_len, EMBD_DIM), dtype=dt, **kw)
        self.rot = rot_table(max_len, device)
        self.ar_nk = torch.arange(nk, **kw)
        self.ar_n = torch.arange(n, **kw)
        self.positions = torch.arange(max_len, **kw)
        # src[t, r]: the cache row holding position t of beam row r's
        # history
        self.src = torch.empty((max_len, nk), dtype=torch.int32, **kw)
        self.step = torch.empty((), dtype=torch.int64, **kw)
        self.out_idx = torch.empty((nk, max_len + 1), dtype=torch.long, **kw)
        self.log_probs = torch.empty((nk,), dtype=torch.float32, **kw)
        self.done = torch.empty((n,), dtype=torch.bool, **kw)
        self.best_seq = torch.empty((n, max_len + 1), dtype=torch.long, **kw)
        self.best_logprob = torch.empty((n,), dtype=torch.float32, **kw)
        self.row_src = torch.empty((nk, max_len), dtype=torch.long, **kw)
        self.best_row_src = torch.empty((n, max_len), dtype=torch.long, **kw)
        self.loop = DeviceLoop(device)

    def decode(self, tok: torch.Tensor) -> torch.Tensor:
        out, _, _, _ = decode_ops.decode_step(
            self.step, self.embd[tok], self.w, self.rot, self.self_k,
            self.self_v, self.mem_k, self.mem_v, self.mem_len, self.src)
        self.outc.index_copy_(1, self.step.view(1), out[:, None])
        return out

    def latch(self, newly_done: torch.Tensor) -> None:
        # torch.where, not boolean-mask assignment: a mask index would wait
        # for the device every step
        n, k = self.n, self.k
        lp = self.log_probs.view(n, k)
        best_beam = lp.argmax(dim=1)
        flat = self.ar_n * k + best_beam
        take = newly_done[:, None]
        self.best_seq.copy_(torch.where(take, self.out_idx[flat],
                                        self.best_seq))
        self.best_logprob.copy_(torch.where(
            newly_done, lp[self.ar_n, best_beam], self.best_logprob))
        self.best_row_src.copy_(torch.where(take, self.row_src[flat],
                                            self.best_row_src))
        self.done.logical_or_(newly_done)

    def body(self, _=None) -> None:
        """One step at the device position ``step``; every buffer it
        changes is updated in place, so a CUDA graph of it can be
        replayed."""
        n, k, nk = self.n, self.k, self.nk
        step, out_idx, ar_n = self.step, self.out_idx, self.ar_n
        at = step.expand(nk, 1)
        last_tok = out_idx.gather(1, at).view(nk)
        decoded = self.decode(last_tok)
        top_v, top_i = charhead_ops.char_topk(decoded, self.ch, k)
        finished = (last_tok == END_TOK)[:, None]
        top_v = torch.where(finished, torch.zeros_like(top_v), top_v)
        top_i = torch.where(finished, torch.full_like(top_i, END_TOK), top_i)
        cand = (self.log_probs[:, None] + top_v).view(n, k * k)
        sel_v, sel_flat = stable_topk(cand, k)
        parent = sel_flat // k
        new_tok_idx = sel_flat % k
        parent_flat = (ar_n[:, None] * k + parent).view(-1)
        out_idx.copy_(out_idx[parent_flat])
        tok = top_i.view(n, k, k)[ar_n[:, None], parent,
                                  new_tok_idx].view(-1)
        out_idx.scatter_(1, at + 1, tok[:, None])
        # each new row inherits its parent's history, position step
        # included (src[step] is still the identity there); later
        # positions keep the identity
        self.src.copy_(torch.where(self.positions[:, None] <= step,
                                   self.src[:, parent_flat], self.src))
        self.row_src.scatter_(1, at, self.ar_nk[:, None])
        self.row_src.copy_(self.row_src[parent_flat])
        self.log_probs.copy_(sel_v.reshape(-1))
        fin = (tok == END_TOK).view(n, k)
        self.latch((fin.sum(dim=1) >= self.max_finished_hypos) & ~self.done)
        step.add_(1)

    def search(self, mem_k: torch.Tensor, mem_v: torch.Tensor,
               mem_len: torch.Tensor) -> dict:
        k, nk, max_len = self.k, self.nk, self.max_len
        self.mem_k.copy_(mem_k)
        self.mem_v.copy_(mem_v)
        self.mem_len.copy_(mem_len)
        self.outc.zero_()
        self.src.copy_(self.ar_nk.to(torch.int32).expand(max_len, nk))
        self.step.zero_()
        self.out_idx.fill_(END_TOK)
        self.out_idx[:, 0] = START_TOK
        top_v, top_i = charhead_ops.char_topk(self.decode(self.out_idx[:, 0]),
                                              self.ch, k)
        beam_pos = self.ar_nk % k
        self.out_idx[:, 1] = top_i[self.ar_nk, beam_pos]
        self.log_probs.copy_(top_v[self.ar_nk, beam_pos])
        self.step.fill_(1)
        self.done.zero_()
        self.best_seq.fill_(END_TOK)
        self.best_logprob.fill_(float('-inf'))
        self.row_src.copy_(self.ar_nk[:, None].expand(nk, max_len))
        self.best_row_src.zero_()

        steps = self.loop.run(self.body, 1, max_len, _DONE_CHECK_EVERY,
                              self.done.all)
        count('ocr.line_steps', self.n * steps)
        self.latch(~self.done)
        if self.step.device.type == 'cuda':
            decode_ops.raise_step_error(self.step.device)
        colors = self.outc[self.best_row_src, self.positions[None, :]]
        return {'best_seq': self.best_seq.clone(),
                'best_logprob': self.best_logprob.clone(),
                'best_colors': colors}


@torch.no_grad()
def run_beam(model: OCR48, memory: torch.Tensor, memory_mask: torch.Tensor,
             beams_k: int, max_len: int, max_finished_hypos: int,
             dtype: Optional[torch.dtype] = None) -> dict:
    """Fixed-shape beam search with per-sample latching (semantics of
    reference infer_beam_batch_tensor :678-801, as the JAX package's
    ``run_beam``): one decoder-step launch and one char-head launch per
    step. The self-K/V cache never moves: each beam row reads its history
    through the ancestry table ``src`` (``ops.decode_step``), which follows
    the beam parents; colour rows are recovered after the loop from
    ``row_src``.

    As the JAX package's ``while_loop``, the loop lives on the device: the
    step is a 0-d int64 tensor that K2 reads from device memory, and steps
    1.. are one fixed-shape body over buffers updated in place
    (``BeamLoop``), which ``ops.device_loop`` replays as a CUDA graph on
    the card (eagerly on the CPU), reading the all-done flag once every
    ``_DONE_CHECK_EVERY`` steps."""
    dev = memory.device
    dt = dtype or decode_dtype(dev)
    mem_k, mem_v, mem_len = init_memory_kv(model, memory, memory_mask,
                                           beams_k, dt)
    return BeamLoop(model, dev, memory.shape[0], beams_k, max_len,
                    mem_k.shape[1], max_finished_hypos, dt).search(
                        mem_k, mem_v, mem_len)


@torch.no_grad()
def beam_decode_from_memory(model: OCR48, memory: torch.Tensor,
                            memory_mask: torch.Tensor, beams_k: int = 5,
                            max_len: int = 255, max_finished_hypos: int = 2,
                            dtype: Optional[torch.dtype] = None) -> dict:
    """Beam search + colour heads over a precomputed encoder memory."""
    state = run_beam(model, memory, memory_mask, beams_k, max_len,
                     max_finished_hypos, dtype)
    fg, bg, fg_ind, bg_ind = color_predictions(model, state['best_colors'])
    return {'sequences': state['best_seq'][:, 1:],
            'probs': torch.exp(state['best_logprob']),
            'fg': fg, 'bg': bg, 'fg_ind': fg_ind, 'bg_ind': bg_ind}


@torch.no_grad()
def beam_decode(model: OCR48, images: torch.Tensor,
                valid_widths: torch.Tensor, beams_k: int = 5,
                max_len: int = 255, max_finished_hypos: int = 2,
                bf16_backbone: bool = False,
                dtype: Optional[torch.dtype] = None) -> dict:
    """Full OCR inference for a batch of 48 px strips (N, 48, W, 3) in
    [-1, 1]: compute_memory + beam_decode_from_memory."""
    memory, memory_mask = compute_memory(model, images, valid_widths,
                                         bf16_backbone)
    return beam_decode_from_memory(model, memory, memory_mask, beams_k,
                                   max_len, max_finished_hypos, dtype)


def sharded_compute_memory(model: OCR48, images: torch.Tensor,
                           valid_widths: torch.Tensor, bf16_backbone: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """compute_memory split over the crops on every mesh device
    (zero-width padding rows are cropped back). Without a mesh:
    compute_memory."""
    from ..parallel.mesh import sharded_batch

    def fn(m, im, w):
        return compute_memory(m, im, w, bf16_backbone)
    return sharded_batch(fn, ('ocr48.memory', bf16_backbone), model, images,
                         valid_widths)


def sharded_beam_decode_from_memory(model: OCR48, memory: torch.Tensor,
                                    memory_mask: torch.Tensor,
                                    beams_k: int = 5, max_len: int = 255,
                                    max_finished_hypos: int = 2) -> dict:
    """beam_decode_from_memory split over the rows on every mesh device.
    Padding rows get zero memory with an all-valid mask and are cropped
    from the result. Without a mesh: beam_decode_from_memory."""
    from ..parallel.mesh import sharded_batch

    def fn(m, mem, mask):
        return beam_decode_from_memory(m, mem, mask, beams_k=beams_k,
                                       max_len=max_len,
                                       max_finished_hypos=max_finished_hypos)
    return sharded_batch(fn, ('ocr48.decode_mem', beams_k, max_len,
                              max_finished_hypos),
                         model, memory, memory_mask)


# --------------------------------------------------------------------------
# Construction
# --------------------------------------------------------------------------

def build_ocr48(dict_size: int, device='cpu', state_dict=None,
                fold: bool = True) -> OCR48:
    """An eval-mode OCR48 on ``device``, optionally loaded from a torch
    state dict (checkpoint keys), with the backbone BNs folded."""
    from ..weights import load_state_dict_into
    model = OCR48(dict_size).eval()
    if state_dict is not None:
        load_state_dict_into(model, state_dict)
    if fold:
        fold_bn(model)
    return model.to(device)


def init_state_dict(dict_size: int, seed: int = 42) -> dict:
    """Seeded random weights in checkpoint layout (the JAX package's
    ``init_params`` scheme), for runs without the released checkpoint."""
    gen = torch.Generator().manual_seed(seed)
    model = OCR48(dict_size)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / m.in_features ** 0.5)
                m.bias.zero_()
        model.embd.weight.copy_(torch.randn(model.embd.weight.shape,
                                            generator=gen) * 0.02)
    return model.state_dict()
