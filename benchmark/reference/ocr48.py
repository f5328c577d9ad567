"""Plain reference of the 48px OCR (reference ``ocr/model_48px.py:183-855``
with ``ocr/xpos_relative_position.py``): the ConvNeXt feature extractor,
four pre-LN XPOS encoder layers, and five pre-LN decoder layers with the
weight-tied char head, run teacher-forced over a whole served sequence
(causal self-attention, no cache, no beam).

A frozen copy of the program's module layout, so that the same checkpoint
loads into both; plain PyTorch, float32, batch norms unfolded. Every
product's inputs pass through ``precision.r`` (the identity unless a
control computes in a lower precision). Imports nothing of the program.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..precision import r

EMBD_DIM = 320
N_HEADS = 4
HEAD_DIM = EMBD_DIM // N_HEADS
N_ENCODERS = 4
N_DECODERS = 5
FF_DIM = 2048
XPOS_SCALE_BASE = EMBD_DIM

START_TOK, END_TOK, PAD_TOK = 1, 2, 0



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
    scores = torch.einsum('nhqd,nhkd->nhqk', r(q.float()), r(k.float()))
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                    float('-inf'))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum('nhqk,nhkd->nhqd', r(w), r(v))
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


def build(state_dict, dict_size: int, device) -> OCR48:
    model = OCR48(dict_size).eval()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device)


@torch.no_grad()
def memory(model: OCR48, images: torch.Tensor, valid_widths: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (N, 48, W, 3) in [-1, 1], valid pixel widths (N,) ->
    (encoder memory (N, W/4, 320), mask (N, W/4), True = padding)."""
    x = convnext_features(model.backbone, images.float())
    m = x.shape[1]
    valid = (valid_widths.long() + 3) // 4 + 2
    mask = (torch.arange(m, device=x.device)[None, :]
            >= valid.clamp(max=m)[:, None])
    for layer in model.encoders:
        x = layer(x, mask)
    return x, mask


def _attend(q, k, v, hidden):
    """q (N, H, T, D), k/v (N, H, S, D), ``hidden`` broadcast to (N, H, T,
    S), True where a key is hidden."""
    s = torch.einsum('nhtd,nhsd->nhts', r(q), r(k))
    s = s.masked_fill(hidden, float('-inf'))
    return torch.einsum('nhts,nhsd->nhtd', r(torch.softmax(s, dim=-1)), r(v))


@torch.no_grad()
def sequence_logprobs(model: OCR48, mem: torch.Tensor, mem_mask: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode: ``tokens`` (N, T) decoder inputs (START
    first) -> log-probs (N, T, V) of the next token at each position. Step
    t's self-attention query and key sit at position t with XPOS exponents
    +t and -t; its cross-attention query at position t with exponent
    (t + 1) // 2 - 1; the memory keys at their positions, centred."""
    n, t_len = tokens.shape
    m = mem.shape[1]
    steps = np.arange(t_len)
    mpos = np.arange(m)
    causal = torch.ones((t_len, t_len), dtype=torch.bool,
                        device=mem.device).triu(1)[None, None]
    cross_hidden = mem_mask[:, None, None, :]
    x = model.embd.weight[tokens]
    scale = HEAD_DIM ** -0.5
    for layer in model.decoders:
        sa, ca = layer.self_attn, layer.multihead_attn
        xn = layer.norm1(x)
        q = apply_xpos(_split_heads(sa.q_proj(xn) * scale), steps, steps,
                       downscale=False)
        k = apply_xpos(_split_heads(sa.k_proj(xn)), steps, steps,
                       downscale=True)
        v = _split_heads(sa.v_proj(xn))
        x = x + sa.out_proj(_merge_heads(_attend(q, k, v, causal)))
        xn = layer.norm2(x)
        q2 = apply_xpos(_split_heads(ca.q_proj(xn) * scale), steps,
                        (steps + 1) // 2 - 1, downscale=False)
        k2 = apply_xpos(_split_heads(ca.k_proj(mem)), mpos,
                        mpos - (m + 1) // 2, downscale=True)
        v2 = _split_heads(ca.v_proj(mem))
        x = x + ca.out_proj(_merge_heads(_attend(q2, k2, v2, cross_hidden)))
        xn = layer.norm3(x)
        x = x + layer.linear2(F.relu(layer.linear1(xn)))
    h = F.gelu(model.pred1(x))
    logits = torch.einsum('nte,ve->ntv', r(h), r(model.embd.weight)) \
        + model.pred.bias
    return torch.log_softmax(logits.float(), dim=-1)
