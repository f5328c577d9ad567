"""Plain reference of the 32px OCR (``ocr.ckpt`` in ``ocr.zip``; reference
``ocr/model_32px.py``): the FAN ResNet [3, 6, 7, 5] with 2x2 tail convs,
sinusoidal positions, 3 post-LN encoder and 2 post-LN decoder layers
(torch ``MultiheadAttention`` parameters: 4 heads, FF 2048, ReLU), the
weight-tied char head; the decoder run teacher-forced over a whole served
sequence (causal, no cache, no beam).

A frozen copy of the program's module layout, so that the same checkpoint
loads into both; plain PyTorch, float32, batch norms unfolded. Every
product's operands pass through ``precision.r``. Imports nothing of the
program.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..precision import r

EMBD_DIM = 320
N_HEADS = 4
HEAD_DIM = EMBD_DIM // N_HEADS
N_ENCODERS = 3
N_DECODERS = 2
FF_DIM = 2048
LAYERS = (3, 6, 7, 5)
OUT_BLOCKS = (80, 160, 320, 320)
COLOR_HEADS = ('fg_r', 'fg_g', 'fg_b', 'bg_r', 'bg_g', 'bg_b')


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class BasicBlock(nn.Module):
    """Pre-activation BasicBlock (reference model_48px_ctc.py:372-403)."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = _conv3(cin, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = _conv3(planes, planes)
        self.downsample = (nn.Sequential(nn.BatchNorm2d(cin),
                                         nn.Conv2d(cin, planes, 1,
                                                   bias=False))
                           if cin != planes else None)

    def forward(self, x):
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        res = x if self.downsample is None else self.downsample(x)
        return out + res


class ResNetFeatures(nn.Module):
    """FAN ResNet: (N, 3, H, W) → (N, W', 320) tokens. ``layers`` are the
    four stages' block counts; ``tail`` the kernel of conv4_1 / conv4_2
    (3 for the 48px CTC model, 2 for the 32px model) and ``tail_pad``
    conv4_1's (row, column) padding."""

    def __init__(self, layers: Sequence[int], tail: int,
                 tail_pad: Tuple[int, int]):
        super().__init__()
        self.conv0_1 = _conv3(3, 40)
        self.bn0_1 = nn.BatchNorm2d(40)
        self.conv0_2 = _conv3(40, 40)
        inplanes = 40
        for li, (blocks, planes) in enumerate(zip(layers, OUT_BLOCKS),
                                              start=1):
            setattr(self, f'layer{li}', nn.Sequential(*[
                BasicBlock(inplanes if b == 0 else planes, planes)
                for b in range(blocks)]))
            inplanes = planes
        for i, c in ((1, 80), (2, 160), (3, 320)):
            setattr(self, f'bn{i}', nn.BatchNorm2d(c))
            setattr(self, f'conv{i}', _conv3(c, c))
        self.bn4_1 = nn.BatchNorm2d(320)
        self.conv4_1 = nn.Conv2d(320, 320, tail, (2, 1), tail_pad,
                                 bias=False)
        self.bn4_2 = nn.BatchNorm2d(320)
        self.conv4_2 = nn.Conv2d(320, 320, tail, bias=False)
        self.bn4_3 = nn.BatchNorm2d(320)

    def forward(self, x):
        x = self.conv0_2(F.relu(self.bn0_1(self.conv0_1(x))))
        x = F.avg_pool2d(x, 2, 2)
        x = self.layer1(x)
        x = self.conv1(F.relu(self.bn1(x)))
        x = F.avg_pool2d(x, 2, 2)
        x = self.layer2(x)
        x = self.conv2(F.relu(self.bn2(x)))
        x = F.avg_pool2d(x, 2, (2, 1), (0, 1))
        x = self.layer3(x)
        x = self.conv3(F.relu(self.bn3(x)))
        x = self.layer4(x)
        x = self.conv4_1(F.relu(self.bn4_1(x)))
        x = self.conv4_2(F.relu(self.bn4_2(x)))
        x = self.bn4_3(x)
        return x[:, :, 0, :].transpose(1, 2)


class Backbone(nn.Module):
    """The checkpoint's ``backbone.ConvNet`` scope."""

    def __init__(self, convnet: ResNetFeatures):
        super().__init__()
        self.ConvNet = convnet


@functools.lru_cache(maxsize=2)
def sinusoidal_pe(length: int, dim: int = EMBD_DIM) -> np.ndarray:
    pe = np.zeros((length, dim), np.float32)
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                      * (-np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def pe_table(length: int, device) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_pe(2048)[:length]).to(device)


class PackedAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` (``in_proj_weight`` (3E,
    E), ``in_proj_bias``, ``out_proj``), applied by ``attention``."""

    def __init__(self, dim: int = EMBD_DIM):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def project(self, x: torch.Tensor, which: int) -> torch.Tensor:
        """Projection ``which`` (0 q, 1 k, 2 v) of ``x``."""
        e = self.out_proj.in_features
        rows = slice(which * e, (which + 1) * e)
        return F.linear(r(x), r(self.in_proj_weight[rows]),
                        self.in_proj_bias[rows])


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    n, l, e = x.shape
    return x.view(n, l, heads, e // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    n, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(n, l, h * hd)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           key_mask=None) -> torch.Tensor:
    """Heads-split attention, scores and softmax in f32; ``key_mask`` (N,
    M) True masks a key."""
    scores = torch.einsum('nhqd,nhkd->nhqk', r(q.float()), r(k.float()))
    if key_mask is not None:
        scores = scores.masked_fill(key_mask[:, None, None, :],
                                    float('-inf'))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum('nhqk,nhkd->nhqd', r(w), r(v))


def attention(attn: PackedAttention, q_in, k_in, v_in, heads: int,
              key_mask=None) -> torch.Tensor:
    hd = attn.out_proj.in_features // heads
    q = split_heads(attn.project(q_in, 0) * (hd ** -0.5), heads)
    k = split_heads(attn.project(k_in, 1), heads)
    v = split_heads(attn.project(v_in, 2), heads)
    return attn.out_proj(merge_heads(attend(q, k, v, key_mask)))


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


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class OCR32(nn.Module):
    def __init__(self, dict_size: int):
        super().__init__()
        self.backbone = Backbone(ResNetFeatures(LAYERS, 2, (0, 1)))
        self.encoders = _Layers([EncoderLayer() for _ in range(N_ENCODERS)])
        self.decoders = _Layers([DecoderLayer() for _ in range(N_DECODERS)])
        self.embd = nn.Embedding(dict_size, EMBD_DIM)
        self.pred1 = nn.Sequential(nn.Linear(EMBD_DIM, EMBD_DIM))
        self.pred = _Bias(dict_size)
        self.color_pred1 = nn.Sequential(nn.Linear(EMBD_DIM, 64))
        for c in COLOR_HEADS:
            setattr(self, f'{c}_pred', nn.Linear(64, 1))


def build(state_dict, dict_size: int, device) -> OCR32:
    model = OCR32(dict_size).eval()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device)


@torch.no_grad()
def memory(model: OCR32, images: torch.Tensor, valid_widths: torch.Tensor):
    """images (N, 32, W, 3) in [-1, 1] -> (memory (N, M, 320), mask (N, M),
    True = padding)."""
    x = model.backbone.ConvNet(images.permute(0, 3, 1, 2).contiguous()
                               .float())
    m = x.shape[1]
    valid = (valid_widths.long() + 3) // 4 + 2
    mask = (torch.arange(m, device=x.device)[None, :]
            >= valid.clamp(max=m)[:, None])
    x = x + pe_table(m, x.device)
    for layer in model.encoders.layers:
        x = layer(x, mask)
    return x, mask


@torch.no_grad()
def sequence_logprobs(model: OCR32, mem: torch.Tensor, mem_mask: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode: ``tokens`` (N, T) decoder inputs (START
    first) -> log-probs (N, T, V) of the next token at each position."""
    t_len = tokens.shape[1]
    causal = torch.ones((t_len, t_len), dtype=torch.bool,
                        device=mem.device).triu(1)
    x = model.embd.weight[tokens] + pe_table(t_len, mem.device)
    for layer in model.decoders.layers:
        sa, ca = layer.self_attn, layer.multihead_attn
        q = split_heads(sa.project(x, 0) * HEAD_DIM ** -0.5, N_HEADS)
        k = split_heads(sa.project(x, 1), N_HEADS)
        v = split_heads(sa.project(x, 2), N_HEADS)
        s = torch.einsum('nhqd,nhkd->nhqk', r(q), r(k)).masked_fill(
            causal, float('-inf'))
        a = torch.einsum('nhqk,nhkd->nhqd', r(torch.softmax(s, dim=-1)),
                         r(v))
        x = layer.norm1(x + sa.out_proj(merge_heads(a)))
        x = layer.norm2(x + attention(ca, x, mem, mem, N_HEADS, mem_mask))
        x = layer.norm3(x + layer.ff(x))
    h = F.relu(model.pred1(x))
    logits = torch.einsum('nte,ve->ntv', r(h), r(model.embd.weight)) \
        + model.pred.bias
    return torch.log_softmax(logits.float(), dim=-1)
