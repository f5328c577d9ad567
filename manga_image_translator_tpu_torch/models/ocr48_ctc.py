"""48px CTC OCR model — PyTorch port.

Counterpart of the JAX package's ``models/ocr48_ctc.py`` (checkpoint
``ocr-ctc.ckpt``; reference ``ocr/model_48px_ctc.py:163-455``): a FAN-style
ResNet feature extractor (pre-activation BasicBlocks, layers [4, 6, 8, 6],
320 channels at one row), 3 pre-LN transformer encoder layers (torch
MultiheadAttention with a packed in_proj, sinusoidal PE added to q/k only),
a LayerNorm + GELU char head for CTC and a clamped 6-channel colour head.

Fully feed-forward: one forward per crop chunk; greedy CTC decode runs on
the host (``ocr/model_48px_ctc.py``). Module names follow the checkpoint's
keys. Convolutions and matrix products are plain PyTorch (cuDNN and cuBLAS
on the card), as the JAX package leaves them to XLA. The FAN backbone and
the sinusoidal PE are shared with the 32px model (``models/ocr32.py``).
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

EMBD_DIM = 320
N_HEADS = 8
HEAD_DIM = EMBD_DIM // N_HEADS
N_LAYERS = 3
FF_DIM = EMBD_DIM * 4
LAYERS = (4, 6, 8, 6)
OUT_BLOCKS = (80, 160, 320, 320)
BLANK = 0


# --------------------------------------------------------------------------
# FAN ResNet feature extractor (shared with the 32px model)
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# torch MultiheadAttention with a packed in_proj
# --------------------------------------------------------------------------

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
        return F.linear(x, self.in_proj_weight[which * e:(which + 1) * e],
                        self.in_proj_bias[which * e:(which + 1) * e])


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
    scores = torch.einsum('nhqd,nhkd->nhqk', q.float(), k.float())
    if key_mask is not None:
        scores = scores.masked_fill(key_mask[:, None, None, :],
                                    float('-inf'))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum('nhqk,nhkd->nhqd', w, v)


def attention(attn: PackedAttention, q_in, k_in, v_in, heads: int,
              key_mask=None) -> torch.Tensor:
    hd = attn.out_proj.in_features // heads
    q = split_heads(attn.project(q_in, 0) * (hd ** -0.5), heads)
    k = split_heads(attn.project(k_in, 1), heads)
    v = split_heads(attn.project(v_in, 2), heads)
    return attn.out_proj(merge_heads(attend(q, k, v, key_mask)))


# --------------------------------------------------------------------------
# The CTC model
# --------------------------------------------------------------------------

class EncoderLayer(nn.Module):
    """Pre-LN layer, sinusoidal PE added to q and k only, GELU FF."""

    def __init__(self):
        super().__init__()
        self.self_attn = PackedAttention()
        self.linear1 = nn.Linear(EMBD_DIM, FF_DIM)
        self.linear2 = nn.Linear(FF_DIM, EMBD_DIM)
        self.norm1 = nn.LayerNorm(EMBD_DIM, eps=1e-5)
        self.norm2 = nn.LayerNorm(EMBD_DIM, eps=1e-5)

    def forward(self, x, pe):
        normed = self.norm1(x)
        pe_normed = normed + pe
        x = x + attention(self.self_attn, pe_normed, pe_normed, normed,
                          N_HEADS)
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class OCR48CTC(nn.Module):
    def __init__(self, dict_size: int):
        super().__init__()
        self.backbone = Backbone(ResNetFeatures(LAYERS, 3, (1, 1)))
        self.encoders = _Layers([EncoderLayer() for _ in range(N_LAYERS)])
        self.char_pred_norm = nn.Sequential(nn.LayerNorm(EMBD_DIM, eps=1e-5))
        self.char_pred = nn.Linear(EMBD_DIM, dict_size)
        self.color_pred1 = nn.Sequential(nn.Linear(EMBD_DIM, 6))


@torch.no_grad()
def ctc_forward(model: OCR48CTC, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 48, W, 3) in [-1, 1] → (char log-probs (N, T, V) f32, colours
    (N, T, 6) clamped to [0, 1])."""
    feats = model.backbone.ConvNet(images.permute(0, 3, 1, 2).contiguous())
    pe = pe_table(feats.shape[1], feats.device).to(feats.dtype)
    for layer in model.encoders.layers:
        feats = layer(feats, pe)
    h = F.gelu(model.char_pred_norm(feats))
    logits = model.char_pred(h)
    colors = torch.clamp(model.color_pred1(feats), 0, 1)
    return torch.log_softmax(logits.float(), -1), colors


def build_ocr48_ctc(dict_size: int, device='cpu', state_dict=None
                    ) -> OCR48CTC:
    from ..weights import load_state_dict_into
    model = OCR48CTC(dict_size).eval()
    if state_dict is not None:
        load_state_dict_into(model, state_dict)
    return model.to(device)


def init_state_dict(dict_size: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights with the checkpoint's keys and shapes: the
    JAX package's ``init_params`` draws (same seed, order and scale, in its
    HWIO / (I, O) layout), bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(31)
    params: Dict[str, np.ndarray] = {}
    conv, bn, dense, ln = _init_helpers(rs, params)
    _init_backbone(conv, bn, LAYERS, 3)
    for i in range(N_LAYERS):
        pre = f'encoders.layers.{i}'
        params[f'{pre}.self_attn.in_proj_weight'] = (
            rs.randn(EMBD_DIM, 3 * EMBD_DIM).astype(np.float32)
            / np.sqrt(EMBD_DIM)).astype(np.float32)
        params[f'{pre}.self_attn.in_proj_bias'] = np.zeros(
            (3 * EMBD_DIM,), np.float32)
        dense(f'{pre}.self_attn.out_proj', EMBD_DIM, EMBD_DIM)
        dense(f'{pre}.linear1', EMBD_DIM, FF_DIM)
        dense(f'{pre}.linear2', FF_DIM, EMBD_DIM)
        ln(f'{pre}.norm1', EMBD_DIM)
        ln(f'{pre}.norm2', EMBD_DIM)
    ln('char_pred_norm.0', EMBD_DIM)
    dense('char_pred', EMBD_DIM, dict_size)
    dense('color_pred1.0', EMBD_DIM, 6)
    return torch_state_dict_from_jax(params)


def _init_helpers(rs: np.random.RandomState, params: Dict):
    """The JAX ``init_params`` draw helpers, writing numpy arrays."""

    def conv(key, kh, kw, ci, co):
        params[key + '.weight'] = (rs.randn(kh, kw, ci, co).astype(np.float32)
                                   * np.sqrt(2.0 / (kh * kw * ci))
                                   ).astype(np.float32)

    def bn(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)
        params[key + '.running_mean'] = np.zeros((c,), np.float32)
        params[key + '.running_var'] = np.ones((c,), np.float32)

    def dense(key, i, o):
        params[key + '.weight'] = (rs.randn(i, o).astype(np.float32)
                                   / np.sqrt(i)).astype(np.float32)
        params[key + '.bias'] = np.zeros((o,), np.float32)

    def ln(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)

    return conv, bn, dense, ln


def _init_backbone(conv, bn, layers: Sequence[int], tail: int) -> None:
    bb = 'backbone.ConvNet'
    conv(f'{bb}.conv0_1', 3, 3, 3, 40)
    bn(f'{bb}.bn0_1', 40)
    conv(f'{bb}.conv0_2', 3, 3, 40, 40)
    inplanes = 40
    for li, (blocks, planes) in enumerate(zip(layers, OUT_BLOCKS), start=1):
        for b in range(blocks):
            pre = f'{bb}.layer{li}.{b}'
            cin = inplanes if b == 0 else planes
            bn(f'{pre}.bn1', cin)
            conv(f'{pre}.conv1', 3, 3, cin, planes)
            bn(f'{pre}.bn2', planes)
            conv(f'{pre}.conv2', 3, 3, planes, planes)
            if b == 0 and inplanes != planes:
                bn(f'{pre}.downsample.0', inplanes)
                conv(f'{pre}.downsample.1', 1, 1, inplanes, planes)
        inplanes = planes
    for i, c in ((1, 80), (2, 160), (3, 320)):
        bn(f'{bb}.bn{i}', c)
        conv(f'{bb}.conv{i}', 3, 3, c, c)
    bn(f'{bb}.bn4_1', 320)
    conv(f'{bb}.conv4_1', tail, tail, 320, 320)
    bn(f'{bb}.bn4_2', 320)
    conv(f'{bb}.conv4_2', tail, tail, 320, 320)
    bn(f'{bb}.bn4_3', 320)
