"""PaddleOCR-style DB text detector — PyTorch port.

Counterpart of the JAX package's ``models/paddle_det.py``. The reference's
``Detector.paddle`` runs a PaddleOCR detection model under ONNX Runtime in
an external Rust wheel (reference ``detection/common_rust.py:14-63``); the
JAX package re-implemented that architecture, and this is its port: a
MobileNetV3-large ×0.5 backbone (hard-swish, squeeze-excite) → DB-FPN
feature fusion → DB head. ``detection/paddle_onnx.py`` maps the ONNX
artifact's weights onto these module names. Plain PyTorch; internally
NCHW, ``paddle_det_forward`` keeps the JAX package's NHWC interface.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# MobileNetV3-large ×0.5 residual config:
# (kernel, expand, out, use_se, act, stride)
_MNV3_CFG = [
    (3, 8, 8, False, 'relu', 1),
    (3, 32, 12, False, 'relu', 2),
    (3, 40, 12, False, 'relu', 1),
    (5, 40, 20, True, 'relu', 2),
    (5, 60, 20, True, 'relu', 1),
    (5, 60, 20, True, 'relu', 1),
    (3, 120, 40, False, 'hswish', 2),
    (3, 100, 40, False, 'hswish', 1),
    (3, 92, 40, False, 'hswish', 1),
    (3, 92, 40, False, 'hswish', 1),
    (3, 240, 56, True, 'hswish', 1),
    (3, 336, 56, True, 'hswish', 1),
    (5, 336, 80, True, 'hswish', 2),
    (5, 480, 80, True, 'hswish', 1),
    (5, 480, 80, True, 'hswish', 1),
]
FPN_CHANNELS = 96

# the DB head's 2×2 transposed convs
TRANSPOSED_CONV_PATTERNS = (r'head\.(binarize|thresh)\.conv[23]\.weight',)


def _hswish(x):
    """x · clip(x + 3, 0, 6) / 6, written out as the JAX package does."""
    return x * torch.clamp(x + 3, 0, 6) / 6


def _hsigmoid(x):
    """clip(x + 3, 0, 6) / 6 (slope 1/6, not Paddle's 0.2)."""
    return torch.clamp(x + 3, 0, 6) / 6


def _act(x, act):
    if act == 'relu':
        return F.relu(x)
    if act == 'hswish':
        return _hswish(x)
    return x


class ConvBN(nn.Module):
    def __init__(self, ci: int, co: int, k: int, stride: int = 1,
                 groups: int = 1, act=None):
        super().__init__()
        self.conv = nn.Conv2d(ci, co, k, stride, k // 2, groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(co, eps=1e-5)
        self.act = act

    def forward(self, x):
        return _act(self.bn(self.conv(x)), self.act)


class SE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c // 4, 1)
        self.conv2 = nn.Conv2d(c // 4, c, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * _hsigmoid(self.conv2(F.relu(self.conv1(s))))


class ResidualUnit(nn.Module):
    def __init__(self, ci: int, k: int, e: int, o: int, se: bool, act: str,
                 stride: int):
        super().__init__()
        self.expand = ConvBN(ci, e, 1, act=act)
        self.depthwise = ConvBN(e, e, k, stride, groups=e, act=act)
        self.se = SE(e) if se else None
        self.linear = ConvBN(e, o, 1)
        self.residual = stride == 1 and ci == o

    def forward(self, x):
        y = self.depthwise(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.linear(y)
        return y + x if self.residual else y


class MobileNetV3(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBN(3, 8, 3, 2, act='hswish')
        cin = 8
        for i, (k, e, o, se, act, s) in enumerate(_MNV3_CFG):
            self.add_module(f'block{i}', ResidualUnit(cin, k, e, o, se, act,
                                                      s))
            cin = o
        self.conv_last = ConvBN(cin, 480, 1, act='hswish')

    def forward(self, x) -> List[torch.Tensor]:
        """→ [c1 (1/4), c2 (1/8), c3 (1/16), c4 (1/32)]."""
        x = self.conv0(x)
        feats = []
        for i, cfg in enumerate(_MNV3_CFG):
            if cfg[5] == 2:
                feats.append(x)
            x = getattr(self, f'block{i}')(x)
        feats.append(self.conv_last(x))
        return feats[1:]


def _up(x, s: int):
    return x.repeat_interleave(s, 2).repeat_interleave(s, 3)


class DBFPN(nn.Module):
    """1×1 laterals, top-down nearest upsampling, 3×3 smoothing convs,
    concatenated at 1/4 scale."""

    def __init__(self):
        super().__init__()
        for name, c in zip(('in2', 'in3', 'in4', 'in5'), (12, 20, 56, 480)):
            self.add_module(name, nn.Conv2d(c, FPN_CHANNELS, 1))
        for name in ('p2', 'p3', 'p4', 'p5'):
            self.add_module(name, nn.Conv2d(FPN_CHANNELS,
                                            FPN_CHANNELS // 4, 3, 1, 1))

    def forward(self, feats):
        c1, c2, c3, c4 = feats
        in5 = self.in5(c4)
        out4 = self.in4(c3) + _up(in5, 2)
        out3 = self.in3(c2) + _up(out4, 2)
        out2 = self.in2(c1) + _up(out3, 2)
        return torch.cat([_up(self.p5(in5), 8), _up(self.p4(out4), 4),
                          _up(self.p3(out3), 2), self.p2(out2)], 1)


class HeadBranch(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(FPN_CHANNELS, 24, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(24, eps=1e-5)
        self.conv2 = nn.ConvTranspose2d(24, 24, 2, 2, 0)
        self.bn2 = nn.BatchNorm2d(24, eps=1e-5)
        self.conv3 = nn.ConvTranspose2d(24, 1, 2, 2, 0)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return torch.sigmoid(self.conv3(h))


class DBHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.binarize = HeadBranch()
        self.thresh = HeadBranch()

    def forward(self, x):
        return torch.cat([self.binarize(x), self.thresh(x)], 1)


class PaddleDet(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = MobileNetV3()
        self.neck = DBFPN()
        self.head = DBHead()

    def forward(self, x):
        """x: (N, 3, H, W) ImageNet-normalised → (N, 2, H, W) shrink +
        threshold maps."""
        return self.head(self.neck(self.backbone(x)))


def paddle_det_forward(model: PaddleDet, x: torch.Tensor) -> torch.Tensor:
    """NHWC interface: (N, H, W, 3) → (N, H, W, 2)."""
    return model(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


def build_paddle_det(device='cpu', state_dict=None) -> PaddleDet:
    from ..weights import load_state_dict_into
    model = PaddleDet().eval()
    if state_dict is not None:
        load_state_dict_into(model, state_dict)
    return model.to(device)


def init_state_dict() -> Dict[str, torch.Tensor]:
    """Seeded random weights: the JAX package's ``init_params`` draws (same
    seed, order and scale), bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(47)
    params: Dict[str, np.ndarray] = {}

    def conv(key, kh, kw, ci, co, groups=1, bias=False):
        params[key + '.weight'] = (
            rs.randn(kh, kw, ci // groups, co).astype(np.float32)
            * np.sqrt(2.0 / (kh * kw * max(ci // groups, 1)))
        ).astype(np.float32)
        if bias:
            params[key + '.bias'] = np.zeros((co,), np.float32)

    def bn(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)
        params[key + '.running_mean'] = np.zeros((c,), np.float32)
        params[key + '.running_var'] = np.ones((c,), np.float32)

    def conv_bn(key, kh, ci, co, groups=1):
        conv(f'{key}.conv', kh, kh, ci, co, groups=groups)
        bn(f'{key}.bn', co)

    conv_bn('backbone.conv0', 3, 3, 8)
    cin = 8
    for i, (k, e, o, se, act, s) in enumerate(_MNV3_CFG):
        pre = f'backbone.block{i}'
        conv_bn(f'{pre}.expand', 1, cin, e)
        conv_bn(f'{pre}.depthwise', k, e, e, groups=e)
        if se:
            conv(f'{pre}.se.conv1', 1, 1, e, e // 4, bias=True)
            conv(f'{pre}.se.conv2', 1, 1, e // 4, e, bias=True)
        conv_bn(f'{pre}.linear', 1, e, o)
        cin = o
    conv_bn('backbone.conv_last', 1, cin, 480)
    for name, c in zip(('in2', 'in3', 'in4', 'in5'), (12, 20, 56, 480)):
        conv(f'neck.{name}', 1, 1, c, FPN_CHANNELS, bias=True)
    for name in ('p2', 'p3', 'p4', 'p5'):
        conv(f'neck.{name}', 3, 3, FPN_CHANNELS, FPN_CHANNELS // 4,
             bias=True)
    for head in ('binarize', 'thresh'):
        conv(f'head.{head}.conv1', 3, 3, FPN_CHANNELS, 24)
        bn(f'head.{head}.bn1', 24)
        conv(f'head.{head}.conv2', 2, 2, 24, 24, bias=True)
        bn(f'head.{head}.bn2', 24)
        conv(f'head.{head}.conv3', 2, 2, 24, 1, bias=True)
    return torch_state_dict_from_jax(params, TRANSPOSED_CONV_PATTERNS)

