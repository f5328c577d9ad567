"""ComicTextDetector (ctd) network — PyTorch port.

Counterpart of the JAX package's ``models/ctd.py`` (checkpoint
``comictextdetector.pt``; reference ``detection/ctd_utils/basemodel.py`` +
``ctd_utils/yolov5/common.py``): the yolov5s backbone (Focus stem,
Conv/C3/SPP blocks, SiLU), the UnetHead (C3 up blocks + transposed convs →
text pixel mask, leaky ReLU 0.1) and the C3-based DBHead (shrink +
threshold line maps). The YOLO Detect head's block boxes are unused at
inference (reference ctd.py:169-176), so it is not ported.

Module names follow the checkpoint's three parts, prefixed ``blk_det.``,
``text_seg.`` and ``text_det.`` (``detection/ctd.py`` flattens them).
Convolutions, BN and transposed convolutions are plain PyTorch (cuDNN on
the card), as the JAX package leaves them to XLA. Internally NCHW;
``ctd_forward`` keeps the JAX package's NHWC interface.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

TRANSPOSED_CONV_PATTERNS = (
    r'text_seg\.upconv\d\.conv\.1\.weight',
    r'text_seg\.upconv6\.0\.weight',
    r'text_det\.upconv\d\.conv\.1\.weight',
    r'text_det\.(binarize|thresh)\.[36]\.weight',
)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == 'silu':
        return F.silu(x)
    return F.leaky_relu(x, 0.1)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class ConvBnAct(nn.Module):
    def __init__(self, ci: int, co: int, k: int, stride: int = 1,
                 act: str = 'silu'):
        super().__init__()
        self.conv = nn.Conv2d(ci, co, k, stride, k // 2, bias=False)
        self.bn = _bn(co)
        self.act = act

    def forward(self, x):
        return _act(self.bn(self.conv(x)), self.act)


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool, act: str):
        super().__init__()
        self.cv1 = ConvBnAct(c, c, 1, act=act)
        self.cv2 = ConvBnAct(c, c, 3, act=act)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3(nn.Module):
    def __init__(self, ci: int, co: int, n: int, shortcut: bool = True,
                 act: str = 'silu'):
        super().__init__()
        cm = co // 2
        self.cv1 = ConvBnAct(ci, cm, 1, act=act)
        self.cv2 = ConvBnAct(ci, cm, 1, act=act)
        self.cv3 = ConvBnAct(2 * cm, co, 1, act=act)
        self.m = nn.Sequential(*[Bottleneck(cm, shortcut, act)
                                 for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class Focus(nn.Module):
    """Space-to-depth slice + conv (yolov5 Focus)."""

    def __init__(self, act: str):
        super().__init__()
        self.conv = ConvBnAct(12, 32, 3, act=act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                   1))


class SPP(nn.Module):
    def __init__(self, ci: int, co: int, act: str):
        super().__init__()
        self.cv1 = ConvBnAct(ci, ci // 2, 1, act=act)
        self.cv2 = ConvBnAct(ci // 2 * 4, co, 1, act=act)

    def forward(self, x):
        y = self.cv1(x)
        # max_pool2d pads with -inf, as the JAX reduce_window does
        pools = [y] + [F.max_pool2d(y, k, 1, k // 2) for k in (5, 9, 13)]
        return self.cv2(torch.cat(pools, 1))


class Backbone(nn.Module):
    """yolov5s (depth 0.33, width 0.5); ``forward`` gives the five taps
    (f160, f80, f40, f20, f3) of the JAX ``backbone_features``."""

    def __init__(self, act: str = 'silu'):
        super().__init__()
        self.model = nn.ModuleList([
            Focus(act),                        # 0: 3 → 32, /2
            ConvBnAct(32, 64, 3, 2, act),      # 1: /4  → f160
            C3(64, 64, 1, act=act),            # 2
            ConvBnAct(64, 128, 3, 2, act),     # 3: /8  → f80
            C3(128, 128, 3, act=act),          # 4
            ConvBnAct(128, 256, 3, 2, act),    # 5: /16 → f40
            C3(256, 256, 3, act=act),          # 6
            ConvBnAct(256, 512, 3, 2, act),    # 7: /32 → f20
            SPP(512, 512, act),                # 8
            C3(512, 512, 1, shortcut=False, act=act),   # 9 → f3
        ])

    def forward(self, x):
        feats = []
        for layer in self.model:
            x = layer(x)
            feats.append(x)
        return feats[1], feats[3], feats[5], feats[7], feats[9]


class UpC3(nn.Module):
    """C3 + 4×4 s2 transposed conv + BN + ReLU (basemodel.py:15-26);
    ``conv`` indices match the checkpoint."""

    def __init__(self, cin: int, mid: int, out: int, act: str):
        super().__init__()
        self.conv = nn.Sequential(
            C3(cin + mid, mid, 1, act=act),
            nn.ConvTranspose2d(mid, out, 4, 2, 1, bias=False),
            _bn(out), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class _DownC3(nn.Module):
    def __init__(self, act: str):
        super().__init__()
        self.conv = C3(512, 512, 1, act=act)

    def forward(self, x):
        return self.conv(F.avg_pool2d(x, 2, 2))


class UnetHead(nn.Module):
    def __init__(self, act: str = 'leaky'):
        super().__init__()
        self.down_conv1 = _DownC3(act)
        self.upconv0 = UpC3(0, 512, 256, act)
        self.upconv2 = UpC3(256, 512, 256, act)
        self.upconv3 = UpC3(0, 512, 256, act)
        self.upconv4 = UpC3(128, 256, 128, act)
        self.upconv5 = UpC3(64, 128, 64, act)
        self.upconv6 = nn.Sequential(
            nn.ConvTranspose2d(64, 1, 4, 2, 1, bias=False))

    def forward(self, f160, f80, f40, f20, f3):
        """→ (mask (N, 1, H, W), (f80, f40, u40) for the DB head)."""
        u20 = self.upconv0(self.down_conv1(f3))
        u40 = self.upconv2(torch.cat([f20, u20], 1))
        u80 = self.upconv3(torch.cat([f40, u40], 1))
        u160 = self.upconv4(torch.cat([f80, u80], 1))
        u320 = self.upconv5(torch.cat([f160, u160], 1))
        return torch.sigmoid(self.upconv6(u320)), (f80, f40, u40)


def _db_branch(bias: bool) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(64, 16, 3, 1, 1, bias=bias), _bn(16), nn.ReLU(),
        nn.ConvTranspose2d(16, 16, 2, 2, 0), _bn(16), nn.ReLU(),
        nn.ConvTranspose2d(16, 1, 2, 2, 0), nn.Sigmoid())


class DBHead(nn.Module):
    """ctd DBHead inference: concat(sigmoid(shrink), sigmoid(thresh)) at
    the input resolution. The threshold branch's first conv is
    bias-free."""

    def __init__(self, act: str = 'leaky'):
        super().__init__()
        self.upconv3 = UpC3(0, 512, 256, act)
        self.upconv4 = UpC3(128, 256, 128, act)
        self.conv = nn.Sequential(nn.Conv2d(128, 64, 1), _bn(64), nn.ReLU())
        self.binarize = _db_branch(True)
        self.thresh = _db_branch(False)

    def forward(self, f80, f40, u40):
        u80 = self.upconv3(torch.cat([f40, u40], 1))
        x = self.conv(self.upconv4(torch.cat([f80, u80], 1)))
        return torch.cat([self.binarize(x), self.thresh(x)], 1)


class ComicTextDetectorNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.blk_det = Backbone('silu')
        self.text_seg = UnetHead('leaky')
        self.text_det = DBHead('leaky')

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, 3, H, W) in [0, 1] → (mask (N, 1, H, W), lines (N, 2, H,
        W))."""
        feats = self.blk_det(x)
        mask, (f80, f40, u40) = self.text_seg(*feats)
        return mask, self.text_det(f80, f40, u40)


def ctd_forward(model: ComicTextDetectorNet, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC interface of the JAX package: x (N, H, W, 3) in [0, 1] →
    (mask (N, H, W, 1), lines (N, H, W, 2))."""
    mask, lines = model(x.permute(0, 3, 1, 2).contiguous())
    return mask.permute(0, 2, 3, 1), lines.permute(0, 2, 3, 1)


def build_ctd(device='cpu', state_dict=None) -> ComicTextDetectorNet:
    """An eval-mode network on ``device``, optionally loaded (strictly) from
    a flattened torch state dict."""
    from ..weights import load_state_dict_into
    model = ComicTextDetectorNet().eval()
    if state_dict is not None:
        load_state_dict_into(model, state_dict)
    return model.to(device)


def init_state_dict() -> Dict[str, torch.Tensor]:
    """Seeded random weights with the checkpoint's keys and shapes: the
    JAX package's ``init_params`` draws (same seed, order and scale, in its
    HWIO layout), bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(29)
    params: Dict[str, np.ndarray] = {}

    def conv(key, kh, kw, ci, co, bias=False):
        params[key + '.weight'] = (rs.randn(kh, kw, ci, co).astype(np.float32)
                                   * np.sqrt(2.0 / (kh * kw * ci))
                                   ).astype(np.float32)
        if bias:
            params[key + '.bias'] = np.zeros((co,), np.float32)

    def bn(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)
        params[key + '.running_mean'] = np.zeros((c,), np.float32)
        params[key + '.running_var'] = np.ones((c,), np.float32)

    def cba(key, ci, co, k):
        conv(f'{key}.conv', k, k, ci, co)
        bn(f'{key}.bn', co)

    def c3(key, ci, co, n, e=0.5):
        cm = int(co * e)
        cba(f'{key}.cv1', ci, cm, 1)
        cba(f'{key}.cv2', ci, cm, 1)
        cba(f'{key}.cv3', 2 * cm, co, 1)
        for i in range(n):
            cba(f'{key}.m.{i}.cv1', cm, cm, 1)
            cba(f'{key}.m.{i}.cv2', cm, cm, 3)

    bb = 'blk_det'
    cba(f'{bb}.model.0.conv', 12, 32, 3)
    cba(f'{bb}.model.1', 32, 64, 3)
    c3(f'{bb}.model.2', 64, 64, 1)
    cba(f'{bb}.model.3', 64, 128, 3)
    c3(f'{bb}.model.4', 128, 128, 3)
    cba(f'{bb}.model.5', 128, 256, 3)
    c3(f'{bb}.model.6', 256, 256, 3)
    cba(f'{bb}.model.7', 256, 512, 3)
    cba(f'{bb}.model.8.cv1', 512, 256, 1)
    cba(f'{bb}.model.8.cv2', 256 * 4, 512, 1)
    c3(f'{bb}.model.9', 512, 512, 1)

    def up_c3(key, cin, mid, out):
        c3(f'{key}.conv.0', cin + mid, mid, 1)
        conv(f'{key}.conv.1', 4, 4, mid, out)
        bn(f'{key}.conv.2', out)

    seg = 'text_seg'
    c3(f'{seg}.down_conv1.conv', 512, 512, 1)
    up_c3(f'{seg}.upconv0', 0, 512, 256)
    up_c3(f'{seg}.upconv2', 256, 512, 256)
    up_c3(f'{seg}.upconv3', 0, 512, 256)
    up_c3(f'{seg}.upconv4', 128, 256, 128)
    up_c3(f'{seg}.upconv5', 64, 128, 64)
    conv(f'{seg}.upconv6.0', 4, 4, 64, 1)

    det = 'text_det'
    up_c3(f'{det}.upconv3', 0, 512, 256)
    up_c3(f'{det}.upconv4', 128, 256, 128)
    conv(f'{det}.conv.0', 1, 1, 128, 64, bias=True)
    bn(f'{det}.conv.1', 64)
    for head in ('binarize', 'thresh'):
        conv(f'{det}.{head}.0', 3, 3, 64, 16, bias=head == 'binarize')
        bn(f'{det}.{head}.1', 16)
        conv(f'{det}.{head}.3', 2, 2, 16, 16, bias=True)
        bn(f'{det}.{head}.4', 16)
        conv(f'{det}.{head}.6', 2, 2, 16, 1, bias=True)
    return torch_state_dict_from_jax(params, TRANSPOSED_CONV_PATTERNS)
