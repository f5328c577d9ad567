"""DBNet-ConvNeXt text detector — PyTorch port.

Counterpart of the JAX package's ``models/dbnet_convnext.py`` (reference
``detection/dbnet_convnext.py``): a timm-style ConvNeXt backbone (depths
3/3/27/3, dims 128/256/512/1024, patch-4 stem, layer-normed downsample
convs), two more ConvNeXt down stages, six UpconvSkip blocks (a ConvNeXt
block + a 2×2 transposed conv), a BN-free SiLU DB head and a SiLU mask
head. Layer norm runs over the channels (channels-last, eps 1e-6), GELU is
exact.

The reference registers this detector with an empty checkpoint URL: no
weights were ever released, so random init is the only mode upstream too;
the module names follow timm's, so a state dict in that layout loads with
``load_state_dict``. Plain PyTorch; internally NCHW, ``dbnet_convnext_
forward`` keeps the JAX package's NHWC interface.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEPTHS = (3, 3, 27, 3)
DIMS = (128, 256, 512, 1024)
_UPS = [('upconv1', 1024, 128), ('upconv2', 128 + 1024, 128),
        ('upconv3', 128 + 1024, 128), ('upconv4', 128 + 512, 128),
        ('upconv5', 128 + 256, 128), ('upconv6', 128 + 128, 64)]

TRANSPOSED_CONV_PATTERNS = (
    r'upconv\d\.upconv\.weight',
    r'conv_db\.(binarize|thresh)\.[24]\.weight',
)


class LayerNorm2d(nn.LayerNorm):
    """Layer norm over the channels of an NCHW tensor."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _Shortcut(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv = nn.Conv2d(ci, co, 1)

    def forward(self, x):
        return self.conv(x)


class _Mlp(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc1 = nn.Linear(c, 4 * c)
        self.fc2 = nn.Linear(4 * c, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    """timm ConvNeXtBlock (channels-last LN + Linear MLP, layer scale);
    the 7×7 conv is depthwise when out ≥ in, a full conv otherwise."""

    def __init__(self, ci: int, co: int, ks: int = 7):
        super().__init__()
        groups = co if co >= ci else 1
        self.conv_dw = nn.Conv2d(ci, co, ks, 1, ks // 2, groups=groups)
        self.norm = nn.LayerNorm(co, eps=1e-6)
        self.mlp = _Mlp(co)
        self.gamma = nn.Parameter(torch.full((co,), 1e-6))
        self.shortcut = _Shortcut(ci, co) if ci != co else None

    def forward(self, x):
        y = self.conv_dw(x).permute(0, 2, 3, 1)
        y = self.mlp(self.norm(y)) * self.gamma
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return y.permute(0, 3, 1, 2) + shortcut


class Stage(nn.Module):
    def __init__(self, ci: int, co: int, depth: int, downsample: bool):
        super().__init__()
        self.downsample = (nn.Sequential(LayerNorm2d(ci, eps=1e-6),
                                         nn.Conv2d(ci, co, 2, 2))
                           if downsample else None)
        self.blocks = nn.Sequential(*[ConvNeXtBlock(co, co)
                                      for _ in range(depth)])

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class ConvNeXt(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv2d(3, DIMS[0], 4, 4),
                                  LayerNorm2d(DIMS[0], eps=1e-6))
        prev = DIMS[0]
        stages = []
        for si, (depth, dim) in enumerate(zip(DEPTHS, DIMS)):
            stages.append(Stage(prev, dim, depth, si > 0))
            prev = dim
        self.stages = nn.ModuleList(stages)


class UpconvSkip(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv = ConvNeXtBlock(ci, co)
        self.upconv = nn.ConvTranspose2d(co, co, 2, 2, 0)

    def forward(self, x):
        return self.upconv(self.conv(x))


def _db_branch(bias: bool) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(128, 32, 3, 1, 1, bias=bias), nn.SiLU(),
        nn.ConvTranspose2d(32, 32, 4, 2, 1), nn.SiLU(),
        nn.ConvTranspose2d(32, 1, 4, 2, 1))


class DBHead(nn.Module):
    """concat(shrink logits, sigmoid(thresh)); the threshold branch's first
    conv is bias-free."""

    def __init__(self):
        super().__init__()
        self.binarize = _db_branch(True)
        self.thresh = _db_branch(False)

    def forward(self, x):
        return torch.cat([self.binarize(x), torch.sigmoid(self.thresh(x))],
                         1)


class DBNetConvNext(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = ConvNeXt()
        self.down_conv1 = Stage(1024, 1024, 2, True)
        self.down_conv2 = Stage(1024, 1024, 2, True)
        for name, ci, co in _UPS:
            self.add_module(name, UpconvSkip(ci, co))
        self.conv_db = DBHead()
        self.conv_mask = nn.Sequential(
            nn.Conv2d(64, 64, 3, 1, 1), nn.SiLU(),
            nn.Conv2d(64, 32, 3, 1, 1), nn.SiLU(),
            nn.Conv2d(32, 1, 1), nn.Sigmoid())

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, 3, H, W) in [-1, 1] → (db (N, 2, H, W), mask (N, 1, H/2,
        W/2))."""
        bb = self.backbone
        h = bb.stem(x)
        h4 = bb.stages[0](h)
        h8 = bb.stages[1](h4)
        h16 = bb.stages[2](h8)
        h32 = bb.stages[3](h16)
        h64 = self.down_conv1(h32)
        h128 = self.down_conv2(h64)
        up128 = self.upconv1(h128)
        up64 = self.upconv2(torch.cat([up128, h64], 1))
        up32 = self.upconv3(torch.cat([up64, h32], 1))
        up16 = self.upconv4(torch.cat([up32, h16], 1))
        up8 = self.upconv5(torch.cat([up16, h8], 1))
        up4 = self.upconv6(torch.cat([up8, h4], 1))
        return self.conv_db(up8), self.conv_mask(up4)


def dbnet_convnext_forward(model: DBNetConvNext, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC interface: x (N, H, W, 3) in [-1, 1] → (db (N, H, W, 2), mask
    (N, H/2, W/2, 1))."""
    db, mask = model(x.permute(0, 3, 1, 2).contiguous())
    return db.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)


def build_dbnet_convnext(device='cpu', state_dict=None) -> DBNetConvNext:
    from ..weights import load_state_dict_into
    model = DBNetConvNext().eval()
    if state_dict is not None:
        load_state_dict_into(model, state_dict)
    return model.to(device)


def init_state_dict() -> Dict[str, torch.Tensor]:
    """Seeded random weights: the JAX package's ``init_params`` draws (same
    seed, order and scale), bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(23)
    params: Dict[str, np.ndarray] = {}

    def conv(key, kh, kw, ci, co, groups=1, bias=True):
        params[key + '.weight'] = (rs.randn(kh, kw, ci // groups, co)
                                   .astype(np.float32) * 0.02
                                   ).astype(np.float32)
        if bias:
            params[key + '.bias'] = np.zeros((co,), np.float32)

    def dense(key, i, o):
        params[key + '.weight'] = (rs.randn(i, o).astype(np.float32) * 0.02
                                   ).astype(np.float32)
        params[key + '.bias'] = np.zeros((o,), np.float32)

    def ln(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)

    def block(key, ci, co, ks=7):
        if co >= ci:
            conv(f'{key}.conv_dw', ks, ks, co, co, groups=co)
        else:
            conv(f'{key}.conv_dw', ks, ks, ci, co)
        ln(f'{key}.norm', co)
        dense(f'{key}.mlp.fc1', co, co * 4)
        dense(f'{key}.mlp.fc2', co * 4, co)
        params[f'{key}.gamma'] = np.full((co,), 1e-6, np.float32)
        if ci != co:
            conv(f'{key}.shortcut.conv', 1, 1, ci, co)

    conv('backbone.stem.0', 4, 4, 3, DIMS[0])
    ln('backbone.stem.1', DIMS[0])
    prev = DIMS[0]
    for si, (depth, dim) in enumerate(zip(DEPTHS, DIMS)):
        pre = f'backbone.stages.{si}'
        if si > 0:
            ln(f'{pre}.downsample.0', prev)
            conv(f'{pre}.downsample.1', 2, 2, prev, dim)
        for b in range(depth):
            block(f'{pre}.blocks.{b}', dim, dim)
        prev = dim
    for name in ('down_conv1', 'down_conv2'):
        ln(f'{name}.downsample.0', 1024)
        conv(f'{name}.downsample.1', 2, 2, 1024, 1024)
        for b in range(2):
            block(f'{name}.blocks.{b}', 1024, 1024)
    for name, ci, co in _UPS:
        block(f'{name}.conv', ci, co)
        conv(f'{name}.upconv', 2, 2, co, co)
    for head, bias in (('binarize', True), ('thresh', False)):
        conv(f'conv_db.{head}.0', 3, 3, 128, 32, bias=bias)
        conv(f'conv_db.{head}.2', 4, 4, 32, 32, bias=True)
        conv(f'conv_db.{head}.4', 4, 4, 32, 1, bias=True)
    conv('conv_mask.0', 3, 3, 64, 64)
    conv('conv_mask.2', 3, 3, 64, 32)
    conv('conv_mask.4', 1, 1, 32, 1)
    return torch_state_dict_from_jax(params, TRANSPOSED_CONV_PATTERNS)
