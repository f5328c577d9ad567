"""CRAFT text detector (VGG16-BN U-net, region + affinity heatmaps) and
its RefineNet — PyTorch port.

Counterpart of the JAX package's ``models/craft.py`` (checkpoints
``craft_mlt_25k.pth`` / ``craft_refiner_CTW1500.pth``; reference
``detection/craft.py:29-97``, ``craft_utils/vgg16_bn.py``,
``craft_utils/refiner.py``). The torchvision ``vgg16_bn`` feature indices,
sliced into ``basenet.slice1..5``, are the module names, so both
checkpoints load with a strict ``load_state_dict``.

The reference's slices end at a BatchNorm, but the next slice begins with
an in-place ReLU that mutates the tap before the U-net reads it, so the
taps relu2_2 / relu3_2 / relu4_3 are post-ReLU; relu5_3 stays pre-ReLU
(slice5 begins with a max-pool). The U-net's upsampling is
``ops.resize.resize_linear`` (``jax.image.resize`` linear semantics, as the
JAX package's ``interpolate_bilinear``). Plain PyTorch otherwise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_linear

# torchvision vgg16_bn conv/bn indices per slice (see the module docstring
# for the trailing ReLUs)
_SLICE_LAYERS = {
    'slice1': [('conv', 0), ('bn', 1), ('relu',), ('conv', 3), ('bn', 4),
               ('relu',), ('pool',), ('conv', 7), ('bn', 8),
               ('relu',), ('conv', 10), ('bn', 11), ('relu',)],
    'slice2': [('pool',), ('conv', 14), ('bn', 15),
               ('relu',), ('conv', 17), ('bn', 18), ('relu',)],
    'slice3': [('conv', 20), ('bn', 21), ('relu',),
               ('pool',), ('conv', 24), ('bn', 25), ('relu',),
               ('conv', 27), ('bn', 28), ('relu',)],
    'slice4': [('conv', 30), ('bn', 31), ('relu',),
               ('pool',), ('conv', 34), ('bn', 35), ('relu',),
               ('conv', 37), ('bn', 38)],
}
_VGG = [('slice1.0', 3, 64), ('slice1.3', 64, 64), ('slice1.7', 64, 128),
        ('slice1.10', 128, 128), ('slice2.14', 128, 256),
        ('slice2.17', 256, 256), ('slice3.20', 256, 256),
        ('slice3.24', 256, 512), ('slice3.27', 512, 512),
        ('slice4.30', 512, 512), ('slice4.34', 512, 512),
        ('slice4.37', 512, 512)]
_UPS = [('upconv1', 1536, 512, 256), ('upconv2', 768, 256, 128),
        ('upconv3', 384, 128, 64), ('upconv4', 192, 64, 32)]


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


def _upsample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """NCHW linear resize of ``x`` to ``like``'s spatial size."""
    y = resize_linear(x.permute(0, 2, 3, 1), like.shape[2], like.shape[3])
    return y.permute(0, 3, 1, 2)


class _Slice(nn.Module):
    """One VGG slice: submodules named by their torchvision index."""

    def __init__(self, name: str):
        super().__init__()
        self.layers = _SLICE_LAYERS[name]
        for key, ci, co in _VGG:
            prefix, idx = key.split('.')
            if prefix == name:
                self.add_module(idx, nn.Conv2d(ci, co, 3, 1, 1))
                self.add_module(str(int(idx) + 1), _bn(co))

    def forward(self, x):
        for layer in self.layers:
            if layer[0] in ('conv', 'bn'):
                x = getattr(self, str(layer[1]))(x)
            elif layer[0] == 'relu':
                x = F.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
        return x


class VGG16BN(nn.Module):
    def __init__(self):
        super().__init__()
        for name in ('slice1', 'slice2', 'slice3', 'slice4'):
            self.add_module(name, _Slice(name))
        self.slice5 = nn.Sequential(
            nn.MaxPool2d(3, 1, 1), nn.Conv2d(512, 1024, 3, 1, 6, dilation=6),
            nn.Conv2d(1024, 1024, 1))

    def forward(self, x):
        r2 = self.slice1(x)
        r3 = self.slice2(r2)
        r4 = self.slice3(r3)
        r5 = self.slice4(r4)
        return self.slice5(r5), r5, r4, r3, r2


class DoubleConv(nn.Module):
    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, mid, 1), _bn(mid), nn.ReLU(),
            nn.Conv2d(mid, out, 3, 1, 1), _bn(out), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class CRAFT(nn.Module):
    def __init__(self):
        super().__init__()
        self.basenet = VGG16BN()
        for name, cin, mid, out in _UPS:
            self.add_module(name, DoubleConv(cin, mid, out))
        self.conv_cls = nn.Sequential(
            nn.Conv2d(32, 32, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(32, 32, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(32, 16, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(16, 16, 1), nn.ReLU(),
            nn.Conv2d(16, 2, 1))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, 3, H, W) ImageNet-normalised → (y (N, 2, H/2, W/2) region
        + affinity, feature (N, 32, H/2, W/2))."""
        fc7, r5, r4, r3, r2 = self.basenet(x)
        y = self.upconv1(torch.cat([fc7, r5], 1))
        y = self.upconv2(torch.cat([_upsample(y, r4), r4], 1))
        y = self.upconv3(torch.cat([_upsample(y, r3), r3], 1))
        feature = self.upconv4(torch.cat([_upsample(y, r2), r2], 1))
        return self.conv_cls(feature), feature


def _aspp(dilation: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(64, 128, 3, 1, dilation, dilation=dilation), _bn(128),
        nn.ReLU(), nn.Conv2d(128, 128, 1), _bn(128), nn.ReLU(),
        nn.Conv2d(128, 1, 1))


class RefineNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.last_conv = nn.Sequential(
            nn.Conv2d(34, 64, 3, 1, 1), _bn(64), nn.ReLU(),
            nn.Conv2d(64, 64, 3, 1, 1), _bn(64), nn.ReLU(),
            nn.Conv2d(64, 64, 3, 1, 1), _bn(64), nn.ReLU())
        for i, d in enumerate((6, 12, 18, 24), start=1):
            self.add_module(f'aspp{i}', _aspp(d))

    def forward(self, y, feature):
        """(y, upconv4 feature) → the refined link map (N, 1, H/2, W/2)."""
        x = self.last_conv(torch.cat([y, feature], 1))
        return (self.aspp1(x) + self.aspp2(x) + self.aspp3(x)
                + self.aspp4(x))


def craft_forward(craft: CRAFT, refiner: RefineNet, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC interface: x (N, H, W, 3) normalised → (text map, refined link
    map), each (N, H/2, W/2)."""
    y, feature = craft(x.permute(0, 3, 1, 2).contiguous())
    refined = refiner(y, feature)
    return y[:, 0], refined[:, 0]


def build(cls, device='cpu', state_dict=None):
    """An eval-mode ``cls`` (``CRAFT`` or ``RefineNet``) on ``device``,
    optionally loaded (strictly) from a torch state dict."""
    from ..weights import load_state_dict_into
    model = cls().eval()
    if state_dict is not None:
        load_state_dict_into(model, state_dict)
    return model.to(device)


def _params(seed: int):
    rs = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}

    def conv(key, ci, co, k=3, bias=True):
        params[key + '.weight'] = (rs.randn(k, k, ci, co).astype(np.float32)
                                   * np.sqrt(2.0 / (k * k * ci))
                                   ).astype(np.float32)
        if bias:
            params[key + '.bias'] = np.zeros((co,), np.float32)

    def bn(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)
        params[key + '.running_mean'] = np.zeros((c,), np.float32)
        params[key + '.running_var'] = np.ones((c,), np.float32)
    return params, conv, bn


def init_state_dict() -> Dict[str, torch.Tensor]:
    """Seeded random CRAFT weights: the JAX package's ``init_params`` draws
    (same seed, order and scale), bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    params, conv, bn = _params(13)
    for key, ci, co in _VGG:
        conv(f'basenet.{key}', ci, co)
        prefix, idx = key.rsplit('.', 1)
        bn(f'basenet.{prefix}.{int(idx) + 1}', co)
    conv('basenet.slice5.1', 512, 1024)
    conv('basenet.slice5.2', 1024, 1024, k=1)
    for name, cin, mid, out in _UPS:
        conv(f'{name}.conv.0', cin, mid, k=1)
        bn(f'{name}.conv.1', mid)
        conv(f'{name}.conv.3', mid, out)
        bn(f'{name}.conv.4', out)
    conv('conv_cls.0', 32, 32)
    conv('conv_cls.2', 32, 32)
    conv('conv_cls.4', 32, 16)
    conv('conv_cls.6', 16, 16, k=1)
    conv('conv_cls.8', 16, 2, k=1)
    return torch_state_dict_from_jax(params)


def init_refiner_state_dict() -> Dict[str, torch.Tensor]:
    """Seeded random RefineNet weights (JAX ``init_refiner_params``)."""
    from ..weights import torch_state_dict_from_jax
    params, conv, bn = _params(17)
    conv('last_conv.0', 34, 64)
    bn('last_conv.1', 64)
    conv('last_conv.3', 64, 64)
    bn('last_conv.4', 64)
    conv('last_conv.6', 64, 64)
    bn('last_conv.7', 64)
    for i in range(1, 5):
        conv(f'aspp{i}.0', 64, 128)
        bn(f'aspp{i}.1', 128)
        conv(f'aspp{i}.3', 128, 128, k=1)
        bn(f'aspp{i}.4', 128)
        conv(f'aspp{i}.6', 128, 1, k=1)
    return torch_state_dict_from_jax(params)
