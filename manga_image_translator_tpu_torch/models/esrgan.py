"""ESRGAN RRDBNet 4x super-resolution — PyTorch port.

Counterpart of the JAX package's ``models/esrgan.py`` (old-format ESRGAN
checkpoints, e.g. 4xESRGAN.pth / 4x-UltraSharp; reference
``upscaling/esrgan_pytorch.py:28-160``): a first conv, nb RRDB blocks (3
dense blocks of 5 convs each at nf 64 / gc 32, LeakyReLU 0.2, 0.2-scaled
residuals), a trunk conv with the long skip, two nearest-2x + conv stages,
the HR conv and the last conv. Module names are the checkpoints' flat keys
('model.0', 'model.1.sub.{i}.RDB{j}.conv{k}.0', 'model.1.sub.{nb}',
'model.3', 'model.6', 'model.8', 'model.10'). Plain PyTorch (cuDNN on the
card), as the JAX package leaves these convolutions to XLA; its
lane-packing switch (``MIT_TPU_DECONV_PACK``) is a TPU layout workaround
and is not ported.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NF = 64
GC = 32


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _conv(ci: int, co: int) -> nn.Conv2d:
    return nn.Conv2d(ci, co, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    """ResidualDenseBlock_5C."""

    def __init__(self, nf: int = NF, gc: int = GC):
        super().__init__()
        for k in range(1, 6):
            setattr(self, f'conv{k}', nn.Sequential(
                _conv(nf + (k - 1) * gc, gc if k < 5 else nf)))

    def forward(self, x):
        feats = [x]
        for k in range(1, 5):
            feats.append(_lrelu(getattr(self, f'conv{k}')(
                torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int = NF, gc: int = GC):
        super().__init__()
        self.RDB1 = ResidualDenseBlock(nf, gc)
        self.RDB2 = ResidualDenseBlock(nf, gc)
        self.RDB3 = ResidualDenseBlock(nf, gc)

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class _Trunk(nn.Module):
    """``model.1``: nb RRDBs and the trunk conv (its output is added to the
    first conv's by the caller)."""

    def __init__(self, nb: int, nf: int, gc: int):
        super().__init__()
        self.sub = nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)],
                                 _conv(nf, nf))


class RRDBNet(nn.Module):
    def __init__(self, nb: int, nf: int = NF, gc: int = GC):
        super().__init__()
        self.nb = nb
        self.model = nn.ModuleDict({
            '0': _conv(3, nf), '1': _Trunk(nb, nf, gc), '3': _conv(nf, nf),
            '6': _conv(nf, nf), '8': _conv(nf, nf), '10': _conv(nf, 3)})

    def forward(self, x):
        """x: (N, 3, H, W) → (N, 3, 4H, 4W)."""
        m = self.model
        fea = m['0'](x)
        fea = fea + m['1'].sub(fea)
        fea = _lrelu(m['3'](F.interpolate(fea, scale_factor=2,
                                          mode='nearest')))
        fea = _lrelu(m['6'](F.interpolate(fea, scale_factor=2,
                                          mode='nearest')))
        return m['10'](_lrelu(m['8'](fea)))


@torch.no_grad()
def esrgan_forward(model: RRDBNet, x: torch.Tensor) -> torch.Tensor:
    """NHWC interface of the JAX package: (N, H, W, 3) in [0, 1] → (N, 4H,
    4W, 3)."""
    return model(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


def detect_nb(sd: Mapping[str, object]) -> int:
    """Number of RRDB blocks from the key layout."""
    nb = 0
    while f'model.1.sub.{nb}.RDB1.conv1.0.weight' in sd:
        nb += 1
    return nb


def build_esrgan(sd: Dict[str, torch.Tensor], device='cpu') -> RRDBNet:
    """The RRDBNet of a state dict in the old flat layout; nb, nf and gc
    are read from its keys and shapes."""
    from ..weights import load_state_dict_into
    nb = detect_nb(sd)
    nf = sd['model.0.weight'].shape[0]
    gc = sd['model.1.sub.0.RDB1.conv1.0.weight'].shape[0] if nb else GC
    model = RRDBNet(nb, nf, gc).eval()
    load_state_dict_into(model, sd)
    return model.to(device)


def init_state_dict(nb: int = 6, nf: int = NF, gc: int = GC
                    ) -> Dict[str, torch.Tensor]:
    """Seeded random weights with the checkpoint's keys and shapes: the
    JAX package's ``init_params`` draws, bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(5)
    params: Dict[str, np.ndarray] = {}

    def conv(key, ci, co, k=3):
        params[key + '.weight'] = (rs.randn(k, k, ci, co).astype(np.float32)
                                   * np.sqrt(0.2 / (k * k * ci))
                                   ).astype(np.float32)
        params[key + '.bias'] = np.zeros((co,), np.float32)

    conv('model.0', 3, nf)
    for i in range(nb):
        for j in (1, 2, 3):
            pre = f'model.1.sub.{i}.RDB{j}'
            for k in range(1, 6):
                ci = nf + (k - 1) * gc
                co = gc if k < 5 else nf
                conv(f'{pre}.conv{k}.0', ci, co)
    conv(f'model.1.sub.{nb}', nf, nf)
    conv('model.3', nf, nf)
    conv('model.6', nf, nf)
    conv('model.8', nf, nf)
    conv('model.10', nf, 3)
    return torch_state_dict_from_jax(params)

