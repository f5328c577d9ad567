"""Plain reference of the ESRGAN RRDBNet 4x upscaler (Wang et al., ECCV
2018 workshops; Real-ESRGAN x4plus-anime-6B: 6 RRDB blocks, nf 64, gc 32):
a first conv, nb RRDBs of three 5-conv dense blocks with 0.2-scaled
residuals, the trunk conv with the long skip, two nearest-2x + conv
stages, the HR conv and the last conv.

The old flat module layout (``model.0``, ``model.1.sub.{i}.RDB{j}.conv{k}.0``
...); plain PyTorch, float32. Imports nothing of the program.
"""
from __future__ import annotations

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


def build(state_dict, nb: int, device) -> RRDBNet:
    model = RRDBNet(nb).eval()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device)


@torch.no_grad()
def forward(model: RRDBNet, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [0, 1] -> (N, 4H, 4W, 3)."""
    return model(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


def new_style_key(key: str, nb: int) -> str:
    """The Real-ESRGAN release's name of an old-style key."""
    parts = key.split('.')
    if parts[1] == '1' and parts[3] != str(nb):
        return (f'body.{parts[3]}.rdb{parts[4][3:]}.{parts[5]}.'
                + '.'.join(parts[7:]))
    names = {'0': 'conv_first', '1': 'conv_body', '3': 'conv_up1',
             '6': 'conv_up2', '8': 'conv_hr', '10': 'conv_last'}
    return names[parts[1]] + '.' + parts[-1]
