"""Plain reference of the LaMa inpainting generator (FFCResNetGenerator,
Suvorov et al., WACV 2022; ``lama_large_512px.ckpt``: 18 FFC blocks, 64
base channels, global ratio 0.75, 3 down- and 3 up-samplings).

The checkpoint's module layout, so that the same state dict loads into
both; plain PyTorch in float32 (NCHW, batch norms unfolded, reflect
padding by ``F.pad``, the Fourier unit by ``torch.fft``). Every product's
operands pass through ``precision.lowered`` when a control computes in a
lower precision. Imports nothing of the program.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NGF = 64
N_DOWN = 3
RATIO = 0.75


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class FourierUnit(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(2 * c, 2 * c, 1, bias=False)
        self.bn = _bn(2 * c)

    def forward(self, x):
        n, c, h, w = x.shape
        spec = torch.fft.rfft2(x.float(), dim=(-2, -1), norm='ortho')
        # channel order c0.re, c0.im, c1.re, ...
        inter = torch.stack((spec.real, spec.imag), dim=2).reshape(
            n, 2 * c, h, w // 2 + 1)
        y = F.relu(self.bn(self.conv_layer(inter)))
        y = y.reshape(n, c, 2, h, w // 2 + 1)
        y = torch.complex(y[:, :, 0].contiguous(), y[:, :, 1].contiguous())
        return torch.fft.irfft2(y, s=(h, w), dim=(-2, -1), norm='ortho')


class SpectralTransform(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(cin, cout // 2, 1, bias=False),
                                   _bn(cout // 2), nn.ReLU())
        self.fu = FourierUnit(cout // 2)
        self.conv2 = nn.Conv2d(cout // 2, cout, 1, bias=False)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(x + self.fu(x))


def _pad(x: Optional[torch.Tensor], p: int):
    return x if x is None or p == 0 else F.pad(x, (p,) * 4, mode='reflect')


class FFC(nn.Module):
    def __init__(self, cin, cout, k, ratio_gin, ratio_gout, stride=1,
                 padding=0):
        super().__init__()
        in_cg = int(cin * ratio_gin)
        in_cl = cin - in_cg
        out_cg = int(cout * ratio_gout)
        out_cl = cout - out_cg
        self.padding = padding

        def conv(ci, co):
            return nn.Conv2d(ci, co, k, stride, 0, bias=False)
        self.convl2l = conv(in_cl, out_cl) if in_cl and out_cl else None
        self.convl2g = conv(in_cl, out_cg) if in_cl and out_cg else None
        self.convg2l = conv(in_cg, out_cl) if in_cg and out_cl else None
        self.convg2g = (SpectralTransform(in_cg, out_cg)
                        if in_cg and out_cg else None)

    def forward(self, x_l, x_g):
        xl_p, xg_p = _pad(x_l, self.padding), _pad(x_g, self.padding)
        out_l = out_g = None
        if self.convl2l is not None:
            out_l = self.convl2l(xl_p)
            if x_g is not None and self.convg2l is not None:
                out_l = out_l + self.convg2l(xg_p)
        if self.convl2g is not None:
            out_g = self.convl2g(xl_p)
            if x_g is not None and self.convg2g is not None:
                out_g = out_g + self.convg2g(x_g)
        return out_l, out_g


class FFC_BN_ACT(nn.Module):
    def __init__(self, cin, cout, k, ratio_gin, ratio_gout, stride=1,
                 padding=0):
        super().__init__()
        self.ffc = FFC(cin, cout, k, ratio_gin, ratio_gout, stride, padding)
        out_cg = int(cout * ratio_gout)
        out_cl = cout - out_cg
        self.bn_l = _bn(out_cl) if out_cl else None
        self.bn_g = _bn(out_cg) if out_cg else None

    def forward(self, x_l, x_g=None):
        x_l, x_g = self.ffc(x_l, x_g)
        if x_l is not None:
            x_l = F.relu(self.bn_l(x_l))
        if x_g is not None:
            x_g = F.relu(self.bn_g(x_g))
        return x_l, x_g


class FFCResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = FFC_BN_ACT(dim, dim, 3, RATIO, RATIO, padding=1)
        self.conv2 = FFC_BN_ACT(dim, dim, 3, RATIO, RATIO, padding=1)

    def forward(self, x_l, x_g):
        y_l, y_g = self.conv2(*self.conv1(x_l, x_g))
        return x_l + y_l, x_g + y_g


class LamaGenerator(nn.Module):
    def __init__(self, n_blocks: int):
        super().__init__()
        self.n_blocks = n_blocks
        layers = [nn.ReflectionPad2d(3),
                  FFC_BN_ACT(4, NGF, 7, 0, 0),
                  FFC_BN_ACT(NGF, NGF * 2, 3, 0, 0, 2, 1),
                  FFC_BN_ACT(NGF * 2, NGF * 4, 3, 0, 0, 2, 1),
                  FFC_BN_ACT(NGF * 4, NGF * 8, 3, 0, RATIO, 2, 1)]
        layers += [FFCResnetBlock(NGF * 8) for _ in range(n_blocks)]
        layers.append(nn.Identity())
        ch = NGF * 8
        for _ in range(N_DOWN):
            layers += [nn.ConvTranspose2d(ch, ch // 2, 3, 2, 1,
                                          output_padding=1),
                       _bn(ch // 2), nn.ReLU()]
            ch //= 2
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(NGF, 3, 7), nn.Sigmoid()]
        self.model = nn.ModuleList(layers)

    def forward(self, img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """img (N, H, W, 3) in [0, 1], already masked; mask (N, H, W, 1)
        -> (N, H, W, 3) in [0, 1]."""
        x = torch.cat([img, mask], dim=-1).permute(0, 3, 1, 2).float()
        x_l, x_g = self.model[1](_pad(x, 3))
        for i in (2, 3, 4):
            x_l, x_g = self.model[i](x_l, x_g)
        for i in range(self.n_blocks):
            x_l, x_g = self.model[5 + i](x_l, x_g)
        x = torch.cat([x_l, x_g], dim=1)
        up0 = 5 + self.n_blocks + 1
        for i in range(N_DOWN):
            base = up0 + 3 * i
            x = F.relu(self.model[base + 1](self.model[base](x)))
        x = self.model[up0 + 3 * N_DOWN + 1](_pad(x, 3))
        return torch.sigmoid(x).permute(0, 2, 3, 1)


def build(state_dict, n_blocks: int, device) -> LamaGenerator:
    model = LamaGenerator(n_blocks).eval()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device)


@torch.no_grad()
def composite(model: LamaGenerator, img: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """The inpainter's result for img (N, H, W, 3) in [0, 1] and a binary
    mask (N, H, W, 1): the generator's output inside the mask, the image
    outside."""
    masked = img.float() * (1.0 - mask.float())
    out = model(masked, mask.float())
    return out * mask + (1.0 - mask) * masked

