"""manga-colorization-v2 (mc2): FFDNet denoiser + AlacGAN-style colorizer —
PyTorch port.

Counterpart of the JAX package's ``models/mc2.py`` (checkpoints
generator.zip / net_rgb.pth; reference
``colorization/manga_colorization_v2_utils/``): FFDNet (space-to-depth +
noise map → 12-layer DnCNN → depth-to-space noise estimate) and the
Generator (SEResNeXt-origin grayscale encoder, 5-channel sketch encoder
pyramid, SE-gated ResNeXt "tunnel" stages with pixel-shuffle upsampling,
tanh output). Module names follow the checkpoints' keys. The decoder
``guide`` branch (transposed convs) is dead in the colorizer, so
``generator_forward`` computes it only when asked. Plain PyTorch (cuDNN on
the card), as the JAX package leaves these convolutions to XLA.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


# --------------------------------------------------------------------------
# FFDNet denoiser
# --------------------------------------------------------------------------

def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, 4C, H/2, W/2) as FFDNet's
    concatenate_input_noise_map (ref denoising/functions.py:16-55): phase
    idx of input channel k lands at output channel 4k+idx, idx = 2·dy + dx
    — ``pixel_unshuffle``'s order."""
    return F.pixel_unshuffle(x, 2)


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """Inverse (FFDNet upsamplefeatures, ref denoising/functions.py:64-80):
    input channel 4k+idx goes to output channel k at phase idx."""
    return F.pixel_shuffle(x, 2)


class _DnCNN(nn.Module):
    def __init__(self):
        super().__init__()
        layers = [nn.Conv2d(15, 96, 3, padding=1, bias=False), nn.ReLU()]
        for _ in range(10):
            layers += [nn.Conv2d(96, 96, 3, padding=1, bias=False),
                       nn.BatchNorm2d(96), nn.ReLU()]
        layers.append(nn.Conv2d(96, 12, 3, padding=1, bias=False))
        self.itermediate_dncnn = nn.Sequential(*layers)


class FFDNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.intermediate_dncnn = _DnCNN()

    def forward(self, x: torch.Tensor, noise_sigma: torch.Tensor):
        """x: (N, 3, H, W) in [0, 1], even H and W; noise_sigma (N,) →
        the predicted noise (N, 3, H, W)."""
        down = space_to_depth2(x)
        n, _, h, w = down.shape
        noise_map = noise_sigma.to(x.dtype).view(-1, 1, 1, 1).expand(
            n, 3, h, w)
        # the noise map comes FIRST (ref functions.py:54)
        feat = torch.cat([noise_map, down], 1)
        return depth_to_space2(self.intermediate_dncnn.itermediate_dncnn(
            feat))


@torch.no_grad()
def ffdnet_rgb_forward(model: FFDNet, x: torch.Tensor,
                       noise_sigma: torch.Tensor) -> torch.Tensor:
    """NHWC interface of the JAX package: (N, H, W, 3) → (N, H, W, 3)."""
    return model(x.permute(0, 3, 1, 2).contiguous(),
                 noise_sigma).permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Colorizer generator
# --------------------------------------------------------------------------

class SELayer(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c // 16, 1)
        self.conv2 = nn.Conv2d(c // 16, c, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv2(F.relu(self.conv1(s))))


class ResNeXtBottleneck(nn.Module):
    def __init__(self, c: int, cardinality: int, dilate: int):
        super().__init__()
        d = c // 2
        self.conv_reduce = nn.Conv2d(c, d, 1, bias=False)
        self.conv_conv = nn.Conv2d(d, d, 3, padding=dilate, dilation=dilate,
                                   groups=cardinality, bias=False)
        self.conv_expand = nn.Conv2d(d, c, 1, bias=False)
        self.selayer = SELayer(c)

    def forward(self, x):
        b = _lrelu(self.conv_reduce(x))
        b = _lrelu(self.conv_conv(b))
        return x + self.selayer(self.conv_expand(b))


class BottleneckXStrided(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        w = planes * 2
        self.conv1 = nn.Conv2d(cin, w, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(w)
        self.conv2 = nn.Conv2d(w, w, 3, stride, 1, groups=32, bias=False)
        self.bn2 = nn.BatchNorm2d(w)
        self.conv3 = nn.Conv2d(w, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.selayer = SELayer(planes * 4)
        self.downsample = (
            nn.Sequential(nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                          nn.BatchNorm2d(planes * 4))
            if stride != 1 or cin != planes * 4 else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.selayer(self.bn3(self.conv3(out)))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class SEResNeXtEncoder(nn.Module):
    """SEResNeXt_Origin [3, 4, 6] grayscale encoder → (x1, x2, x3, x4)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (blocks, planes, stride) in enumerate(
                zip((3, 4, 6), (64, 128, 256), (1, 2, 2)), start=1):
            setattr(self, f'layer{li}', nn.Sequential(*[
                BottleneckXStrided(inplanes if b == 0 else planes * 4,
                                   planes, stride if b == 0 else 1)
                for b in range(blocks)]))
            inplanes = planes * 4

    def forward(self, x):
        x1 = F.relu(self.bn1(self.conv1(x)))
        x2 = self.layer1(x1)
        x3 = self.layer2(x2)
        return x1, x2, x3, self.layer3(x3)


def _encoder_block(ci: int, co: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(ci, co, 3, stride, 1), nn.LeakyReLU(0.2),
                         nn.Conv2d(co, co, 3, 1, 1), nn.LeakyReLU(0.2))


def _tunnel(cin: int, c: int, specs: Sequence[Tuple[int, int]],
            cout: int) -> nn.Sequential:
    """conv + lrelu → ResNeXt blocks → conv → pixel shuffle → lrelu."""
    return nn.Sequential(
        nn.Conv2d(cin, c, 3, padding=1), nn.LeakyReLU(0.2),
        nn.Sequential(*[ResNeXtBottleneck(c, card, dil)
                        for card, dil in specs]),
        nn.Conv2d(c, cout, 3, padding=1), nn.PixelShuffle(2),
        nn.LeakyReLU(0.2))


_T4 = [(32, 1)] * 20
_T3 = ([(32, 1)] * 2 + [(32, 2)] * 2 + [(32, 4)] * 2 + [(32, 2), (32, 1)])
_T2 = _T3


class Generator(nn.Module):
    def __init__(self):
        super().__init__()
        self.to0 = _encoder_block(5, 32, 1)
        self.to1 = _encoder_block(32, 64, 2)
        self.to2 = _encoder_block(64, 92, 2)
        self.to3 = _encoder_block(92, 128, 2)
        self.to4 = _encoder_block(128, 256, 2)     # in the checkpoint, unused
        self.encoder = SEResNeXtEncoder()
        self.tunnel4 = _tunnel(1024 + 128, 512, _T4, 1024)
        self.tunnel3 = _tunnel(512 + 256, 256, _T3, 512)
        self.tunnel2 = _tunnel(128 + 256 + 64, 128, _T2, 256)
        self.exit = nn.Sequential(nn.Conv2d(64 + 32, 32, 3, padding=1),
                                  nn.LeakyReLU(0.2), nn.Conv2d(32, 3, 1))
        self.deconv_for_decoder = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 3, 2, 1, output_padding=1),
            nn.LeakyReLU(0.2),
            nn.ConvTranspose2d(128, 64, 3, 2, 1, output_padding=1),
            nn.LeakyReLU(0.2),
            nn.ConvTranspose2d(64, 32, 3, 1, 1), nn.LeakyReLU(0.2),
            nn.ConvTranspose2d(32, 3, 3, 1, 1), nn.Tanh())

    def forward(self, sketch: torch.Tensor, guide: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """sketch: (N, 5, H, W) = [gray, 4-ch colour hint] → (colorized (N,
        3, H, W) in [-1, 1], the decoder guide or None)."""
        x0 = self.to0(sketch)
        aux = self.to3(self.to2(self.to1(x0)))
        x1, x2, x3, x4 = self.encoder(sketch[:, 0:1])
        out = self.tunnel4(torch.cat([x4, aux], 1))
        x = self.tunnel3(torch.cat([out, x3], 1))
        x = self.tunnel2(torch.cat([x, x2, x1], 1))
        x = torch.tanh(self.exit(torch.cat([x, x0], 1)))
        return x, (self.deconv_for_decoder(out) if guide else None)


@torch.no_grad()
def generator_forward(model: Generator, sketch: torch.Tensor,
                      guide: bool = False):
    """NHWC interface of the JAX package: (N, H, W, 5) → ((N, H, W, 3),
    the guide (N, H, W, 3) when ``guide``, else None)."""
    fake, g = model(sketch.permute(0, 3, 1, 2).contiguous(), guide)
    nhwc = lambda t: None if t is None else t.permute(0, 2, 3, 1)
    return nhwc(fake), nhwc(g)


GENERATOR_TRANSPOSED_PATTERNS = (r'deconv_for_decoder\.[0246]\.weight',)


def build_generator(sd: Dict[str, torch.Tensor], device='cpu') -> Generator:
    from ..weights import load_state_dict_into
    return load_state_dict_into(Generator().eval(), sd).to(device)


def build_ffdnet(sd: Dict[str, torch.Tensor], device='cpu') -> FFDNet:
    from ..weights import load_state_dict_into
    return load_state_dict_into(FFDNet().eval(), sd).to(device)


def init_generator_state_dict() -> Dict[str, torch.Tensor]:
    """Seeded random weights with the checkpoint's keys and shapes: the
    JAX package's ``init_generator_params`` draws, bridged to torch
    layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(41)
    params: Dict[str, np.ndarray] = {}

    def conv(key, kh, kw, ci, co, groups=1, bias=True):
        params[key + '.weight'] = (
            rs.randn(kh, kw, ci // groups, co).astype(np.float32)
            * np.sqrt(1.0 / (kh * kw * max(ci // groups, 1)))
        ).astype(np.float32)
        if bias:
            params[key + '.bias'] = np.zeros((co,), np.float32)

    def bn(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)
        params[key + '.running_mean'] = np.zeros((c,), np.float32)
        params[key + '.running_var'] = np.ones((c,), np.float32)

    def se(key, c):
        conv(f'{key}.conv1', 1, 1, c, c // 16)
        conv(f'{key}.conv2', 1, 1, c // 16, c)

    def rnb(key, c, card):
        d = c // 2
        conv(f'{key}.conv_reduce', 1, 1, c, d, bias=False)
        conv(f'{key}.conv_conv', 3, 3, d, d, groups=card, bias=False)
        conv(f'{key}.conv_expand', 1, 1, d, c, bias=False)
        se(f'{key}.selayer', c)

    def enc_block(key, ci, co):
        conv(f'{key}.0', 3, 3, ci, co)
        conv(f'{key}.2', 3, 3, co, co)

    enc_block('to0', 5, 32)
    enc_block('to1', 32, 64)
    enc_block('to2', 64, 92)
    enc_block('to3', 92, 128)
    enc_block('to4', 128, 256)

    conv('encoder.conv1', 7, 7, 1, 64, bias=False)
    bn('encoder.bn1', 64)
    inplanes = 64
    for li, (blocks, planes, stride) in enumerate(
            zip((3, 4, 6), (64, 128, 256), (1, 2, 2)), start=1):
        for b in range(blocks):
            pre = f'encoder.layer{li}.{b}'
            cin = inplanes if b == 0 else planes * 4
            conv(f'{pre}.conv1', 1, 1, cin, planes * 2, bias=False)
            bn(f'{pre}.bn1', planes * 2)
            conv(f'{pre}.conv2', 3, 3, planes * 2, planes * 2, groups=32,
                 bias=False)
            bn(f'{pre}.bn2', planes * 2)
            conv(f'{pre}.conv3', 1, 1, planes * 2, planes * 4, bias=False)
            bn(f'{pre}.bn3', planes * 4)
            se(f'{pre}.selayer', planes * 4)
            if b == 0 and (stride != 1 or cin != planes * 4):
                conv(f'{pre}.downsample.0', 1, 1, cin, planes * 4,
                     bias=False)
                bn(f'{pre}.downsample.1', planes * 4)
        inplanes = planes * 4

    def tunnel(key, cin, c, specs, cout):
        conv(f'{key}.0', 3, 3, cin, c)
        for i, (card, _d) in enumerate(specs):
            rnb(f'{key}.2.{i}', c, card)
        conv(f'{key}.3', 3, 3, c, cout)

    tunnel('tunnel4', 1024 + 128, 512, _T4, 1024)
    tunnel('tunnel3', 512 + 256, 256, _T3, 512)
    tunnel('tunnel2', 128 + 256 + 64, 128, _T2, 256)

    conv('exit.0', 3, 3, 64 + 32, 32)
    conv('exit.2', 1, 1, 32, 3)

    conv('deconv_for_decoder.0', 3, 3, 256, 128)
    conv('deconv_for_decoder.2', 3, 3, 128, 64)
    conv('deconv_for_decoder.4', 3, 3, 64, 32)
    conv('deconv_for_decoder.6', 3, 3, 32, 3)
    return torch_state_dict_from_jax(params, GENERATOR_TRANSPOSED_PATTERNS)


def init_ffdnet_state_dict() -> Dict[str, torch.Tensor]:
    """Seeded random FFDNet weights: the JAX package's
    ``init_ffdnet_params`` draws, bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(43)
    params: Dict[str, np.ndarray] = {}
    pre = 'intermediate_dncnn.itermediate_dncnn'

    def conv(key, ci, co):
        params[key + '.weight'] = (rs.randn(3, 3, ci, co).astype(np.float32)
                                   * np.sqrt(2.0 / (9 * ci))
                                   ).astype(np.float32)

    def bn(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)
        params[key + '.running_mean'] = np.zeros((c,), np.float32)
        params[key + '.running_var'] = np.ones((c,), np.float32)

    conv(f'{pre}.0', 15, 96)
    idx = 2
    for _ in range(10):
        conv(f'{pre}.{idx}', 96, 96)
        bn(f'{pre}.{idx + 1}', 96)
        idx += 3
    conv(f'{pre}.{idx}', 96, 12)
    return torch_state_dict_from_jax(params)
