"""waifu2x upconv_7 super-resolution — PyTorch port, with its ncnn
weight reader.

Counterpart of the JAX package's ``models/waifu2x.py``: the 2x model of the
reference's waifu2x-ncnn-vulkan executable (upscaling/waifu2x.py:52-105),
six 3x3 VALID convolutions with LeakyReLU(0.1) feeding a 4x4 stride-2
deconvolution cropped by 3 px a side (a 7-px context border in all).
``load_ncnn_upconv7`` reads the executable's ``.param``/``.bin`` pair into
this module's state dict through the port's ncnn reader: ncnn stores
convolutions OIHW and the deconvolution IOHW, which are torch's
``Conv2d`` and ``ConvTranspose2d`` layouts, so no weight is transposed or
flipped.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out_channels, in_channels) per conv layer of upconv_7: six 3x3 convs
# then the 4x4 stride-2 deconvolution (256 -> 3)
UPCONV7_CHANNELS = [(16, 3), (32, 16), (64, 32), (128, 64), (128, 128),
                    (256, 128)]
CONTEXT = 7  # VALID convs + deconv crop eat a 7-px border


class UpConv7(nn.Module):
    def __init__(self):
        super().__init__()
        for i, (co, ci) in enumerate(UPCONV7_CHANNELS):
            setattr(self, f'conv{i}', nn.Conv2d(ci, co, 3))
        self.deconv = nn.ConvTranspose2d(256, 3, 4, stride=2, padding=3)

    def forward(self, x):
        """(N, 3, H+14, W+14) context-padded → (N, 3, 2H, 2W)."""
        for i in range(len(UPCONV7_CHANNELS)):
            x = F.leaky_relu(getattr(self, f'conv{i}')(x), 0.1)
        return self.deconv(x)


def build_upconv7(sd: Dict[str, torch.Tensor], device='cpu') -> UpConv7:
    from ..weights import load_state_dict_into
    model = UpConv7().eval()
    load_state_dict_into(model, sd)
    return model.to(device)


def load_ncnn_upconv7(param_path, bin_path) -> Dict[str, torch.Tensor]:
    """Read an upconv_7 ncnn model (``utils/ncnn_lite.load_ncnn``) into
    this module's state dict: the six Convolutions in file order, then the
    Deconvolution; the ReLU layers of the release files are the forward's
    own LeakyReLU(0.1)."""
    from ..utils.ncnn_lite import load_ncnn
    sd: Dict[str, torch.Tensor] = {}
    convs = 0
    for layer in load_ncnn(param_path, bin_path):
        if layer.type not in ('Convolution', 'Deconvolution'):
            continue
        n_out = int(layer.p(0))
        k = int(layer.p(1, 3))
        w = layer.weights['weight']
        n_in = w.size // (n_out * k * k)
        if layer.type == 'Convolution':
            key = f'conv{convs}'
            w = w.reshape(n_out, n_in, k, k)           # OIHW
            convs += 1
        else:
            key = 'deconv'
            w = w.reshape(n_in, n_out, k, k)           # IOHW
        sd[f'{key}.weight'] = torch.from_numpy(w)
        sd[f'{key}.bias'] = torch.from_numpy(layer.weights['bias'])
    assert convs == 6, f'expected 6 convolutions, got {convs}'
    assert 'deconv.weight' in sd, 'missing deconvolution layer'
    return sd


def init_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random upconv_7 weights (offline fallback / tests): the JAX
    package's ``init_params`` draws, bridged to torch layouts (its
    deconvolution kernel is (kh, kw, out, in), so the plain HWIO → OIHW
    transpose gives torch's (in, out, kh, kw))."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}
    for i, (co, ci) in enumerate(UPCONV7_CHANNELS):
        params[f'conv{i}.weight'] = (rs.randn(3, 3, ci, co).astype(np.float32)
                                     * np.sqrt(2.0 / (9 * ci))
                                     ).astype(np.float32)
        params[f'conv{i}.bias'] = np.zeros((co,), np.float32)
    params['deconv.weight'] = (rs.randn(4, 4, 3, 256).astype(np.float32)
                               * 0.1).astype(np.float32)
    params['deconv.bias'] = np.zeros((3,), np.float32)
    return torch_state_dict_from_jax(params)
