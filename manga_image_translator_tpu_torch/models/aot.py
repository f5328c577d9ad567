"""AOT-GAN inpainting generator (the ``default`` inpainter) — PyTorch port.

Counterpart of the JAX package's ``models/aot.py`` (checkpoint
``inpainting.ckpt``; reference ``inpainting/inpainting_aot.py``): gated
convolutions with scaled weight standardisation (GatedWSConvPadded :120,
ScaledWSConv2d :54), NF-style scaled ReLUs (:36-43), 10 AOT blocks with
dilation rates 2/4/8/16 (:170-196), a transposed-conv upsampling tail and
the output clipped to [-1, 1]. Every padding is reflect.

Weight standardisation uses the unbiased variance over all but the first
torch dimension: per output channel for the convs, per input channel for
the transposed convs; it is computed in f32 from the stored weights at
each call, as the JAX package does, then cast to the compute dtype.
``_my_layer_norm`` uses the unbiased spatial std + 1e-9. The reflect pad
is an index gather that reflects again where the pad reaches past the
edge (``jnp.pad(mode='reflect')``'s semantics; ``F.pad`` raises there), so
small crops and pages behave as in the JAX package. Plain PyTorch: the
JAX package computes this network with XLA, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

RELU_NF_GAIN = 1.7139588594436646
GATE_GAIN = 1.8
WS_EPS = 1e-4
CH = 32
N_BLOCKS = 10
RATES = (2, 4, 8, 16)

TRANSPOSED_CONV_PATTERNS = (r'tail\.[46]\.conv(_gate)?\.weight',)


def _gain(x: torch.Tensor, g: float) -> torch.Tensor:
    """The constant in x's dtype (bf16-rounded in a bf16 forward), as
    ``jnp.asarray(g, x.dtype)``."""
    return x.new_tensor(g)


def relu_nf(x):
    return F.relu(x) * _gain(x, RELU_NF_GAIN)


def _reflect_index(n: int, p: int, device) -> torch.Tensor:
    """Source indices of an axis of length n reflect-padded by p on both
    sides, reflecting repeatedly (period 2n - 2) as numpy does."""
    i = torch.arange(-p, n + p, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect padding of an NCHW tensor by p on each side of H and W."""
    if p == 0:
        return x
    x = x.index_select(2, _reflect_index(x.shape[2], p, x.device))
    return x.index_select(3, _reflect_index(x.shape[3], p, x.device))


def _ws_weight(w: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Scaled weight standardisation over dims (1, 2, 3) of a torch conv
    (OIHW: per output channel) or transposed-conv (IOHW: per input channel)
    weight, in f32 (f64 weights stay f64)."""
    wf = w.to(torch.promote_types(w.dtype, torch.float32))
    fan_in = wf.shape[1] * wf.shape[2] * wf.shape[3]
    var, mean = torch.var_mean(wf, dim=(1, 2, 3), keepdim=True,
                               correction=1)
    scale = torch.rsqrt(torch.clamp(var * fan_in, min=WS_EPS)) \
        * gain.float().view_as(var)
    return wf * scale - mean * scale


class ScaledWSConv(nn.Module):
    """Holds ``weight``, ``bias`` and ``gain`` under the checkpoint's
    names."""

    def __init__(self, ci: int, co: int, k: int, transpose: bool):
        super().__init__()
        shape = (ci, co, k, k) if transpose else (co, ci, k, k)
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(co))
        self.gain = nn.Parameter(torch.ones(ci if transpose else co, 1, 1, 1))

    def standardized(self, dtype: torch.dtype):
        return (_ws_weight(self.weight, self.gain.to(self.weight.dtype))
                .to(dtype),
                self.bias.to(dtype))


class GatedWSConv(nn.Module):
    """Reflect-padded gated conv: signal · sigmoid(gate) · 1.8."""

    def __init__(self, ci: int, co: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = ScaledWSConv(ci, co, k, False)
        self.conv_gate = ScaledWSConv(ci, co, k, False)
        self.k, self.stride = k, stride

    def forward(self, x):
        xp = reflect_pad(x, (self.k - 1) // 2)
        ws, bs = self.conv.standardized(x.dtype)
        wg, bg = self.conv_gate.standardized(x.dtype)
        signal = F.conv2d(xp, ws, bs, self.stride)
        gate = F.conv2d(xp, wg, bg, self.stride)
        return signal * torch.sigmoid(gate) * _gain(x, GATE_GAIN)


class GatedWSConvTranspose(nn.Module):
    def __init__(self, ci: int, co: int, k: int, stride: int):
        super().__init__()
        self.conv = ScaledWSConv(ci, co, k, True)
        self.conv_gate = ScaledWSConv(ci, co, k, True)
        self.k, self.stride = k, stride

    def forward(self, x):
        pad = (self.k - 1) // 2
        ws, bs = self.conv.standardized(x.dtype)
        wg, bg = self.conv_gate.standardized(x.dtype)
        signal = F.conv_transpose2d(x, ws, bs, self.stride, pad)
        gate = F.conv_transpose2d(x, wg, bg, self.stride, pad)
        return signal * torch.sigmoid(gate) * _gain(x, GATE_GAIN)


class _ReLUNF(nn.Module):
    def forward(self, x):
        return relu_nf(x)


class _PadConv(nn.Module):
    """Slot ``1`` of the reference's Sequential(ReflectionPad2d, Conv2d).
    The weights stay f32 and are cast to the input's dtype at each call
    (as ``conv2d`` of the JAX package does), so that the standardised
    convs keep computing their statistics from f32 weights."""

    def __init__(self, ci: int, co: int, dilation: int):
        super().__init__()
        self.add_module('1', nn.Conv2d(ci, co, 3, dilation=dilation))
        self.dilation = dilation

    def forward(self, x):
        conv = getattr(self, '1')
        return F.conv2d(reflect_pad(x, self.dilation),
                        conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                        dilation=self.dilation)


def _my_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """reference my_layer_norm (:164-169): spatial mean and unbiased std
    per channel, scaled to ±5; f32 inside (f64 stays f64)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(2, 3), keepdim=True)
    n = xf.shape[2] * xf.shape[3]
    var = xf.var(dim=(2, 3), keepdim=True, correction=0) * (n / max(n - 1, 1))
    std = torch.sqrt(var) + 1e-9
    return (5.0 * (2.0 * (xf - mean) / std - 1.0)).to(x.dtype)


class AOTBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        for i, rate in enumerate(RATES):
            self.add_module(f'block{i:02d}', _PadConv(dim, dim // 4, rate))
        self.fuse = _PadConv(dim, dim, 1)
        self.gate = _PadConv(dim, dim, 1)

    def forward(self, x):
        out = torch.cat([F.relu(getattr(self, f'block{i:02d}')(x))
                         for i in range(len(RATES))], 1)
        out = self.fuse(out)
        mask = torch.sigmoid(_my_layer_norm(self.gate(x)))
        return x * (1 - mask) + out * mask


class AOTGenerator(nn.Module):
    def __init__(self):
        super().__init__()
        dim = CH * 4
        self.head = nn.Sequential(
            GatedWSConv(4, CH, 3), _ReLUNF(),
            GatedWSConv(CH, CH * 2, 4, 2), _ReLUNF(),
            GatedWSConv(CH * 2, dim, 4, 2))
        self.body_conv = nn.Sequential(*[AOTBlock(dim)
                                         for _ in range(N_BLOCKS)])
        self.tail = nn.Sequential(
            GatedWSConv(dim, dim, 3), _ReLUNF(),
            GatedWSConv(dim, dim, 3), _ReLUNF(),
            GatedWSConvTranspose(dim, CH * 2, 4, 2), _ReLUNF(),
            GatedWSConvTranspose(CH * 2, CH, 4, 2), _ReLUNF(),
            GatedWSConv(CH, 3, 3))

    def forward(self, img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """img (N, H, W, 3) in [-1, 1] (pre-masked), mask (N, H, W, 1), both
        in the compute dtype → (N, H, W, 3) in [-1, 1]. The NHWC interface
        of the JAX ``aot_generator_forward``; NCHW inside."""
        x = torch.cat([mask, img], -1).permute(0, 3, 1, 2).contiguous()
        x = self.tail(self.body_conv(self.head(x)))
        return torch.clamp(x, -1, 1).permute(0, 2, 3, 1)


def build_aot(device='cpu', state_dict=None) -> AOTGenerator:
    from ..weights import load_state_dict_into
    model = AOTGenerator().eval()
    if state_dict is not None:
        load_state_dict_into(model, state_dict)
    return model.to(device)


def init_state_dict() -> Dict[str, torch.Tensor]:
    """Seeded random weights: the JAX package's ``init_params`` draws (same
    seed, order and scale), bridged to torch layouts."""
    from ..weights import torch_state_dict_from_jax
    rs = np.random.RandomState(11)
    params: Dict[str, np.ndarray] = {}

    def gated(key, ks, ci, co, transpose=False):
        for part in ('conv', 'conv_gate'):
            params[f'{key}.{part}.weight'] = (
                rs.randn(ks, ks, ci, co).astype(np.float32)
                * np.sqrt(1.0 / (ks * ks * ci))).astype(np.float32)
            params[f'{key}.{part}.bias'] = np.zeros((co,), np.float32)
            params[f'{key}.{part}.gain'] = np.ones(
                (ci if transpose else co, 1, 1, 1), np.float32)

    def conv(key, ks, ci, co):
        params[f'{key}.weight'] = (rs.randn(ks, ks, ci, co).astype(np.float32)
                                   * np.sqrt(2.0 / (ks * ks * ci))
                                   ).astype(np.float32)
        params[f'{key}.bias'] = np.zeros((co,), np.float32)

    gated('head.0', 3, 4, CH)
    gated('head.2', 4, CH, CH * 2)
    gated('head.4', 4, CH * 2, CH * 4)
    dim = CH * 4
    for i in range(N_BLOCKS):
        for j in range(len(RATES)):
            conv(f'body_conv.{i}.block{j:02d}.1', 3, dim, dim // 4)
        conv(f'body_conv.{i}.fuse.1', 3, dim, dim)
        conv(f'body_conv.{i}.gate.1', 3, dim, dim)
    gated('tail.0', 3, dim, dim)
    gated('tail.2', 3, dim, dim)
    gated('tail.4', 4, dim, CH * 2, transpose=True)
    gated('tail.6', 4, CH * 2, CH, transpose=True)
    gated('tail.8', 3, CH, 3)
    return torch_state_dict_from_jax(params, TRANSPOSED_CONV_PATTERNS)
