"""Minimal pure-Python ncnn model reader + PyTorch graph evaluator.

Counterpart of the JAX package's ``utils/ncnn_lite.py``. The reference's
waifu2x backend shells out to waifu2x-ncnn-vulkan (reference
``upscaling/waifu2x.py:52-105``) with ``-m models-cunet -n 0``: the
executable archive carries ncnn ``.param``/``.bin`` graphs for cunet and
the upconv_7 families, at several noise levels. This module reads the
format directly (the parser is the JAX package's, plain Python) and runs
the layer DAG as PyTorch ops on the input's device.

Format notes (ncnn project, param magic 7767517):

* ``.param`` text: ``magic\\nlayer_count blob_count\\n`` then one line per
  layer: ``type name n_in n_out <in blobs> <out blobs> k=v ...``. Integer
  keys are scalar ints/floats; a key ``-233xx`` marks an ARRAY value for
  id ``xx`` written as ``count,v0,v1,...``.
* ``.bin``: for each weight-carrying layer in file order, a uint32 dtype
  tag (0 = fp32) + the weight floats, then (untagged) bias floats when
  bias_term=1. Convolution weights are OIHW; Deconvolution weights IOHW.

Supported layers cover the waifu2x model zoo (upconv_7 = Conv/ReLU chains
+ one Deconvolution; cunet adds Split/Concat/Crop skip plumbing, BinaryOp
residuals and SE blocks = global Pooling + InnerProduct + Sigmoid +
broadcast multiply). The evaluator works in NCHW, ncnn's own CHW order
with a batch axis in front (Concat axis 0 = channels = dim 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class Layer:
    type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    params: Dict[int, object]          # scalar int/float or list
    weights: Dict[str, np.ndarray]
    # the weights as tensors, by (name, device, dtype)
    tensors: Dict[tuple, torch.Tensor] = field(default_factory=dict)

    def p(self, key: int, default=0):
        return self.params.get(key, default)


def _parse_value(tok: str):
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def parse_param(text: str) -> List[Layer]:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    assert lines[0] == '7767517', 'not an ncnn param file'
    layers: List[Layer] = []
    for ln in lines[2:]:
        parts = ln.split()
        ltype, name = parts[0], parts[1]
        n_in, n_out = int(parts[2]), int(parts[3])
        inputs = parts[4:4 + n_in]
        outputs = parts[4 + n_in:4 + n_in + n_out]
        params: Dict[int, object] = {}
        for item in parts[4 + n_in + n_out:]:
            if '=' not in item:
                continue
            k, v = item.split('=', 1)
            k = int(k)
            if k <= -23300:           # array value: count,v0,v1,...
                vals = v.split(',')
                params[-k - 23300] = [_parse_value(t) for t in vals[1:]]
            else:
                params[k] = _parse_value(v)
        layers.append(Layer(ltype, name, inputs, outputs, params, {}))
    return layers


_WEIGHTED = {'Convolution', 'ConvolutionDepthWise', 'Deconvolution',
             'InnerProduct'}


def load_ncnn(param_path, bin_path) -> List[Layer]:
    """Parse a .param/.bin pair into layers with attached weights."""
    layers = parse_param(Path(param_path).read_text())
    blob = Path(bin_path).read_bytes()
    off = 0
    for layer in layers:
        if layer.type not in _WEIGHTED:
            continue
        wsize = int(layer.p(6 if layer.type != 'InnerProduct' else 2))
        tag = np.frombuffer(blob, np.uint32, 1, off)[0]
        assert tag == 0, (f'{layer.name}: non-fp32 ncnn weights '
                          f'(tag {tag})')
        off += 4
        w = np.frombuffer(blob, np.float32, wsize, off).copy()
        off += 4 * wsize
        layer.weights['weight'] = w
        n_out = int(layer.p(0))
        if layer.p(5 if layer.type != 'InnerProduct' else 1, 0):
            layer.weights['bias'] = np.frombuffer(blob, np.float32, n_out,
                                                  off).copy()
            off += 4 * n_out
        else:
            layer.weights['bias'] = np.zeros((n_out,), np.float32)
    return layers


def _weight(layer: Layer, name: str, x: torch.Tensor) -> torch.Tensor:
    """A layer's weight as a tensor on ``x``'s device and dtype, made once
    per device and dtype."""
    key = (name, x.device, x.dtype)
    if key not in layer.tensors:
        layer.tensors[key] = torch.from_numpy(layer.weights[name]).to(
            x.device, x.dtype)
    return layer.tensors[key]


def _activation(x, act_type: int, act_params):
    if act_type == 0:
        return x
    if act_type == 1:
        return torch.relu(x)
    if act_type == 2:
        slope = float(act_params[0]) if act_params else 0.0
        return torch.where(x >= 0, x, slope * x)
    if act_type == 4:
        return torch.sigmoid(x)
    raise NotImplementedError(f'ncnn activation {act_type}')


def _conv(layer: Layer, x):
    n_out = int(layer.p(0))
    kw = int(layer.p(1, 3))
    kh = int(layer.p(11, kw))
    dil = int(layer.p(2, 1))
    stride = int(layer.p(3, 1))
    pad = int(layer.p(4, 0))
    n_in = x.shape[1]
    groups = int(layer.p(7, 1)) if layer.type == 'ConvolutionDepthWise' \
        else 1
    w = _weight(layer, 'weight', x).reshape(n_out, n_in // groups, kh, kw)
    y = F.conv2d(x, w, _weight(layer, 'bias', x), stride, pad, dil, groups)
    return _activation(y, int(layer.p(9, 0)), layer.p(10, []))


def _deconv(layer: Layer, x):
    n_out = int(layer.p(0))
    kw = int(layer.p(1, 3))
    kh = int(layer.p(11, kw))
    stride = int(layer.p(3, 1))
    pad = int(layer.p(4, 0))
    n_in = x.shape[1]
    # ncnn's IOHW is torch's ConvTranspose2d layout
    w = _weight(layer, 'weight', x).reshape(n_in, n_out, kh, kw)
    y = F.conv_transpose2d(x, w, _weight(layer, 'bias', x), stride, pad)
    return _activation(y, int(layer.p(9, 0)), layer.p(10, []))


def _crop(layer: Layer, blobs: Sequence[torch.Tensor]):
    x = blobs[0]
    woff = int(layer.p(0, 0))
    hoff = int(layer.p(1, 0))
    coff = int(layer.p(2, 0))
    if len(blobs) > 1:                  # crop to reference blob's H, W
        ref = blobs[1]
        outh, outw = ref.shape[2], ref.shape[3]
        outc = x.shape[1] - coff
    else:
        outw = int(layer.p(3, 0)) or x.shape[3] - 2 * woff
        outh = int(layer.p(4, 0)) or x.shape[2] - 2 * hoff
        outc = int(layer.p(5, 0)) or x.shape[1] - coff
    return x[:, coff:coff + outc, hoff:hoff + outh, woff:woff + outw]


def _binary_op(layer: Layer, blobs: Sequence[torch.Tensor]):
    op = int(layer.p(0, 0))
    a, b = blobs[0], blobs[1]
    # ncnn broadcasts a per-channel (c,1,1) operand over (c,h,w): a flat
    # (N, C) operand (a global pooling's) becomes (N, C, 1, 1)
    if a.ndim != b.ndim:
        if a.ndim < b.ndim:
            a = a.reshape(a.shape[0] if a.ndim > 1 else 1, -1, 1, 1)
        else:
            b = b.reshape(b.shape[0] if b.ndim > 1 else 1, -1, 1, 1)
    if op == 0:
        return a + b
    if op == 1:
        return a - b
    if op == 2:
        return a * b
    if op == 3:
        return a / b
    if op == 4:
        return torch.maximum(a, b)
    raise NotImplementedError(f'ncnn BinaryOp {op}')


def run_graph(layers: List[Layer], x: torch.Tensor) -> torch.Tensor:
    """Execute the layer DAG on an NCHW input; returns the last blob."""
    blobs: Dict[str, torch.Tensor] = {}
    out = x
    for layer in layers:
        t = layer.type
        if t == 'Input':
            blobs[layer.outputs[0]] = x
            out = x
            continue
        ins = [blobs[n] for n in layer.inputs]
        if t in ('Convolution', 'ConvolutionDepthWise'):
            out = _conv(layer, ins[0])
        elif t == 'Deconvolution':
            out = _deconv(layer, ins[0])
        elif t == 'ReLU':
            slope = float(layer.p(0, 0.0))
            out = (torch.relu(ins[0]) if slope == 0.0
                   else torch.where(ins[0] >= 0, ins[0], slope * ins[0]))
        elif t == 'Sigmoid':
            out = torch.sigmoid(ins[0])
        elif t == 'Split':
            for o in layer.outputs:
                blobs[o] = ins[0]
            out = ins[0]
            continue
        elif t == 'Concat':
            axis = int(layer.p(0, 0))   # ncnn CHW: 0 = channels
            out = torch.cat(ins, dim=axis + 1)
        elif t == 'Crop':
            out = _crop(layer, ins)
        elif t == 'BinaryOp':
            out = _binary_op(layer, ins)
        elif t == 'Pooling':
            ptype = int(layer.p(0, 0))
            if int(layer.p(4, 0)):      # global pooling -> (N, C)
                out = (ins[0].amax(dim=(2, 3)) if ptype == 0
                       else ins[0].mean(dim=(2, 3)))
            else:
                k = int(layer.p(1, 2))
                s = int(layer.p(2, k))
                out = (F.max_pool2d(ins[0], k, s) if ptype == 0
                       else F.avg_pool2d(ins[0], k, s))
        elif t == 'InnerProduct':
            n_out = int(layer.p(0))
            v = ins[0].reshape(ins[0].shape[0], -1)
            w = _weight(layer, 'weight', v).reshape(n_out, -1)
            out = F.linear(v, w, _weight(layer, 'bias', v))
            out = _activation(out, int(layer.p(9, 0)), layer.p(10, []))
        elif t == 'Interp':
            # bilinear/nearest resize (param 0: 1 nearest, 2 bilinear;
            # 1/2: h/w scale factors), half-pixel centres as jax.image
            mode = int(layer.p(0, 1))
            sh = float(layer.p(1, 1.0))
            sw = float(layer.p(2, 1.0))
            n, c, h, w = ins[0].shape
            size = (int(round(h * sh)), int(round(w * sw)))
            if mode == 1:
                out = F.interpolate(ins[0], size=size, mode='nearest-exact')
            else:
                out = F.interpolate(ins[0], size=size, mode='bilinear',
                                    align_corners=False,
                                    antialias=min(sh, sw) < 1)
        else:
            raise NotImplementedError(f'ncnn layer type {t}')
        blobs[layer.outputs[0]] = out
    return out


def make_forward(layers: List[Layer]):
    """``fn(x_nchw) -> y_nchw`` running the DAG."""
    def fn(x):
        return run_graph(layers, x)
    return fn


# --- waifu2x model-zoo file layout --------------------------------------

def model_relpath(family: str, noise: int, scale: int) -> str:
    """Relative path of a waifu2x ncnn model inside the release archive
    (reference executable flags: ``-m models-<family> -n <noise>
    -s <scale>``)."""
    folders = {
        'cunet': 'models-cunet',
        'upconv_7_anime': 'models-upconv_7_anime_style_art_rgb',
        'upconv_7_photo': 'models-upconv_7_photo',
    }
    folder = folders[family]
    if noise < 0:
        stem = f'scale{scale}.0x_model'
    elif scale <= 1:
        stem = f'noise{noise}_model'
    else:
        stem = f'noise{noise}_scale{scale}.0x_model'
    return f'{folder}/{stem}'
