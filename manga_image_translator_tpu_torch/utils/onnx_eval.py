"""ONNX graph evaluator over ``onnx_lite``'s parsed graphs — PyTorch port.

Counterpart of the JAX package's ``utils/onnx_eval.py``: the auxiliary
ONNX models the reference runs through onnxruntime (the wd-swinv2 booru
tagger, ``inpainting/booru_tagger.py:40-102``) are interpreted op by op
into torch operations on the device of the caller's input. The machine
has neither ``onnx`` nor ``onnxruntime``.

Shape flow: ONNX exports compute shapes in the graph (Shape -> Gather ->
Concat -> Reshape). Any node whose inputs are all host values
(initializers, Shape results, Constants) is folded on the host with numpy,
as the JAX package does to keep its jit static (``_is_static``); only the
tensor compute reaches the device. Initializers that meet a device tensor
are uploaded once per device and kept. Host float64 values reach the
device as float32 (the JAX package's default dtypes). Conv, pool and norm
ops are NCHW, as in ONNX. Resize follows ``jax.image.resize`` (half-pixel
centres; an antialiasing triangle / Keys-cubic filter when downsampling),
which is what the JAX evaluator computes. An op outside the table raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .onnx_lite import OnnxGraph, OnnxNode

_CAST_DTYPES = {
    1: (np.float32, torch.float32), 2: (np.uint8, torch.uint8),
    3: (np.int8, torch.int8), 4: (np.uint16, torch.uint16),
    5: (np.int16, torch.int16), 6: (np.int32, torch.int32),
    7: (np.int64, torch.int64), 9: (np.bool_, torch.bool),
    10: (np.float16, torch.float16), 11: (np.float64, torch.float64),
    12: (np.uint32, torch.uint32), 13: (np.uint64, torch.uint64),
}


def _is_static(*vals) -> bool:
    return all(v is None or isinstance(v, (np.ndarray, np.generic, int,
                                           float, list, tuple))
               for v in vals)


def _ints(v) -> List[int]:
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _axes(node: OnnxNode, ins: Sequence, idx: int = 1) -> Optional[List[int]]:
    """Reduce-op axes: attribute (opset <= 17) or input (>= 18)."""
    if 'axes' in node.attrs:
        return [int(a) for a in node.attrs['axes']]
    if len(ins) > idx and ins[idx] is not None:
        return _ints(ins[idx])
    return None


def _pads(pads, nd: int):
    """ONNX (begins..., ends...) -> F.pad's (last_lo, last_hi, ...)."""
    pads = _ints(pads)
    out = []
    for i in reversed(range(nd)):
        out += [pads[i], pads[nd + i]]
    return out


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source indices of an axis of length n padded by (lo, hi) in numpy's
    ``edge`` or ``reflect`` mode (reflecting again past the far edge)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == 'edge' or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * n - 2
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def _resize_weights(m: int, n: int, kernel) -> np.ndarray:
    """(m, n) weights of ``jax.image.resize`` along one axis (scale n / m,
    no translation, antialias on)."""
    inv_scale = m / n
    kernel_scale = max(inv_scale, 1.)
    sample_f = (np.arange(n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :]
               - np.arange(m, dtype=np.float64)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, 0)


_RESIZE_KERNELS = {
    'linear': lambda x: np.maximum(0, 1 - np.abs(x)),
    'cubic': _keys_cubic,
}


class _Evaluator:
    def __init__(self, graph: OnnxGraph, device):
        self.graph = graph
        self.device = torch.device(device)
        self._init_ids = {id(v) for v in graph.initializers.values()}
        self._uploaded: Dict[int, torch.Tensor] = {}

    def _t(self, x) -> torch.Tensor:
        """x as a tensor on the device (initializers uploaded once)."""
        if isinstance(x, torch.Tensor):
            return x
        key = id(x)
        if key in self._uploaded:
            return self._uploaded[key]
        arr = np.asarray(x)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        t = torch.as_tensor(np.array(arr), device=self.device)    # a copy
        if key in self._init_ids:
            self._uploaded[key] = t
        return t

    # -- evaluation --------------------------------------------------------

    def run(self, feeds: Dict[str, torch.Tensor]) -> Dict[str, object]:
        env: Dict[str, object] = {}
        env.update(self.graph.initializers)
        env.update(feeds)
        for node in self.graph.nodes:
            impl = getattr(self, f'op_{node.op_type}', None)
            if impl is None:
                raise NotImplementedError(
                    f'ONNX op {node.op_type} (node {node.name!r}) is not '
                    f'supported by onnx_eval')
            ins = [env[n] if n else None for n in node.inputs]
            out = impl(node, *ins)
            if not isinstance(out, (tuple, list)):
                out = (out,)
            for name, val in zip(node.outputs, out):
                if name:
                    env[name] = val
        return {o: env[o] for o in self.graph.outputs}

    def _binary(self, a, b, fn):
        if _is_static(a, b):
            return fn(a, b)
        return fn(self._t(a), self._t(b))

    # -- elementwise -------------------------------------------------------

    def op_Add(self, node, a, b):
        return self._binary(a, b, lambda x, y: x + y)

    def op_Sub(self, node, a, b):
        return self._binary(a, b, lambda x, y: x - y)

    def op_Mul(self, node, a, b):
        return self._binary(a, b, lambda x, y: x * y)

    def op_Div(self, node, a, b):
        if _is_static(a, b):
            a, b = np.asarray(a), np.asarray(b)
            if np.issubdtype(a.dtype, np.integer) \
                    and np.issubdtype(b.dtype, np.integer):
                return a // b
            return a / b
        return self._t(a) / self._t(b)

    def op_Pow(self, node, a, b):
        return np.power(a, b) if _is_static(a, b) \
            else torch.pow(self._t(a), self._t(b))

    def op_Sqrt(self, node, x):
        return np.sqrt(x) if _is_static(x) else torch.sqrt(x)

    def op_Erf(self, node, x):
        return torch.erf(self._t(x))

    def op_Exp(self, node, x):
        return torch.exp(self._t(x))

    def op_Log(self, node, x):
        return torch.log(self._t(x))

    def op_Neg(self, node, x):
        return -x if _is_static(x) else -self._t(x)

    def op_Abs(self, node, x):
        return np.abs(x) if _is_static(x) else torch.abs(x)

    def op_Floor(self, node, x):
        return np.floor(x) if _is_static(x) else torch.floor(x)

    def op_Ceil(self, node, x):
        return np.ceil(x) if _is_static(x) else torch.ceil(x)

    def op_Tanh(self, node, x):
        return torch.tanh(self._t(x))

    def op_Sigmoid(self, node, x):
        return torch.sigmoid(self._t(x))

    def op_Relu(self, node, x):
        return torch.relu(self._t(x))

    def op_LeakyRelu(self, node, x):
        return F.leaky_relu(self._t(x), node.attrs.get('alpha', 0.01))

    def op_Gelu(self, node, x):
        approx = node.attrs.get('approximate', 'none')
        return F.gelu(self._t(x),
                      approximate='tanh' if approx == 'tanh' else 'none')

    def op_HardSigmoid(self, node, x):
        a = node.attrs.get('alpha', 0.2)
        b = node.attrs.get('beta', 0.5)
        return torch.clamp(a * self._t(x) + b, 0.0, 1.0)

    def op_HardSwish(self, node, x):
        x = self._t(x)
        return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)

    def op_Softmax(self, node, x):
        return torch.softmax(self._t(x), int(node.attrs.get('axis', -1)))

    def op_Clip(self, node, x, lo=None, hi=None):
        lo = node.attrs.get('min', lo)
        hi = node.attrs.get('max', hi)
        x = self._t(x)
        if lo is not None:
            x = torch.maximum(x, self._t(lo).to(x.dtype))
        if hi is not None:
            x = torch.minimum(x, self._t(hi).to(x.dtype))
        return x

    def op_Where(self, node, c, a, b):
        if _is_static(c, a, b):
            return np.where(c, a, b)
        return torch.where(self._t(c).bool(), self._t(a), self._t(b))

    def op_Equal(self, node, a, b):
        return self._binary(a, b, lambda x, y: x == y)

    def op_Less(self, node, a, b):
        return self._binary(a, b, lambda x, y: x < y)

    def op_Greater(self, node, a, b):
        return self._binary(a, b, lambda x, y: x > y)

    def op_Not(self, node, x):
        return np.logical_not(x) if _is_static(x) else ~self._t(x)

    def op_And(self, node, a, b):
        if _is_static(a, b):
            return np.logical_and(a, b)
        return self._t(a) & self._t(b)

    def op_Identity(self, node, x):
        return x

    def op_Cast(self, node, x):
        np_dt, t_dt = _CAST_DTYPES[int(node.attrs['to'])]
        if _is_static(x):
            return np.asarray(x).astype(np_dt)
        return self._t(x).to(t_dt)

    # -- reductions --------------------------------------------------------

    def _reduce(self, node, ins, fn_t, fn_np):
        x = ins[0]
        axes = _axes(node, ins)
        keep = bool(node.attrs.get('keepdims', 1))
        ax = None if axes is None else tuple(axes)
        if _is_static(x):
            return fn_np(np.asarray(x), axis=ax, keepdims=keep)
        x = self._t(x)
        return fn_t(x, dim=tuple(range(x.ndim)) if ax is None else ax,
                    keepdim=keep)

    def op_ReduceMean(self, node, *ins):
        return self._reduce(node, ins, torch.mean, np.mean)

    def op_ReduceSum(self, node, *ins):
        return self._reduce(node, ins, torch.sum, np.sum)

    def op_ReduceMax(self, node, *ins):
        return self._reduce(node, ins, torch.amax, np.max)

    def op_ReduceMin(self, node, *ins):
        return self._reduce(node, ins, torch.amin, np.min)

    def op_ReduceL2(self, node, *ins):
        x = self._t(ins[0])
        axes = _axes(node, ins)
        keep = bool(node.attrs.get('keepdims', 1))
        ax = tuple(range(x.ndim)) if axes is None else tuple(axes)
        return torch.sqrt(torch.sum(x * x, dim=ax, keepdim=keep))

    # -- shape plumbing ----------------------------------------------------

    def op_Shape(self, node, x):
        return np.asarray(_shape(x), np.int64)

    def op_Constant(self, node):
        for key in ('value', 'value_float', 'value_int', 'value_floats',
                    'value_ints'):
            if key in node.attrs:
                return np.asarray(node.attrs[key])
        raise ValueError('Constant node without value')

    def op_ConstantOfShape(self, node, shape):
        fill = node.attrs.get('value')
        if fill is None:
            fill = np.zeros(1, np.float32)
        fill = np.asarray(fill).reshape(-1)[0]
        return np.full(_ints(shape), fill)

    def op_Range(self, node, start, limit, delta):
        return np.arange(int(np.asarray(start)), int(np.asarray(limit)),
                         int(np.asarray(delta)), np.int64)

    def op_Reshape(self, node, x, shape):
        target = _ints(shape)
        cur = list(_shape(x))
        out = []
        for i, d in enumerate(target):
            if d == 0 and not node.attrs.get('allowzero', 0):
                out.append(cur[i])
            else:
                out.append(d)
        if _is_static(x):
            return np.asarray(x).reshape(out)
        return self._t(x).reshape(out)

    def op_Flatten(self, node, x):
        ax = int(node.attrs.get('axis', 1))
        shape = _shape(x)
        lead = int(np.prod(shape[:ax])) if ax else 1
        return self._t(x).reshape(lead, -1)

    def op_Transpose(self, node, x):
        perm = node.attrs.get('perm')
        if perm is None:
            perm = list(range(len(_shape(x))))[::-1]
        if _is_static(x):
            return np.transpose(np.asarray(x), perm)
        return self._t(x).permute(*perm)

    def op_Squeeze(self, node, x, axes=None):
        axes = _axes(node, (x, axes))
        nd = len(_shape(x))
        ax = None if axes is None else tuple(a % max(nd, 1) for a in axes)
        if _is_static(x):
            return np.squeeze(np.asarray(x), axis=ax)
        x = self._t(x)
        return x.squeeze() if ax is None else x.squeeze(ax)

    def op_Unsqueeze(self, node, x, axes=None):
        axes = _axes(node, (x, axes))
        out_rank = len(_shape(x)) + len(axes)
        ax = sorted(a % out_rank for a in axes)
        if _is_static(x):
            return np.expand_dims(np.asarray(x), tuple(ax))
        x = self._t(x)
        for a in ax:
            x = x.unsqueeze(a)
        return x

    def op_Concat(self, node, *ins):
        ax = int(node.attrs['axis'])
        xs = [x for x in ins if x is not None]
        if _is_static(*xs):
            return np.concatenate([np.atleast_1d(np.asarray(x))
                                   for x in xs], axis=ax)
        return torch.cat([self._t(x) for x in xs], dim=ax)

    def op_Split(self, node, x, split=None):
        ax = int(node.attrs.get('axis', 0))
        n_out = len(node.outputs)
        if 'split' in node.attrs:
            sizes = [int(s) for s in node.attrs['split']]
        elif split is not None:
            sizes = _ints(split)
        else:
            d = _shape(x)[ax]
            q = -(-d // n_out)
            sizes = [q] * (n_out - 1) + [d - q * (n_out - 1)]
        return tuple(torch.split(self._t(x), sizes, dim=ax))

    def op_Slice(self, node, x, starts=None, ends=None, axes=None,
                 steps=None):
        if starts is None:                       # opset-9 attribute form
            starts = node.attrs['starts']
            ends = node.attrs['ends']
            axes = node.attrs.get('axes')
        starts, ends = _ints(starts), _ints(ends)
        axes = list(range(len(starts))) if axes is None else _ints(axes)
        steps = [1] * len(starts) if steps is None else _ints(steps)
        shape = _shape(x)
        nd = len(shape)
        sl = [slice(None)] * nd
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            ax = ax % nd
            dim = shape[ax]
            if st < 0:
                st += dim
            if en < 0 and en > -(1 << 62):
                en += dim
            en = min(en, dim) if sp > 0 else max(en, -dim - 1)
            sl[ax] = slice(st, en, sp)
        if _is_static(x):
            return np.asarray(x)[tuple(sl)]
        x = self._t(x)
        for ax, s in enumerate(sl):
            if s.step is not None and s.step < 0:   # torch slices step > 0
                idx = torch.arange(*s.indices(shape[ax]), device=x.device)
                x = x.index_select(ax, idx)
                sl[ax] = slice(None)
        return x[tuple(sl)]

    def op_Gather(self, node, x, idx):
        ax = int(node.attrs.get('axis', 0))
        if _is_static(x, idx):
            return np.take(np.asarray(x), np.asarray(idx, np.int64),
                           axis=ax)
        x = self._t(x)
        ax = ax % x.ndim
        idx = self._t(idx).long()
        idx = torch.where(idx < 0, idx + x.shape[ax], idx)
        out = x.index_select(ax, idx.reshape(-1))
        return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])

    def op_GatherElements(self, node, x, idx):
        ax = int(node.attrs.get('axis', 0))
        return torch.gather(self._t(x), ax, self._t(idx).long())

    def op_Expand(self, node, x, shape):
        target = _ints(shape)
        cur = list(_shape(x))
        rank = max(len(target), len(cur))
        cur = [1] * (rank - len(cur)) + cur
        target = [1] * (rank - len(target)) + target
        out = [max(c, t) for c, t in zip(cur, target)]
        if _is_static(x):
            return np.broadcast_to(np.asarray(x).reshape(cur), out)
        return self._t(x).reshape(cur).expand(out)

    def op_Tile(self, node, x, reps):
        return torch.tile(self._t(x), tuple(_ints(reps)))

    def op_Pad(self, node, x, pads=None, value=None, axes=None):
        mode = node.attrs.get('mode', 'constant')
        if pads is None:
            pads = node.attrs['pads']
        pads = _ints(pads)
        x = self._t(x)
        nd = x.ndim
        ax = list(range(nd)) if axes is None else _ints(axes)
        cfg = [(0, 0)] * nd
        half = len(pads) // 2
        for i, a in enumerate(ax):
            cfg[a % nd] = (pads[i], pads[half + i])
        if mode == 'constant':
            cval = 0.0 if value is None else float(np.asarray(
                value.cpu() if isinstance(value, torch.Tensor) else value))
            flat = [p for a in reversed(range(nd)) for p in cfg[a]]
            return F.pad(x, flat, value=cval)
        if mode not in ('reflect', 'edge'):
            raise NotImplementedError(f'Pad mode {mode!r}')
        for a, (lo, hi) in enumerate(cfg):
            if lo or hi:
                x = x.index_select(a, _pad_index(x.shape[a], lo, hi, mode,
                                                 x.device))
        return x

    def op_Resize(self, node, x, roi=None, scales=None, sizes=None):
        x = self._t(x)
        shape = list(x.shape)
        if sizes is not None and np.size(_ints(sizes)):
            out_shape = _ints(sizes)
        else:
            if isinstance(scales, torch.Tensor):
                scales = scales.cpu().numpy()
            sc = np.asarray(scales, np.float64).reshape(-1)
            out_shape = [int(round(d * s)) for d, s in zip(shape, sc)]
        mode = node.attrs.get('mode', 'nearest')
        if mode not in ('nearest', 'linear', 'cubic'):
            raise NotImplementedError(f'Resize mode {mode!r}')
        for d, (m, n) in enumerate(zip(shape, out_shape)):
            if m == n:
                continue
            if mode == 'nearest':
                offs = np.floor(((np.arange(n, dtype=np.float32) + 0.5)
                                 * np.float32(m) / np.float32(n))
                                .astype(np.float32)).astype(np.int64)
                x = x.index_select(d, torch.as_tensor(offs, device=x.device))
            else:
                w = torch.as_tensor(
                    _resize_weights(m, n, _RESIZE_KERNELS[mode]),
                    dtype=x.dtype, device=x.device)
                x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])),
                                  -1, d)
        return x

    # -- linear algebra ----------------------------------------------------

    def op_MatMul(self, node, a, b):
        return torch.matmul(self._t(a), self._t(b))

    def op_Gemm(self, node, a, b, c=None):
        a, b = self._t(a), self._t(b)
        if node.attrs.get('transA', 0):
            a = a.T
        if node.attrs.get('transB', 0):
            b = b.T
        y = torch.matmul(a, b) * node.attrs.get('alpha', 1.0)
        if c is not None:
            y = y + self._t(c) * node.attrs.get('beta', 1.0)
        return y

    def op_Einsum(self, node, *ins):
        return torch.einsum(node.attrs['equation'],
                            *(self._t(x) for x in ins))

    # -- NN ops (NCHW, matching ONNX) --------------------------------------

    def op_Conv(self, node, x, w, b=None):
        x, w = self._t(x), self._t(w)
        ks = list(w.shape[2:])
        n_sp = len(ks)
        strides = [int(s) for s in node.attrs.get('strides', [1] * n_sp)]
        dil = [int(d) for d in node.attrs.get('dilations', [1] * n_sp)]
        group = int(node.attrs.get('group', 1))
        pads = node.attrs.get('pads')
        auto = node.attrs.get('auto_pad', 'NOTSET')
        if auto in ('SAME_UPPER', 'SAME_LOWER'):
            # XLA's 'SAME' for both: the odd pixel at the end
            lo_hi = []
            for i in range(n_sp):
                n = x.shape[2 + i]
                out = -(-n // strides[i])
                total = max((out - 1) * strides[i]
                            + (ks[i] - 1) * dil[i] + 1 - n, 0)
                lo_hi.append((total // 2, total - total // 2))
        elif pads is None:
            lo_hi = [(0, 0)] * n_sp
        else:
            pads = _ints(pads)
            lo_hi = list(zip(pads[:n_sp], pads[n_sp:]))
        flat = [p for i in reversed(range(n_sp)) for p in lo_hi[i]]
        if any(flat):
            x = F.pad(x, flat)
        conv = F.conv2d if n_sp == 2 else F.conv1d
        return conv(x, w, None if b is None else self._t(b), stride=strides,
                    dilation=dil, groups=group)

    def _pool(self, node, x, avg: bool):
        x = self._t(x)
        ks = [int(k) for k in node.attrs['kernel_shape']]
        strides = [int(s) for s in node.attrs.get('strides', [1] * len(ks))]
        pads = node.attrs.get('pads')
        flat = [0] * (2 * len(ks)) if pads is None else _pads(pads, len(ks))
        one_d = len(ks) == 1
        if one_d:                       # (N, C, W) -> (N, C, 1, W)
            x, ks, strides = x.unsqueeze(2), [1] + ks, [1] + strides
            flat = flat + [0, 0]
        if not avg:
            y = F.max_pool2d(F.pad(x, flat, value=float('-inf')), ks,
                             strides)
        else:
            y = F.avg_pool2d(F.pad(x, flat), ks, strides,
                             divisor_override=1)
            if node.attrs.get('count_include_pad', 0):
                counts = float(np.prod(ks))
            else:
                counts = F.avg_pool2d(F.pad(torch.ones_like(x), flat), ks,
                                      strides, divisor_override=1)
            y = y / counts
        return y.squeeze(2) if one_d else y

    def op_MaxPool(self, node, x):
        return self._pool(node, x, avg=False)

    def op_AveragePool(self, node, x):
        return self._pool(node, x, avg=True)

    def op_GlobalAveragePool(self, node, x):
        x = self._t(x)
        return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)

    def op_LayerNormalization(self, node, x, scale, bias=None):
        ax = int(node.attrs.get('axis', -1))
        eps = node.attrs.get('epsilon', 1e-5)
        x = self._t(x)
        axes = tuple(range(ax % x.ndim, x.ndim))
        mean = torch.mean(x, dim=axes, keepdim=True)
        var = torch.var(x, dim=axes, keepdim=True, correction=0)
        y = (x - mean) / torch.sqrt(var + eps) * self._t(scale)
        if bias is not None:
            y = y + self._t(bias)
        return y

    def op_BatchNormalization(self, node, x, scale, bias, mean, var):
        eps = node.attrs.get('epsilon', 1e-5)
        x = self._t(x)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale, bias, mean, var = (self._t(v).reshape(shape)
                                  for v in (scale, bias, mean, var))
        return (x - mean) / torch.sqrt(var + eps) * scale + bias

    def op_InstanceNormalization(self, node, x, scale, bias):
        eps = node.attrs.get('epsilon', 1e-5)
        x = self._t(x)
        axes = tuple(range(2, x.ndim))
        mean = torch.mean(x, dim=axes, keepdim=True)
        var = torch.var(x, dim=axes, keepdim=True, correction=0)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return ((x - mean) / torch.sqrt(var + eps)
                * self._t(scale).reshape(shape)
                + self._t(bias).reshape(shape))


def _feed_device(feeds) -> torch.device:
    for v in feeds.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device('cpu')


def evaluate(graph: OnnxGraph,
             feeds: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Evaluate the graph once on the device of the feeds' tensors."""
    with torch.inference_mode():
        return _Evaluator(graph, _feed_device(feeds)).run(feeds)


def make_runner(graph: OnnxGraph):
    """Single-input -> single-output runner on the input's device; the
    input is the graph's first non-initializer input. Initializers are
    uploaded to a device at its first run there and kept."""
    input_names = [n for n in graph.inputs if n not in graph.initializers]
    evaluators: Dict[torch.device, _Evaluator] = {}

    def run(x: torch.Tensor) -> torch.Tensor:
        ev = evaluators.get(x.device)
        if ev is None:
            ev = evaluators[x.device] = _Evaluator(graph, x.device)
        with torch.inference_mode():
            return ev._t(ev.run({input_names[0]: x})[graph.outputs[0]])

    return run
