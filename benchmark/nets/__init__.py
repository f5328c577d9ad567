"""The networks a configuration runs, one module each, found by the name
the configuration gives them under ``networks``.

Each module has:

* ``write(model_dir, spec, seed, device)``: the network's files, in the
  layout and format the program's loaders read, under ``model_dir``
  (``MIT_TPU_MODEL_DIR``), with weights drawn from ``seed``;
* ``files(spec)``: those files, relative to ``model_dir``;
* ``install(rec, spec)``: hooks that record, on the sampled pages, what
  the timed path feeds the network and what it returns, and for every
  page the shapes the work counts need;
* ``check(rec, spec, model_dir, device, control=None)``: the comparisons
  of what was recorded with the plain reference (under ``reference/``)
  in float32, as ``{number name: value}``; with ``control`` (a lower
  precision, ``precision.py``), the same comparisons with the reference
  computed in it put in the program's place: the control's readings.
"""
from __future__ import annotations

import importlib
import os
import re
from typing import Callable, Dict, Tuple

import torch


def load(name: str):
    return importlib.import_module(f'{__name__}.{name}')


def sampled(rec, name: str) -> bool:
    """Whether the window recorded anything of network ``name``."""
    return any(k.split('.')[0] == name and v for k, v in rec.samples.items())


def save_atomic(obj, path: str, writer: Callable = None) -> None:
    """Writes ``path`` through a temporary name beside it, so that a run
    cut short never leaves a partial file the next run would read."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.partial'
    if writer is None:
        torch.save(obj, tmp)
    else:
        writer(obj, tmp)
    os.replace(tmp, path)


def fan_in(key: str, shape: Tuple[int, ...], transposed: bool) -> int:
    if len(shape) == 4:
        cin = shape[0] if transposed else shape[1]
        return cin * shape[2] * shape[3]
    return shape[-1]


def draw_state_dict(template: Dict[str, torch.Tensor], rule: Callable,
                    seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict with ``template``'s keys, shapes and dtypes.
    ``rule(key, shape)`` gives ``('normal', std)`` or ``('const', v)``;
    all normal draws come from one ``torch.Generator`` on ``device`` in one
    call, in key order."""
    kinds = {k: rule(k, tuple(t.shape)) for k, t in template.items()}
    total = sum(t.numel() for k, t in template.items()
                if kinds[k][0] == 'normal')
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for k, t in template.items():
        kind, value = kinds[k]
        if kind == 'normal':
            n = t.numel()
            out[k] = (flat[at:at + n].view(t.shape) * value).to(
                t.dtype).cpu()
            at += n
        else:
            out[k] = torch.full(tuple(t.shape), value, dtype=t.dtype)
    return out


def conv_rule(template: Dict[str, torch.Tensor], gains: Dict[str, float],
              transposed: Tuple[str, ...] = (), bias_std: float = 0.02,
              overrides: Dict[str, Tuple[str, float]] = None):
    """The draw of each weight of ``template``: the first pattern of
    ``overrides`` a key matches gives its draw; else He-normal
    convolutions and N(0, 1/fan-in) linear layers, times the gain of the
    first pattern of ``gains`` the key matches; N(0, ``bias_std``) biases;
    batch norms at identity statistics, layer norms at 1 and 0."""
    gain_res = [(re.compile(p), g) for p, g in gains.items()]
    t_res = [re.compile(p) for p in transposed]
    o_res = [(re.compile(p), v) for p, v in (overrides or {}).items()]

    def rule(key, shape):
        hit = next((tuple(v) for p, v in o_res if p.search(key)), None)
        if hit is not None:
            return hit
        mod, leaf = key.rsplit('.', 1)
        if leaf in ('running_mean', 'num_batches_tracked'):
            return 'const', 0
        if leaf == 'running_var':
            return 'const', 1.0
        if len(shape) == 1:
            own = template.get(f'{mod}.weight')
            if leaf == 'weight':
                return 'const', 1.0
            if own is not None and own.dim() == 1:      # a norm's shift
                return 'const', 0.0
            return 'normal', bias_std
        gain = next((g for p, g in gain_res if p.search(key)), 1.0)
        if len(shape) == 4:
            tr = any(p.search(key) for p in t_res)
            return 'normal', gain * (2.0 / fan_in(key, shape, tr)) ** 0.5
        return 'normal', gain * fan_in(key, shape, False) ** -0.5
    return rule
