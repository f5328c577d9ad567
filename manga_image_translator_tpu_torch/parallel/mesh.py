"""Several devices: the mesh, data and tensor parallelism, the sharded page
step and a data-parallel training step.

Counterpart of the JAX package's ``parallel/mesh.py``. The reference has no
distributed compute (its only parallelism is HTTP fan-out to executor
processes). Here a mesh is an explicit list of ``torch.device`` laid out as
``(dp, tp)``:

* **data parallel over pages or crops** — each page's detection, OCR and
  inpainting are independent, so a batch splits over every mesh device;
  each shard runs on its device and the results are concatenated on the
  first. Distinct devices run their shards at once, one host thread each
  (the OCR beam loop is paced by the host); a device that appears more
  than once runs its shards in turn, which is how one card or the CPU
  stands in for several in the tests and the smoke;
* **tensor parallel within a model** — ``shard_ocr_params_tp`` splits each
  feed-forward of the OCR transformer over ``tp`` devices, with an
  explicit sum on the output device. The serving path is data parallel
  only, as in the JAX package: every model fits one card;
* **fine-tuning** — ``train_step_dbnet`` averages the detector's gradients
  over the ``dp`` shards on the first device and takes one SGD step.

Nothing here adds a collective backend: tensors move between devices by
copies. ``get_mesh`` returns None on a host with fewer than two CUDA
devices, and every call site then runs its single-device path.
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch
import torch.nn as nn


class Mesh:
    """``dp × tp`` devices, row-major: ``devices[i * tp + j]`` is data
    shard ``i``, tensor shard ``j``. A device may appear more than once."""

    def __init__(self, devices: List[torch.device], dp: int, tp: int):
        self.devices = list(devices)
        self.shape = {'dp': dp, 'tp': tp}

    def __repr__(self):
        return f'Mesh(dp={self.shape["dp"]}, tp={self.shape["tp"]}, ' \
               f'devices={[str(d) for d in self.devices]})'


_AUTO_MESH: Optional[Mesh] = None
_AUTO_MESH_FAILED = False


def get_mesh() -> Optional[Mesh]:
    """The process-global serving mesh: every CUDA device as ('dp', 'tp').

    Returns None on hosts with fewer than two CUDA devices or when
    disabled via MIT_TPU_MESH=0 — callers then run their single-device
    path. ``set_mesh`` installs another mesh or resets the cache."""
    global _AUTO_MESH, _AUTO_MESH_FAILED
    if os.environ.get('MIT_TPU_MESH', 'auto') == '0':
        return None
    if _AUTO_MESH is not None or _AUTO_MESH_FAILED:
        return _AUTO_MESH
    if torch.cuda.device_count() < 2:
        _AUTO_MESH_FAILED = True
        return None
    _AUTO_MESH = make_mesh()
    return _AUTO_MESH


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install ``mesh`` as the serving mesh (an explicit one, for example
    ``make_mesh(devices=[cpu] * 8)``), or with None forget the cached one
    so that ``get_mesh`` looks at the devices again."""
    global _AUTO_MESH, _AUTO_MESH_FAILED
    _AUTO_MESH = mesh
    _AUTO_MESH_FAILED = False


def make_mesh(n_devices: int = None, tp: int = None,
              devices: List[torch.device] = None) -> Mesh:
    """Mesh with ('dp', 'tp') axes covering exactly ``n_devices`` devices
    (of ``devices``, by default every CUDA device).

    tp defaults to 2 when divisible. Raises if fewer than ``n_devices``
    devices exist or the axes don't tile them — a silently-truncated mesh
    would "pass" multi-device checks while exercising one device.
    """
    if devices is None:
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices or n_devices < 1:
        raise ValueError(f'requested a {n_devices}-device mesh but only '
                         f'{len(devices)} devices are given')
    devices = devices[:n_devices]
    if tp is None:
        tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if n_devices % tp != 0:
        raise ValueError(f'{n_devices} devices not divisible by tp={tp}')
    return Mesh(devices, n_devices // tp, tp)


def mesh_devices(mesh: Mesh) -> int:
    return mesh.shape['dp'] * mesh.shape['tp']


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_pages(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Split a (N, ...) batch over EVERY mesh device (pure data
    parallelism; N must divide evenly): one shard per device, on it."""
    nd = mesh_devices(mesh)
    if x.shape[0] % nd:
        raise ValueError(f'{x.shape[0]} rows do not split over {nd} '
                         f'devices')
    return [s.to(d) for s, d in zip(torch.chunk(x, nd), mesh.devices)]


def _tensors(obj):
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def to_device(obj, device: torch.device):
    """``obj`` (a module, tensor, or dict / list / tuple of them) on
    ``device``: the object itself when it is already there, else a copy."""
    device = torch.device(device)
    if all(_same_device(t.device, device) for t in _tensors(obj)):
        return obj
    if isinstance(obj, nn.Module):
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != 'cuda':
        return True
    return (a.index or 0) == (b.index or 0)


def replicate(params, mesh: Mesh) -> list:
    """``params`` placed on every mesh device: a list aligned with
    ``mesh.devices``, one copy per distinct device (a repeated device
    shares it)."""
    by_device = {}
    out = []
    for d in mesh.devices:
        key = (d.type, d.index or 0)
        if key not in by_device:
            by_device[key] = to_device(params, d)
        out.append(by_device[key])
    return out


def _tree_concat(outs: list, device: torch.device):
    """Concatenate per-shard results (tensors, or dicts / tuples / lists of
    them) along the leading dim on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    if isinstance(first, dict):
        return {k: _tree_concat([o[k] for o in outs], device) for k in first}
    return type(first)(_tree_concat([o[i] for o in outs], device)
                       for i in range(len(first)))


def run_on_devices(jobs: list, devices: List[torch.device]) -> list:
    """Run ``jobs[i]()`` on ``devices[i]``: jobs of one device in turn,
    distinct devices at once (a thread each, with the caller's grad and
    inference modes). Returns the results in order."""
    groups: Dict[tuple, List[int]] = {}
    for i, d in enumerate(devices):
        groups.setdefault((d.type, d.index or 0), []).append(i)
    results = [None] * len(jobs)
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()

    def run_group(idxs):
        dev = devices[idxs[0]]
        ctx = (torch.cuda.device(dev) if dev.type == 'cuda'
               else contextlib.nullcontext())
        with ctx, torch.inference_mode(inference), \
                torch.set_grad_enabled(grad):
            for i in idxs:
                results[i] = jobs[i]()

    if len(groups) == 1:
        run_group(next(iter(groups.values())))
        return results
    # each thread in a copy of the caller's context: its spans stay in the
    # caller's page (utils.profiling)
    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        for fut in [pool.submit(contextvars.copy_context().run, run_group,
                                idxs)
                    for idxs in groups.values()]:
            fut.result()
    return results


_DP_CACHE: dict = {}


def data_parallel(fn, mesh: Mesh, n_batch_args: int, key=None):
    """Wrap ``fn(params, *batched) -> batched-or-tree`` to run over all
    mesh devices: params replicated (once per device, memoized on ``key``
    while the same params object is passed), every other argument split on
    its leading dim (which must divide evenly), results concatenated on
    the first device."""
    cache_key = (key, id(mesh), n_batch_args) if key is not None else None

    def wrapped(params, *batched):
        if len(batched) != n_batch_args:
            raise ValueError(f'expected {n_batch_args} batched arguments, '
                             f'got {len(batched)}')
        hit = _DP_CACHE.get(cache_key) if cache_key is not None else None
        if hit is not None and hit[0] is params:
            replicas = hit[1]
        else:
            replicas = replicate(params, mesh)
            if cache_key is not None:
                _DP_CACHE[cache_key] = (params, replicas)
        nd = mesh_devices(mesh)
        for b in batched:
            if b.shape[0] % nd:
                raise ValueError(f'{b.shape[0]} rows do not split over '
                                 f'{nd} devices')
        shards = [torch.chunk(b, nd) for b in batched]
        jobs = [
            (lambda i=i, d=d: fn(replicas[i],
                                 *[s[i].to(d) for s in shards]))
            for i, d in enumerate(mesh.devices)]
        return _tree_concat(run_on_devices(jobs, mesh.devices),
                            mesh.devices[0])
    return wrapped


def sharded_batch(fn, key, params, *batched, jit_fallback=None):
    """Run ``fn(params, *batched)`` data-parallel over the serving mesh.

    The leading (batch) dim of every ``batched`` arg is zero-padded to a
    device multiple, the call runs through ``data_parallel`` and outputs
    are cropped back. Without a mesh ``jit_fallback`` (or ``fn``) runs
    as it is — call sites stay single-device-identical."""
    mesh = get_mesh()
    if mesh is None:
        return (jit_fallback or fn)(params, *batched)
    nd = mesh_devices(mesh)
    n = batched[0].shape[0]
    pad = (-n) % nd
    if pad:
        batched = tuple(
            torch.cat([b, torch.zeros((pad,) + tuple(b.shape[1:]),
                                      dtype=b.dtype, device=b.device)])
            for b in batched)
    out = data_parallel(fn, mesh, len(batched), key=key)(params, *batched)
    if pad:
        out = _tree_map(lambda x: x[:n], out)
    return out


def _tree_map(f, tree):
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    return type(tree)(_tree_map(f, v) for v in tree)


# -- tensor parallelism for the OCR transformer ------------------------------

class TensorParallelFF(nn.Module):
    """``linear2(relu(linear1(x)))`` of one transformer layer split over
    ``tp`` devices: ``linear1`` by output columns and ``linear2`` by input
    rows; each device computes its slice of the hidden layer and its
    partial output, and the partials are summed on the output device with
    ``linear2``'s bias."""

    def __init__(self, linear1: nn.Linear, linear2: nn.Linear,
                 devices: List[torch.device]):
        super().__init__()
        tp = len(devices)
        hidden = linear1.out_features
        if hidden % tp:
            raise ValueError(f'hidden size {hidden} not divisible by tp={tp}')
        self.devices = list(devices)
        self.out_device = linear2.weight.device
        w1 = linear1.weight.detach().chunk(tp, dim=0)
        b1 = linear1.bias.detach().chunk(tp)
        w2 = linear2.weight.detach().chunk(tp, dim=1)
        self.w1 = nn.ParameterList(nn.Parameter(w.to(d), requires_grad=False)
                                   for w, d in zip(w1, devices))
        self.b1 = nn.ParameterList(nn.Parameter(b.to(d), requires_grad=False)
                                   for b, d in zip(b1, devices))
        self.w2 = nn.ParameterList(nn.Parameter(w.to(d), requires_grad=False)
                                   for w, d in zip(w2, devices))
        self.b2 = linear2.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def part(i):
            d = self.devices[i]
            h = torch.relu(torch.nn.functional.linear(
                x.to(d), self.w1[i].to(x.dtype), self.b1[i].to(x.dtype)))
            return torch.nn.functional.linear(h, self.w2[i].to(x.dtype))
        parts = run_on_devices([lambda i=i: part(i)
                                for i in range(len(self.devices))],
                               self.devices)
        out = parts[0].to(self.out_device)
        for p in parts[1:]:
            out = out + p.to(self.out_device)
        return out + self.b2.to(x.dtype)


class _TPEncoderLayer(nn.Module):
    """An OCR encoder layer whose feed-forward is a ``TensorParallelFF``."""

    def __init__(self, layer: nn.Module, ff: TensorParallelFF):
        super().__init__()
        self.self_attn = layer.self_attn
        self.norm1 = layer.norm1
        self.norm2 = layer.norm2
        self.ff = ff

    def forward(self, x, key_padding_mask):
        from ..models.ocr48 import xpos_attention
        x = x + xpos_attention(self.self_attn, self.norm1(x),
                               key_padding_mask)
        return x + self.ff(self.norm2(x))


def shard_ocr_params_tp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """A copy of the 48px OCR model whose encoder feed-forwards are split
    over the first ``tp`` row of the mesh (``TensorParallelFF``); every
    other weight stays on the model's device. The decoder's packed weights
    (kernel K2) stay whole on the first device."""
    tp_devices = mesh.devices[:mesh.shape['tp']]
    out = copy.copy(model)
    out._modules = dict(model._modules)
    out.encoders = nn.ModuleList(
        _TPEncoderLayer(layer, TensorParallelFF(layer.linear1, layer.linear2,
                                                tp_devices))
        for layer in model.encoders)
    out._cache = {}
    return out


# -- the sharded page step and the training step ------------------------------

def pipeline_step(mesh: Mesh, db_params, ocr_params, inpaint_params,
                  beams_k: int = 2, max_len: int = 6):
    """The production page step, data-parallel over the mesh.

    Runs the serving bodies — the bilateral prefilter (kernel K1) + DBNet
    forward (detection/default._maps_batch), the full 48px OCR beam decode
    (models/ocr48.beam_decode: kernels K2 and K3 on the card) and the AOT
    inpaint composite (inpainting/inpainting_aot._aot_body) — on every
    shard. The three models are the ``params`` tuple of the returned
    ``fn(params, pages, crops, widths, masks)``; every other argument is
    split on its leading dim over all mesh devices."""
    from ..detection.default import _maps_batch
    from ..inpainting import inpainting_aot
    from ..models.ocr48 import beam_decode
    from ..ocr.model_48px import bf16_backbone_enabled

    @torch.no_grad()
    def step(params, pages, crops, widths, masks):
        dbm, ocrm, inpm = params
        prob, _seg = _maps_batch(dbm, pages)
        dec = beam_decode(ocrm, crops.float() / 127.5 - 1.0, widths,
                          beams_k=beams_k, max_len=max_len,
                          bf16_backbone=bf16_backbone_enabled())
        img = pages.float() / 127.5 - 1.0
        inpainted = inpainting_aot._aot_body(inpm, img, masks,
                                             inpainting_aot.COMPUTE_DTYPE)
        return prob, dec['sequences'], dec['probs'], inpainted

    return data_parallel(step, mesh, 4,
                         key=('pipeline_step', id(mesh), beams_k, max_len))


class _AffineBN(nn.Module):
    """Inference-mode BatchNorm as the JAX package computes it (one
    multiply-add from the four statistics), differentiable in all four, as
    that package's training step differentiates them."""

    def __init__(self, bn: nn.BatchNorm2d):
        super().__init__()
        self.eps = bn.eps
        for name in ('weight', 'bias', 'running_mean', 'running_var'):
            setattr(self, name, nn.Parameter(getattr(bn, name).detach()))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def _trainable_dbnet() -> nn.Module:
    """A DBNet on the meta device whose BatchNorms are ``_AffineBN``, the
    module ``train_step_dbnet`` calls with the parameters it is given."""
    from ..models.dbnet import DBNet
    with torch.device('meta'):
        model = DBNet().eval()

    def swap(mod):
        for name, child in mod.named_children():
            if isinstance(child, nn.BatchNorm2d):
                setattr(mod, name, _AffineBN(child))
            else:
                swap(child)
    swap(model)
    return model


def train_step_dbnet(mesh: Mesh):
    """Data-parallel training step for the detector: the batch splits over
    the ``dp`` axis (one shard per mesh row, on the row's first device),
    each shard computes the L1 loss on ``sigmoid(db)`` and ``seg`` and its
    gradients (``torch.autograd``), the gradients and losses are averaged
    on the first device, then one SGD step ``p - lr * g`` cast to
    ``p.dtype``.

    Returns ``step(params, batch, target_prob, target_mask, lr) -> (loss,
    new_params)``; ``params`` is the detector's state dict (checkpoint
    keys, the BatchNorm statistics included: they are differentiated and
    updated as in the JAX package), ``batch`` (N, H, W, 3) pixels."""
    from ..models.dbnet import dbnet_forward
    template = _trainable_dbnet()
    names = [n for n, _ in template.named_parameters()]
    dp, tp = mesh.shape['dp'], mesh.shape['tp']
    devices = [mesh.devices[i * tp] for i in range(dp)]

    def loss_fn(params, batch, target_prob, target_mask):
        x = batch.float() / 127.5 - 1.0
        db, seg = torch.func.functional_call(
            template, params, (x.permute(0, 3, 1, 2).contiguous(),))
        prob = torch.sigmoid(db[:, 0])
        return (torch.mean(torch.abs(prob - target_prob))
                + torch.mean(torch.abs(seg[:, 0] - target_mask)))

    def step(params, batch, target_prob, target_mask, lr):
        for b in (batch, target_prob, target_mask):
            if b.shape[0] % dp:
                raise ValueError(f'{b.shape[0]} rows do not split over '
                                 f'dp={dp}')
        shards = [torch.chunk(b, dp) for b in (batch, target_prob,
                                                target_mask)]
        replicas = replicate({n: params[n] for n in names},
                             Mesh(devices, dp, 1))

        def shard(i):
            leaves = {n: t.detach().requires_grad_(True)
                      for n, t in replicas[i].items()}
            args = [s[i].to(devices[i]) for s in shards]
            loss = loss_fn(leaves, *args)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
            return loss.detach(), grads

        with torch.enable_grad():
            results = run_on_devices([lambda i=i: shard(i)
                                      for i in range(dp)], devices)
        first = devices[0]
        loss = torch.stack([r[0].to(first) for r in results]).mean()
        new_params = dict(params)
        with torch.no_grad():
            for j, n in enumerate(names):
                g = torch.stack([r[1][j].to(first)
                                 for r in results]).mean(0)
                p = params[n]
                new_params[n] = (p.to(first) - lr * g).to(p.dtype)
        return loss, new_params

    return step
