"""Fused OCR char head + top-k — kernel K3.

Counterpart of the JAX package's ``ops/pallas_charhead.py``
(``char_topk_fused``): the top-k of
``log_softmax(gelu(dec @ W1 + b1) @ Wv^T + bv)`` per decoder row, without
materialising the (N, V) logits on the card.

Precision contract (the kernel's and the plain version's): f32 sums over
the storage dtype, ``h`` rounded to the dtype of ``dec``, f32 logits, exact
erf GELU. Top-k order: larger value first, ties to the lower index.

* ``prepare_charhead`` packs the weights in the port's layout: W1 as
  (in, out), the vocab matrix as (V, E) rows (the embedding itself, no
  padding), biases f32.
* ``char_topk_ref`` is the plain PyTorch version; ``char_topk`` the
  wrapper: CPU tensors take the plain version, CUDA tensors launch
  ``csrc/charhead.cu`` (bf16 only; one cooperative launch per call) or
  raise. The launch allocates only its scratch (from PyTorch's allocator)
  and runs on the current stream, so a beam loop's CUDA graph capture
  records it; its grid-barrier buffer is made at the first eager call.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

KERNEL = 'charhead'
E = 320
CV = 64           # vocab rows per kernel chunk (csrc/charhead.cu)
TOPC = 5          # per-chunk candidates: the largest k the kernel serves
NMAX = 160        # rows one launch serves (24 crops x 5 beams = 120)


def prepare_charhead(pred1_weight: torch.Tensor, pred1_bias: torch.Tensor,
                     embd: torch.Tensor, pred_bias: torch.Tensor,
                     dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """pred1 as a torch Linear (out, in) weight; embd (V, E); pred bias
    (V,) → {'w1': (E, E) [in, out], 'b1', 'wv': (V, E), 'bv'}."""
    return {
        'w1': pred1_weight.detach().t().contiguous().to(dtype),
        'b1': pred1_bias.detach().float().contiguous(),
        'wv': embd.detach().contiguous().to(dtype),
        'bv': pred_bias.detach().float().contiguous(),
    }


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def char_topk_ref(dec: torch.Tensor, w: Dict[str, torch.Tensor], k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = F.gelu(dec.float() @ w['w1'].float() + w['b1']).to(dec.dtype)
    logits = h.float() @ w['wv'].float().t() + w['bv']
    vals, idx = stable_topk(logits, k)
    lse = torch.logsumexp(logits, dim=-1)
    return vals - lse[:, None], idx


def _check_weights(w: Dict[str, torch.Tensor], device) -> None:
    for name, dtype in (('w1', torch.bfloat16), ('wv', torch.bfloat16),
                        ('b1', torch.float32), ('bv', torch.float32)):
        t = w.get(name)
        if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                or not t.is_contiguous() or t.device != device):
            raise TypeError(f'char_topk: {name} must be a contiguous {dtype} '
                            f'tensor on {device}')
    v = w['wv'].shape[0]
    if (w['w1'].shape != (E, E) or w['b1'].shape != (E,)
            or w['wv'].shape != (v, E) or w['bv'].shape != (v,)):
        raise ValueError('char_topk: weight shapes do not match E=320')


_weights = cuda_build.CheckedWeights(('w1', 'b1', 'wv', 'bv'),
                                     _check_weights)


def _launch(dec: torch.Tensor, w: Dict[str, torch.Tensor], k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    weight_ptrs = _weights.pointers(w, dec.device)
    n = dec.shape[0]
    v = w['wv'].shape[0]
    if v < k:
        raise ValueError(f'char_topk: vocabulary of {v} rows < k={k}')
    n_chunks = -(-v // CV)
    dev = dec.device
    h = torch.empty_like(dec)
    pmax = torch.empty((n, n_chunks), dtype=torch.float32, device=dev)
    psum = torch.empty_like(pmax)
    pval = torch.empty((n, n_chunks, TOPC), dtype=torch.float32, device=dev)
    pidx = torch.empty((n, n_chunks, TOPC), dtype=torch.int32, device=dev)
    out_val = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    p = cuda_build.ptr
    status = cuda_build.entry(KERNEL)(
        p(dec), *weight_ptrs, n, v, k, p(h), p(pmax), p(psum), p(pval),
        p(pidx), p(out_val), p(out_idx),
        p(cuda_build.sync_buffer(KERNEL, dev)), cuda_build.current_stream(dev))
    cuda_build.check(status, 'char-head top-k kernel')
    cuda_build.count_launch(KERNEL)
    return out_val, out_idx


def char_topk(dec: torch.Tensor, w: Dict[str, torch.Tensor], k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, E) decoder outputs → (log-probs (N, k) f32, indices (N, k)
    int64)."""
    if dec.device.type == 'cpu':
        return char_topk_ref(dec, w, k)
    if dec.device.type != 'cuda':
        raise ValueError(f'char_topk: unsupported device {dec.device}')
    if dec.dim() != 2 or dec.shape[1] != E:
        raise ValueError(f'char_topk: expected (N, {E}), got '
                         f'{tuple(dec.shape)}')
    if not 1 <= dec.shape[0] <= NMAX:
        raise ValueError(f'char_topk: {dec.shape[0]} rows outside 1..{NMAX}')
    if not 1 <= k <= TOPC:
        raise ValueError(f'char_topk: k={k} outside 1..{TOPC}')
    if dec.dtype != torch.bfloat16:
        raise TypeError(f'char_topk: dec must be bf16, got {dec.dtype}')
    return _launch(dec.contiguous(), w, k)
