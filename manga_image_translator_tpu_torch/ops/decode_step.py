"""One 48px-OCR decoder step through all 5 layers — kernel K2.

Counterpart of the JAX package's ``ops/pallas_decode.py``
(``decode_step_pallas``), with the semantics of ``models/ocr48.decode_step``:
pre-LN self-attention over an XPOS-rotated KV cache (current step
included), cross-attention over pre-rotated memory K/V with a length mask,
ReLU feed-forward.

The port's own layout (no TPU lane padding):

* weights stacked over layers in [in, out] layout (``pack_decoder``), the
  attention scale applied to q in f32 (not folded into bf16 weights);
* self K/V caches ``(L, S, N, E)``, memory K/V ``(L, M, N, E)``, the
  cross-attention mask as per-row lengths ``mem_len (N,)`` int32 (the
  memory mask is a prefix mask);
* ``rot (S, 6, HD)`` f32 XPOS rows per step: self-q sin/cos, self-k sin/cos,
  cross-q sin/cos (``models.ocr48.xpos_step_tables``);
* the step as an ``int`` or a 0-d int64 tensor on the device of ``tgt``
  (the JAX kernel's scalar prefetch): the kernel reads it from device
  memory, so a beam loop advances it on the card and replays its steps as
  a CUDA graph (``ops.device_loop``). A device step outside ``0..S-1``
  makes the launch write the per-device error word and return;
  ``raise_step_error`` reads the word once, after the loop. A host
  ``int`` is checked before the launch;
* the beam's history as an ancestry table ``src (S, N)`` int32:
  ``src[t, n]`` is the cache row that holds position t of row n's history,
  for t < step; position ``step`` is row n itself. ``None`` is the identity.
  A beam search updates the table after each selection instead of moving
  the caches (the JAX kernel permutes them in place: ``fused_gather``); the
  attention sees the same values in the same order either way.

Precision contract of the kernel and of ``decode_step_ref``: storage in the
dtype of the caches (bf16 on the card; the plain version also runs in f32),
f32 accumulation, LayerNorm, softmax and rotation in f32; rounding to the
storage dtype at the LN outputs, q/k/v, the attention outputs, the FF
hidden layer and after each residual add.

``decode_step`` is the wrapper: CPU tensors take the plain version, CUDA
tensors launch ``csrc/decode_step.cu`` (bf16; one cooperative launch per
call) or raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import HOST_SYNCS, count
from . import cuda_build

KERNEL = 'decode_step'
E = 320
H = 4
HD = 80
L = 5
FF = 2048
WEIGHT_KEYS = ('wqkv', 'bqkv', 'wo', 'bo', 'wcq', 'bcq', 'wco', 'bco',
               'ln_w', 'ln_b', 'w1', 'b1', 'w2', 'b2')


def pack_decoder(decoders, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Stack the decoder layers (``models.ocr48.DecoderLayer``) into the
    kernel's layout: matrices [in, out] in ``dtype``, biases and norms f32,
    self-attention q|k|v fused into one (E, 3E) matrix per layer."""
    def st(fn, dt):
        return torch.stack([fn(d).detach() for d in decoders]).to(
            dt).contiguous()

    def wt(lin):
        return lin.weight.t()

    sa = lambda d: d.self_attn
    ca = lambda d: d.multihead_attn
    return {
        'wqkv': st(lambda d: torch.cat([wt(sa(d).q_proj), wt(sa(d).k_proj),
                                        wt(sa(d).v_proj)], dim=1), dtype),
        'bqkv': st(lambda d: torch.cat([sa(d).q_proj.bias, sa(d).k_proj.bias,
                                        sa(d).v_proj.bias]), torch.float32),
        'wo': st(lambda d: wt(sa(d).out_proj), dtype),
        'bo': st(lambda d: sa(d).out_proj.bias, torch.float32),
        'wcq': st(lambda d: wt(ca(d).q_proj), dtype),
        'bcq': st(lambda d: ca(d).q_proj.bias, torch.float32),
        'wco': st(lambda d: wt(ca(d).out_proj), dtype),
        'bco': st(lambda d: ca(d).out_proj.bias, torch.float32),
        'ln_w': st(lambda d: torch.stack([d.norm1.weight, d.norm2.weight,
                                          d.norm3.weight]), torch.float32),
        'ln_b': st(lambda d: torch.stack([d.norm1.bias, d.norm2.bias,
                                          d.norm3.bias]), torch.float32),
        'w1': st(lambda d: wt(d.linear1), dtype),
        'b1': st(lambda d: d.linear1.bias, torch.float32),
        'w2': st(lambda d: wt(d.linear2), dtype),
        'b2': st(lambda d: d.linear2.bias, torch.float32),
    }


def _rotate_pairs(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
                  ) -> torch.Tensor:
    """XPOS pair rotation over the last dim (E, tables tiled per head):
    out[2i] = x[2i] cos[2i] - x[2i+1] sin[2i];
    out[2i+1] = x[2i+1] cos[2i+1] + x[2i] sin[2i+1]."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return x * cos + rotated * sin


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + 1e-5) * w + b).to(x.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """q (N, E); k, v (T, N, E); valid (N, T) bool → (N, E)."""
    n, t = q.shape[0], k.shape[0]
    qh = q.float().view(n, H, HD)
    kh = k.float().view(t, n, H, HD)
    vh = v.float().view(t, n, H, HD)
    scores = torch.einsum('nhd,tnhd->nht', qh, kh)
    scores = scores.masked_fill(~valid[:, None, :], float('-inf'))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum('nht,tnhd->nhd', w, vh).reshape(n, E).to(q.dtype)


def _history_rows(step: int, n: int, src: Optional[torch.Tensor], device
                 ) -> Optional[torch.Tensor]:
    """(step + 1, N) long: the cache row of each position 0..step of each
    beam row's history (``src`` for t < step, row n at ``step``); ``None``
    for the identity."""
    if src is None:
        return None
    rows = torch.empty((step + 1, n), dtype=torch.long, device=device)
    rows[:step] = src[:step].to(device)
    rows[step] = torch.arange(n, device=device)
    return rows


def _host_step(step, s_len: int) -> int:
    """The plain version's step: an ``int``, or a 0-d tensor on the CPU
    read with ``item()``; raises outside ``0..s_len-1``."""
    if isinstance(step, torch.Tensor):
        if step.device.type != 'cpu' or step.dim() != 0:
            raise ValueError('decode_step_ref: the step must be an int or '
                             'a 0-d CPU tensor')
        step = int(step.item())
    if not 0 <= step < s_len:
        raise ValueError(f'decode_step: step {step} outside 0..{s_len - 1}')
    return step


def decode_step_ref(step, tgt: torch.Tensor, w: Dict[str, torch.Tensor],
                    rot: torch.Tensor, self_k: torch.Tensor,
                    self_v: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, mem_len: torch.Tensor,
                    src: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version; updates self_k/self_v at ``step`` in place and returns
    (out (N, E), k_new (L, N, E), v_new (L, N, E)). Self-attention reads
    each position's row through ``src`` (see the module note). ``step``:
    an ``int`` or a 0-d CPU tensor."""
    step = _host_step(step, self_k.shape[1])
    dt = self_k.dtype
    n = tgt.shape[0]
    m = mem_k.shape[1]
    scale = HD ** -0.5
    r = rot[step].to(tgt.device)
    tile = lambda row: row.repeat(H)
    sq_sin, sq_cos, sk_sin, sk_cos, cq_sin, cq_cos = (tile(r[i])
                                                      for i in range(6))
    pos = torch.arange(m, device=tgt.device)
    cross_valid = pos[None, :] < mem_len.to(tgt.device).long()[:, None]
    self_valid = torch.ones((n, step + 1), dtype=torch.bool,
                            device=tgt.device)
    rows = _history_rows(step, n, src, tgt.device)
    pos_t = torch.arange(step + 1, device=tgt.device)[:, None]
    x = tgt.to(dt)
    k_new = torch.empty((L, n, E), dtype=dt, device=tgt.device)
    v_new = torch.empty_like(k_new)
    for l in range(L):
        xn = _ln(x, w['ln_w'][l, 0], w['ln_b'][l, 0])
        qkv = xn.float() @ w['wqkv'][l].float() + w['bqkv'][l]
        q = _rotate_pairs(qkv[:, :E] * scale, sq_sin, sq_cos).to(dt)
        k = _rotate_pairs(qkv[:, E:2 * E], sk_sin, sk_cos).to(dt)
        v = qkv[:, 2 * E:].to(dt)
        self_k[l, step] = k
        self_v[l, step] = v
        k_new[l] = k
        v_new[l] = v
        if rows is None:
            keys, values = self_k[l, :step + 1], self_v[l, :step + 1]
        else:
            keys, values = self_k[l][pos_t, rows], self_v[l][pos_t, rows]
        attn = _attend(q, keys, values, self_valid)
        x = (x.float() + attn.float() @ w['wo'][l].float()
             + w['bo'][l]).to(dt)
        xn = _ln(x, w['ln_w'][l, 1], w['ln_b'][l, 1])
        q2 = _rotate_pairs((xn.float() @ w['wcq'][l].float() + w['bcq'][l])
                           * scale, cq_sin, cq_cos).to(dt)
        attn2 = _attend(q2, mem_k[l], mem_v[l], cross_valid)
        x = (x.float() + attn2.float() @ w['wco'][l].float()
             + w['bco'][l]).to(dt)
        xn = _ln(x, w['ln_w'][l, 2], w['ln_b'][l, 2])
        h1 = F.relu(xn.float() @ w['w1'][l].float() + w['b1'][l]).to(dt)
        x = (x.float() + h1.float() @ w['w2'][l].float()
             + w['b2'][l]).to(dt)
    return x, k_new, v_new


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'decode_step: {name} must be a tensor, got '
                        f'{type(t).__name__}')
    if t.device != device:
        raise ValueError(f'decode_step: {name} on {t.device}, expected '
                         f'{device}')
    if t.dtype != dtype:
        raise TypeError(f'decode_step: {name} is {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'decode_step: {name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'decode_step: {name} must be contiguous')


_BF = torch.bfloat16
_F32 = torch.float32
WEIGHT_LAYOUT = {
    'wqkv': ((L, E, 3 * E), _BF), 'bqkv': ((L, 3 * E), _F32),
    'wo': ((L, E, E), _BF), 'bo': ((L, E), _F32),
    'wcq': ((L, E, E), _BF), 'bcq': ((L, E), _F32),
    'wco': ((L, E, E), _BF), 'bco': ((L, E), _F32),
    'ln_w': ((L, 3, E), _F32), 'ln_b': ((L, 3, E), _F32),
    'w1': ((L, E, FF), _BF), 'b1': ((L, FF), _F32),
    'w2': ((L, FF, E), _BF), 'b2': ((L, E), _F32),
}
FF2_SPLITS = 8    # FF2's split over K in csrc/decode_step.cu
NMAX = 160        # beam rows one launch serves (24 crops x 5 beams = 120)


def _check_weights(w: Dict[str, torch.Tensor], device) -> None:
    for key in WEIGHT_KEYS:
        shape, dtype = WEIGHT_LAYOUT[key]
        _check(key, w.get(key), dtype, shape, device)


_weights = cuda_build.CheckedWeights(WEIGHT_KEYS, _check_weights)

_error_words: Dict[str, torch.Tensor] = {}


def _error_word(device) -> torch.Tensor:
    """The (2,) int32 word of ``device`` that a launch with an
    out-of-range device step sets to (1, step); zeroed once, allocated
    before any capture (``cuda_build.persistent_zeros``)."""
    return cuda_build.persistent_zeros(_error_words, str(device), 2, device)


def raise_step_error(device) -> None:
    """Read (one host read) and clear the error word of ``device``; raise
    if a launch since the last read had its step outside the cache."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    word = _error_words.get(str(device))
    if word is None:
        return
    count(HOST_SYNCS)
    flag, step = word.tolist()
    if flag:
        word.zero_()
        raise ValueError(f'decode_step: device step {step} outside the '
                         'cache; the launch wrote nothing')


def _launch(step, tgt, w, rot, self_k, self_v, mem_k, mem_v, mem_len, src,
            stamps=None):
    n = tgt.shape[0]
    dev = tgt.device
    s_len = self_k.shape[1] if isinstance(self_k, torch.Tensor) else 0
    m_len = mem_k.shape[1] if isinstance(mem_k, torch.Tensor) else 0
    _check('tgt', tgt, _BF, (n, E), dev)
    _check('self_k', self_k, _BF, (L, s_len, n, E), dev)
    _check('self_v', self_v, _BF, (L, s_len, n, E), dev)
    _check('mem_k', mem_k, _BF, (L, m_len, n, E), dev)
    _check('mem_v', mem_v, _BF, (L, m_len, n, E), dev)
    _check('mem_len', mem_len, torch.int32, (n,), dev)
    _check('rot', rot, _F32, (s_len, 6, HD), dev)
    if not 1 <= n <= NMAX or m_len < 1:
        raise ValueError(f'decode_step: N={n} outside 1..{NMAX} or an empty '
                         f'memory (M={m_len})')
    if src is not None:
        _check('src', src, torch.int32, (s_len, n), dev)
    if isinstance(step, torch.Tensor):
        _check('step', step, torch.int64, (), dev)
    else:
        if not 0 <= step < s_len:
            raise ValueError(f'decode_step: step {step} outside '
                             f'0..{s_len - 1}')
        step = torch.full((), step, dtype=torch.int64, device=dev)
    weight_ptrs = _weights.pointers(w, dev)

    out = tgt.clone()
    k_new = torch.empty((L, n, E), dtype=_BF, device=dev)
    v_new = torch.empty_like(k_new)
    q_buf = torch.empty((n, E), dtype=_BF, device=dev)
    attn_buf = torch.empty_like(q_buf)
    h_buf = torch.empty((n, FF), dtype=_BF, device=dev)
    partial = torch.empty((FF2_SPLITS, n, E), dtype=_F32, device=dev)
    p = cuda_build.ptr
    status = cuda_build.entry(KERNEL)(
        n, s_len, m_len, p(step), p(out), *weight_ptrs, p(rot),
        p(self_k), p(self_v), p(mem_k), p(mem_v), p(mem_len),
        None if src is None else p(src), p(k_new), p(v_new), p(q_buf),
        p(attn_buf), p(h_buf), p(partial),
        p(cuda_build.sync_buffer(KERNEL, dev)), p(_error_word(dev)),
        None if stamps is None else p(stamps), cuda_build.current_stream(dev))
    cuda_build.check(status, 'decode-step kernel')
    cuda_build.count_launch(KERNEL)
    return out, k_new, v_new


# the kernel's phases, in the order it runs them in each layer
PHASES = ('qkv', 'self_attention', 'out_proj', 'cross_q', 'cross_attention',
          'cross_out_proj', 'ff1', 'ff2')


def phase_clocks(step, tgt, w, rot, self_k, self_v, mem_k, mem_v, mem_len,
                 src=None) -> torch.Tensor:
    """Launch the kernel once (CUDA tensors only) with its phase stamps
    on: (L * 8, 2) int64 SM clocks of block 0 at the start and the end of
    each phase (layer-major, ``PHASES`` order). A phase's start minus the
    previous phase's end is block 0's wait at the grid barrier."""
    stamps = torch.zeros(2 * L * len(PHASES), dtype=torch.int64,
                         device=tgt.device)
    _launch(step, tgt, w, rot, self_k, self_v, mem_k, mem_v, mem_len, src,
            stamps)
    return stamps.view(L * len(PHASES), 2)


def decode_step(step, tgt: torch.Tensor, w: Dict[str, torch.Tensor],
                rot: torch.Tensor, self_k: torch.Tensor, self_v: torch.Tensor,
                mem_k: torch.Tensor, mem_v: torch.Tensor,
                mem_len: torch.Tensor, src: Optional[torch.Tensor] = None):
    """One decoder step for (N,) beam rows at position ``step`` (an
    ``int``, or a 0-d int64 tensor on ``tgt``'s device), the history read
    through the ancestry table ``src`` (None: identity).

    Returns ``(out (N, E), k_new (L, N, E), v_new (L, N, E), (self_k,
    self_v))``; the caches are updated in place at ``step``."""
    if tgt.device.type == 'cpu':
        out, k_new, v_new = decode_step_ref(step, tgt, w, rot, self_k,
                                            self_v, mem_k, mem_v, mem_len,
                                            src)
    elif tgt.device.type == 'cuda':
        out, k_new, v_new = _launch(step, tgt, w, rot, self_k, self_v,
                                    mem_k, mem_v, mem_len, src)
    else:
        raise ValueError(f'decode_step: unsupported device {tgt.device}')
    return out, k_new, v_new, (self_k, self_v)
