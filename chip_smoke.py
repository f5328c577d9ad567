#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (nvidia-smi) and checks that the
   host libraries of the pipeline import (cv2, PIL, pydantic, networkx);
2. builds every kernel of the port from ``manga_image_translator_tpu_torch/
   csrc`` with nvcc (sm_90a) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, within the stated tolerance (K1 bilateral on
   the 2048x2048 canvas, the 1448x2048 page and uniform random bytes, K2
   decoder step at N=120 and 80 through a random ancestry table, K3 char
   head, K4 FourierUnit, K5 streaming conv), and the whole 18-block LaMa
   generator on a 512² crop in f32 against its plain routes;
4. writes a synthetic Sugoi model (the default translator's ct2 model at
   its published widths, int8 weights from a seed, with its spm models)
   into its own ``MIT_TPU_MODEL_DIR``; holds that transformer on the card
   against the same model on the CPU (``translate_check``: encoder states
   and first-step log-probs within 1e-4 of max |value|, equal tokens at
   beam 5 and 1); drives the port's main path — the ``local`` CLI mode
   with the default ``Config`` (detect → 48px OCR → textline merge →
   translate ``sugoi`` → mask refinement → inpaint ``lama_large`` → render
   ``default``) on two synthetic pages — with the
   launch counters set to 0 just before and read just after; random-weight
   detectors may find no text, so the OCR, mask-refinement, inpainting and
   rendering stage runners also run on the pages' known text boxes; every
   kernel must have launched, K4 36 times and K5 twice per generator
   forward; the inpainted page may change only inside the mask, the
   rendered one only inside the text boxes; then runs the literal
   ``python -m manga_image_translator_tpu_torch local`` command in a
   process of its own; prints a ``translate`` line per page (sentences,
   chunks, decoder steps, stage ms, wall ms against device-busy µs per
   beam step);
   the batch path: ``translate_batch`` on three pages (``batch``, its
   launch counters set to 0 just before and read just after; the
   detection pre-pass's line lists become the pages' known boxes), which
   must serve every page in its batched detection, pooled OCR and batched
   inpainting, launch every kernel, read the same texts as the per-page
   OCR and change pixels only inside the mask and the text boxes; K1 on
   its three letterboxed canvases and the generator at its largest crop
   bucket against their plain versions; the HTTP gateway with
   ``--start-instance`` (``server``: the gateway and its ``shared``
   executor, each a process of its own, answer ``/translate/json``,
   ``/translate/bytes/stream`` and ``/translate/batch/json``); one page
   through the ws worker (``ws``); the other detectors and inpainters
   (``backends``): each network (ctd, craft with its refiner, dbconvnext,
   paddle, AOT, the 9-block lama_mpe generator with its embeddings) on
   the card against the CPU within 1e-3 of max |cpu|, the lama_mpe
   generator's K4/K5 routes against its plain routes, one page through
   the ``local`` CLI with ``ctd`` + ``lama_mpe`` (K1-K5 must launch, only
   9-block MPE forwards) and with ``craft`` + ``default`` (AOT; K1-K3
   must launch, K4 and K5 not), then ``dbconvnext`` and ``paddle``
   through ``detection.dispatch``; the other OCRs, the upscalers and the
   colorizer (``extras``): each network (ESRGAN at nb 6 and 23, FFDNet,
   the mc2 generator, ocr32, ocr48_ctc, upconv_7, a cunet-style ncnn
   graph) on the card against the CPU within 1e-3 of max |cpu|, one
   724x1024 scan through the ``local`` CLI with colorizer ``mc2``,
   upscaler ``esrgan`` at ratio 2 and OCR ``32px`` (K1 must launch in
   detection and in mask refinement, K4 and K5 in LaMa, K2 and K3 not),
   then OCR → render on the upscaled page's known boxes, ``48px_ctc`` and
   ``mocr`` (its text model stubbed; K2 and K3 must launch) through
   ``ocr.dispatch``, ``4xultrasharp`` and ``waifu2x`` through
   ``upscaling.dispatch``; K1 on the upscaled page and the generator at
   the pass's largest crop bucket against their plain versions;
5. times each kernel (CUDA events around 5 back-to-back calls, median of
   5 such samples after warm-up) beside its
   plain version and a PyTorch library composite of the same function, and
   computes the least time the card could take (``bound_ms``); traces one
   decoder step + char head (one kernel launch each; K2's phases by its own
   SM-clock stamps), one whole beam-search step at step 128 (``beam_step``)
   and one LaMa forward (its device time between K4, K5 and cuDNN); times
   the OCR stage on one page;
6. prints the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

It exits non-zero on any failure, and when CUDA is unavailable.
Weights are random, made from fixed seeds (MIT_TPU_ALLOW_RANDOM_WEIGHTS=1;
the Sugoi model is written from a seed, since ct2 models have no random
fallback).

Two more modes compare two checkouts on one card:

* ``--times-only``: builds the kernels, runs step 5's kernel timings, the
  beam step and the OCR and inpainting stages on one page
  (``phase_beam_step``, ``phase_ocr_page``, ``phase_inpaint_page``); no
  checks, no main path. Its last line is a JSON object of those numbers.
* ``--compare-with DIR --pairs N``: DIR is the root of another checkout
  inside this one (for example the parent commit unpacked with ``git
  archive`` into ``build/parent``). Copies this script there and runs
  ``--times-only`` N times on each side in ABBA order (DIR, here, here,
  DIR, ...), each run a process of its own, so both sides are measured by
  the same code in one call. Prints every run and, per number, each side's
  median, lowest and highest.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import copy
import functools
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')
OUT = os.path.join(WORK, 'out')

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # CUDA cores, f32
BF16_OPS_PER_S = 989e12        # tensor cores, bf16 inputs
F32X3_OPS_PER_S = 495e12 / 3   # f32-accurate products as three TF32 passes

SLEEP_CYCLES = 40_000_000      # ~20 ms of SM clock at 1.98 GHz
PAGE_W, PAGE_H = 1448, 2048    # one detection canvas tall
LINES_PER_PAGE = 18            # > 16 lines: the 24-crop OCR chunk (N = 120)
LAMA_BLOCKS = 18               # lama_large
FU_C = 192                     # FourierUnit channels (384 global // 2)
CROP = 1024                    # the largest crop bucket
# K5's two convs on the LaMa path: (cin, cout, relu, output dtype)
K5_CONVS = {'stem': (4, 64, True, torch.bfloat16),
            'final': (64, 3, False, torch.float32)}


def require(cond, msg: str) -> None:
    """A check that stays under ``python -O`` (unlike assert)."""
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 25, warmup: int = 3, reps: int = 5) -> float:
    """Per-call device time of ``fn``: the median, over ``iters // reps``
    samples, of CUDA events around ``reps`` back-to-back calls over
    ``reps``. Each sample starts behind a kernel that keeps the device busy
    for ~20 ms (``torch.cuda._sleep``) while the host enqueues the calls, so
    the host's time per call stays out of the number whenever enqueueing
    ``reps`` calls takes less than that (without it, a kernel of a few tens
    of µs reads as its wrapper's host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reps = min(reps, iters)
    times = []
    for _ in range(max(1, iters // reps)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def host_us(fn, iters: int = 200) -> float:
    """Host time to enqueue one call of ``fn`` (µs), at a shape small
    enough that the device keeps up: what the wrapper costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


# ---------------------------------------------------------------------------
# phase 1: card and host libraries
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f'nvidia-smi failed: {smi.stderr}')
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    missing = []
    for mod in ('cv2', 'PIL', 'pydantic', 'networkx', 'numpy', 'aiohttp',
                'websockets'):
        try:
            __import__(mod)
        except ImportError as e:
            missing.append(f'{mod} ({e})')
    if missing:
        raise RuntimeError('host libraries of the pipeline are missing: '
                           + ', '.join(missing))
    emit({'phase': 'card', 'card': card, 'torch': torch.__version__,
          'cuda': torch.version.cuda})
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from manga_image_translator_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    for name in cuda_build.SOURCES:
        cuda_build.library(name)
    seconds = time.perf_counter() - t0
    emit({'phase': 'build', 'seconds': seconds,
          'libraries': {k: os.path.relpath(str(v), ROOT)
                        for k, v in paths.items()}})
    return seconds


# ---------------------------------------------------------------------------
# inputs at main-path shapes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def k1_inputs(h=2048, w=2048, kind='page'):
    """A page-like image (white paper, dark strokes, mild noise) or, for
    ``kind='random'``, uniform random bytes (the worst case for anything
    whose time depends on the colour distances)."""
    import numpy as np
    rs = np.random.RandomState(0)
    if kind == 'random':
        return torch.from_numpy(rs.randint(0, 256, (h, w, 3)).astype(
            np.uint8)).cuda()
    page = np.full((h, w, 3), 235, np.uint8)
    page[rs.rand(h, w) < 0.08] = 20
    page = np.clip(page.astype(np.int16) + rs.randint(-12, 13, page.shape),
                   0, 255).astype(np.uint8)
    return torch.from_numpy(page).cuda()


# K1's inputs: the smoke's 2048x2048 canvas (its main number), the page
# shape the pipeline runs it on, and uniform random bytes
K1_INPUTS = {'canvas_2048': (2048, 2048, 'page'),
             'page_1448x2048': (PAGE_H, PAGE_W, 'page'),
             'random_2048': (2048, 2048, 'random')}


def ocr_model(dict_size: int):
    from manga_image_translator_tpu_torch.models import ocr48
    return ocr48.build_ocr48(dict_size, 'cuda',
                             ocr48.init_state_dict(dict_size))


def k2_inputs(model, n=120, s_len=256, m_len=96, seed=0):
    from manga_image_translator_tpu_torch.models import ocr48
    g = torch.Generator(device='cuda').manual_seed(seed)
    memory = torch.randn((n, m_len, 320), generator=g, device='cuda') * 0.5
    lens = torch.randint(m_len // 2, m_len + 1, (n,), generator=g,
                         device='cuda')
    mask = torch.arange(m_len, device='cuda')[None, :] >= lens[:, None]
    mem_k, mem_v, mem_len = ocr48.init_memory_kv(model, memory, mask, 1,
                                                 torch.bfloat16)
    rot = ocr48.rot_table(s_len, 'cuda')
    return mem_k, mem_v, mem_len, rot


def k4_inputs(shape, seed=0):
    """A FourierUnit input (post-ReLU, so non-negative) and folded weights
    at the generator's init scale."""
    c = shape[-1]
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.rand(shape, generator=g, device='cuda')
    w_spec = (torch.randn((2 * c, 2 * c), generator=g, device='cuda')
              * math.sqrt(2.0 / (2 * c)))
    b_spec = torch.randn((2 * c,), generator=g, device='cuda') * 0.1
    return x, w_spec, b_spec


def k5_inputs(name, n, h, w, seed=0):
    """Padded input (n, h + 6, w + 6, cin) for an h x w output, HWIO 7x7
    weights and bias of K5's conv ``name``."""
    cin, cout, _, _ = K5_CONVS[name]
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.rand((n, h + 6, w + 6, cin), generator=g, device='cuda')
    wt = (torch.randn((7, 7, cin, cout), generator=g, device='cuda')
          * math.sqrt(2.0 / (49 * cin)))
    b = torch.randn((cout,), generator=g, device='cuda') * 0.1
    return x, wt, b


def k4_work(shape, in_bytes):
    """(bytes, operations) FourierUnit needs at ``shape``: x read and the
    output written once, the weights read once; the spectral conv plus the
    FFT-minimal cost (2.5 N log2 N per real 2-D transform and channel)."""
    n, h, w, c = shape
    k = w // 2 + 1
    nbytes = 2 * n * h * w * c * in_bytes + (2 * c) ** 2 * 4 + 2 * c * 4
    ops = n * (2 * (2 * c) ** 2 * h * k
               + 2 * 2.5 * h * w * math.log2(h * w) * c)
    return nbytes, ops


def k5_work(name, n, h, w, in_bytes):
    """(bytes, operations) of K5's conv ``name`` for an n x h x w output."""
    cin, cout, _, out_dt = K5_CONVS[name]
    out_bytes = 2 if out_dt == torch.bfloat16 else 4
    nbytes = (n * (h + 6) * (w + 6) * cin * in_bytes
              + n * h * w * cout * out_bytes + 49 * cin * cout * 4 + cout * 4)
    return nbytes, 2 * n * h * w * 49 * cin * cout


@functools.lru_cache(maxsize=1)
def lama_model():
    """The 18-block generator, seeded random weights, BN folded, f32."""
    from manga_image_translator_tpu_torch.models import lama
    return lama.fold_bn(lama.build_lama(
        LAMA_BLOCKS, lama.init_state_dict(LAMA_BLOCKS), 'cuda'))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_check(results):
    from manga_image_translator_tpu_torch.ops import bilateral, charhead
    from manga_image_translator_tpu_torch.ops import decode_step as dops

    # K1 at a 2048x2048 detection canvas, the 1448x2048 page and on random
    # bytes: <= 1 gray
    errs = []
    for at, (h, w, kind) in K1_INPUTS.items():
        img = k1_inputs(h, w, kind)
        got = bilateral.bilateral_filter_batch(img[None])[0]
        ref = bilateral.bilateral_filter_ref(img)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        emit({'phase': 'check', 'kernel': 'bilateral', 'at': at,
              'shape': list(img.shape), 'max_abs_err': err, 'tol': 1})
        require(err <= 1, f'bilateral at {at}: max abs err {err} gray > 1')
        errs.append(err)
    results['bilateral']['max_abs_err'] = max(errs)

    # K2 at the port's two chunk sizes (N=120: 24 crops, N=80: 16), S=256,
    # M=96 (a 384-px width bucket), bf16, steps 0-19 and 120-129 (the
    # second decode tier's depth); then N=120 at M=386 (the 1536-px
    # bucket, the widest the port makes), steps 0, 1, 33, 128, 254 and 255;
    # every step through a random non-identity ancestry table; a second run
    # of the kernel on the same inputs must give the same bits
    model = ocr_model(7935)
    w, ch, embd = model.packed(torch.bfloat16)
    s_len = 256
    worst_all = 0.0
    worst_abs_all = 0.0
    repeatable_all = True
    deep = list(range(20)) + list(range(120, 130))
    for n, m_len, steps in ((120, 96, deep), (80, 96, deep),
                            (120, 386, [0, 1, 33, 128, 254, 255])):
        worst = 0.0
        worst_abs = 0.0
        repeatable = True
        mem_k, mem_v, mem_len, rot = k2_inputs(model, n, s_len, m_len)
        shape = (5, s_len, n, 320)
        g = torch.Generator(device='cuda').manual_seed(n)
        sk = (torch.randn(shape, generator=g, device='cuda') * 0.5
              ).to(torch.bfloat16)
        sv = (torch.randn(shape, generator=g, device='cuda') * 0.5
              ).to(torch.bfloat16)
        rk, rv = sk.clone(), sv.clone()
        sk2, sv2 = sk.clone(), sv.clone()
        src = torch.randint(0, n, (s_len, n), generator=g, device='cuda',
                            dtype=torch.int32)
        for step in steps:
            tok = torch.randint(3, 7935, (n,), generator=g, device='cuda')
            out, kn, vn, _ = dops.decode_step(step, embd[tok], w, rot, sk,
                                              sv, mem_k, mem_v, mem_len, src)
            out2, kn2, vn2, _ = dops.decode_step(step, embd[tok], w, rot,
                                                 sk2, sv2, mem_k, mem_v,
                                                 mem_len, src)
            rout, rkn, rvn = dops.decode_step_ref(step, embd[tok], w, rot,
                                                  rk, rv, mem_k, mem_v,
                                                  mem_len, src)
            torch.cuda.synchronize()
            repeatable &= (torch.equal(out, out2) and torch.equal(kn, kn2)
                           and torch.equal(vn, vn2))
            for a, b in ((out, rout), (kn, rkn), (vn, rvn)):
                d = float((a.float() - b.float()).abs().max())
                scale = float(b.float().abs().max()) + 1e-6
                worst = max(worst, d / scale)
                worst_abs = max(worst_abs, d)
        emit({'phase': 'check', 'kernel': 'decode_step', 'n': n,
              's_len': s_len, 'm_len': int(mem_k.shape[1]),
              'steps': len(steps),
              'ancestry': 'random', 'max_rel_err': worst,
              'max_abs_err': worst_abs, 'tol_rel': 0.05,
              'bitwise_repeatable': repeatable})
        worst_all = max(worst_all, worst)
        worst_abs_all = max(worst_abs_all, worst_abs)
        repeatable_all &= repeatable
    require(worst_all < 0.05, f'decode_step: rel err {worst_all} >= 0.05')
    require(repeatable_all, 'decode_step: two runs on the same inputs differ')
    results['decode_step']['max_abs_err'] = worst_abs_all

    # K3 at N=120 for the released (7935) and placeholder (2322) alphabets
    n = 120
    k3_err = 0.0
    for v in (7935, 2322):
        m = model if v == 7935 else ocr_model(v)
        _, chv, _ = m.packed(torch.bfloat16)
        gd = torch.Generator(device='cuda').manual_seed(v)
        dec = (torch.randn((n, 320), generator=gd, device='cuda')
               ).to(torch.bfloat16)
        gv, gi = charhead.char_topk(dec, chv, 5)
        rv_, ri = charhead.char_topk_ref(dec, chv, 5)
        torch.cuda.synchronize()
        same = bool((gi == ri).all())
        gap = 0.0
        if not same:
            # a near-tie may flip an index: the logits of the two picks
            # must then agree within the tolerance
            logits = (torch.nn.functional.gelu(
                dec.float() @ chv['w1'].float() + chv['b1']).to(dec.dtype)
                .float() @ chv['wv'].float().t() + chv['bv'])
            bad = (gi != ri)
            gap = float((logits.gather(1, gi) - logits.gather(1, ri))
                        .abs()[bad].max())
        verr = float((gv - rv_).abs().max())
        emit({'phase': 'check', 'kernel': 'charhead', 'n': n, 'vocab': v,
              'indices_equal': same, 'flip_logit_gap': gap,
              'max_abs_err': verr, 'tol': 2e-2})
        require(gap < 2e-2, f'charhead: index flip with logit gap {gap}')
        torch.testing.assert_close(gv, rv_, rtol=2e-2, atol=2e-2)
        k3_err = max(k3_err, verr)
    results['charhead']['max_abs_err'] = k3_err
    check_lama(results)


def check_lama(results):
    """K4, K5 and the whole generator against their plain versions. The
    plain versions run in true f32: matmuls without TF32 (the port's
    setting, device.py), cuDNN without TF32 (conv2d_stream_ref switches it
    off for its call; here for the generator's other convs too)."""
    from manga_image_translator_tpu_torch.ops import conv_stream as k5
    from manga_image_translator_tpu_torch.ops import fourier_unit as k4
    require(not torch.backends.cuda.matmul.allow_tf32,
            'TF32 matmuls are on: the plain FourierUnit is no f32 reference')

    # K4 (3xTF32 on the tensor cores) at a 1024² crop's trunk and at the
    # full-page path's odd width (a 2048 x 1448 page: 256 x 181): f32 1e-4
    # of the output's max; bf16 in and out (the main path's types) 1e-2
    k4_err = 0.0
    for shape in ((1, CROP // 8, CROP // 8, FU_C), (1, 256, 181, FU_C)):
        x, w_spec, b_spec = k4_inputs(shape)
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            xi = x.to(dt)
            got = k4.fourier_unit(xi, w_spec, b_spec)
            ref = k4.fourier_unit_ref(xi, w_spec, b_spec)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            rel = err / float(ref.float().abs().max())
            emit({'phase': 'check', 'kernel': 'fourier_unit', 'shape': shape,
                  'dtype': str(dt), 'max_abs_err': err, 'max_rel_err': rel,
                  'tol_rel': tol})
            require(rel <= tol, f'fourier_unit {shape} {dt}: rel err {rel}')
            if dt == torch.float32:
                k4_err = max(k4_err, err)
    results['fourier_unit']['max_abs_err'] = k4_err

    # K5: stem and final conv of a 1024² crop. f32 input (the CUDA-core
    # body) against the f32 conv, 1e-5; bf16 input (the tensor-core route,
    # bf16 weights) in the main path's types against the f32 conv of the
    # same bf16 input and bf16-rounded weights: 1e-5 for the final conv's
    # f32 output, 1e-2 for the stem's bf16 output
    k5_err = 0.0
    for name, (_, _, relu, out_dt) in K5_CONVS.items():
        x, w, b = k5_inputs(name, 1, CROP, CROP)
        for in_dt, o_dt in ((torch.float32, torch.float32),
                            (torch.bfloat16, out_dt)):
            tol = 1e-5 if o_dt == torch.float32 else 1e-2
            xi = x.to(in_dt)
            w_ref = w if in_dt == torch.float32 else w.to(in_dt).float()
            got = k5.conv2d_stream(xi, w, b, relu=relu, out_dtype=o_dt)
            ref = k5.conv2d_stream_ref(xi, w_ref, b, relu=relu,
                                       out_dtype=torch.float32)
            torch.cuda.synchronize()
            err = float((got.float() - ref).abs().max())
            rel = err / float(ref.abs().max())
            emit({'phase': 'check', 'kernel': 'conv_stream', 'conv': name,
                  'shape': list(xi.shape), 'in': str(in_dt), 'out': str(o_dt),
                  'max_abs_err': err, 'max_rel_err': rel, 'tol_rel': tol})
            require(rel <= tol, f'conv_stream {name} {in_dt}: rel err {rel}')
            k5_err = max(k5_err, err)
    results['conv_stream']['max_abs_err'] = k5_err
    check_generator((1, 512, 512), 'crop_512')


def scaled_generator(model, n_blocks):
    """A copy of ``model`` with each block's second FFC scaled by 0.1.
    Random weights grow the trunk through the residual blocks until the
    sigmoid saturates (logits ~1e8, every output 0 or 1), which would hide
    any difference; scaled, the output stays in (0, 1)."""
    model = copy.deepcopy(model)
    with torch.no_grad():
        for i in range(n_blocks):
            ffc = model.model[5 + i].conv2.ffc
            for conv in (ffc.convl2l, ffc.convg2l, ffc.convl2g,
                         ffc.convg2g.conv2):
                conv.weight.mul_(0.1)
                if conv.bias is not None:
                    conv.bias.mul_(0.1)
    return model


def check_generator(shape, at, n_blocks=LAMA_BLOCKS, mpe=None):
    """The whole generator (lama_large's, or with ``mpe`` the 9-block
    lama_mpe one with both embeddings) on an (n, h, w) input in f32:
    kernels against the plain routes with the same weights, 1e-3 absolute
    on the output (``scaled_generator``)."""
    import numpy as np
    from manga_image_translator_tpu_torch.models import lama
    from manga_image_translator_tpu_torch.ops import conv_stream as k5
    from manga_image_translator_tpu_torch.ops import fourier_unit as k4
    n, h, w = shape
    model = scaled_generator(lama_model() if mpe is None
                             else mpe_generator(), n_blocks)
    g = torch.Generator(device='cuda').manual_seed(5)
    img = torch.rand((n, h, w, 3), generator=g, device='cuda')
    mask = (torch.rand((n, h, w, 1), generator=g, device='cuda')
            < 0.3).float()
    img = img * (1 - mask)
    emb = ()
    if mpe is not None:
        encs = [lama.masked_position_encoding(m[..., 0])
                for m in mask.cpu().numpy()]
        with torch.inference_mode():
            emb = mpe(*[torch.from_numpy(np.stack([e[i] for e in encs]))
                        .cuda() for i in (0, 1)])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    routes = (lama.fourier_unit, lama.conv2d_stream)
    try:
        with torch.inference_mode():
            got = model(img, mask, *emb)
            lama.fourier_unit = k4.fourier_unit_ref
            lama.conv2d_stream = k5.conv2d_stream_ref
            ref = model(img, mask, *emb)
        torch.cuda.synchronize()
    finally:
        lama.fourier_unit, lama.conv2d_stream = routes
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((got - ref).abs().max())
    unsaturated = float(((ref > 0.01) & (ref < 0.99)).float().mean())
    emit({'phase': 'check', 'kernel': 'lama_generator', 'at': at,
          'blocks': n_blocks, 'mpe': mpe is not None,
          'shape': list(img.shape), 'dtype': 'float32', 'max_abs_err': err,
          'output_range': [float(ref.min()), float(ref.max())],
          'unsaturated_share': unsaturated, 'tol': 1e-3})
    require(unsaturated > 0.5, f'LaMa generator output saturated '
            f'({unsaturated} of values in (0.01, 0.99))')
    require(err <= 1e-3, f'LaMa generator at {at}: kernels vs plain {err}')
    del model, got, ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the default translator: a synthetic Sugoi model at the published width
# ---------------------------------------------------------------------------

# Sugoi V4 (ja->en) is the JParaCrawl "big" transformer: fairseq
# transformer_vaswani_wmt_en_de_big (Morishita et al., LREC 2020), post-norm,
# separate 32k source and target sentencepiece vocabularies
SUGOI = {'d': 1024, 'heads': 16, 'ffn': 4096, 'layers': 6, 'vocab': 32000}
SUGOI_DIR = 'translators/sugoi'       # under MIT_TPU_MODEL_DIR
CHECK_SENTENCES = ['これはテストです。', '漫画の翻訳を確認します!']


def _wstr(s: str) -> bytes:
    import struct
    raw = s.encode('utf-8') + b'\0'
    return struct.pack('<H', len(raw)) + raw


def _sugoi_vocabs():
    """(source, target) pieces, 32,000 each. The source covers the 48px
    OCR's offline alphabet (ASCII, kana, 2,048 CJK), bare and word-initial;
    the target holds short Latin pieces."""
    n = SUGOI['vocab']
    specials = ['<unk>', '<s>', '</s>', '▁']
    chars = ([chr(c) for c in range(33, 127)]
             + [chr(c) for c in range(0x3041, 0x3097)]
             + [chr(c) for c in range(0x30A1, 0x30FB)]
             + [chr(c) for c in range(0x4E00, 0x4E00 + 2048)])
    src = specials + chars + ['▁' + c for c in chars]
    src += [f'▁ja{i}' for i in range(n - len(src))]

    def latin(i):
        s = ''
        while True:
            s += chr(97 + i % 26)
            i //= 26
            if not i:
                return s
    tgt = specials + [('▁' if i % 3 else '') + latin(i)
                      for i in range(n - len(specials))]
    return src, tgt


def _write_spm(path, pieces, seed):
    """A unigram sentencepiece model of ``pieces`` (the first three are
    unk, <s>, </s>), scores from ``seed``."""
    import struct
    import numpy as np

    def varint(v):
        out = b''
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def ld(num, data):
        return varint((num << 3) | 2) + varint(len(data)) + data

    scores = -np.random.RandomState(seed).rand(len(pieces)) * 10
    blob = bytearray()
    for i, text in enumerate(pieces):
        typ = 2 if i == 0 else 3 if i < 3 else 1
        body = (ld(1, text.encode('utf-8')) + varint((2 << 3) | 5)
                + struct.pack('<f', scores[i]) + varint(3 << 3) + varint(typ))
        blob += ld(1, body)
    with open(path, 'wb') as f:
        f.write(bytes(blob))


def write_sugoi_model(root, seed=0):
    """The released sugoi archive's unpacked layout under ``root``
    (``translators/sugoi/{spm.ja,spm.en}.nopretok.model``, ``big-ja-en/``
    with a v6 ``model.bin``, the two vocabularies and ``config.json``), at
    the published widths with weights from ``seed``: every matrix in int8
    with its per-row ``_scale`` (uniform, std ~1/sqrt(fan-in) after
    dequantisation), biases and layer norms in f32. Returns the parameter
    count."""
    import struct
    import numpy as np
    d, ffn, vocab = SUGOI['d'], SUGOI['ffn'], SUGOI['vocab']
    rng = np.random.default_rng(seed)
    shapes = {'encoder/embeddings/weight': (vocab, d),
              'decoder/embeddings/weight': (vocab, d)}
    for side, subs in (('encoder', ('self_attention', 'ffn')),
                       ('decoder', ('self_attention', 'attention', 'ffn'))):
        for i in range(SUGOI['layers']):
            pre = f'{side}/layer_{i}'
            shapes[f'{pre}/self_attention/linear_0'] = (3 * d, d)
            shapes[f'{pre}/self_attention/linear_1'] = (d, d)
            if side == 'decoder':
                shapes[f'{pre}/attention/linear_0'] = (d, d)
                shapes[f'{pre}/attention/linear_1'] = (2 * d, d)
                shapes[f'{pre}/attention/linear_2'] = (d, d)
            shapes[f'{pre}/ffn/linear_0'] = (ffn, d)
            shapes[f'{pre}/ffn/linear_1'] = (d, ffn)
            for sub in subs:
                shapes[f'{pre}/{sub}/layer_norm'] = (d,)
    shapes['decoder/projection'] = (vocab, d)

    variables = []              # (name, array) in file order
    params = 0
    for name, shape in shapes.items():
        if name.endswith('layer_norm'):
            variables += [(f'{name}/gamma', (1 + 0.1 * rng.standard_normal(
                d, np.float32)).astype(np.float32)),
                (f'{name}/beta', 0.1 * rng.standard_normal(d, np.float32))]
            params += 2 * d
            continue
        key = name if name.endswith('/weight') else f'{name}/weight'
        q = rng.integers(-127, 128, shape, dtype=np.int8)
        # rows' largest |w| around sqrt(3 / fan-in): std ~1/sqrt(fan-in)
        amax = math.sqrt(3.0 / shape[1]) * rng.uniform(0.8, 1.2, shape[0])
        variables += [(key, q), (key + '_scale',
                                 (127 / amax).astype(np.float32))]
        params += q.size
        if not name.endswith('/weight'):
            variables.append((f'{name}/bias', 0.02 * rng.standard_normal(
                shape[0], np.float32)))
            params += shape[0]

    model_dir = os.path.join(root, SUGOI_DIR, 'big-ja-en')
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, 'model.bin'), 'wb') as f:
        f.write(struct.pack('<I', 6) + _wstr('TransformerSpec')
                + struct.pack('<II', 7, len(variables)))
        for name, arr in variables:
            dtype = 'int8' if arr.dtype == np.int8 else 'float32'
            f.write(_wstr(name) + struct.pack('<B', arr.ndim)
                    + struct.pack(f'<{arr.ndim}I', *arr.shape) + _wstr(dtype)
                    + struct.pack('<I', arr.nbytes))
            f.write(arr.tobytes())
        f.write(struct.pack('<I', 0))
    src, tgt = _sugoi_vocabs()
    for side, pieces in (('source', src), ('target', tgt)):
        with open(os.path.join(model_dir, f'{side}_vocabulary.txt'), 'w',
                  encoding='utf-8') as f:
            f.write('\n'.join(pieces) + '\n')
    with open(os.path.join(model_dir, 'config.json'), 'w') as f:
        json.dump({'num_heads': SUGOI['heads']}, f)
    for lang, pieces, s in (('ja', src, seed + 1), ('en', tgt, seed + 2)):
        _write_spm(os.path.join(root, SUGOI_DIR,
                                f'spm.{lang}.nopretok.model'), pieces, s)
    return params


def phase_sugoi_model():
    t0 = time.perf_counter()
    params = write_sugoi_model(os.environ['MIT_TPU_MODEL_DIR'])
    path = os.path.join(os.environ['MIT_TPU_MODEL_DIR'], SUGOI_DIR,
                        'big-ja-en', 'model.bin')
    emit({'phase': 'sugoi_model', **SUGOI, 'params': params,
          'model_bin_bytes': os.path.getsize(path),
          'seconds': time.perf_counter() - t0})


def phase_translate_check(max_len=16):
    """The ct2 transformer at the full Sugoi width on the card against the
    same model on the CPU, on two sentences: encoder states and first-step
    log-probs within 1e-4 of max |value|, equal tokens at beam 5 and 1."""
    import numpy as np
    from manga_image_translator_tpu_torch.translators import ct2_model
    from manga_image_translator_tpu_torch.utils import spm_lite
    t0 = time.perf_counter()
    root = os.path.join(os.environ['MIT_TPU_MODEL_DIR'], SUGOI_DIR)
    model_dir = os.path.join(root, 'big-ja-en')
    variables = ct2_model.read_ct2_model(os.path.join(model_dir, 'model.bin'))
    vocabs = ct2_model.load_vocabulary(model_dir)
    cfg = ct2_model.read_config(model_dir)
    card = ct2_model.Ct2Transformer(variables, cfg, *vocabs)
    require(card.device.type == 'cuda' and all(
        b.is_cuda for b in card.buffers()), 'the ct2 model is not on the card')
    cpu = ct2_model.Ct2Transformer(variables, cfg, *vocabs, device='cpu')
    del variables
    sp = spm_lite.SentencePieceModel.load(
        os.path.join(root, 'spm.ja.nopretok.model'))
    batch = [sp.encode(s, out_type=str) for s in CHECK_SENTENCES]
    errs = {}

    def rel(name, ref, got):
        ref = ref.float().cpu()
        errs[name] = float((got.float().cpu() - ref).abs().max()
                           / ref.abs().max())
        require(errs[name] <= 1e-4, f'translate_check: {name} off by '
                f'{errs[name]:.3g} of max |value|')

    with torch.inference_mode():
        outs = {}
        for name, m in (('cpu', cpu), ('card', card)):
            tokens, lengths, prefix, prefix_len = m.prepare(batch)
            memory, _ = m.encode(torch.from_numpy(tokens).to(m.device),
                                 torch.from_numpy(lengths).to(m.device))
            search = ct2_model.BeamSearch(m, tokens, lengths, prefix,
                                          prefix_len, max_len=max_len,
                                          beam_size=5)
            logits = search.forward(search.toks[:, :, 0].reshape(-1), 0)
            outs[name] = (memory, torch.log_softmax(logits, -1))
        rel('encoder_states', outs['cpu'][0], outs['card'][0])
        rel('first_step_logprobs', outs['cpu'][1], outs['card'][1])
    tokens = {}
    for beam in (5, 1):
        ref = cpu.translate_batch(batch, beam_size=beam, max_len=max_len)
        got = card.translate_batch(batch, beam_size=beam, max_len=max_len)
        require(got == ref, f'translate_check: beam {beam} tokens differ '
                f'between the card and the CPU:\n{got}\n{ref}')
        tokens[f'beam_{beam}'] = [len(t) for t in got]
    emit({'phase': 'translate_check', 'sentences': len(batch),
          'source_pieces': [len(t) for t in batch], 'max_len': max_len,
          'rel_err': errs, 'tokens_equal': True, 'output_lengths': tokens,
          'seconds': time.perf_counter() - t0})


@contextlib.contextmanager
def recording_decodes(log):
    """Every ``Ct2Transformer.translate_batch`` call inside the block is
    appended to ``log``: the model, the pieces, the keywords, the
    device-synchronised wall ms and the decoder steps."""
    from manga_image_translator_tpu_torch.translators import ct2_model
    inner = ct2_model.Ct2Transformer.translate_batch

    def recorded(self, batch_tokens, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(self, batch_tokens, **kw)
        torch.cuda.synchronize()
        log.append({'model': self, 'batch': batch_tokens, 'kw': kw,
                    'wall_ms': (time.perf_counter() - t0) * 1e3,
                    'steps': self.last_steps})
        return out
    ct2_model.Ct2Transformer.translate_batch = recorded
    try:
        yield
    finally:
        ct2_model.Ct2Transformer.translate_batch = inner


def decode_busy_us(call, chunk=2):
    """Device time per beam step of a recorded decode, by CUDA events: the
    same search replayed ``chunk`` steps at a time, each chunk enqueued
    behind ~20 ms of ``torch.cuda._sleep`` so that the host's pace stays
    out of the number (a chunk is ~600 launches: more would fill the
    launch queue, and the host would wait for the sleep). Returns (µs per
    step, the number of chunks whose enqueue outlasted the sleep: those
    hold idle time)."""
    from manga_image_translator_tpu_torch.translators import ct2_model
    model, kw = call['model'], call['kw']
    total_ms, late = 0.0, 0
    with torch.inference_mode():
        search = ct2_model.BeamSearch(
            model, *model.prepare(call['batch']),
            max_len=kw.get('max_len', 200),
            rep_penalty=kw.get('repetition_penalty', 3.0),
            beam_size=kw.get('beam_size', 5))
        while search.t < call['steps']:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            t0 = time.perf_counter()
            for _ in range(min(chunk, call['steps'] - search.t)):
                search.step()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            b.record()
            b.synchronize()
            total_ms += a.elapsed_time(b)
            late += enqueue_ms > SLEEP_CYCLES / 1.98e6
    return total_ms / call['steps'] * 1e3, late


def decode_step_work(model, b, rows, s_len, t):
    """(bytes, f32 operations) one beam step at step ``t`` needs: the
    decoder's weights and the projection read once, every layer's K/V
    cache at positions 0..t and the memory K/V (one copy a sentence) read
    once, the new K/V rows written once; the linear layers' products for
    ``rows`` rows and the attention's over t + 1 and ``s_len`` keys."""
    d, n = model.d_model, model.n_dec
    params = sum(v.numel() for k, v in model.named_buffers()
                 if k.startswith('decoder/') and 'embeddings' not in k)
    nbytes = 4 * (params + 2 * n * rows * (t + 1) * d
                  + 2 * n * b * s_len * d + 2 * n * rows * d)
    ops = 2 * rows * params + 4 * n * rows * d * (t + 1 + s_len)
    return nbytes, ops


def phase_translate_kernels(call, at=96, steps=8, top=8):
    """Device µs per beam step by kernel over steps ``at`` .. ``at +
    steps`` of a recorded decode (a torch.profiler trace of the replayed
    search): the ``top`` kernels by time, all kernels' sum and count, the
    window's span, and the least time the card could take for a step
    (``bound_us``: the larger of its bytes over the HBM rate and its f32
    operations over the CUDA cores' peak, averaged over the window)."""
    from torch.profiler import ProfilerActivity, profile
    from manga_image_translator_tpu_torch.translators import ct2_model
    model, kw = call['model'], call['kw']
    with torch.inference_mode():
        search = ct2_model.BeamSearch(
            model, *model.prepare(call['batch']),
            max_len=kw.get('max_len', 200),
            rep_penalty=kw.get('repetition_penalty', 3.0),
            beam_size=kw.get('beam_size', 5))
        while search.t < at:
            search.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                search.step()
            torch.cuda.synchronize()
    path = os.path.join(OUT, 'translate_trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        ks = [e for e in json.load(f)['traceEvents']
              if e.get('cat') == 'kernel']
    by = collections.Counter()
    for e in ks:
        by[e['name'][:90]] += e['dur'] / steps
    span = (max(e['ts'] + e['dur'] for e in ks)
            - min(e['ts'] for e in ks)) / steps
    tokens = model.prepare(call['batch'])[0]
    bounds = [bound_ms(*decode_step_work(model, search.b, search.bk,
                                         tokens.shape[1], t),
                       F32_OPS_PER_S) for t in range(at, at + steps)]
    emit({'phase': 'translate_kernels', 'rows': search.bk,
          'source_len': tokens.shape[1],
          'bound_us': statistics.mean(b for b, _ in bounds) * 1e3,
          'bound_by': bounds[0][1],
          'steps': [at, at + steps], 'busy_us': sum(by.values()),
          'span_us': span, 'kernels': len(ks) / steps,
          'top_us': dict(by.most_common(top))})


def phase_translate(extra):
    """One ``translate`` line per page of the known-box pass: sentences
    (queries) and chunks (sugoi's decoder batch), decoder rows and source
    length, decoder steps, the translate stage's ms, and the decode's wall
    ms per beam step against its device-busy µs per step. Returns the
    first page's decode."""
    for name, r in sorted(extra.items()):
        t = r['translate']
        require(len(t['decodes']) == 1,
                f'{name}: {len(t["decodes"])} decodes in the translate stage')
        call = t['decodes'][0]
        busy_us, late = decode_busy_us(call)
        tokens = call['model'].prepare(call['batch'])[0]
        emit({'phase': 'translate', 'page': name, 'translator': 'sugoi',
              'device': str(call['model'].device),
              'sentences': t['sentences'], 'chunks': t['chunks'],
              'beam': call['kw'].get('beam_size'),
              'rows': tokens.shape[0] * call['kw'].get('beam_size', 5),
              'source_len': tokens.shape[1], 'steps': call['steps'],
              'stage_ms': r['stage_ms']['translate'],
              'decode_wall_ms': call['wall_ms'],
              'wall_ms_per_step': call['wall_ms'] / call['steps'],
              'busy_us_per_step': busy_us,
              'replay_chunks_host_late': late,
              'translations': t['translations']})
    return extra['page0.png']['translate']['decodes'][0]


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def make_pages(page_dir, n=2):
    """``n`` synthetic pages with black text lines on white; returns the
    text boxes of every page."""
    import cv2
    import numpy as np
    os.makedirs(page_dir, exist_ok=True)
    boxes = {}
    words = ['HELLO WORLD', 'MANGA PAGE', 'TRANSLATE ME', 'SPEECH BUBBLE',
             'OCR LINE', 'GPU PORT']
    for p in range(n):
        img = np.full((PAGE_H, PAGE_W, 3), 255, np.uint8)
        quads = []
        for i in range(LINES_PER_PAGE):
            text = words[(i + p) % len(words)]
            col, row = i % 2, i // 2
            x = 90 + col * 700
            y = 170 + row * 200
            scale, thick = 1.6, 4
            cv2.putText(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale,
                        (0, 0, 0), thick)
            (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                             scale, thick)
            x0, y0, x1, y1 = x - 6, y - th - 6, x + tw + 6, y + base + 6
            quads.append([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
        name = f'page{p}.png'
        cv2.imwrite(os.path.join(page_dir, name),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        boxes[name] = quads
    return boxes


def stroke_mask(img_rgb):
    """The page's dark strokes, dilated: the raw text mask the known-box
    passes give mask refinement (the random DBNet's mask covers the page)."""
    import cv2
    import numpy as np
    gray = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2GRAY)
    return cv2.dilate(((gray < 128) * 255).astype(np.uint8),
                      np.ones((5, 5), np.uint8))


def render_boxes(ctx, config):
    """Where the renderer may draw: the bounding rects of the translated
    regions' font-size adjusted boxes, computed as rendering.dispatch does,
    on copies (the resize sets each region's font size). Call it before
    rendering."""
    import cv2
    import numpy as np
    from manga_image_translator_tpu_torch import rendering
    drawn = [r for r in ctx.text_regions if r.translation]
    boxes = np.zeros(ctx.img_inpainted.shape[:2], bool)
    for dst in rendering.resize_regions_to_font_size(
            ctx.img_inpainted, copy.deepcopy(drawn), config.render.font_size,
            config.render.font_size_offset, config.render.font_size_minimum):
        x, y, w, h = cv2.boundingRect(dst.astype(np.int32))
        x, y = max(x, 0), max(y, 0)
        boxes[y:y + h, x:x + w] = True
    return boxes


async def _known_quads_pass(translator, config, page_path, quads, decodes):
    """OCR + merge + translate + mask refinement + inpainting + rendering
    through the orchestrator's stage runners on the page's known text boxes
    (the random-weight detector may find none); returns per-stage ms
    (device synchronised), what each stage changed and what the translate
    stage decoded (``decodes``: the ``recording_decodes`` log). Writes the
    inpainted and the rendered page under OUT."""
    import cv2
    import numpy as np
    from PIL import Image
    from manga_image_translator_tpu_torch import inpainting, translators
    from manga_image_translator_tpu_torch.utils.generic import (Context,
                                                                load_image)
    from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
    ctx = Context()
    ctx.input = Image.open(page_path)
    ctx.img_rgb, ctx.img_alpha = load_image(ctx.input)
    ctx.textlines = [Quadrilateral(np.array(q), '', 1.0) for q in quads]
    ctx.mask_raw = stroke_mask(ctx.img_rgb)
    ms = {}

    async def timed(name, coro_fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = await coro_fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    ctx.textlines = await timed('ocr', lambda: translator._run_ocr(config,
                                                                   ctx))
    ctx.text_regions = await timed(
        'textline_merge', lambda: translator._run_textline_merge(config, ctx))
    first_decode = len(decodes)
    ctx.text_regions = await timed(
        'translate', lambda: translator._run_text_translation(config, ctx))
    sugoi = translators.get_translator(config.translator.translator)
    translated = {'sentences': len(sugoi.query_split_sizes),
                  'chunks': sum(sugoi.query_split_sizes),
                  'decodes': decodes[first_decode:],
                  'translations': [r.translation[:60]
                                   for r in ctx.text_regions[:3]]}
    ctx.mask = await timed('mask_refine',
                           lambda: translator._run_mask_refinement(config,
                                                                   ctx))
    inp = inpainting.get_inpainter(config.inpainter.inpainter)
    first = len(inp.forwards)
    ctx.img_inpainted = await timed(
        'inpaint', lambda: translator._run_inpainting(config, ctx))
    forwards = inp.forwards[first:]

    # the inpainter may change the mask's pixels only; the renderer only
    # the rects it composites into: the bounding rects of the regions'
    # font-size adjusted boxes (computed as rendering.dispatch does, on
    # copies: the resize sets each region's font size)
    inside = ctx.mask >= 127
    inpainted = (ctx.img_inpainted != ctx.img_rgb).any(-1)
    drawn = [r for r in ctx.text_regions if r.translation]
    boxes = render_boxes(ctx, config)
    ctx.img_rendered = await timed(
        'render', lambda: translator._run_text_rendering(config, ctx))
    rendered = (ctx.img_rendered != ctx.img_inpainted).any(-1)
    stem = os.path.splitext(os.path.basename(page_path))[0]
    for tag, img in (('inpainted', ctx.img_inpainted),
                     ('rendered', ctx.img_rendered)):
        cv2.imwrite(os.path.join(OUT, f'{stem}_{tag}.png'),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return {'ocr_lines': len(ctx.textlines),
            'regions': len(ctx.text_regions), 'drawn_regions': len(drawn),
            'mask_pixels': int(inside.sum()),
            'inpainted_pixels_inside': int((inpainted & inside).sum()),
            'inpainted_pixels_outside': int((inpainted & ~inside).sum()),
            'rendered_pixels_in_boxes': int((rendered & boxes).sum()),
            'rendered_pixels_outside': int((rendered & ~boxes).sum()),
            'forwards': [list(f) for f in forwards], 'stage_ms': ms,
            'translate': translated}


def phase_pipeline():
    import numpy as np
    from PIL import Image
    from manga_image_translator_tpu_torch.args import parser
    from manga_image_translator_tpu_torch.mode.local import (
        MangaTranslatorLocal, load_config_file)
    from manga_image_translator_tpu_torch import inpainting
    from manga_image_translator_tpu_torch.config import Inpainter, Translator
    from manga_image_translator_tpu_torch.ops import cuda_build

    page_dir = os.path.join(WORK, 'pages')
    dest = os.path.join(OUT, 'pages_out')
    boxes = make_pages(page_dir)
    cfg_path = os.path.join(WORK, 'config.json')
    with open(cfg_path, 'w') as f:
        # random OCR weights give probabilities ~1e-40: threshold 0 keeps
        # their lines so the later stages (mask refinement, inpainting,
        # rendering) have work; the inpainter's precision is the default
        # (bf16)
        json.dump({'detector': {'detector': 'default',
                                'detection_size': 2048},
                   'ocr': {'ocr': '48px', 'prob': 0.0},
                   'translator': {'translator': 'sugoi',
                                  'target_lang': 'ENG',
                                  'no_text_lang_skip': True,
                                  'enable_post_translation_check': False},
                   'inpainter': {'inpainter': 'lama_large'},
                   'render': {'renderer': 'default'}}, f)
    args = parser.parse_args(['local', '-i', page_dir, '--dest', dest,
                              '--config-file', cfg_path, '--overwrite'])
    args_dict = vars(args)
    stage_ms = []

    async def hook(state, finished):
        if state.startswith('stage-time:'):
            _, name, ms = state.split(':')
            stage_ms.append((name, float(ms)))

    inp = inpainting.get_inpainter(Inpainter.lama_large)
    decodes = []

    async def drive():
        translator = MangaTranslatorLocal(args_dict)
        require(translator.device == 'cuda',
                f'translator runs on {translator.device}, not cuda')
        translator.add_progress_hook(hook)
        await translator.translate_path(args_dict['input'], dest, args_dict)
        config = load_config_file(cfg_path)
        require(config.translator.translator == Translator.sugoi,
                f'the pipeline runs {config.translator.translator}')
        extra = {}
        for name, quads in boxes.items():
            extra[name] = await _known_quads_pass(
                translator, config, os.path.join(page_dir, name), quads,
                decodes)
        return extra

    torch.cuda.synchronize()
    inp.forwards = []
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_decodes(decodes):
        extra = asyncio.run(drive())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_build.launch_counts()
    for call in decodes:
        model = call['model']
        require(model.device.type == 'cuda' and all(
            b.is_cuda for b in model.buffers()),
            f'the ct2 model ran on {model.device}, not the card')

    written = sorted(os.listdir(dest)) if os.path.isdir(dest) else []
    pages = {}
    for name in sorted(boxes):
        out_path = os.path.join(dest, name)
        require(os.path.isfile(out_path), f'page not written: {out_path}')
        arr = np.asarray(Image.open(out_path).convert('RGB'))
        require(arr.shape == (PAGE_H, PAGE_W, 3) and np.isfinite(arr).all(),
                f'{name}: result shape {arr.shape}')
        pages[name] = {'shape': list(arr.shape), 'mean': float(arr.mean())}
    forwards = list(inp.forwards)
    buckets = collections.Counter(tuple(f) for f in forwards)
    emit({'phase': 'pipeline', 'wall_s': wall, 'stage_ms': stage_ms,
          'known_box_pass': {
              name: {k: v for k, v in r.items() if k != 'translate'}
              for name, r in extra.items()},
          'decodes': [{k: c[k] for k in ('wall_ms', 'steps')}
                      for c in decodes],
          'pages_written': written,
          'pages': pages, 'launches': counts,
          'lama_forwards': {f'{n}x{h}x{w}': k
                            for (n, h, w), k in sorted(buckets.items())},
          'inpaint_ms_per_page': [r['stage_ms']['inpaint']
                                  for r in extra.values()],
          'render_ms_per_page': [r['stage_ms']['render']
                                 for r in extra.values()]})
    for name, n in counts.items():
        require(n > 0, f'kernel {name} was not launched by the main path')
    # K4 once per FourierUnit (2 per resnet block), K5 for stem and final
    require(counts['fourier_unit'] == 2 * LAMA_BLOCKS * len(forwards)
            and counts['conv_stream'] == 2 * len(forwards),
            f'{len(forwards)} generator forwards, launches {counts}')
    for name, r in extra.items():
        require(r['ocr_lines'] == LINES_PER_PAGE and r['mask_pixels'] > 0,
                f'{name}: {r["ocr_lines"]} OCR lines, '
                f'{r["mask_pixels"]} mask pixels')
        require(r['forwards'] and r['inpainted_pixels_inside'] > 0
                and r['inpainted_pixels_outside'] == 0,
                f'{name}: inpainting changed {r["inpainted_pixels_inside"]} '
                f'pixels inside the mask, {r["inpainted_pixels_outside"]} '
                f'outside')
        require(r['translate']['decodes'],
                f'{name}: the translate stage decoded nothing')
        require(r['drawn_regions'] > 0 and r['rendered_pixels_in_boxes'] > 0
                and r['rendered_pixels_outside'] == 0,
                f'{name}: rendering changed {r["rendered_pixels_in_boxes"]} '
                f'pixels in the text boxes, {r["rendered_pixels_outside"]} '
                f'outside')
    return counts, forwards, page_dir, cfg_path, extra


def phase_cli(page_dir, cfg_path):
    """The literal command line, in a process of its own (no --use-gpu:
    the card is the default); its launches are not counted here."""
    import numpy as np
    from PIL import Image
    dest = os.path.join(OUT, 'cli_out')
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m', 'manga_image_translator_tpu_torch', 'local',
         '-i', page_dir, '--dest', dest, '--config-file', cfg_path],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    require(res.returncode == 0,
            f'CLI failed (exit {res.returncode}):\n{res.stderr[-3000:]}')
    written = sorted(os.listdir(dest))
    require(len(written) == 2, f'CLI wrote {written}')
    for name in written:
        arr = np.asarray(Image.open(os.path.join(dest, name)).convert('RGB'))
        require(arr.shape == (PAGE_H, PAGE_W, 3), f'{name}: {arr.shape}')
    emit({'phase': 'cli', 'seconds': time.perf_counter() - t0,
          'pages_written': written})


BATCH_PAGES = 3


class _Failures:
    """Collects the orchestrator's warnings and errors (a batched pre-pass
    that fell back to the per-page path logs one) while installed."""

    def __init__(self, logger):
        import logging
        self.logger = logger
        self.records = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = lambda record: self.records.append(record.getMessage())
        self.handler = handler

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _letterbox(rgbs, size):
    """The batched detector's canvases: each page resized to fit a
    ``size`` square, top left, zeros elsewhere."""
    import cv2
    import numpy as np
    canvases = np.zeros((len(rgbs), size, size, 3), np.uint8)
    for i, rgb in enumerate(rgbs):
        h, w = rgb.shape[:2]
        ratio = size / max(h, w)
        th, tw = int(round(h * ratio)), int(round(w * ratio))
        canvases[i, :th, :tw] = cv2.resize(rgb, (tw, th),
                                           interpolation=cv2.INTER_LINEAR)
    return canvases


def phase_batch(cfg_path):
    """``translate_batch`` on the card with the smoke's default ``Config``
    on three synthetic pages, the launch counters set to 0 just before and
    read just after. The random DBNet finds no text, so the detection
    pre-pass is wrapped here: the real one runs (its K1 launch and DBNet
    forward), then each page's line list and raw mask become its known
    boxes and stroke mask. Pooled OCR then reads 54 lines in chunks of 24,
    sugoi translates them in one batched call, the inpainter takes the
    three pages' crops in shared buckets and each page renders. Fails if a
    pre-pass left a page to the per-page path, if a kernel did not launch,
    if the pooled texts differ from the per-page OCR's on the same boxes,
    or if inpainting or rendering changed a pixel outside the mask or the
    text boxes."""
    import numpy as np
    from PIL import Image
    from manga_image_translator_tpu_torch import (inpainting, ocr,
                                                  manga_translator as mt)
    from manga_image_translator_tpu_torch.config import Inpainter, Ocr
    from manga_image_translator_tpu_torch.mode.local import load_config_file
    from manga_image_translator_tpu_torch.ops import cuda_build
    from manga_image_translator_tpu_torch.utils.generic import (Context,
                                                                load_image)
    from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral

    page_dir = os.path.join(WORK, 'batch_pages')
    boxes = make_pages(page_dir, BATCH_PAGES)
    names = sorted(boxes)
    config = load_config_file(cfg_path)
    images = [Image.open(os.path.join(page_dir, n)) for n in names]
    rgbs = [load_image(im)[0] for im in images]

    def known(i):
        return [Quadrilateral(np.array(q), '', 1.0) for q in boxes[names[i]]]

    translator = mt.MangaTranslator({'batch_size': BATCH_PAGES})
    require(translator.device == 'cuda',
            f'translator runs on {translator.device}, not cuda')
    rec = ocr.get_ocr(Ocr.ocr48px)
    inp = inpainting.get_inpainter(Inpainter.lama_large)
    stage_ms = collections.defaultdict(float)
    served, per_page = {}, collections.Counter()
    detected, render_boxes_of = [], {}

    def timed(name, fn):
        async def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = await fn(*args, **kw)
            torch.cuda.synchronize()
            stage_ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def counted(name, fn):
        async def run(*args, **kw):
            per_page[name] += 1
            return await fn(*args, **kw)
        return run

    predetect = translator._batch_predetect

    async def predetect_known(images_with_configs, batch_size):
        out = await predetect(images_with_configs, batch_size)
        served['detect'] = sorted(out)
        for i in sorted(out):
            detected.append(len(out[i][0]))
            out[i] = (known(i), stroke_mask(rgbs[i]), out[i][2])
        return out

    preocr = translator._batch_preocr

    async def preocr_served(images_with_configs, predetected):
        out = await preocr(images_with_configs, predetected)
        served['ocr'] = sorted(out)
        return out

    infer_batch = inp.infer_batch

    async def inpaint_served(imgs, masks, cfg, size, *args, **kw):
        served['inpaint'] = len(imgs)
        return await infer_batch(imgs, masks, cfg, size, *args, **kw)

    render = translator._run_text_rendering

    async def render_boxed(cfg, ctx):
        render_boxes_of[id(ctx)] = render_boxes(ctx, cfg)
        return await render(cfg, ctx)

    translator._batch_predetect = timed('detect', predetect_known)
    translator._batch_preocr = timed('ocr', preocr_served)
    translator._batch_translate_contexts = timed(
        'translate', translator._batch_translate_contexts)
    translator._run_textline_merge = timed('textline_merge',
                                           translator._run_textline_merge)
    translator._run_mask_refinement = timed('mask_refine',
                                            translator._run_mask_refinement)
    translator._run_text_rendering = timed('render', render_boxed)
    inp.infer_batch = timed('inpaint', inpaint_served)
    translator._run_detection = counted('detect', translator._run_detection)
    translator._run_inpainting = counted('inpaint', translator._run_inpainting)
    rec._infer = counted('ocr', rec._infer)
    two_tier = rec._two_tier_decode
    chunks = collections.Counter()

    def chunk_counted(memory):
        chunks['now'] += 1
        return two_tier(memory)
    rec._two_tier_decode = chunk_counted
    decodes = []
    forwards_before = len(inp.forwards)
    try:
        with _Failures(mt.logger) as failures, recording_decodes(decodes):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_build.reset_launch_counts()
            t0 = time.perf_counter()
            contexts = asyncio.run(translator.translate_batch(
                [(im, config) for im in images]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = cuda_build.launch_counts()
            peak = torch.cuda.max_memory_allocated()
        chunks_pooled = chunks.pop('now', 0)
        fallthrough = dict(per_page)
        forwards = [tuple(f) for f in inp.forwards[forwards_before:]]

        def read(pooled):
            """Each page's (box, text) pairs on the known boxes, through
            ``_run_ocr`` as the batch calls it: per page, or given the
            pooled OCR's lines (not counted)."""
            pre = (asyncio.run(rec.infer_pooled(
                rgbs, [known(i) for i in range(BATCH_PAGES)], config.ocr))
                if pooled else None)
            out = []
            for i in range(BATCH_PAGES):
                ctx = Context()
                ctx.img_rgb = rgbs[i]
                ctx.textlines = known(i)
                if pre is not None:
                    ctx.pre_ocred = pre[i]
                out.append([(q.pts.tolist(), q.text) for q in
                            asyncio.run(translator._run_ocr(config, ctx))])
            return out

        def lines_differ(a, b):
            return sum(x != y for pa, pb in zip(a, b) for x, y in
                       zip(pa, pb)) + sum(abs(len(pa) - len(pb))
                                          for pa, pb in zip(a, b))

        per_page_texts = read(False)
        chunks_per_page = chunks.pop('now', 0)
        batch_texts = [[(q.pts.tolist(), q.text) for q in ctx.textlines]
                       for ctx in contexts]
        # In bf16 the backbone's cuDNN convolutions round differently at
        # another batch size or width bucket, and random weights' 255-token
        # beams turn the least difference into other characters; in f32
        # without TF32 the memory of a crop does not depend on the crops
        # beside it: there the pooled texts must equal the per-page ones.
        switch = os.environ.get('MIT_TPU_OCR_BF16_BACKBONE')
        tf32 = torch.backends.cudnn.allow_tf32
        os.environ['MIT_TPU_OCR_BF16_BACKBONE'] = '0'
        torch.backends.cudnn.allow_tf32 = False
        try:
            exact = lines_differ(read(True), read(False))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
            if switch is None:
                os.environ.pop('MIT_TPU_OCR_BF16_BACKBONE')
            else:
                os.environ['MIT_TPU_OCR_BF16_BACKBONE'] = switch
    finally:
        del rec._infer, rec._two_tier_decode, inp.infer_batch

    # three translate calls on the same pages and boxes, for the wall time
    single = mt.MangaTranslator({})
    detect = single._run_detection

    async def detect_known(cfg, ctx):
        await detect(cfg, ctx)
        i = next(j for j, rgb in enumerate(rgbs)
                 if rgb.shape == ctx.img_rgb.shape
                 and np.array_equal(rgb, ctx.img_rgb))
        return known(i), stroke_mask(rgbs[i]), None
    single._run_detection = detect_known
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = [asyncio.run(single.translate(im, config)) for im in images]
    torch.cuda.synchronize()
    wall_single = time.perf_counter() - t0

    pages = {}
    for name, ctx in zip(names, contexts):
        inside = ctx.mask >= 127
        inpainted = (ctx.img_inpainted != ctx.img_rgb).any(-1)
        drawn = render_boxes_of.get(id(ctx))
        rendered = (ctx.img_rendered != ctx.img_inpainted).any(-1)
        pages[name] = {
            'ocr_lines': len(ctx.textlines),
            'regions': len(ctx.text_regions),
            'mask_pixels': int(inside.sum()),
            'inpainted_pixels_inside': int((inpainted & inside).sum()),
            'inpainted_pixels_outside': int((inpainted & ~inside).sum()),
            'rendered_pixels_in_boxes': (int((rendered & drawn).sum())
                                         if drawn is not None else None),
            'rendered_pixels_outside': (int((rendered & ~drawn).sum())
                                        if drawn is not None else None),
            'result_size': list(ctx.result.size)}
    buckets = collections.Counter(forwards)
    record = {'phase': 'batch', 'pages': BATCH_PAGES,
              'lines': sum(len(b) for b in boxes.values()),
              'detected_lines': detected, 'served': served,
              'per_page_fallthrough': fallthrough,
              'stage_ms': dict(stage_ms),
              'ocr_chunks': {'pooled': chunks_pooled,
                             'per_page': chunks_per_page},
              'ocr_lines_pooled_unlike_per_page': {
                  'bf16_backbone': lines_differ(batch_texts, per_page_texts),
                  'f32_backbone_no_tf32': exact},
              'lama_forwards': {f'{n}x{h}x{w}': k
                                for (n, h, w), k in sorted(buckets.items())},
              'sugoi_decodes': [{k: c[k] for k in ('wall_ms', 'steps')}
                                for c in decodes],
              'launches': counts, 'max_memory_allocated': peak,
              'wall_s': wall, 'wall_s_three_translate_calls': wall_single,
              'logged_failures': failures.records[:5], 'per_page': pages}
    emit(record)
    everything = list(range(BATCH_PAGES))
    require(served.get('detect') == everything
            and served.get('ocr') == everything
            and served.get('inpaint') == BATCH_PAGES,
            f'a batched pre-pass did not serve every page: {served}')
    require(not fallthrough, f'pages fell through to the per-page path: '
            f'{fallthrough}')
    require(not failures.records, f'the batch logged failures: '
            f'{failures.records[:3]}')
    for name, n in counts.items():
        require(n > 0, f'kernel {name} was not launched by the batch path')
    require(counts['fourier_unit'] == 2 * LAMA_BLOCKS * len(forwards)
            and counts['conv_stream'] == 2 * len(forwards),
            f'{len(forwards)} generator forwards, launches {counts}')
    require(len(decodes) >= 1, 'the batch decoded no translation')
    require(exact == 0, f'{exact} lines: the pooled OCR texts differ from the '
            f'per-page OCR in f32')
    for name, r in pages.items():
        require(r['ocr_lines'] == LINES_PER_PAGE,
                f'{name}: {r["ocr_lines"]} OCR lines')
        require(r['mask_pixels'] > 0 and r['inpainted_pixels_inside'] > 0
                and r['inpainted_pixels_outside'] == 0,
                f'{name}: inpainting changed {r["inpainted_pixels_inside"]} '
                f'pixels inside the mask, {r["inpainted_pixels_outside"]} '
                f'outside')
        require(r['rendered_pixels_in_boxes']
                and r['rendered_pixels_outside'] == 0,
                f'{name}: rendering changed {r["rendered_pixels_in_boxes"]} '
                f'pixels in the text boxes, {r["rendered_pixels_outside"]} '
                f'outside')
        require(r['result_size'] == [PAGE_W, PAGE_H], f'{name}: result size')
    for ctx in singles:
        require(ctx.result is not None and ctx.result.size == (PAGE_W, PAGE_H),
                'a translate call of the comparison gave no page')
    return {'launches': counts, 'forwards': forwards,
            'canvases': _letterbox(rgbs, config.detector.detection_size)}


def check_batch_kernels(results, batch):
    """K1 on the batch's letterboxed canvases (one launch for the three)
    against its plain version, at most 1 gray, and timed; the 18-block
    generator at the largest crop bucket the batch ran, kernels against
    the plain routes as check_lama holds it."""
    from manga_image_translator_tpu_torch.ops import bilateral
    canvases = torch.from_numpy(batch['canvases']).cuda()
    got = bilateral.bilateral_filter_batch(canvases)
    ref = bilateral.bilateral_filter_ref(canvases)
    torch.cuda.synchronize()
    err = int((got.int() - ref.int()).abs().max())
    emit({'phase': 'check', 'kernel': 'bilateral', 'at': 'batch_canvases',
          'shape': list(canvases.shape), 'max_abs_err': err, 'tol': 1})
    require(err <= 1, f'bilateral at the batch canvases: {err} gray > 1')
    results['bilateral']['max_abs_err'] = max(
        results['bilateral']['max_abs_err'], err)
    n, h, w = canvases.shape[:3]
    taps = len(bilateral.window_offsets(8)) - 1
    pixels = n * h * w
    r = {'shape': list(canvases.shape), 'data': 'letterboxed pages'}
    r['ms'] = cuda_ms(lambda: bilateral.bilateral_filter_batch(canvases))
    r['plain_ms'] = cuda_ms(lambda: bilateral.bilateral_filter_ref(canvases),
                            iters=5, warmup=1)
    r['library_ms'] = None
    r['bound_ms'], r['bound_by'] = bound_ms(
        2 * pixels * 3, pixels * (taps * 7 + taps // 2 * 6 + 12),
        F32_OPS_PER_S)
    results['bilateral']['at_batch_canvases'] = r
    largest = max(batch['forwards'], key=lambda f: f[0] * f[1] * f[2])
    check_generator(largest, 'batch_largest_bucket')


def _free_port_pair():
    """A free port whose successor is free too (the gateway's executor
    listens on the gateway's port + 1)."""
    import socket
    for _ in range(100):
        with socket.socket() as a:
            a.bind(('127.0.0.1', 0))
            port = a.getsockname()[1]
        try:
            with socket.socket() as b:
                b.bind(('127.0.0.1', port + 1))
            return port
        except OSError:
            continue
    raise RuntimeError('no free pair of ports')


def _decode_wire(payload: bytes):
    """The translations of a binary response (the layout of
    examples/response.cpp); fails unless it parses to its last byte."""
    import struct
    (count,), off = struct.unpack_from('<i', payload, 0), 4
    texts = []
    for _ in range(count):
        off += 16 + 1 + 8 + 6
        (n_text,) = struct.unpack_from('<i', payload, off)
        off += 4
        text = {}
        for _ in range(n_text):
            (kl,) = struct.unpack_from('<I', payload, off)
            key = payload[off + 4:off + 4 + kl].decode()
            off += 4 + kl
            (vl,) = struct.unpack_from('<I', payload, off)
            text[key] = payload[off + 4:off + 4 + vl].decode()
            off += 4 + vl
        (bl,) = struct.unpack_from('<I', payload, off)
        off += 4 + bl
        texts.append(text)
    require(off == len(payload), f'binary response: {len(payload) - off} '
            f'bytes after the last translation')
    return texts


def phase_server(page_dir, cfg_path):
    """The gateway with ``--start-instance``, each a process of its own:
    ``python -m manga_image_translator_tpu_torch.server.main`` spawns
    ``python -m manga_image_translator_tpu_torch shared`` (on the card).
    One page to ``/translate/json``, one to ``/translate/bytes/stream``
    (its frames decoded), two to ``/translate/batch/json``; then SIGTERM to
    the gateway, which stops its executor. Fails on a status other than
    200, a response that does not decode, a non-zero exit or a traceback in
    either process's output."""
    import base64
    import signal
    import urllib.request
    with open(cfg_path) as f:
        cfg = json.load(f)
    pages = [base64.b64encode(open(os.path.join(page_dir, n), 'rb').read())
             .decode() for n in sorted(os.listdir(page_dir))]
    port = _free_port_pair()
    nonce = os.urandom(8).hex()
    log_path = os.path.join(OUT, 'server.log')
    env = dict(os.environ, PYTHONPATH=ROOT, MIT_TPU_ALLOW_RANDOM_WEIGHTS='1')
    t0 = time.perf_counter()
    log = open(log_path, 'w')
    gateway = subprocess.Popen(
        [sys.executable, '-m', 'manga_image_translator_tpu_torch.server.main',
         '--host', '127.0.0.1', '--port', str(port), '--nonce', nonce,
         '--start-instance'], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True)

    def get(url):
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.loads(r.read())

    def post(path, body, timeout=600):
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
            headers={'Content-Type': 'application/json'})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=timeout) as r:
            require(r.status == 200, f'{path}: status {r.status}')
            data = r.read()
        ms[path] = (time.perf_counter() - t) * 1e3
        return data

    ms = {}
    try:
        deadline = time.monotonic() + 300
        while True:
            require(gateway.poll() is None, 'the gateway exited at start '
                    f'(code {gateway.returncode}):\n'
                    + open(log_path).read()[-3000:])
            require(time.monotonic() < deadline, 'the gateway or its '
                    'executor did not come up in 300 s:\n'
                    + open(log_path).read()[-3000:])
            try:
                get(f'http://127.0.0.1:{port}/queue-size')
                get(f'http://127.0.0.1:{port + 1}/is_locked')
                break
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        one = json.loads(post('/translate/json',
                              {'image': pages[0], 'config': cfg}))
        require(isinstance(one.get('translations'), list),
                f'/translate/json: {str(one)[:300]}')
        raw = post('/translate/bytes/stream', {'image': pages[1],
                                               'config': cfg})
        frames, i = [], 0
        while i < len(raw):
            n = int.from_bytes(raw[i + 1:i + 5], 'big')
            frames.append((raw[i], raw[i + 5:i + 5 + n]))
            i += 5 + n
        require(i == len(raw) and frames and frames[-1][0] == 0,
                f'stream frames: {[s for s, _ in frames]}')
        progress = [p.decode() for s, p in frames if s == 1]
        require('detection' in progress, f'stream progress: {progress}')
        streamed = _decode_wire(frames[-1][1])
        batch = json.loads(post('/translate/batch/json', {'images': [
            {'image': p, 'config': cfg} for p in pages[:2]]}))
        require(isinstance(batch, list) and len(batch) == 2 and all(
            isinstance(r.get('translations'), list) for r in batch),
            f'/translate/batch/json: {str(batch)[:300]}')
        gateway.send_signal(signal.SIGTERM)
        rc = gateway.wait(timeout=120)
    finally:
        if gateway.poll() is None:
            os.killpg(gateway.pid, signal.SIGKILL)
            gateway.wait()
        log.close()
    out = open(log_path).read()
    emit({'phase': 'server', 'port': port, 'up_s': up_s, 'request_ms': ms,
          'translations': {'json': len(one['translations']),
                           'stream': len(streamed),
                           'batch': [len(r['translations']) for r in batch]},
          'stream_frames': len(frames), 'progress': progress[:12],
          'exit_code': rc, 'seconds': time.perf_counter() - t0})
    require(rc == 0, f'the gateway exited with code {rc}:\n{out[-3000:]}')
    require('Traceback' not in out,
            f'a traceback in the server output:\n{out[-3000:]}')


def phase_ws(page_dir, cfg_path):
    """One page through the port's ws worker (``MangaTranslatorWS`` on the
    card, in this process) against a local websockets server: status
    frames, then a result frame holding the page."""
    import base64
    import io
    import websockets
    from PIL import Image
    from manga_image_translator_tpu_torch.mode.ws import MangaTranslatorWS
    with open(cfg_path) as f:
        cfg = json.load(f)
    name = sorted(os.listdir(page_dir))[0]
    page = base64.b64encode(open(os.path.join(page_dir, name), 'rb').read()
                            ).decode()
    received = []

    async def run():
        done = asyncio.Event()

        async def handler(ws):
            await ws.send(json.dumps({'type': 'new_task', 'id': 'smoke-1',
                                      'image_b64': page, 'config': cfg}))
            async for raw in ws:
                received.append(json.loads(raw))
                if received[-1]['type'] in ('result', 'error'):
                    done.set()
                    return

        async with websockets.serve(handler, '127.0.0.1', 0,
                                    max_size=1 << 30) as server:
            port = server.sockets[0].getsockname()[1]
            worker = MangaTranslatorWS({'ws_url': f'ws://127.0.0.1:{port}',
                                        'ws_secret': 'smoke'})
            require(worker.device == 'cuda', f'ws worker on {worker.device}')
            task = asyncio.create_task(worker.listen())
            try:
                await asyncio.wait_for(done.wait(), timeout=600)
            finally:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass

    t0 = time.perf_counter()
    asyncio.run(run())
    types = [m['type'] for m in received]
    require(types and types[-1] == 'result',
            f'ws frames: {types}; last: {str(received[-1:])[:300]}')
    out = Image.open(io.BytesIO(base64.b64decode(received[-1]['image_b64'])))
    emit({'phase': 'ws', 'frames': len(received),
          'statuses': [m['status'] for m in received
                       if m['type'] == 'status'][:12],
          'result_size': list(out.size), 'seconds': time.perf_counter() - t0})
    require(out.size == (PAGE_W, PAGE_H), f'ws result size {out.size}')


# ---------------------------------------------------------------------------
# the other detectors and inpainters
# ---------------------------------------------------------------------------

MPE_BLOCKS = 9                 # lama_mpe
MPE_ALPHA = 0.5                # the init's 0 would switch the MPE off
# the two configurations through the local CLI, and the detectors run by
# dispatch on the same page, each at its detection size
BACKEND_CONFIGS = {'a': {'detector': 'ctd', 'inpainter': 'lama_mpe'},
                   'b': {'detector': 'craft', 'inpainter': 'default'}}
DISPATCHED = ('dbconvnext', 'paddle')
BACKEND_DETECT_SIZE = {'ctd': 2048, 'craft': 2048, 'dbconvnext': 2048,
                       'paddle': 2048}
BACKEND_CANVAS = 1024          # ctd's fixed input; the detectors' canvas
BACKEND_CROP = 512             # AOT's crop, the lama_mpe generator's bucket
# kernels each configuration's path must launch, and must not
BACKEND_KERNELS = {'a': (('bilateral', 'decode_step', 'charhead',
                          'fourier_unit', 'conv_stream'), ()),
                   'b': (('bilateral', 'decode_step', 'charhead'),
                         ('fourier_unit', 'conv_stream'))}


@functools.lru_cache(maxsize=1)
def mpe_generator():
    """The 9-block lama_mpe generator, seeded random weights, BN folded,
    f32, on the card."""
    from manga_image_translator_tpu_torch.models import lama
    return lama.fold_bn(lama.build_lama(
        MPE_BLOCKS, lama.init_state_dict(MPE_BLOCKS), 'cuda'))


def mpe_tables(device):
    """The MPE module with its init tables and both scales at
    ``MPE_ALPHA``."""
    from manga_image_translator_tpu_torch.models import lama
    sd = lama.mpe_init_state_dict()
    sd['alpha5'] = sd['alpha6'] = torch.tensor(MPE_ALPHA)
    return lama.build_mpe(sd, device)


def backend_models(rgb):
    """name -> (f32 model on the CPU, forward(model, *inputs), CPU inputs)
    of each network of the other detectors and inpainters at full width:
    ctd at its fixed 1024² input, craft (with its refiner), dbconvnext and
    paddle on the page letterboxed into 1024², AOT on one 512² crop, the
    lama_mpe generator (``scaled_generator``, embeddings at scale 0.5) on
    one 512² crop bucket. Inputs as each detector or inpainter makes
    them."""
    import numpy as np
    from manga_image_translator_tpu_torch.models import (aot, craft, ctd,
                                                         dbnet_convnext, lama,
                                                         paddle_det)
    canvas = torch.from_numpy(_letterbox([rgb], BACKEND_CANVAS)).float()
    imagenet = (torch.tensor([0.485, 0.456, 0.406]),
                torch.tensor([0.229, 0.224, 0.225]))
    c = BACKEND_CROP
    crop = torch.from_numpy(np.ascontiguousarray(rgb[:c, :c])).float()
    mask = torch.from_numpy(stroke_mask(rgb)[:c, :c] >= 127)[
        None, ..., None].float()
    out = {}
    out['ctd'] = (ctd.build_ctd('cpu', ctd.init_state_dict()),
                  ctd.ctd_forward, (canvas / 255.0,))
    out['craft'] = (
        torch.nn.ModuleList([
            craft.build(craft.CRAFT, 'cpu', craft.init_state_dict()),
            craft.build(craft.RefineNet, 'cpu',
                        craft.init_refiner_state_dict())]),
        lambda m, x: craft.craft_forward(m[0], m[1], x),
        ((canvas - imagenet[0] * 255) / (imagenet[1] * 255),))
    out['dbconvnext'] = (
        dbnet_convnext.build_dbnet_convnext('cpu',
                                            dbnet_convnext.init_state_dict()),
        dbnet_convnext.dbnet_convnext_forward, (canvas / 127.5 - 1.0,))
    out['paddle'] = (
        paddle_det.build_paddle_det('cpu', paddle_det.init_state_dict()),
        paddle_det.paddle_det_forward,
        ((canvas / 255.0 - imagenet[0]) / imagenet[1],))
    out['aot'] = (aot.build_aot('cpu', aot.init_state_dict()),
                  lambda m, i, k: m(i, k),
                  ((crop[None] / 127.5 - 1.0) * (1 - mask), mask))
    rel, direct = lama.masked_position_encoding(mask[0, ..., 0].numpy())
    gen = scaled_generator(mpe_generator(), MPE_BLOCKS).cpu()
    out['lama_mpe'] = (
        torch.nn.ModuleList([gen, mpe_tables('cpu')]),
        lambda m, i, k, r, d: m[0](i, k, *m[1](r, d)),
        (crop[None] / 255.0 * (1 - mask), mask,
         torch.from_numpy(rel)[None], torch.from_numpy(direct)[None]))
    return out


# Random AOT weights are chaotic in f32: each of the 10 AOT blocks about
# doubles a perturbation (the gate's layer norm scales by 10 / std), so an
# input change of 1e-6 moves the 512² output by up to 2.7e-2 on the CPU
# (PERF.md §6). AOT is held card against CPU in f64, where rounding
# cannot reach 1e-3; its f32 difference is reported beside the CPU's own
# change under a one-ulp change of the input.
F64_CHECKED = ('aot',)


def _card_vs_cpu(model, fwd, inputs):
    """(max |card - cpu| / max |cpu| over the outputs, CPU seconds, the
    CPU outputs)."""
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = fwd(model, *inputs)
    cpu_s = time.perf_counter() - t0
    card = copy.deepcopy(model).cuda()
    with torch.inference_mode():
        got = fwd(card, *[x.cuda() for x in inputs])
    torch.cuda.synchronize()
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    require(all(g.is_cuda for g in got), 'a network left the card')
    rel = max(float((g.double().cpu() - r.double()).abs().max())
              / float(r.double().abs().max()) for g, r in zip(got, ref))
    return rel, cpu_s, ref


def check_backend_models(rgb):
    """Each network of ``backend_models`` on the card against the same
    weights and inputs on the CPU, without TF32: max |card - cpu| at most
    1e-3 of max |cpu| (the JAX suite's bound between two frameworks,
    tests/test_model_oracle.py:72), in f32, AOT in f64
    (``F64_CHECKED``). The lama_mpe generator runs K4 and K5 on the
    card."""
    return check_card_vs_cpu(backend_models(rgb))


# device memory the card-against-CPU checks may take beyond what is live
# when they start (see check_card_vs_cpu)
CHECK_HEADROOM = 4 << 30


def check_card_vs_cpu(models):
    """Each ``name -> (model, forward, CPU inputs)`` on the card against
    the CPU without TF32, within 1e-3 of max |cpu|; the names in
    ``F64_CHECKED`` in f64. Returns each check's record, with the peak
    device memory of its card forward (``max_memory_allocated``; the
    peak counter is reset before each check)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's f32 algorithms without TF32 can ask for tens of GB of
    # workspace (ocr48_ctc's conv4_2 on a 16x320x3x129 input: the bulk of
    # the 59.8 GB these checks reached uncapped on the H100): with the
    # allocator capped, such a request fails and PyTorch takes the next
    # algorithm cuDNN offers
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(min(1.0, (
        torch.cuda.memory_allocated() + CHECK_HEADROOM)
        / torch.cuda.get_device_properties(0).total_memory))
    checks = {}
    try:
        for name, (model, fwd, inputs) in models.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rel, cpu_s, ref = _card_vs_cpu(model, fwd, inputs)
            checks[name] = {'shape': [list(x.shape) for x in inputs],
                            'dtype': 'float32', 'max_rel_err': rel,
                            'cpu_s': cpu_s,
                            'max_memory_allocated':
                                torch.cuda.max_memory_allocated()}
            if name in F64_CHECKED:
                with torch.inference_mode():
                    ulp = fwd(model, *[torch.nextafter(
                        x, torch.tensor(float('inf'))) for x in inputs])
                ulp = ulp if isinstance(ulp, tuple) else (ulp,)
                checks[name]['cpu_change_one_ulp_input'] = max(
                    float((u - r).abs().max()) / float(r.abs().max())
                    for u, r in zip(ulp, ref))
                checks[name]['float32_max_rel_err'] = rel
                rel, _, _ = _card_vs_cpu(
                    model.double(), fwd, [x.double() for x in inputs])
                checks[name].update(dtype='float64', max_rel_err=rel)
            require(rel <= 1e-3, f'{name}: card against CPU {rel} of max')
            del model, ref
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.set_per_process_memory_fraction(1.0)
    torch.cuda.empty_cache()
    return checks


def phase_backends(cfg_path):
    """The other detectors and inpainters on the card (``backends``):

    1. each network against the CPU (``check_backend_models``), and the
       lama_mpe generator's kernel routes against its plain routes
       (``check_generator``);
    2. one synthetic page through the ``local`` CLI in configuration (a)
       ``ctd`` + ``lama_mpe`` and (b) ``craft`` + ``default`` (AOT), the
       detector's real output on random weights, then OCR → inpaint →
       render on the page's known boxes (``_known_quads_pass``); the
       launch counters set to 0 just before each and read just after: (a)
       must launch K1-K5 and run only 9-block MPE forwards, (b) K1-K3 and
       neither K4 nor K5; the inpainted page may change only inside the
       mask; the orchestrator may log no failure;
    3. ``dbconvnext`` and ``paddle`` through ``detection.dispatch`` on the
       same page.

    Prints the ``backends`` line: stage ms per configuration, per detector
    its first forward (device-synchronised wall, cuDNN's first-call setup
    included), the same forward warm (CUDA events) and the host ms of its
    detection, MPE encoding host ms per crop, the LaMa-MPE and AOT
    forwards with the device ms of one at their largest bucket, peak
    device memory."""
    from PIL import Image
    from manga_image_translator_tpu_torch import detection
    from manga_image_translator_tpu_torch.config import Detector
    from manga_image_translator_tpu_torch.detection import (craft, ctd,
                                                            dbnet_convnext,
                                                            paddle)
    from manga_image_translator_tpu_torch.utils.generic import load_image

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    page_dir = os.path.join(WORK, 'backend_pages')
    boxes = make_pages(page_dir, 1)
    name = sorted(boxes)[0]
    page_path = os.path.join(page_dir, name)
    rgb = load_image(Image.open(page_path))[0]

    t0 = time.perf_counter()
    models = check_backend_models(rgb)
    check_generator((1, BACKEND_CROP, BACKEND_CROP),
                    f'mpe_crop_{BACKEND_CROP}', MPE_BLOCKS, mpe_tables('cuda'))
    checks_s = time.perf_counter() - t0

    # each detector's network forward, device-synchronised, by detector;
    # its first call's arguments are kept to time it warm afterwards
    forward_ms = collections.defaultdict(list)
    first_calls = {}

    def timed_forward(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            forward_ms[key].append((time.perf_counter() - t) * 1e3)
            first_calls.setdefault(key, (fn, args, kw))
            return out
        return run
    wrapped = [(ctd, '_forward_batch', 'ctd'), (craft, '_forward', 'craft'),
               (dbnet_convnext, '_forward_batch', 'dbconvnext'),
               (paddle, '_forward', 'paddle')]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in wrapped]
    for mod, attr, key in wrapped:
        setattr(mod, attr, timed_forward(key, getattr(mod, attr)))

    with open(cfg_path) as f:
        base = json.load(f)
    configs, detect_ms = {}, {}
    try:
        for key, chosen in BACKEND_CONFIGS.items():
            cfg = copy.deepcopy(base)
            cfg['detector'].update(
                detector=chosen['detector'],
                detection_size=BACKEND_DETECT_SIZE[chosen['detector']])
            cfg['inpainter'] = {'inpainter': chosen['inpainter']}
            path = os.path.join(WORK, f'config_{key}.json')
            with open(path, 'w') as f:
                json.dump(cfg, f)
            configs[key] = run_backend_config(key, chosen, path, page_dir,
                                              name, boxes[name])
        for key in DISPATCHED:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lines, raw, _ = asyncio.run(detection.dispatch(
                Detector(key), rgb, BACKEND_DETECT_SIZE[key], 0.5, 0.7, 2.3,
                False, False, False, device='cuda'))
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            det = detection.get_detector(Detector(key))
            require(det.device.type == 'cuda', f'{key} ran on {det.device}')
            require(raw is not None and raw.ndim == 2,
                    f'{key}: no raw mask')
            detect_ms[key] = {'size': BACKEND_DETECT_SIZE[key],
                              'lines': len(lines), 'total_ms': total,
                              'forward_ms': forward_ms[key][-1],
                              'host_ms': total - forward_ms[key][-1]}
            asyncio.run(detection.unload(Detector(key)))
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    # warm: CUDA events around the same call, cuDNN's first-call setup done
    for key, (fn, args, kw) in first_calls.items():
        detect_ms.setdefault(key, {})['warm_forward_ms'] = cuda_ms(
            lambda: fn(*args, **kw), iters=10, warmup=2, reps=2)
        detect_ms[key]['canvas'] = list(args[-1].shape)
    del first_calls
    for key, r in configs.items():
        det = BACKEND_CONFIGS[key]['detector']
        total = r['stage_ms_cli'].get('detect')
        detect_ms.setdefault(det, {}).update(
            size=BACKEND_DETECT_SIZE[det], lines=r['detected_lines'],
            total_ms=total, forward_ms=forward_ms[det][0],
            host_ms=(total - forward_ms[det][0] if total is not None
                     else None))

    inpaint_ms = {key: time_inpainter_forward(
        r['inpainter'], [tuple(f) for f in r['inpaint_forwards']], rgb)
        for key, r in configs.items()}
    peak = max([torch.cuda.max_memory_allocated()]
               + [c['max_memory_allocated'] for c in models.values()])
    record = {'phase': 'backends', 'card': torch.cuda.get_device_name(0),
              'models_card_vs_cpu': models, 'checks_s': checks_s,
              'configs': configs, 'detectors': detect_ms,
              'inpainter_forward': inpaint_ms,
              'max_memory_allocated': peak,
              'seconds': time.perf_counter() - t_phase}
    emit(record)
    return record


def time_inpainter_forward(key, forwards, rgb):
    """Device ms of one generator forward of inpainter ``key`` (bf16, its
    default) at the largest bucket it ran, on the page's pixels and stroke
    mask; lama_mpe's embeddings are made beforehand (their host BFS is
    timed by the run itself)."""
    import numpy as np
    from manga_image_translator_tpu_torch import inpainting
    from manga_image_translator_tpu_torch.config import Inpainter
    from manga_image_translator_tpu_torch.inpainting import (inpainting_aot,
                                                             inpainting_lama)
    inp = inpainting.get_inpainter(Inpainter(key))
    n, h, w = max(forwards, key=lambda f: f[0] * f[1] * f[2])
    imgs = np.ascontiguousarray(np.repeat(rgb[None, :h, :w], n, 0))
    masks = np.ascontiguousarray(np.repeat(stroke_mask(rgb)[None, :h, :w],
                                           n, 0))
    img = torch.from_numpy(imgs).cuda().float()
    msk = (torch.from_numpy(masks).cuda().float()[..., None] / 255.0
           >= 0.5).float()
    with torch.inference_mode():
        if key == 'lama_mpe':
            emb = inp._embeddings(masks)
            inp.encodings.pop()
            model, dtype = inp._model_for(torch.bfloat16), torch.bfloat16

            def fwd():
                return inpainting_lama._lama_body(model, img / 255.0, msk,
                                                  dtype, emb)
        else:
            def fwd():
                return inpainting_aot._aot_body(
                    inp.model, img / 127.5 - 1.0, msk,
                    inpainting_aot.COMPUTE_DTYPE)
        ms = cuda_ms(fwd, iters=10, warmup=2, reps=2)
    return {'bucket': [n, h, w], 'device_ms': ms}


def run_backend_config(key, chosen, cfg_path, page_dir, name, quads):
    """One configuration of ``phase_backends``: the page through the
    ``local`` CLI's translator, then the known-box pass, launch counters
    set to 0 just before and read just after."""
    from manga_image_translator_tpu_torch import (inpainting,
                                                  manga_translator as mt)
    from manga_image_translator_tpu_torch.args import parser
    from manga_image_translator_tpu_torch.config import Inpainter
    from manga_image_translator_tpu_torch.inpainting.inpainting_lama import \
        LamaMPEInpainter
    from manga_image_translator_tpu_torch.mode.local import (
        MangaTranslatorLocal, load_config_file)
    from manga_image_translator_tpu_torch.ops import cuda_build
    dest = os.path.join(OUT, f'backends_{key}')
    args = vars(parser.parse_args(['local', '-i', page_dir, '--dest', dest,
                                   '--config-file', cfg_path,
                                   '--overwrite']))
    stage_ms = {}
    detected = []

    async def hook(state, finished):
        if state.startswith('stage-time:'):
            _, stage, ms = state.split(':')
            stage_ms[stage] = stage_ms.get(stage, 0.0) + float(ms)

    inp = inpainting.get_inpainter(Inpainter(chosen['inpainter']))
    decodes = []

    async def drive():
        translator = MangaTranslatorLocal(args)
        require(translator.device == 'cuda',
                f'translator runs on {translator.device}, not cuda')
        translator.add_progress_hook(hook)
        detect = translator._run_detection

        async def detect_counted(config, ctx):
            out = await detect(config, ctx)
            detected.append(len(out[0]))
            return out
        translator._run_detection = detect_counted
        await translator.translate_path(args['input'], dest, args)
        config = load_config_file(cfg_path)
        require(config.detector.detector.value == chosen['detector']
                and config.inpainter.inpainter.value == chosen['inpainter'],
                f'configuration {key} runs {config.detector.detector} and '
                f'{config.inpainter.inpainter}')
        return await _known_quads_pass(
            translator, config, os.path.join(page_dir, name), quads,
            decodes)

    torch.cuda.synchronize()
    inp.forwards = []
    encodings_before = len(getattr(inp, 'encodings', []))
    with _Failures(mt.logger) as failures, recording_decodes(decodes):
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        extra = asyncio.run(drive())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = cuda_build.launch_counts()
    out_path = os.path.join(dest, name)
    require(os.path.isfile(out_path), f'{key}: page not written: {out_path}')
    forwards = list(inp.forwards)
    result = {'detector': chosen['detector'],
              'inpainter': chosen['inpainter'], 'wall_s': wall,
              'stage_ms_cli': stage_ms, 'stage_ms_known_boxes':
              extra['stage_ms'], 'detected_lines': detected[0],
              'ocr_lines': extra['ocr_lines'], 'launches': counts,
              'inpaint_forwards': [list(f) for f in forwards],
              'mask_pixels': extra['mask_pixels'],
              'inpainted_pixels_inside': extra['inpainted_pixels_inside'],
              'inpainted_pixels_outside': extra['inpainted_pixels_outside'],
              'logged_failures': failures.records[:5]}
    if isinstance(inp, LamaMPEInpainter):
        enc = inp.encodings[encodings_before:]
        result['mpe_blocks'] = inp.model.n_blocks
        result['mpe_encodings'] = len(enc)
        result['mpe_encode_ms_per_crop'] = (
            sum(ms for _, ms in enc) / max(sum(n for n, _ in enc), 1))
        # one encoding per forward; K4 twice per block, K5 twice per
        # forward: every LaMa forward was a 9-block MPE forward
        require(inp.model.n_blocks == MPE_BLOCKS and inp.mpe is not None
                and len(enc) == len(forwards)
                and counts['fourier_unit'] == 2 * MPE_BLOCKS * len(forwards)
                and counts['conv_stream'] == 2 * len(forwards),
                f'{key}: {len(forwards)} LaMa forwards, {len(enc)} MPE '
                f'encodings, {inp.model.n_blocks} blocks, launches '
                f'{counts}')
    must, must_not = BACKEND_KERNELS[key]
    for k in must:
        require(counts[k] > 0, f'{key}: kernel {k} was not launched')
    for k in must_not:
        require(counts[k] == 0, f'{key}: kernel {k} launched {counts[k]} '
                f'times')
    require(extra['ocr_lines'] == LINES_PER_PAGE,
            f'{key}: {extra["ocr_lines"]} OCR lines')
    require(forwards and extra['inpainted_pixels_inside'] > 0
            and extra['inpainted_pixels_outside'] == 0,
            f'{key}: inpainting changed {extra["inpainted_pixels_inside"]} '
            f'pixels inside the mask, {extra["inpainted_pixels_outside"]} '
            f'outside')
    require(not failures.records, f'{key}: the orchestrator logged '
            f'{failures.records[:3]}')
    return result


# ---------------------------------------------------------------------------
# the other OCRs, the upscalers and the colorizer (extras)
# ---------------------------------------------------------------------------

TF32_OPS_PER_S = 495e12        # tensor cores, TF32 inputs (cuDNN's convs)
SCAN_W, SCAN_H = PAGE_W // 2, PAGE_H // 2      # a low-resolution scan
# the CLI pass's stages beside the smoke's default config
EXTRAS_CONFIG = {'colorizer': {'colorizer': 'mc2', 'colorization_size': 576,
                               'denoise_sigma': 30},
                 'upscale': {'upscaler': 'esrgan', 'upscale_ratio': 2},
                 'ocr': {'ocr': '32px', 'prob': 0.0}}
# kernels the CLI pass must launch, and must not
EXTRAS_KERNELS = (('bilateral', 'fourier_unit', 'conv_stream'),
                  ('decode_step', 'charhead'))
ESRGAN_TILE = 272              # 256 + 2 x 8 px of context
# a cunet-style ncnn graph: Split, conv branch, SE block (global pooling,
# two InnerProducts, Sigmoid, broadcast multiply), Crop to a reference,
# channel Concat and the 4x4 stride-2 Deconvolution
CUNET_STYLE_PARAM = '\n'.join([
    '7767517', '12 14',
    'Input input 0 1 input',
    'Split split0 1 2 input in_a in_b',
    'Convolution conv1 1 1 in_a f1 0=64 1=3 5=1 6=1728',
    'ReLU relu1 1 1 f1 f1r 0=0.100000',
    'Pooling gap 1 1 f1r pooled 0=1 4=1',
    'InnerProduct fc1 1 1 pooled fc1o 0=8 1=1 2=512 9=1',
    'InnerProduct fc2 1 1 fc1o fc2o 0=64 1=1 2=512',
    'Sigmoid sig 1 1 fc2o gate',
    'BinaryOp scale 2 1 f1r gate scaled 0=2',
    'Crop crop0 2 1 in_b scaled in_c',
    'Concat cat 2 1 in_c scaled cat_o 0=0',
    'Deconvolution up 1 1 cat_o out 0=3 1=4 3=2 4=3 5=1 6=3216', ''])


def esrgan_tile_macs(nb: int) -> float:
    """Multiply-adds of one ESRGAN forward over a 272² tile (nf 64, gc
    32): per input pixel the first conv, nb RRDBs of three dense blocks
    (9·(64+96+128+160)·32 + 9·192·64 each) and the trunk conv; the two
    upsampling convs at 4x and 16x the pixels, the HR and last convs at
    16x."""
    rdb = 9 * (64 + 96 + 128 + 160) * 32 + 9 * 192 * 64
    conv = 9 * 64 * 64
    per_px = (9 * 3 * 64 + nb * 3 * rdb + conv * (1 + 4 + 16 + 16)
              + 16 * 9 * 64 * 3)
    return per_px * ESRGAN_TILE * ESRGAN_TILE


class _Graph(torch.nn.Module):
    """An ncnn layer list as a module, so that it moves like the others."""

    def __init__(self, layers):
        super().__init__()
        self.layers = layers

    def forward(self, x):
        from manga_image_translator_tpu_torch.utils import ncnn_lite
        return ncnn_lite.run_graph(self.layers, x)


def write_cunet_style(root, seed=0):
    """The graph's .param and a .bin of seeded weights under ``root``."""
    import numpy as np
    from manga_image_translator_tpu_torch.utils import ncnn_lite
    rs = np.random.RandomState(seed)
    blobs = []
    for layer in ncnn_lite.parse_param(CUNET_STYLE_PARAM):
        if layer.type in ('Convolution', 'Deconvolution', 'InnerProduct'):
            n = int(layer.p(6 if layer.type != 'InnerProduct' else 2))
            blobs += [np.zeros(1, np.uint32).tobytes(),
                      (rs.randn(n) * 0.05).astype(np.float32).tobytes(),
                      (rs.randn(int(layer.p(0))) * 0.01).astype(
                          np.float32).tobytes()]
    param, binf = (os.path.join(root, f'cunet_style.{e}')
                   for e in ('param', 'bin'))
    with open(param, 'w') as f:
        f.write(CUNET_STYLE_PARAM)
    with open(binf, 'wb') as f:
        f.write(b''.join(blobs))
    return param, binf


def make_scan(page_dir):
    """One of the smoke's pages at half its size (724x1024), as a scan the
    upscaler is for; returns its name and its lines' boxes."""
    import cv2
    import numpy as np
    full_dir = os.path.join(WORK, 'extras_full')
    boxes = make_pages(full_dir, 1)
    full = cv2.imread(os.path.join(full_dir, 'page0.png'))
    os.makedirs(page_dir, exist_ok=True)
    cv2.imwrite(os.path.join(page_dir, 'scan0.png'),
                cv2.resize(full, (SCAN_W, SCAN_H),
                           interpolation=cv2.INTER_AREA))
    return 'scan0.png', (np.array(boxes['page0.png'])
                         * [SCAN_W / PAGE_W, SCAN_H / PAGE_H]).tolist()


def _ocr_batch(rgb, quads, height, extra):
    """The OCR's first chunk of crops: 16 host warps of the page's lines
    at ``height``, padded into one width bucket (as the 32px and CTC
    backends make it), in [-1, 1]; and their widths."""
    import numpy as np
    from manga_image_translator_tpu_torch.ocr.model_48px import bucket_width
    from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
    crops = [Quadrilateral(np.array(q), '', 1.0).get_transformed_region(
        rgb, 'h', height) for q in quads[:16]]
    widths = [c.shape[1] for c in crops]
    bw = bucket_width(max(widths) + extra)
    batch = np.zeros((16, height, bw, 3), np.uint8)
    for i, c in enumerate(crops):
        batch[i, :, :min(c.shape[1], bw)] = c[:, :bw]
    return (torch.from_numpy(batch).float() / 127.5 - 1.0,
            torch.tensor([min(w, bw) for w in widths]))


def extras_models(rgb, quads):
    """name -> (f32 model on the CPU, forward(model, *inputs), CPU inputs)
    of each network of the other OCRs, the upscalers and the colorizer at
    full width, on the scan's pixels: ESRGAN at nb 6 (the 'esrgan' key)
    and 23 (4x-UltraSharp) on one 272² tile, FFDNet on a 512² crop, the
    mc2 generator on the 576x832 sketch the colorizer makes of the scan,
    ocr32's memory and first-step log-probs and ocr48_ctc's log-probs on
    the first 16 lines, upconv_7 on a context-padded 256² crop and the
    cunet-style ncnn graph on a 256² crop."""
    import numpy as np
    from manga_image_translator_tpu_torch.colorization.\
        manga_colorization_v2 import resize_pad
    from manga_image_translator_tpu_torch.models import (esrgan, mc2, ocr32,
                                                         ocr48_ctc, waifu2x)
    from manga_image_translator_tpu_torch.ocr.model_48px import \
        _placeholder_dictionary
    from manga_image_translator_tpu_torch.utils import ncnn_lite
    f = rgb.astype(np.float32) / 255.0
    t = ESRGAN_TILE
    tile = torch.from_numpy(np.ascontiguousarray(f[:t, :t, ::-1]))[None]
    out = {f'esrgan_{nb}': (esrgan.build_esrgan(esrgan.init_state_dict(nb)),
                            esrgan.esrgan_forward, (tile,))
           for nb in (6, 23)}
    out['ffdnet'] = (mc2.build_ffdnet(mc2.init_ffdnet_state_dict()),
                     mc2.ffdnet_rgb_forward,
                     (torch.from_numpy(np.ascontiguousarray(f[:512, :512]))[
                         None], torch.tensor([30 / 255.0])))
    gray, _ = resize_pad(f, 576)
    sketch = np.concatenate([gray, np.zeros(gray.shape[:2] + (4,),
                                            np.float32)], -1)
    out['mc2_generator'] = (
        mc2.build_generator(mc2.init_generator_state_dict()),
        lambda m, s: mc2.generator_forward(m, s)[0],
        (torch.from_numpy(np.ascontiguousarray(sketch))[None],))
    v = len(_placeholder_dictionary())

    def ocr32_forward(m, img, widths):
        mem, mask = ocr32.compute_memory(m, img, widths)
        dec = ocr32._Decoder(m, mem, mask, 4)
        step = dec.step(torch.full((img.shape[0],), ocr32.START_TOK,
                                   device=img.device), 0)
        return mem, ocr32.char_logprobs(m, step)
    out['ocr32'] = (ocr32.build_ocr32(v, 'cpu', ocr32.init_state_dict(v)),
                    ocr32_forward, _ocr_batch(rgb, quads, 32, 0))
    out['ocr48_ctc'] = (
        ocr48_ctc.build_ocr48_ctc(v, 'cpu', ocr48_ctc.init_state_dict(v)),
        ocr48_ctc.ctc_forward, _ocr_batch(rgb, quads, 48, 128)[:1])
    crop = torch.from_numpy(np.ascontiguousarray(f[:256, :256])).permute(
        2, 0, 1)[None]
    c = waifu2x.CONTEXT
    out['upconv7'] = (waifu2x.build_upconv7(waifu2x.init_state_dict()),
                      lambda m, x: m(x),
                      (torch.nn.functional.pad(crop, (c, c, c, c),
                                               mode='replicate'),))
    graph = ncnn_lite.load_ncnn(*write_cunet_style(WORK))
    out['ncnn_cunet_style'] = (_Graph(graph), lambda m, x: m(x), (crop,))
    return out


def phase_extras(cfg_path):
    """The other OCRs, the upscalers and the colorizer on the card
    (``extras``):

    1. each network against the CPU (``extras_models``, within 1e-3 of max
       |cpu| without TF32);
    2. the scan through the ``local`` CLI with colorizer ``mc2``
       (colorization_size 576, denoise_sigma 30), upscaler ``esrgan`` at
       ratio 2 and OCR ``32px``, every other stage the smoke's default
       (``run_extras_cli``): the launch counters set to 0 just before and
       read just after; K1 must launch in detection and in mask
       refinement, K4 and K5 in LaMa, K2 and K3 not at all;
    3. ``48px_ctc`` and ``mocr`` (its text model stubbed: no weights and
       no ``transformers`` here; K2 and K3 must launch for its colours)
       through ``ocr.dispatch`` on the upscaled page's known lines, and
       ``4xultrasharp`` at ratio 4 and ``waifu2x`` at ratio 2 through
       ``upscaling.dispatch`` on the scan.

    Prints the ``extras`` line: the CLI pass's stage ms, the ESRGAN tiles
    and device ms per tile (CUDA events, TF32 as the pipeline runs them)
    at nb 6 and 23 beside their bound, the FFDNet and generator forwards'
    device ms at the pass's shapes, the launches, peak device memory (all
    and by part: the checks, the CLI pass, the other keys, the
    timings)."""
    import numpy as np
    from PIL import Image
    from manga_image_translator_tpu_torch import ocr, upscaling
    from manga_image_translator_tpu_torch.config import (Ocr, OcrConfig,
                                                         Upscaler)
    from manga_image_translator_tpu_torch.models import esrgan, mc2
    from manga_image_translator_tpu_torch.ocr import model_manga_ocr
    from manga_image_translator_tpu_torch.ops import cuda_build
    from manga_image_translator_tpu_torch.upscaling.esrgan import TILE_BATCH
    from manga_image_translator_tpu_torch.utils.generic import load_image
    from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    page_dir = os.path.join(WORK, 'extras_pages')
    name, quads = make_scan(page_dir)
    scan = Image.open(os.path.join(page_dir, name))
    rgb = load_image(scan)[0]

    peaks = {}

    def peak(part):
        """Peak device memory since the last part ended."""
        torch.cuda.synchronize()
        peaks[part] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    models = check_card_vs_cpu(extras_models(rgb, quads))
    checks_s = time.perf_counter() - t0
    peak('checks')
    peaks['checks'] = max([peaks['checks']] + [
        c['max_memory_allocated'] for c in models.values()])

    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.update(copy.deepcopy(EXTRAS_CONFIG))
    path = os.path.join(WORK, 'config_extras.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    cli = run_extras_cli(path, page_dir, name, quads)
    peak('cli')

    # the other keys
    up_rgb = np.asarray(Image.open(cli['upscaled_path']).convert('RGB'))
    others = {}
    load_text, read_text = (model_manga_ocr.ModelMangaOCR._load_text_model,
                            model_manga_ocr.ModelMangaOCR._mocr_text)
    model_manga_ocr.ModelMangaOCR._load_text_model = lambda self: None
    model_manga_ocr.ModelMangaOCR._mocr_text = lambda self, img: 'テスト'
    try:
        for key in ('48px_ctc', 'mocr'):
            lines = [Quadrilateral(np.array(q), '', 1.0)
                     for q in cli['upscaled_quads']]
            torch.cuda.synchronize()
            cuda_build.reset_launch_counts()
            t0 = time.perf_counter()
            found = asyncio.run(ocr.dispatch(Ocr(key), up_rgb, lines,
                                             OcrConfig(prob=0.0), 'cuda'))
            torch.cuda.synchronize()
            counts = cuda_build.launch_counts()
            others[key] = {'ms': (time.perf_counter() - t0) * 1e3,
                           'lines': len(found), 'launches': counts}
            require(found, f'{key} read no line')
            fresh = key == 'mocr'
            require((counts['decode_step'] > 0 and counts['charhead'] > 0)
                    == fresh, f'{key}: K2/K3 launches {counts}')
            if fresh:
                require(all(q.text == 'テスト' for q in found),
                        'mocr: a line kept its 48px text')
    finally:
        model_manga_ocr.ModelMangaOCR._load_text_model = load_text
        model_manga_ocr.ModelMangaOCR._mocr_text = read_text
    for key, ratio in (('4xultrasharp', 4), ('waifu2x', 2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = asyncio.run(upscaling.dispatch(Upscaler(key), [scan], ratio,
                                             'cuda'))[0]
        torch.cuda.synchronize()
        up = upscaling.get_upscaler(Upscaler(key))
        require(up.device.type == 'cuda', f'{key} ran on {up.device}')
        require(res.size == (SCAN_W * ratio, SCAN_H * ratio),
                f'{key}: {res.size}')
        others[f'{key}_x{ratio}'] = {
            'ms': (time.perf_counter() - t0) * 1e3, 'size': list(res.size),
            **({'nb': up.model.nb, 'forwards': up.forwards}
               if key != 'waifu2x' else {})}
        asyncio.run(upscaling.unload(Upscaler(key)))
    peak('other_keys')

    # device ms per ESRGAN tile (batches of TILE_BATCH tiles, TF32 as the
    # pipeline runs it) and of the colorizer's two forwards at the pass's
    # shapes
    tiles = {}
    f = rgb.astype(np.float32) / 255.0
    t = ESRGAN_TILE
    batch = torch.from_numpy(np.ascontiguousarray(np.stack(
        [f[:t, :t, ::-1]] * TILE_BATCH))).cuda()
    for nb in (6, 23):
        model = esrgan.build_esrgan(esrgan.init_state_dict(nb), 'cuda')
        with torch.inference_mode():
            ms = cuda_ms(lambda: esrgan.esrgan_forward(model, batch),
                         iters=4, warmup=1, reps=2) / TILE_BATCH
        bound, by = bound_ms(batch[0].numel() * 4 * 17,
                             2 * esrgan_tile_macs(nb), TF32_OPS_PER_S)
        tiles[f'nb{nb}'] = {'ms_per_tile': ms, 'bound_ms': bound,
                            'bound_by': by,
                            'macs_per_tile': esrgan_tile_macs(nb)}
        del model
    col = cli['colorizer_forwards']
    den_hw = next(hw for k, hw in col if k == 'ffdnet')
    gen_hw = next(hw for k, hw in col if k == 'generator')
    den = mc2.build_ffdnet(mc2.init_ffdnet_state_dict(), 'cuda')
    gen = mc2.build_generator(mc2.init_generator_state_dict(), 'cuda')
    x = torch.rand((1,) + tuple(den_hw) + (3,), device='cuda')
    sk = torch.rand((1,) + tuple(gen_hw) + (5,), device='cuda')
    sigma = torch.tensor([30 / 255.0], device='cuda')
    with torch.inference_mode():
        forward_ms = {
            'ffdnet': cuda_ms(lambda: mc2.ffdnet_rgb_forward(den, x, sigma),
                              iters=6, warmup=1, reps=2),
            'generator': cuda_ms(lambda: mc2.generator_forward(gen, sk),
                                 iters=6, warmup=1, reps=2)}
    del den, gen
    peak('timings')
    record = {'phase': 'extras', 'card': torch.cuda.get_device_name(0),
              'models_card_vs_cpu': models, 'checks_s': checks_s,
              'cli': {k: v for k, v in cli.items() if k != 'upscaled_quads'},
              'others': others, 'esrgan_tile': [ESRGAN_TILE] * 2,
              'esrgan_tiles_per_forward': TILE_BATCH,
              'esrgan_ms_per_tile': tiles,
              'colorizer_forward_ms': forward_ms,
              'colorizer_shapes': {'ffdnet': den_hw, 'generator': gen_hw},
              'max_memory_allocated': max(peaks.values()),
              'max_memory_allocated_by_part': peaks,
              'seconds': time.perf_counter() - t_phase}
    emit(record)
    return record


def check_extras_kernels(results, extras):
    """K1 on the upscaled page, which the CLI pass's detection and mask
    refinement filter whole, against its plain version, at most 1 gray,
    and timed; the 18-block generator at the largest crop bucket the
    pass's inpainting ran, kernels against the plain routes as check_lama
    holds it."""
    import numpy as np
    from PIL import Image
    from manga_image_translator_tpu_torch.ops import bilateral
    cli = extras['cli']
    page = torch.from_numpy(np.asarray(
        Image.open(cli['upscaled_path']).convert('RGB'))).cuda()[None]
    got = bilateral.bilateral_filter_batch(page)
    ref = bilateral.bilateral_filter_ref(page)
    torch.cuda.synchronize()
    err = int((got.int() - ref.int()).abs().max())
    emit({'phase': 'check', 'kernel': 'bilateral', 'at': 'upscaled_page',
          'shape': list(page.shape), 'max_abs_err': err, 'tol': 1})
    require(err <= 1, f'bilateral at the upscaled page: {err} gray > 1')
    results['bilateral']['max_abs_err'] = max(
        results['bilateral']['max_abs_err'], err)
    n, h, w = page.shape[:3]
    taps = len(bilateral.window_offsets(8)) - 1
    pixels = n * h * w
    r = {'shape': list(page.shape), 'data': 'colorized, upscaled scan'}
    r['ms'] = cuda_ms(lambda: bilateral.bilateral_filter_batch(page))
    r['plain_ms'] = cuda_ms(lambda: bilateral.bilateral_filter_ref(page),
                            iters=5, warmup=1)
    r['library_ms'] = None
    r['bound_ms'], r['bound_by'] = bound_ms(
        2 * pixels * 3, pixels * (taps * 7 + taps // 2 * 6 + 12),
        F32_OPS_PER_S)
    results['bilateral']['at_upscaled_page'] = r
    del page, got, ref
    largest = max(cli['inpaint_forwards'], key=lambda f: f[0] * f[1] * f[2])
    check_generator(tuple(largest), 'extras_largest_bucket')


def run_extras_cli(cfg_path, page_dir, name, quads):
    """The scan through the ``local`` CLI's translator, then the known-box
    pass on its upscaled page (the scan's lines scaled as the colorizer
    and the upscaler scaled the page), the launch counters set to 0 just
    before and read just after; K1's launches are also counted inside the
    detection and mask-refinement stages."""
    import numpy as np
    from manga_image_translator_tpu_torch import colorization, upscaling
    from manga_image_translator_tpu_torch import manga_translator as mt
    from manga_image_translator_tpu_torch.args import parser
    from manga_image_translator_tpu_torch.config import Colorizer, Upscaler
    from manga_image_translator_tpu_torch.mode.local import (
        MangaTranslatorLocal, load_config_file)
    from manga_image_translator_tpu_torch.ops import cuda_build
    dest = os.path.join(OUT, 'extras')
    args = vars(parser.parse_args(['local', '-i', page_dir, '--dest', dest,
                                   '--config-file', cfg_path,
                                   '--overwrite']))
    stage_ms = {}
    k1 = collections.Counter()
    pages = {}

    async def hook(state, finished):
        if state.startswith('stage-time:'):
            _, stage, ms = state.split(':')
            stage_ms[stage] = stage_ms.get(stage, 0.0) + float(ms)

    def counting(fn, stage):
        async def run(config, ctx):
            before = cuda_build.LAUNCHES['bilateral']
            out = await fn(config, ctx)
            k1[stage] += cuda_build.LAUNCHES['bilateral'] - before
            pages.setdefault(stage, out)
            return out
        return run

    decodes = []

    async def drive():
        translator = MangaTranslatorLocal(args)
        require(translator.device == 'cuda',
                f'translator runs on {translator.device}, not cuda')
        translator.add_progress_hook(hook)
        for attr, stage in (('_run_colorizer', 'colorize'),
                            ('_run_upscaling', 'upscale'),
                            ('_run_detection', 'detect'),
                            ('_run_mask_refinement', 'mask_refine')):
            setattr(translator, attr,
                    counting(getattr(translator, attr), stage))
        await translator.translate_path(args['input'], dest, args)
        config = load_config_file(cfg_path)
        require(config.colorizer.colorizer == Colorizer.mc2
                and config.upscale.upscaler == Upscaler.esrgan
                and config.upscale.upscale_ratio == 2
                and config.ocr.ocr.value == '32px',
                f'the extras config runs {config}')
        up = pages['upscale']
        sx, sy = up.size[0] / SCAN_W, up.size[1] / SCAN_H
        scaled = [[[x * sx, y * sy] for x, y in q] for q in quads]
        up_path = os.path.join(WORK, 'extras_upscaled.png')
        up.save(up_path)
        extra = await _known_quads_pass(translator, config, up_path, scaled,
                                        decodes)
        return extra, scaled, up_path

    torch.cuda.synchronize()
    colorizer = colorization.get_colorizer(Colorizer.mc2)
    with _Failures(mt.logger) as failures, recording_decodes(decodes):
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        extra, scaled, up_path = asyncio.run(drive())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = cuda_build.launch_counts()
    require(os.path.isfile(os.path.join(dest, name)),
            f'extras: page not written: {dest}/{name}')
    upscaler = upscaling.get_upscaler(Upscaler.esrgan)
    col, up = pages['colorize'], pages['upscale']
    require(colorizer.device.type == 'cuda'
            and upscaler.device.type == 'cuda',
            'the colorizer or the upscaler left the card')
    require(up.size == (2 * col.size[0], 2 * col.size[1]),
            f'upscaled {up.size} from {col.size}')
    must, must_not = EXTRAS_KERNELS
    for k in must:
        require(counts[k] > 0, f'extras: kernel {k} was not launched')
    for k in must_not:
        require(counts[k] == 0,
                f'extras: kernel {k} launched {counts[k]} times')
    require(k1['detect'] > 0 and k1['mask_refine'] > 0,
            f'extras: K1 launches by stage {dict(k1)}')
    require(extra['ocr_lines'] == len(quads),
            f'extras: {extra["ocr_lines"]} OCR lines of {len(quads)}')
    require(extra['forwards'] and extra['inpainted_pixels_inside'] > 0
            and extra['inpainted_pixels_outside'] == 0,
            f'extras: inpainting changed {extra["inpainted_pixels_inside"]} '
            f'pixels inside the mask, {extra["inpainted_pixels_outside"]} '
            f'outside')
    require(extra['drawn_regions'] > 0
            and extra['rendered_pixels_in_boxes'] > 0
            and extra['rendered_pixels_outside'] == 0,
            f'extras: rendering changed {extra["rendered_pixels_in_boxes"]} '
            f'pixels in the text boxes, {extra["rendered_pixels_outside"]} '
            f'outside')
    require(not failures.records,
            f'extras: the orchestrator logged {failures.records[:3]}')
    return {'wall_s': wall, 'scan': [SCAN_W, SCAN_H],
            'colorized': list(col.size), 'upscaled': list(up.size),
            'stage_ms_cli': stage_ms,
            'stage_ms_known_boxes': extra['stage_ms'],
            'launches': counts, 'k1_by_stage': dict(k1),
            'esrgan_forwards': [list(f) for f in upscaler.forwards],
            'colorizer_forwards': [(k, list(hw))
                                   for k, hw in colorizer.forwards],
            'ocr_lines': extra['ocr_lines'],
            'mask_pixels': extra['mask_pixels'],
            'inpaint_forwards': extra['forwards'],
            'upscaled_path': up_path, 'upscaled_quads': scaled}


def phase_breakdown():
    """Where the detect stage's time goes on one pipeline page: the K1
    prefilter, the resize + pad, the DBNet forward (each device-timed) and
    the host DB postprocess."""
    import cv2
    import numpy as np
    import torch.nn.functional as F
    from manga_image_translator_tpu_torch import detection
    from manga_image_translator_tpu_torch.config import Detector
    from manga_image_translator_tpu_torch.detection.db_postprocess import (
        DBPostprocess)
    from manga_image_translator_tpu_torch.detection.default import (
        PAD_MULT, _forward_batch, _preprocess_page)
    from manga_image_translator_tpu_torch.ops.bilateral import (
        bilateral_filter)
    from manga_image_translator_tpu_torch.ops.resize import resize_linear
    det = detection.get_detector(Detector.default)
    img = cv2.cvtColor(cv2.imread(os.path.join(WORK, 'pages', 'page0.png')),
                       cv2.COLOR_BGR2RGB)
    h, w = img.shape[:2]
    ratio = 2048 / max(h, w)
    th, tw = int(round(h * ratio)), int(round(w * ratio))
    ph, pw = (-th) % PAD_MULT, (-tw) % PAD_MULT
    page_t = torch.from_numpy(img).cuda()
    smoothed = bilateral_filter(page_t)
    ms = {
        'bilateral': cuda_ms(lambda: bilateral_filter(page_t), iters=5),
        'resize_pad': cuda_ms(lambda: F.pad(resize_linear(
            smoothed.float(), th, tw), (0, 0, 0, pw, 0, ph)), iters=5),
    }
    page = _preprocess_page(page_t, th, tw, ph, pw)
    ms['dbnet_forward'] = cuda_ms(lambda: _forward_batch(det.model,
                                                         page[None]), iters=5)
    prob, mask = _forward_batch(det.model, page[None])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob_np = prob[0].cpu().numpy()
    mask[0].cpu().numpy()
    ms['to_host'] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    boxes, _ = DBPostprocess(0.5, 0.7, unclip_ratio=2.3)(prob_np, tw + pw,
                                                          th + ph)
    ms['db_postprocess_host'] = (time.perf_counter() - t0) * 1e3
    emit({'phase': 'breakdown', 'stage': 'detect', 'page': [h, w],
          'canvas': [th + ph, tw + pw], 'ms': ms,
          'boxes': int(boxes.shape[0]),
          'prob_above_0.3': float((prob_np > 0.3).mean())})


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------

def _library_decode_step(step, tgt, w, rot, sk, sv, mem_k, mem_v, mem_len,
                         src=None):
    """The decoder step as a composite of PyTorch library calls (cuBLAS
    matmuls, layer_norm, scaled_dot_product_attention; the history gathered
    by the ancestry table ``src`` with one indexing op per cache and layer):
    a yardstick the port never calls."""
    import torch.nn.functional as F
    from manga_image_translator_tpu_torch.ops.decode_step import (
        E, H, HD, L, _rotate_pairs)
    n = tgt.shape[0]
    m = mem_k.shape[1]
    dt = tgt.dtype
    r = rot[step].repeat(1, H)
    cross_mask = (torch.arange(m, device=tgt.device)[None, :]
                  < mem_len[:, None])[:, None, None, :]
    if src is not None:
        rows = src[:step + 1].long()
        rows[step] = torch.arange(n, device=tgt.device)
        pos_t = torch.arange(step + 1, device=tgt.device)[:, None]
    x = tgt
    for l in range(L):
        xn = F.layer_norm(x, (E,), w['ln_w'][l, 0].to(dt), w['ln_b'][l, 0].to(dt))
        qkv = torch.addmm(w['bqkv'][l].to(dt), xn, w['wqkv'][l])
        q = _rotate_pairs(qkv[:, :E], r[0].to(dt), r[1].to(dt))
        k = _rotate_pairs(qkv[:, E:2 * E], r[2].to(dt), r[3].to(dt))
        sk[l, step] = k
        sv[l, step] = qkv[:, 2 * E:]
        if src is None:
            kk, vv = sk[l, :step + 1], sv[l, :step + 1]
        else:
            kk, vv = sk[l][pos_t, rows], sv[l][pos_t, rows]
        kk = kk.reshape(step + 1, n, H, HD).permute(1, 2, 0, 3)
        vv = vv.reshape(step + 1, n, H, HD).permute(1, 2, 0, 3)
        a = F.scaled_dot_product_attention(q.view(n, H, 1, HD), kk, vv)
        x = x + torch.addmm(w['bo'][l].to(dt), a.reshape(n, E), w['wo'][l])
        xn = F.layer_norm(x, (E,), w['ln_w'][l, 1].to(dt), w['ln_b'][l, 1].to(dt))
        q2 = _rotate_pairs(torch.addmm(w['bcq'][l].to(dt), xn, w['wcq'][l]),
                           r[4].to(dt), r[5].to(dt))
        mk = mem_k[l].view(m, n, H, HD).permute(1, 2, 0, 3)
        mv = mem_v[l].view(m, n, H, HD).permute(1, 2, 0, 3)
        a2 = F.scaled_dot_product_attention(q2.view(n, H, 1, HD), mk, mv,
                                            attn_mask=cross_mask)
        x = x + torch.addmm(w['bco'][l].to(dt), a2.reshape(n, E), w['wco'][l])
        xn = F.layer_norm(x, (E,), w['ln_w'][l, 2].to(dt), w['ln_b'][l, 2].to(dt))
        h1 = F.relu(torch.addmm(w['b1'][l].to(dt), xn, w['w1'][l]))
        x = x + torch.addmm(w['b2'][l].to(dt), h1, w['w2'][l])
    return x


def phase_times(results, forwards, batch_forwards=()):
    from manga_image_translator_tpu_torch.ops import bilateral, charhead
    from manga_image_translator_tpu_torch.ops import decode_step as dops

    # K1 at each of its inputs (the 2048x2048 canvas is its main number)
    taps = len(bilateral.window_offsets(8)) - 1
    for at, (h, wd, kind) in K1_INPUTS.items():
        img = k1_inputs(h, wd, kind)[None].contiguous()
        r = {'shape': list(img.shape), 'data': kind}
        r['ms'] = cuda_ms(lambda: bilateral.bilateral_filter_batch(img))
        r['plain_ms'] = cuda_ms(lambda: bilateral.bilateral_filter_ref(img),
                                iters=5, warmup=1)
        r['library_ms'] = None   # no single PyTorch call filters bilaterally
        # the work the function needs, an FMA counted as 2 operations as the
        # peak rate counts it: per tap, 3 FMAs and 1 add to accumulate; per
        # symmetric pair of taps, one colour weight (the +o tap of p and the
        # -o tap of p+o share it: 3 subtracts, 2 adds, 1 multiply; abs is a
        # free modifier, exp of an integer distance a table read); per
        # pixel, the centre tap and the normalisation, about 12
        pixels = img.shape[0] * h * wd
        r['bound_ms'], r['bound_by'] = bound_ms(
            2 * pixels * 3, pixels * (taps * 7 + taps // 2 * 6 + 12),
            F32_OPS_PER_S)
        if at == 'canvas_2048':
            results['bilateral'].update(r)
        else:
            results['bilateral'][f'at_{at}'] = r

    # K2: one step at N=120, S=256, step 128, M=96
    model = ocr_model(7935)
    w, ch, embd = model.packed(torch.bfloat16)
    n, s_len, step = 120, 256, 128
    mem_k, mem_v, mem_len, rot = k2_inputs(model, n, s_len)
    m_len = mem_k.shape[1]
    g = torch.Generator(device='cuda').manual_seed(2)
    sk = (torch.randn((5, s_len, n, 320), generator=g, device='cuda') * 0.5
          ).to(torch.bfloat16)
    sv = (torch.randn((5, s_len, n, 320), generator=g, device='cuda') * 0.5
          ).to(torch.bfloat16)
    tgt = embd[torch.randint(3, 7935, (n,), generator=g, device='cuda')]
    # the beam's history through the ancestry table run_beam makes, where
    # this checkout's kernel takes one (a checkout from before it reads the
    # cache in row order and moves it in the beam loop instead)
    kw = ({'src': beam_ancestry(step, s_len)} if 'src' in inspect.signature(
        dops.decode_step).parameters else {})
    r = results['decode_step']
    r['ms'] = cuda_ms(lambda: dops.decode_step(step, tgt, w, rot, sk, sv,
                                               mem_k, mem_v, mem_len, **kw))
    r['plain_ms'] = cuda_ms(lambda: dops.decode_step_ref(
        step, tgt, w, rot, sk, sv, mem_k, mem_v, mem_len, **kw), iters=10)
    r['library_ms'] = cuda_ms(lambda: _library_decode_step(
        step, tgt, w, rot, sk, sv, mem_k, mem_v, mem_len, kw.get('src')))
    n_weights = sum(w[k].numel() for k in ('wqkv', 'wo', 'wcq', 'wco', 'w1',
                                           'w2'))
    weight_bytes = sum(w[k].numel() * w[k].element_size() for k in w)
    # the cache rows this step needs: each distinct (position, row) of the
    # history once (beams of a crop share their old positions' rows), the
    # step's new rows written, each row's memory positions up to its length
    hist_rows = step * n
    if kw:
        t_col = torch.arange(step, device='cuda')[:, None] * n
        hist_rows = int(torch.unique(t_col + kw['src'][:step].long()).numel())
    mem_rows = int(mem_len.clamp(0, m_len).sum())
    kv_bytes = 5 * 2 * (hist_rows + n + mem_rows) * 320 * 2
    io_bytes = 2 * n * 320 * 2 + 2 * 5 * n * 320 * 2 + n * 4
    if kw:    # the ancestry table's rows for positions 0..step-1
        io_bytes += step * n * 4
    attn_ops = 5 * 4 * 80 * 2 * 2 * (n * (step + 1) + mem_rows)
    r['bound_ms'], r['bound_by'] = bound_ms(
        weight_bytes + kv_bytes + io_bytes, 2 * n * n_weights + attn_ops,
        BF16_OPS_PER_S)
    r['shape'] = {'n': n, 's_len': s_len, 'step': step, 'm_len': m_len,
                  'ancestry': 'run_beam' if kw else None,
                  'history_rows': hist_rows, 'memory_rows': mem_rows}

    # K3: N=120, released alphabet size
    dec = (torch.randn((n, 320), generator=g, device='cuda')
           ).to(torch.bfloat16)
    v = ch['wv'].shape[0]
    r = results['charhead']
    r['ms'] = cuda_ms(lambda: charhead.char_topk(dec, ch, 5))
    r['plain_ms'] = cuda_ms(lambda: charhead.char_topk_ref(dec, ch, 5))

    def library_head():
        hh = torch.nn.functional.gelu(torch.addmm(
            ch['b1'].to(dec.dtype), dec, ch['w1']))
        logits = (hh @ ch['wv'].t()).float() + ch['bv']
        vals, idx = torch.topk(logits, 5)
        return vals - torch.logsumexp(logits, -1, keepdim=True), idx
    r['library_ms'] = cuda_ms(library_head)
    nbytes = (n * 320 * 2 + 320 * 320 * 2 + 320 * 4 + v * 320 * 2 + v * 4
              + n * 5 * 12)
    r['bound_ms'], r['bound_by'] = bound_ms(
        nbytes, 2 * n * 320 * 320 + 2 * n * v * 320, BF16_OPS_PER_S)
    r['shape'] = {'n': n, 'vocab': v, 'k': 5}

    times_lama(results, forwards, batch_forwards)

    def times(r):       # the ms numbers, those at other inputs by input
        return {k: (times(v) if k.startswith('at_') else v)
                for k, v in r.items() if k.endswith('ms') or k.startswith('at_')}
    emit({'phase': 'times', 'kernels': {k: times(r)
                                        for k, r in results.items()}})


def lama_shapes(forwards, batch_forwards=()):
    """(N, H, W) of the generator forward the pipeline ran most (ties to
    the most pixels), of one 1024² crop and of the largest bucket the batch
    ran."""
    seen = collections.Counter(tuple(f) for f in forwards)
    most = max(seen, key=lambda f: (seen[f], f[0] * f[1] * f[2]))
    shapes = {'pipeline_most': most, 'crop_1024': (1, CROP, CROP)}
    if batch_forwards:
        shapes['batch_largest'] = tuple(max(
            batch_forwards, key=lambda f: f[0] * f[1] * f[2]))
    return shapes


def times_lama(results, forwards, batch_forwards=()):
    """K4 and K5 at the main path's types (bf16 in; K4 out bf16, K5's stem
    bf16 and final f32) for one generator forward at each of
    ``lama_shapes``: K4 per call, K5 its stem and final convs summed. The
    K4 yardstick is its plain version itself (cuFFT + einsum: one PyTorch
    route to the same function), K5's one cuDNN conv with bias (+ ReLU)
    on the same bf16 input in channels_last."""
    import torch.nn.functional as F
    from manga_image_translator_tpu_torch.ops import conv_stream as k5
    from manga_image_translator_tpu_torch.ops import fourier_unit as k4
    bf16 = torch.bfloat16
    # K5 as the generator calls it, on weights it packed once (a checkout
    # from before the tensor-core route has no pack_weights)
    pack = getattr(k5, 'pack_weights', None)

    def packed(wt):
        return {'packed': pack(wt)} if pack is not None else {}
    x, w_spec, b_spec = k4_inputs((1, 16, 16, FU_C))
    x = x.to(bf16)
    k4_host = host_us(lambda: k4.fourier_unit(x, w_spec, b_spec))
    xs, wt, b = k5_inputs('stem', 1, 16, 16)
    xs = xs.to(bf16)
    kw = packed(wt)
    k5_host = host_us(lambda: k5.conv2d_stream(xs, wt, b, relu=True, **kw))
    emit({'phase': 'host_us_per_call', 'fourier_unit': k4_host,
          'conv_stream': k5_host})
    results['fourier_unit']['host_us_per_call'] = k4_host
    results['conv_stream']['host_us_per_call'] = k5_host
    for at, (n, h, w) in lama_shapes(forwards, batch_forwards).items():
        shape = (n, h // 8, w // 8, FU_C)
        x, w_spec, b_spec = k4_inputs(shape)
        x = x.to(bf16)
        r4 = {'shape': list(shape), 'dtype': 'bfloat16'}
        r4['ms'] = cuda_ms(lambda: k4.fourier_unit(x, w_spec, b_spec))
        r4['plain_ms'] = cuda_ms(lambda: k4.fourier_unit_ref(x, w_spec,
                                                             b_spec))
        r4['library_ms'] = r4['plain_ms']
        r4['bound_ms'], r4['bound_by'] = bound_ms(*k4_work(shape, 2),
                                                  F32X3_OPS_PER_S)
        r5 = {'shape': [n, h, w], 'dtype': 'bfloat16', 'ms': 0.0,
              'plain_ms': 0.0, 'library_ms': 0.0}
        nbytes = ops = 0
        for name, (_, _, relu, out_dt) in K5_CONVS.items():
            xc, wt, b = k5_inputs(name, n, h, w)
            xc = xc.to(bf16)
            w_lib = wt.permute(3, 2, 0, 1).to(bf16).contiguous(
                memory_format=torch.channels_last)
            x_lib = xc.permute(0, 3, 1, 2)          # channels_last view
            b_lib = b.to(bf16)

            def library():
                y = F.conv2d(x_lib, w_lib, b_lib)
                return (F.relu(y) if relu else y).to(out_dt)
            kw = packed(wt)
            c = {'ms': cuda_ms(lambda: k5.conv2d_stream(
                     xc, wt, b, relu=relu, out_dtype=out_dt, **kw)),
                 'plain_ms': cuda_ms(lambda: k5.conv2d_stream_ref(
                     xc, wt, b, relu=relu, out_dtype=out_dt), iters=10),
                 'library_ms': cuda_ms(library)}
            nb, op = k5_work(name, n, h, w, 2)
            c['bound_ms'], c['bound_by'] = bound_ms(nb, op, BF16_OPS_PER_S)
            nbytes, ops = nbytes + nb, ops + op
            for key in ('ms', 'plain_ms', 'library_ms'):
                r5[key] += c[key]
            r5[name] = c
        r5['bound_ms'], r5['bound_by'] = bound_ms(nbytes, ops,
                                                  BF16_OPS_PER_S)
        emit({'phase': 'times_lama', 'at': at, 'forward': [n, h, w],
              'fourier_unit': r4, 'conv_stream': r5})
        for name, r in (('fourier_unit', r4), ('conv_stream', r5)):
            if at == 'pipeline_most':
                results[name].update(r)
            else:
                results[name][f'at_{at}'] = r


def phase_lama_trace(forwards):
    """One bf16 generator forward at the pipeline's most-run crop shape
    under torch.profiler: device µs by kernel (K4's five GEMM stages, K5,
    the rest: cuDNN convs, transposed convs, elementwise), busy and span;
    fails if either kernel's role is empty (a renamed kernel)."""
    from torch.profiler import ProfilerActivity, profile
    from manga_image_translator_tpu_torch.models import lama
    n, h, w = lama_shapes(forwards)['pipeline_most']
    model = lama.cast_for_compute(lama_model(), torch.bfloat16)
    g = torch.Generator(device='cuda').manual_seed(7)
    img = torch.rand((n, h, w, 3), generator=g, device='cuda')
    mask = (torch.rand((n, h, w, 1), generator=g, device='cuda') < 0.3
            ).to(torch.bfloat16)
    img = (img * (1 - mask)).to(torch.bfloat16)
    with torch.inference_mode():
        for _ in range(2):
            model(img, mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(img, mask)
            torch.cuda.synchronize()
    path = os.path.join(OUT, 'lama_trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        ks = [e for e in json.load(f)['traceEvents']
              if e.get('cat') == 'kernel']
    require(ks, 'the LaMa trace holds no kernels')

    def role(name):
        # K5: conv_stream_tc (bf16, tensor cores) or conv_stream (CUDA
        # cores); K4: its five fu_gemm_tf32x3 launches
        if 'conv_stream' in name:
            return 'K5 conv_stream'
        if 'fu_gemm_tf32x3' in name:
            return 'K4 fourier_unit'
        return 'other'
    by_role = collections.defaultdict(float)
    by_name = collections.defaultdict(float)
    for e in ks:
        by_role[role(e['name'])] += e['dur']
        by_name[e['name'][:90]] += e['dur']
    require(by_role['K4 fourier_unit'] > 0 and by_role['K5 conv_stream'] > 0,
            f'the trace attributes no time to K4 or K5: {dict(by_role)}')
    # K4's launches come five to a call, in stage order
    k4 = sorted((e for e in ks if role(e['name']) == 'K4 fourier_unit'),
                key=lambda e: e['ts'])
    require(len(k4) % len(K4_STAGES) == 0,
            f'{len(k4)} K4 launches: not {len(K4_STAGES)} per call')
    k4_stage_us = collections.defaultdict(float)
    for i, e in enumerate(k4):
        k4_stage_us[K4_STAGES[i % len(K4_STAGES)]] += e['dur']
    span = max(e['ts'] + e['dur'] for e in ks) - min(e['ts'] for e in ks)
    ops = []
    for a in prof.key_averages():
        dev = getattr(a, 'self_device_time_total',
                      getattr(a, 'self_cuda_time_total', 0))
        if dev > 0:
            ops.append((dev, a.key, a.count))
    emit({'phase': 'lama_trace', 'forward': [n, h, w], 'dtype': 'bfloat16',
          'kernels': len(ks), 'busy_us': sum(e['dur'] for e in ks),
          'span_us': span, 'us_by_role': dict(by_role),
          'k4_calls': len(k4) // len(K4_STAGES),
          'k4_us_by_stage': dict(k4_stage_us),
          'top_us': dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10]),
          'top_ops_us_calls': [[k, d, c] for d, k, c in
                               sorted(ops, reverse=True)[:12]]})


K4_STAGES = ['w', 'h', 'spectral_conv', 'inverse_h', 'inverse_w']
# the kernels of one decoder step + char head, by name (one launch each)
STEP_KERNELS = {'decode_step': 'decode_step_persistent',
                'charhead': 'char_topk_persistent'}


def k2_state(model, n=120, s_len=256, step=128, seed=3):
    """K2's inputs at the main path's shape: random caches and the
    ancestry table run_beam makes (``beam_ancestry``)."""
    mem_k, mem_v, mem_len, rot = k2_inputs(model, n, s_len)
    g = torch.Generator(device='cuda').manual_seed(seed)
    sk = torch.randn((5, s_len, n, 320), generator=g, device='cuda'
                     ).to(torch.bfloat16)
    sv = torch.randn((5, s_len, n, 320), generator=g, device='cuda'
                     ).to(torch.bfloat16)
    _, _, embd = model.packed(torch.bfloat16)
    tgt = embd[torch.randint(3, 7935, (n,), generator=g, device='cuda')]
    return (step, tgt, model.packed(torch.bfloat16)[0], rot, sk, sv, mem_k,
            mem_v, mem_len, beam_ancestry(step, s_len))


def phase_trace():
    """One decoder step + char head at N=120, step 128 under
    torch.profiler: each kernel's launches per call (1 each) and device µs,
    busy and span; then K2's phases by block 0's SM clock (summed over the
    5 layers, in µs of the step's measured device time), split into work
    and the wait at the grid barrier that ends the phase."""
    from torch.profiler import ProfilerActivity, profile
    from manga_image_translator_tpu_torch.ops import charhead
    from manga_image_translator_tpu_torch.ops import decode_step as dops
    model = ocr_model(7935)
    args = k2_state(model)
    _, ch, _ = model.packed(torch.bfloat16)

    def run():
        out, *_ = dops.decode_step(*args)
        charhead.char_topk(out, ch, 5)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    path = os.path.join(OUT, 'decode_step_trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    ks = sorted((e for e in events if e.get('cat') == 'kernel'
                 and any(k in e.get('name', '')
                         for k in STEP_KERNELS.values())),
                key=lambda e: e['ts'])
    per_call = {name: sum(kn in e['name'] for e in ks)
                for name, kn in STEP_KERNELS.items()}
    for name, count in per_call.items():
        require(count == 1, f'{name}: {count} kernel launches in one call, '
                'expected 1')
    us = {name: sum(e['dur'] for e in ks if kn in e['name'])
          for name, kn in STEP_KERNELS.items()}
    busy = sum(e['dur'] for e in ks)
    span = ks[-1]['ts'] + ks[-1]['dur'] - ks[0]['ts']

    # K2's phases: block 0's clock, scaled to the kernel's device time
    clk = dops.phase_clocks(*args).cpu()
    torch.cuda.synchronize()
    total = int(clk[-1, 1] - clk[0, 0])
    scale = us['decode_step'] / total
    work = collections.defaultdict(float)
    wait = collections.defaultdict(float)
    for i in range(clk.shape[0]):
        ph = dops.PHASES[i % len(dops.PHASES)]
        work[ph] += int(clk[i, 1] - clk[i, 0]) * scale
        if i + 1 < clk.shape[0]:
            wait[ph] += int(clk[i + 1, 0] - clk[i, 1]) * scale
    emit({'phase': 'trace', 'n': 120, 'step': args[0],
          'm_len': int(args[6].shape[1]), 'kernel_launches_per_call': per_call,
          'us_per_call': us, 'busy_us': busy, 'span_us': span,
          'k2_phase_work_us': dict(work), 'k2_barrier_wait_us': dict(wait),
          'k2_barriers': clk.shape[0] - 1})
    return per_call


def beam_inputs():
    """The beam search at N=120 (24 crops x 5 beams), M=96: the seeded
    model with the END token's bias at -1e4 (no beam ends, so every run
    takes its max_len steps), a random memory and ragged lengths."""
    from manga_image_translator_tpu_torch.models import ocr48
    model = ocr_model(7935)
    with torch.no_grad():
        model.pred.bias[ocr48.END_TOK] = -1e4
    g = torch.Generator(device='cuda').manual_seed(11)
    memory = torch.randn((24, 96, 320), generator=g, device='cuda') * 0.5
    lens = torch.randint(48, 97, (24,), generator=g, device='cuda')
    mask = torch.arange(96, device='cuda')[None, :] >= lens[:, None]
    return model, memory, mask


def beam_ancestry(step=128, s_len=256):
    """The (s_len, 120) ancestry table that ``ocr48.run_beam`` hands K2 at
    ``step`` on ``beam_inputs``, identity from ``step`` on: parents stay
    within a crop's 5 beams, so old positions share few rows."""
    from manga_image_translator_tpu_torch.models import ocr48
    model, memory, mask = beam_inputs()
    step_fn = ocr48.decode_ops.decode_step
    seen = {}

    def record(*args):
        if args[0] == step:          # run_beam passes src last
            seen['src'] = args[-1][:step].clone()
        return step_fn(*args)
    ocr48.decode_ops.decode_step = record
    try:
        ocr48.run_beam(model, memory, mask, 5, step + 1, 2)
    finally:
        ocr48.decode_ops.decode_step = step_fn
    src = torch.arange(120, dtype=torch.int32, device='cuda').expand(
        s_len, 120).contiguous()
    src[:step] = seen['src']
    return src


def phase_beam_step(step=128, lo=96, hi=160, repeats=3):
    """One whole step of the beam search (``ocr48.run_beam``) on
    ``beam_inputs``: K2, K3, the beam bookkeeping and the update of the
    ancestry table (a checkout from before the table: its two
    ``index_select`` reorders of the caches).

    ``ms_per_step``: host clock around runs of ``hi`` and ``lo`` steps
    (device-synchronised), the difference over ``hi - lo`` steps (the
    steps around ``step``), median of ``repeats``. ``busy_us``/``span_us``:
    a traced run of ``step + 2`` steps, from the start of the char-head
    kernel of step ``step`` to that of the next step: the device time of
    every kernel in between, and the window's length."""
    from torch.profiler import ProfilerActivity, profile
    from manga_image_translator_tpu_torch.models import ocr48
    model, memory, mask = beam_inputs()

    def run(max_len):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ocr48.run_beam(model, memory, mask, 5, max_len, 2)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run(lo)
    run(hi)
    per_step = statistics.median((run(hi) - run(lo)) / (hi - lo)
                                 for _ in range(repeats))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(step + 2)
    path = os.path.join(OUT, 'beam_step_trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        ks = sorted((e for e in json.load(f)['traceEvents']
                     if e.get('cat') == 'kernel'), key=lambda e: e['ts'])
    # the first kernel of each char-head call: this tree's one launch, or
    # the first of an older tree's three
    heads = [e['ts'] for e in ks
             if 'char_topk' in e['name'] or 'pred1_gelu' in e['name']]
    require(len(heads) == step + 2, f'{len(heads)} char-head calls in a '
            f'run of {step + 2} steps')
    t0, t1 = heads[step], heads[step + 1]
    window = [e for e in ks if t0 <= e['ts'] < t1]
    r = {'phase': 'beam_step', 'n': 120, 'm_len': 96, 'step': step,
         'ms_per_step': per_step, 'steps_timed': [lo, hi],
         'busy_us': sum(e['dur'] for e in window), 'span_us': t1 - t0,
         'kernels': len(window)}
    emit(r)
    return r


def phase_ocr_page(repeats=5):
    """Wall ms of the OCR stage (``ocr.dispatch``: crops, memory, the
    two-tier beam decode, colours) on the second synthetic page's 18 known
    text lines, seeded random weights, device-synchronised: one warm-up
    call (it builds the model), then ``repeats`` timed."""
    import cv2
    import numpy as np
    from manga_image_translator_tpu_torch import ocr
    from manga_image_translator_tpu_torch.config import Ocr, OcrConfig
    from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
    page_dir = os.path.join(WORK, 'pages')
    boxes = make_pages(page_dir)
    img = cv2.cvtColor(cv2.imread(os.path.join(page_dir, 'page1.png')),
                       cv2.COLOR_BGR2RGB)
    cfg = OcrConfig(prob=0.0)

    def run():
        quads = [Quadrilateral(np.array(q), '', 1.0)
                 for q in boxes['page1.png']]
        out = asyncio.run(ocr.dispatch(Ocr.ocr48px, img, quads, cfg, 'cuda'))
        torch.cuda.synchronize()
        return out
    lines = len(run())
    ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        ms.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(ms)
    emit({'phase': 'ocr_page', 'page': 'page1.png', 'lines': lines, 'ms': ms,
          'median_ms': median})
    return median


def phase_inpaint_page(repeats=5):
    """Wall ms of the inpainting stage (``inpainting.dispatch``: crop
    plan, generator forwards, copies back, composite) on the second
    synthetic page with its strokes' dilated mask, the default inpainter
    config (``lama_large``, bf16, size 2048), device-synchronised: one
    warm-up call (it builds the generator), then ``repeats`` timed."""
    import cv2
    import numpy as np
    from manga_image_translator_tpu_torch import inpainting
    from manga_image_translator_tpu_torch.config import (Inpainter,
                                                         InpainterConfig)
    page_dir = os.path.join(WORK, 'pages')
    make_pages(page_dir)
    img = cv2.cvtColor(cv2.imread(os.path.join(page_dir, 'page1.png')),
                       cv2.COLOR_BGR2RGB)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    mask = cv2.dilate(((gray < 128) * 255).astype(np.uint8),
                      np.ones((5, 5), np.uint8))
    cfg = InpainterConfig()
    inp = inpainting.get_inpainter(Inpainter.lama_large)

    def run():
        out = asyncio.run(inpainting.dispatch(
            Inpainter.lama_large, img, mask, cfg, cfg.inpainting_size,
            'cuda'))
        torch.cuda.synchronize()
        return out
    run()
    inp.forwards = []
    ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        ms.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(ms)
    emit({'phase': 'inpaint_page', 'page': 'page1.png', 'ms': ms,
          'median_ms': median,
          'forwards_per_call': [list(f) for f in
                                inp.forwards[:len(inp.forwards) // repeats]]})
    return median


# kernel -> (route, source, the TPU kernel it replaces)
META = {
    'bilateral': ('cuda', 'manga_image_translator_tpu_torch/csrc/bilateral.cu',
                  'manga_image_translator_tpu/ops/pallas_bilateral.py:395'),
    'decode_step': ('cuda', 'manga_image_translator_tpu_torch/csrc/decode_step.cu',
                    'manga_image_translator_tpu/ops/pallas_decode.py:413'),
    'charhead': ('cuda', 'manga_image_translator_tpu_torch/csrc/charhead.cu',
                 'manga_image_translator_tpu/ops/pallas_charhead.py:98'),
    'fourier_unit': ('cuda',
                     'manga_image_translator_tpu_torch/csrc/fourier_unit.cu',
                     'manga_image_translator_tpu/ops/pallas_spectral.py:294'),
    'conv_stream': ('cuda',
                    'manga_image_translator_tpu_torch/csrc/conv_stream.cu',
                    'manga_image_translator_tpu/ops/pallas_conv.py:145'),
}
# the crop bucket the smoke's pipeline runs most (6 crops of 256 x 640)
SMOKE_FORWARD = (6, 256, 640)


def times_only() -> int:
    """Build, kernel timings and the page inpaint; the last line holds
    the numbers by name."""
    phase_card()
    phase_build()
    results = {name: {} for name in META}
    phase_times(results, [SMOKE_FORWARD])
    beam = phase_beam_step()
    numbers = {'inpaint_page1_ms': phase_inpaint_page(),
               'ocr_page1_ms': phase_ocr_page(),
               'beam_step.ms': beam['ms_per_step'],
               'beam_step.busy_us': beam['busy_us'],
               'beam_step.span_us': beam['span_us'],
               'beam_step.kernels': beam['kernels']}
    for name, r in results.items():
        for key in ('ms', 'library_ms', 'host_us_per_call'):
            if r.get(key) is not None:
                numbers[f'{name}.{key}'] = r[key]
        for at, rr in r.items():
            if at.startswith('at_'):
                numbers[f'{name}.{at}.ms'] = rr['ms']
                numbers[f'{name}.{at}.library_ms'] = rr['library_ms']
    emit(numbers)
    return 0


def compare(other: str, pairs: int) -> int:
    """``--times-only`` in ``other`` and here, alternately (ABBA), each
    run in a process of its own; ``other`` gets a copy of this script."""
    phase_card()
    other = os.path.abspath(other)
    require(os.path.isdir(os.path.join(other,
                                       'manga_image_translator_tpu_torch')),
            f'{other} is not the root of a checkout')
    copy_path = os.path.join(other, 'chip_smoke_compare.py')
    shutil.copyfile(os.path.abspath(__file__), copy_path)
    sides = {'other': copy_path, 'this': os.path.abspath(__file__)}
    runs = {'other': [], 'this': []}
    for i in range(pairs):
        order = ('other', 'this') if i % 2 == 0 else ('this', 'other')
        for side in order:
            res = subprocess.run(
                [sys.executable, sides[side], '--times-only'],
                cwd=os.path.dirname(sides[side]), capture_output=True,
                text=True, timeout=900)
            require(res.returncode == 0,
                    f'--times-only in {side} failed (exit {res.returncode}):'
                    f'\n{res.stderr[-3000:]}')
            numbers = json.loads(res.stdout.strip().splitlines()[-1])
            runs[side].append(numbers)
            emit({'phase': 'compare_run', 'pair': i, 'side': side,
                  **numbers})
    summary = {}
    for key in runs['this'][0]:
        summary[key] = {}
        for side in ('other', 'this'):
            vals = [r[key] for r in runs[side] if r.get(key) is not None]
            if vals:
                summary[key][side] = {'median': statistics.median(vals),
                                      'min': min(vals), 'max': max(vals)}
    emit({'phase': 'compare', 'other': other, 'pairs': pairs,
          'numbers': summary})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--times-only', action='store_true',
                    help='build, time the kernels, the beam step and a '
                         'page\'s OCR and inpaint, print the numbers last; '
                         'nothing else')
    ap.add_argument('--compare-with', metavar='DIR',
                    help='another checkout\'s root: alternate --times-only '
                         'runs there and here')
    ap.add_argument('--pairs', type=int, default=10,
                    help='runs per side for --compare-with (default 10)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this smoke test needs an '
              'NVIDIA card', file=sys.stderr)
        return 2
    if args.compare_with:
        return compare(args.compare_with, args.pairs)
    sys.path.insert(0, ROOT)
    os.environ.setdefault('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')
    # the smoke's own model dir: the synthetic Sugoi model only, so every
    # other stage runs on seeded random weights
    os.environ['MIT_TPU_MODEL_DIR'] = os.path.join(WORK, 'models')
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(OUT)
    import manga_image_translator_tpu_torch  # noqa: F401  (fails outside a checkout)
    if args.times_only:
        return times_only()

    t_start = time.perf_counter()
    phase_card()
    build_seconds = phase_build()
    results = {name: {} for name in META}
    phase_check(results)
    phase_sugoi_model()
    phase_translate_check()
    counts, forwards, page_dir, cfg_path, extra = phase_pipeline()
    decode = phase_translate(extra)
    phase_cli(page_dir, cfg_path)
    batch = phase_batch(cfg_path)
    check_batch_kernels(results, batch)
    phase_server(page_dir, cfg_path)
    phase_ws(page_dir, cfg_path)
    phase_backends(cfg_path)
    extras = phase_extras(cfg_path)
    check_extras_kernels(results, extras)
    phase_breakdown()
    phase_times(results, forwards, batch['forwards'])
    per_call = phase_trace()
    phase_beam_step()
    phase_ocr_page()
    phase_lama_trace(forwards)
    phase_translate_kernels(decode)
    kernels = []
    for name, (route, source, replaces) in META.items():
        r = results[name]
        kernels.append({
            'name': name, 'route': route, 'source': source,
            'replaces': replaces, 'launches': counts[name],
            'launches_batch': batch['launches'][name],
            'launches_extras': extras['cli']['launches'][name],
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
            'shape': r['shape'],
            **({'kernel_launches_per_call': per_call[name]}
               if name in per_call else {}),
            **{k: v for k, v in r.items() if k.startswith('at_')}})
    emit({'phase': 'done', 'seconds': time.perf_counter() - t_start,
          'build_seconds': build_seconds})
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
