"""The five hand-written kernels: the name each has in a device trace,
and the (bytes, operations, peak) one launch needs at its recorded shape
(the formulas of ``chip_smoke.py``'s kernel table, frozen here).
Each input byte is counted read once and each output byte written once,
whatever the kernel reads again; where the work depends on the data, what
these inputs need."""
from __future__ import annotations

import math

# kernel -> substrings of its device-trace names (and names to exclude)
TRACE_NAMES = {
    'bilateral': (('bilateral_kernel',), ()),
    'decode_step': (('decode_step_persistent',), ()),
    'charhead': (('char_topk_persistent',), ()),
    'fourier_unit': (('fu_gemm_tf32x3',), ()),
    'conv_stream': (('conv_stream',), ('pack_weights',)),
}

E, HEADS, LAYERS, FF = 320, 4, 5, 2048          # the 48px OCR decoder


def in_trace(kernel: str, name: str) -> bool:
    want, skip = TRACE_NAMES[kernel]
    return any(w in name for w in want) and not any(s in name for s in skip)


def bilateral(call):
    """K1 over (n, h, w, 3) uint8 with a circular window of ``radius``:
    per tap 3 FMAs and an add, per symmetric pair of taps one colour
    weight (6 operations), per pixel 12 more; the image read and written
    once."""
    (n, h, w, _), radius = call
    taps = sum(1 for dy in range(-radius, radius + 1)
               for dx in range(-radius, radius + 1)
               if dy * dy + dx * dx <= radius * radius) - 1
    pixels = n * h * w
    return 2 * pixels * 3, pixels * (taps * 7 + taps // 2 * 6 + 12), 'f32'


def decode_step(rows, crops, m_rows, step, vocab):
    """K2 at ``step`` for ``rows`` beam rows: the bf16 decoder weights and
    float32 biases and norms, the history's K/V rows (a crop's beams
    share their old positions, so a crop's history once: a lower bound),
    the step's new K/V rows, the memory K/V of every row's valid positions
    (``m_rows`` in all); the products of the step."""
    weights = LAYERS * (3 * E * E + 3 * E * E + 2 * E * FF)
    nbytes = (2 * weights + 4 * LAYERS * (13 * E + FF)
              + LAYERS * 2 * (crops * step + rows + m_rows) * E * 2
              + 2 * rows * E * 2 + 2 * LAYERS * rows * E * 2
              + step * rows * 4)
    attn = LAYERS * 4 * E * (rows * (step + 1) + m_rows)
    return nbytes, 2 * rows * weights + attn, 'bf16'


def charhead(rows, vocab, k=5):
    """K3 for ``rows`` rows: the hidden layer and the tied vocabulary
    matrix read once (bf16), the top-k written."""
    nbytes = (rows * E * 2 + E * E * 2 + E * 4 + vocab * E * 2 + vocab * 4
              + rows * k * 12)
    return nbytes, 2 * rows * E * E + 2 * rows * vocab * E, 'bf16'


def fourier_unit(call):
    """K4 over (n, h, w, c): x read and the output written once, the
    weights once; the spectral 1x1 conv plus the FFT-minimal cost
    (2.5 N log2 N per real 2-D transform and channel), as float32-accurate
    3xTF32 products."""
    (n, h, w, c), in_bytes = call
    k = w // 2 + 1
    nbytes = 2 * n * h * w * c * in_bytes + (2 * c) ** 2 * 4 + 2 * c * 4
    ops = n * (2 * (2 * c) ** 2 * h * k
               + 2 * 2.5 * h * w * math.log2(h * w) * c)
    return nbytes, ops, 'f32x3'


def conv_stream(call):
    """K5: a KhxKw conv of a padded NHWC input (n, h + kh - 1, w + kw - 1,
    cin) with HWIO weights; bf16 on the tensor cores, float32 on the
    CUDA cores."""
    (n, hp, wp, cin), (kh, kw, _, cout), in_bytes, out_bytes = call
    h, w = hp - kh + 1, wp - kw + 1
    nbytes = (n * hp * wp * cin * in_bytes + n * h * w * cout * out_bytes
              + kh * kw * cin * cout * 4 + cout * 4)
    ops = 2 * n * h * w * kh * kw * cin * cout
    return nbytes, ops, 'bf16' if in_bytes == 2 else 'f32'


def launches(rec, vocab):
    """kernel -> list of (bytes, operations, peak) of every launch the
    window made."""
    out = {'bilateral': [bilateral(c) for c in rec.calls['k.bilateral']],
           'fourier_unit': [fourier_unit(c)
                            for c in rec.calls['k.fourier_unit']],
           'conv_stream': [conv_stream(c) for c in rec.calls['k.conv_stream']],
           'decode_step': [], 'charhead': []}
    for n, k, m_len, steps, m_rows in rec.calls['ocr48.decoder']:
        for t in range(steps):
            out['decode_step'].append(decode_step(n * k, n, m_rows, t,
                                                  vocab))
            out['charhead'].append(charhead(n * k, vocab))
    return out
