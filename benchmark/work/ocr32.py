"""The 32px OCR: the encoder (FAN ResNet, TF32 convolutions, and three
layers) per chunk, counted on the meta device; the decoder per beam
search from its shape and steps (two post-LN layers, float32): every
beam row's products at each step, the attention over the history and the
memory, the char head, and once per search the memory's keys and values
for every beam row."""
from __future__ import annotations

import functools
from . import counted_flops

E, LAYERS, FF = 320, 2, 2048


@functools.lru_cache(maxsize=None)
def _encoder(vocab):
    def build():
        import torch
        from ..reference import ocr32
        model = ocr32.OCR32(vocab).eval()
        return lambda x: ocr32.memory(model, x, torch.full(
            (x.shape[0],), x.shape[2], dtype=torch.long))
    return build


def decoder_flops(n, k, m_len, steps, m_rows, vocab):
    rows = n * k
    per_row = LAYERS * (2 * 6 * E * E + 2 * 2 * E * FF) + 2 * E * E \
        + 2 * E * vocab
    attn = sum(LAYERS * 4 * E * (rows * (t + 1) + m_rows)
               for t in range(steps))
    memory_kv = LAYERS * 2 * 2 * rows * m_len * E * E
    return steps * rows * per_row + attn + memory_kv


def flops(calls, spec):
    vocab = spec['vocab']
    out = [(counted_flops(_encoder(vocab), shape), 'tf32')
           for shape in calls['ocr32.encoder']]
    out += [(decoder_flops(*c, vocab), 'f32')
            for c in calls['ocr32.decoder']]
    return out
