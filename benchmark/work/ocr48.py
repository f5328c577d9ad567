"""The 48px OCR: the encoder (backbone and four layers) per chunk of crops,
counted on the meta device; the decoder per beam search from its shape
and steps (the step's products for every beam row, the attention over
the history and the memory, the char head, and once per search the
memory's cross-attention keys and values). All bf16."""
from __future__ import annotations

import functools
from . import counted_flops

E, LAYERS, FF = 320, 5, 2048


@functools.lru_cache(maxsize=None)
def _encoder(vocab):
    def build():
        import torch
        from ..reference import ocr48
        model = ocr48.OCR48(vocab).eval()
        return lambda x: ocr48.memory(model, x, torch.full(
            (x.shape[0],), x.shape[2], dtype=torch.long))
    return build


def decoder_flops(n, k, m_len, steps, m_rows, vocab):
    rows = n * k
    per_row = LAYERS * (2 * 6 * E * E + 2 * 2 * E * FF) + 2 * E * E \
        + 2 * E * vocab
    attn = sum(LAYERS * 4 * E * (rows * (t + 1) + m_rows)
               for t in range(steps))
    memory_kv = LAYERS * 2 * 2 * n * m_len * E * E
    return steps * rows * per_row + attn + memory_kv


def flops(calls, spec):
    vocab = spec['vocab']
    out = [(counted_flops(_encoder(vocab), shape), 'bf16')
           for shape in calls['ocr48.encoder']]
    out += [(decoder_flops(*c, vocab), 'bf16')
            for c in calls['ocr48.decoder']]
    return out
