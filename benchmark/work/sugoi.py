"""The Sugoi transformer (d 1024, FFN 4096, 6 + 6 layers, 32k pieces),
float32 on the CUDA cores: the encoder per sentence batch (B, S); the
decoder per search (B sentences, K beams, S source positions, T steps):
every beam row's products at each step, the self-attention over the
positions so far and the cross-attention over the source, the output
projection, and once per search the source's cross-attention keys and
values."""
from __future__ import annotations


def encoder_flops(b, s, d, ffn, layers):
    return b * layers * (s * 2 * (4 * d * d + 2 * d * ffn) + 4 * s * s * d)


def decoder_flops(b, k, s, steps, d, ffn, layers, vocab):
    rows = b * k
    per_row = layers * 2 * (6 * d * d + 2 * d * ffn) + 2 * d * vocab
    attn = sum(layers * 4 * d * rows * (t + 1 + s) for t in range(steps))
    return steps * rows * per_row + attn + layers * 2 * 2 * b * s * d * d


def flops(calls, spec):
    d, ffn, layers, v = (spec['d_model'], spec['ffn'], spec['layers'],
                         spec['vocab'])
    out = [(encoder_flops(b, s, d, ffn, layers), 'f32')
           for b, s in calls['sugoi.encoder']]
    out += [(decoder_flops(b, k, s, t, d, ffn, layers, v), 'f32')
            for b, k, s, t in calls['sugoi.decoder']]
    return out
