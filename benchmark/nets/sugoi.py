"""The Sugoi V4 translator: the JParaCrawl big transformer (Morishita et
al., LREC 2020) in the released sugoi archive's layout, ``translators/
sugoi/{spm.ja,spm.en}.nopretok.model`` and ``big-ja-en/`` with a
CTranslate2 v6 ``model.bin`` (every matrix int8 with its per-row scale,
biases and norms float32), its two vocabularies and ``config.json``.

EOS's logit carries the bias ``eos_bias`` in the output projection, so that
the searches end at lengths like a page's translations instead of the
200-step cap (calibrated on the CPU, ``calibrate.py``). The source
vocabulary holds every character of the 48px OCR's alphabet, bare and
word-initial, so that the OCR's output tokenises without unknowns.

Compared on the sampled pages: the encoder states of every sentence
batch against the reference's (RMS gap over the RMS of the reference's,
valid positions), and each served translation's score (the beam's sum of
log-probabilities) against the reference's teacher-forced sum over the
same tokens (the largest gap in nats).
"""
from __future__ import annotations

import json
import math
import os
import struct

import numpy as np
import torch

from . import sampled, save_atomic
from . import ocr48 as ocr48_net
from .. import precision, seams
from ..reference import ct2 as ref

DIR = 'translators/sugoi'
MODEL = f'{DIR}/big-ja-en/model.bin'


def files(spec):
    return [MODEL, f'{DIR}/big-ja-en/source_vocabulary.txt',
            f'{DIR}/big-ja-en/target_vocabulary.txt',
            f'{DIR}/big-ja-en/config.json', f'{DIR}/spm.ja.nopretok.model',
            f'{DIR}/spm.en.nopretok.model']


def vocabularies(spec):
    """(source, target) pieces. The source: unk, <s>, </s>, '▁', then the
    OCR alphabet's characters bare and word-initial, then fillers; the
    target: short Latin pieces, every third without the word marker."""
    n = spec['vocab']
    specials = ['<unk>', '<s>', '</s>', '▁']
    chars = [c for c in ocr48_net.alphabet(spec['source_alphabet'])[4:]]
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
    return src[:n], tgt


def _wstr(s: str) -> bytes:
    raw = s.encode('utf-8') + b'\0'
    return struct.pack('<H', len(raw)) + raw


def _spm_bytes(pieces, seed) -> bytes:
    """A unigram sentencepiece model of ``pieces`` (unk, <s>, </s> first),
    scores from ``seed``."""
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

    scores = -np.random.default_rng(seed).random(len(pieces)) * 10
    blob = bytearray()
    for i, text in enumerate(pieces):
        typ = 2 if i == 0 else 3 if i < 3 else 1
        body = (ld(1, text.encode('utf-8')) + varint((2 << 3) | 5)
                + struct.pack('<f', scores[i]) + varint(3 << 3) + varint(typ))
        blob += ld(1, body)
    return bytes(blob)


def shapes(spec):
    d, ffn, vocab = spec['d_model'], spec['ffn'], spec['vocab']
    out = {'encoder/embeddings/weight': (vocab, d),
           'decoder/embeddings/weight': (vocab, d)}
    for side, subs in (('encoder', ('self_attention', 'ffn')),
                       ('decoder', ('self_attention', 'attention', 'ffn'))):
        for i in range(spec['layers']):
            pre = f'{side}/layer_{i}'
            out[f'{pre}/self_attention/linear_0'] = (3 * d, d)
            out[f'{pre}/self_attention/linear_1'] = (d, d)
            if side == 'decoder':
                out[f'{pre}/attention/linear_0'] = (d, d)
                out[f'{pre}/attention/linear_1'] = (2 * d, d)
                out[f'{pre}/attention/linear_2'] = (d, d)
            out[f'{pre}/ffn/linear_0'] = (ffn, d)
            out[f'{pre}/ffn/linear_1'] = (d, ffn)
            for sub in subs:
                out[f'{pre}/{sub}/layer_norm'] = (d,)
    out['decoder/projection'] = (vocab, d)
    return out


def variables(spec, seed, device):
    """(name, array) in file order: int8 matrices with per-row scales
    (rows' largest |w| about sqrt(3 / fan-in), so std ~ 1/sqrt(fan-in)
    after dequantisation), biases N(0, 0.02), layer norms N(1, 0.1) and
    N(0, 0.1); drawn on ``device`` from one generator."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for name, shape in shapes(spec).items():
        if name.endswith('layer_norm'):
            g = torch.randn((2,) + shape, generator=gen, device=device) * 0.1
            out += [(f'{name}/gamma', (1 + g[0]).cpu().numpy()),
                    (f'{name}/beta', g[1].cpu().numpy())]
            continue
        key = name if name.endswith('/weight') else f'{name}/weight'
        q = torch.randint(-127, 128, shape, generator=gen, device=device,
                          dtype=torch.int8)
        amax = math.sqrt(3.0 / shape[1]) * (0.8 + 0.4 * torch.rand(
            (shape[0],), generator=gen, device=device))
        out += [(key, q.cpu().numpy()),
                (key + '_scale', (127 / amax).float().cpu().numpy())]
        if not name.endswith('/weight'):
            bias = (0.02 * torch.randn((shape[0],), generator=gen,
                                       device=device)).cpu().numpy()
            if name == 'decoder/projection':
                bias[2] += float(spec['eos_bias'])       # </s>
            out.append((f'{name}/bias', bias))
    return out


def write(model_dir, spec, seed, device):
    root = os.path.join(model_dir, DIR)
    model_dir_ct2 = os.path.join(root, 'big-ja-en')
    os.makedirs(model_dir_ct2, exist_ok=True)
    src, tgt = vocabularies(spec)
    for side, pieces in (('source', src), ('target', tgt)):
        save_atomic(pieces, os.path.join(model_dir_ct2,
                                         f'{side}_vocabulary.txt'),
                    lambda p, tmp: open(tmp, 'w', encoding='utf-8').write(
                        '\n'.join(p) + '\n'))
    save_atomic({'num_heads': spec['heads']},
                os.path.join(model_dir_ct2, 'config.json'),
                lambda c, tmp: open(tmp, 'w').write(json.dumps(c)))
    for lang, pieces, s in (('ja', src, seed + 1), ('en', tgt, seed + 2)):
        save_atomic(_spm_bytes(pieces, s),
                    os.path.join(root, f'spm.{lang}.nopretok.model'),
                    lambda b, tmp: open(tmp, 'wb').write(b))

    def write_bin(items, tmp):
        with open(tmp, 'wb') as f:
            f.write(struct.pack('<I', 6) + _wstr('TransformerSpec')
                    + struct.pack('<II', 7, len(items)))
            for name, arr in items:
                dtype = 'int8' if arr.dtype == np.int8 else 'float32'
                arr = np.ascontiguousarray(arr.astype(arr.dtype))
                f.write(_wstr(name) + struct.pack('<B', arr.ndim)
                        + struct.pack(f'<{arr.ndim}I', *arr.shape)
                        + _wstr(dtype) + struct.pack('<I', arr.nbytes))
                f.write(arr.tobytes())
            f.write(struct.pack('<I', 0))
    save_atomic(variables(spec, seed, device), os.path.join(model_dir, MODEL),
                write_bin)


def install(rec, spec):
    from manga_image_translator_tpu_torch.translators import ct2_model

    def make_encode(original):
        def encode(self, tokens, lengths):
            states, pad = original(self, tokens, lengths)
            if rec.counting:
                rec.calls['sugoi.encoder'].append(tuple(tokens.shape))
            if rec.sampling:
                rec.samples['sugoi.encode'].append({
                    'tokens': seams.keep(tokens),
                    'lengths': seams.keep(lengths),
                    'states': seams.host(states)})
            return states, pad
        return encode

    def make_run(original):
        def run(self, stop=None):
            out = original(self, stop)
            if stop is not None:
                return out
            rec.steps['sugoi'].append(int(self.t))
            if rec.counting:
                rec.calls['sugoi.decoder'].append(
                    (self.b, self.K, int(self.cross_kv[0][0].shape[2]),
                     int(self.t)))
            if rec.sampling:
                norm = self.scores / self.out_len.clamp(min=1).float()
                best = norm.argmax(dim=1)
                rows = torch.arange(self.b, device=best.device)
                rec.samples['sugoi.search'].append({
                    'out': seams.keep(out),
                    'score': seams.keep(self.scores[rows, best]),
                    'start': self.model.start_id, 'eos': self.model.eos_id,
                    'unk': self.model.unk_id, 'rp': self.rep_penalty})
            return out
        return run

    seams.wrap(ct2_model.Ct2Transformer, 'encode', make_encode)
    seams.wrap(ct2_model.BeamSearch, 'run', make_run)


def check(rec, spec, model_dir, device, control=None):
    if not sampled(rec, 'sugoi'):
        return {}
    variables = ref.read_model(os.path.join(model_dir, MODEL))
    model = ref.Model(variables, spec['heads'], device)
    low = control and ref.Model(variables, spec['heads'],
                                device).lowered(control)
    enc_gap, lp_gap, tokens = [], [], 0
    for e, s in zip(rec.samples['sugoi.encode'],
                    rec.samples['sugoi.search'], strict=True):
        toks, lengths = e['tokens'].to(device), e['lengths'].to(device)
        with precision.computing('float32'):
            states, pad = model.encode(toks, lengths)
        got = e['states'].to(device)
        if control:
            with precision.computing(control):
                got = low.encode(toks, lengths)[0]
        valid = (~pad)[..., None].float()
        enc_gap.append(float(((got - states) * valid).square().sum().sqrt()
                             / (states * valid).square().sum().sqrt()))
        for b in range(states.shape[0]):
            row = s['out'][b].tolist()
            served = row[:row.index(s['eos']) + 1] if s['eos'] in row \
                else row
            args = (pad[b:b + 1], served, s['start'], s['unk'], s['rp'])
            with precision.computing('float32'):
                lp = float(model.served_logprobs(states[b:b + 1], *args)
                           .double().sum())
            if control:
                with precision.computing(control):
                    lp_got = float(low.served_logprobs(got[b:b + 1], *args)
                                   .double().sum())
            else:
                lp_got = float(s['score'][b])
            lp_gap.append(abs(lp - lp_got))
            tokens += len(served)
    rec.compared['sugoi tokens'] = tokens
    return {'sugoi_encoder_rel': max(enc_gap),
            'sugoi_logprob_gap': max(lp_gap)}
