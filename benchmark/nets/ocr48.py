"""The default 48px OCR (``ocr_ar_48px.ckpt`` + ``alphabet-all-v7.txt``).

Random weights never emit END, and no bias on END's logit makes them end
at a line's length (``calibrate.py``: up to a bias of 13 every search
runs to its cap, from 15 on every search ends by step 3). So the
configuration caps the decode with the program's own
``MIT_TPU_OCR_MAX_LEN`` at the longest line's length plus END: a chunk of
lines decodes as many steps as its longest line would with trained
weights, instead of the 64 + 255 steps of the two tiers.

Compared on the sampled pages: the encoder memory the program computed
for each chunk of crops against the reference's memory of the same crops
(RMS gap over the RMS of the reference's, valid positions only), and each
served line's log-probability (the beam's score) against the
reference's teacher-forced log-probability of the same tokens (the
largest gap in nats). The crops are the program's (cut by ``ops/warp``
from the page); ``warp_check`` holds them against a plain crop of the
page's own line boxes.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import conv_rule, draw_state_dict, sampled, save_atomic
from .. import precision, seams
from ..reference import ocr48 as ref

CKPT = 'ocr/ocr_ar_48px.ckpt'
ALPHABET = 'ocr/alphabet-all-v7.txt'
START, END = 1, 2


def alphabet(size: int):
    """The alphabet file's entries: the four specials, ASCII, kana, then
    CJK ideographs up to ``size``."""
    chars = (['<PAD>', '<S>', '</S>', '<SP>']
             + [chr(c) for c in range(33, 127)]
             + [chr(c) for c in range(0x3041, 0x3097)]
             + [chr(c) for c in range(0x30A1, 0x30FB)])
    cjk = 0x4E00
    while len(chars) < size:
        chars.append(chr(cjk))
        cjk += 1
    return chars[:size]


def files(spec):
    return [CKPT, ALPHABET]


def template(vocab):
    with torch.device('meta'):
        return ref.OCR48(vocab).state_dict()


def write(model_dir, spec, seed, device):
    vocab = spec['vocab']
    tpl = template(vocab)
    rule = conv_rule(tpl, spec.get('gains', {}),
                     overrides=spec.get('overrides', {}))
    sd = draw_state_dict(tpl, rule, seed, device)
    save_atomic(sd, os.path.join(model_dir, CKPT))
    path = os.path.join(model_dir, ALPHABET)

    def write_text(chars, tmp):
        with open(tmp, 'w', encoding='utf-8') as f:
            f.write('\n'.join(chars) + '\n')
    save_atomic(alphabet(vocab), path, write_text)


def install(rec, spec):
    from manga_image_translator_tpu_torch.models import ocr48
    from manga_image_translator_tpu_torch.ocr import model_48px as m48

    def make_memory(original):
        def _compute_memory(self, images, valid_widths):
            memory, mask = original(self, images, valid_widths)
            if rec.counting:
                rec.calls['ocr48.encoder'].append(tuple(images.shape))
            if rec.sampling:
                rec.samples['ocr48.memory'].append({
                    'images': seams.host(images),
                    'widths': seams.keep(valid_widths),
                    'memory': seams.host(memory),
                    'mask': seams.keep(mask),
                    'ptr': memory.data_ptr(),
                    'row_bytes': memory[0].numel() * memory.element_size(),
                    'rows': memory.shape[0]})
            return memory, mask
        return _compute_memory

    def make_decode(original):
        def _two_tier_decode(self, memory):
            ret = original(self, memory)
            if rec.sampling:
                rec.samples['ocr48.decode'].append({
                    'memory': len(rec.samples['ocr48.memory']) - 1,
                    'ptr': memory[0].data_ptr(),
                    'rows': memory[0].shape[0],
                    'sequences': np.array(ret['sequences']),
                    'logprob': np.array(ret['logprob'], np.float64)})
            return ret
        return _two_tier_decode

    # the beam's score as a log-probability: the program hands on its
    # exponential, which underflows float32 for long lines
    def make_run_beam(original):
        def run_beam(*args, **kwargs):
            state = original(*args, **kwargs)
            if rec.sampling:
                rec.last['ocr48.logprob'] = state['best_logprob'].clone()
            return state
        return run_beam

    def make_decode_call(original):
        def _decode(self, memory, memory_mask, max_len):
            ret = original(self, memory, memory_mask, max_len)
            if rec.sampling:
                ret['logprob'] = rec.last.pop('ocr48.logprob')
            return ret
        return _decode

    def make_search(original):
        def search(self, mem_k, mem_v, mem_len):
            out = original(self, mem_k, mem_v, mem_len)
            steps = int(self.step.item())
            rec.steps['ocr48'].append(steps)
            if rec.counting:
                rec.calls['ocr48.decoder'].append(
                    (self.n, self.k, int(mem_k.shape[1]), steps,
                     int(mem_len.clamp(max=mem_k.shape[1]).sum())))
            return out
        return search

    seams.wrap(m48.Model48pxOCR, '_compute_memory', make_memory)
    seams.wrap(m48.Model48pxOCR, '_two_tier_decode', make_decode)
    seams.wrap(m48.Model48pxOCR, '_decode', make_decode_call)
    seams.wrap(ocr48, 'run_beam', make_run_beam)
    seams.wrap(ocr48.BeamLoop, 'search', make_search)


def served(seq: np.ndarray):
    """The served tokens of a row: up to and including the first END."""
    ends = np.nonzero(seq == END)[0]
    return [int(t) for t in (seq[:ends[0] + 1] if len(ends) else seq)]


def check(rec, spec, model_dir, device, control=None):
    if not sampled(rec, 'ocr48'):
        return {}
    sd = torch.load(os.path.join(model_dir, CKPT), map_location='cpu',
                    weights_only=True)
    model = ref.build(sd, spec['vocab'], device)
    low = control and precision.lowered(ref.build(sd, spec['vocab'],
                                                  device), control)
    mems = rec.samples['ocr48.memory']
    mem_gap, lp_gap, tokens = [], [], 0
    refs, gots = [], []
    for m in mems:
        images, widths = m['images'].to(device), m['widths'].to(device)
        with precision.computing('float32'):
            mem, mask = ref.memory(model, images, widths)
        got = m['memory'].to(device)
        if control:
            with precision.computing(control):
                got = ref.memory(low, images, widths)[0]
        valid = (~mask)[..., None].float()
        mem_gap.append(float(((got - mem) * valid).square().sum().sqrt()
                             / (mem * valid).square().sum().sqrt()))
        refs.append((mem, mask))
        gots.append(got)
    for d in rec.samples['ocr48.decode']:
        # the latest memory that holds the decoded rows (the allocator
        # hands a freed page's addresses to later pages)
        src = next(i for i in range(d['memory'], -1, -1)
                   if 0 <= d['ptr'] - mems[i]['ptr']
                   < mems[i]['rows'] * mems[i]['row_bytes'])
        off = (d['ptr'] - mems[src]['ptr']) // mems[src]['row_bytes']
        mem, mask = refs[src]
        widths = mems[src]['widths']
        for i in range(d['rows']):
            row = off + i
            if int(widths[row]) == 0:         # a chunk's padding row
                continue
            toks = served(d['sequences'][i])
            inp = torch.tensor([[START] + toks[:-1]], device=device)
            at = (0, torch.arange(len(toks)), torch.tensor(toks))
            with precision.computing('float32'):
                lp = ref.sequence_logprobs(model, mem[row:row + 1],
                                           mask[row:row + 1], inp)[at]
            if control:
                with precision.computing(control):
                    got = float(ref.sequence_logprobs(
                        low, gots[src][row:row + 1], mask[row:row + 1],
                        inp)[at].double().sum())
            else:
                got = float(d['logprob'][i])
            lp_gap.append(abs(float(lp.double().sum()) - got))
            tokens += len(toks)
    rec.compared['ocr48 tokens'] = tokens
    return {'ocr48_memory_rel': max(mem_gap),
            'ocr48_logprob_gap': max(lp_gap)}
