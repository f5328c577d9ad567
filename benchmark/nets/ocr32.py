"""The 32px OCR (``ocr/ocr.ckpt`` and ``ocr/alphabet-all-v5.txt`` from
``ocr.zip``), beam 5, as ``ocr48`` capped by ``MIT_TPU_OCR_MAX_LEN``
(random weights never emit END).

Compared on the sampled pages: each served line's log-probability (the
beam's score) against the reference's teacher-forced log-probability of
the same tokens, from the reference's own encoder memory of the same
crops (the largest gap in nats). The crops are the program's (host cv2
warps of the page's detected lines). The memory itself is not compared:
on the card the program's memory (TF32 convolutions) reads 0.008 from the
reference's and the bf16 control's 0.023-0.026, too close for a limit
(PERF.md).
"""
from __future__ import annotations

import os

import torch

from . import conv_rule, draw_state_dict, sampled, save_atomic
from . import ocr48 as ocr48_net
from .. import precision, seams
from ..reference import ocr32 as ref

CKPT = 'ocr/ocr.ckpt'
ALPHABET = 'ocr/alphabet-all-v5.txt'
START, END = 1, 2


def files(spec):
    return [CKPT, ALPHABET]


def write(model_dir, spec, seed, device):
    with torch.device('meta'):
        tpl = ref.OCR32(spec['vocab']).state_dict()
    sd = draw_state_dict(tpl, conv_rule(tpl, spec.get('gains', {})), seed,
                         device)
    save_atomic(sd, os.path.join(model_dir, CKPT))
    save_atomic(ocr48_net.alphabet(spec['vocab']),
                os.path.join(model_dir, ALPHABET),
                lambda chars, tmp: open(tmp, 'w', encoding='utf-8').write(
                    '\n'.join(chars) + '\n'))


def install(rec, spec):
    from manga_image_translator_tpu_torch.models import ocr32

    def make_memory(original):
        def compute_memory(model, images, valid_widths):
            memory, mask = original(model, images, valid_widths)
            if rec.counting:
                rec.calls['ocr32.encoder'].append(tuple(images.shape))
            if rec.sampling:
                rec.samples['ocr32'].append({
                    'images': seams.host(images),
                    'widths': seams.keep(valid_widths)})
            return memory, mask
        return compute_memory

    def make_beam(original):
        def run_beam(model, memory, memory_mask, beams_k, max_len,
                     max_finished_hypos):
            state = original(model, memory, memory_mask, beams_k, max_len,
                             max_finished_hypos)
            seq = state['best_seq'].cpu().numpy()
            ended = (seq[:, 1:] == END)
            steps = max_len if not ended.any(axis=1).all() else int(
                ended.argmax(axis=1).max()) + 1
            rec.steps['ocr32'].append(steps)
            if rec.counting:
                rec.calls['ocr32.decoder'].append(
                    (memory.shape[0], beams_k, memory.shape[1], steps,
                     int((~memory_mask).sum()) * beams_k))
            if rec.sampling:
                rec.samples['ocr32'][-1].update(
                    sequences=seq[:, 1:],
                    logprob=state['best_logprob'].double().cpu().numpy())
            return state
        return run_beam

    seams.wrap(ocr32, 'compute_memory', make_memory)
    seams.wrap(ocr32, 'run_beam', make_beam)


def check(rec, spec, model_dir, device, control=None):
    if not sampled(rec, 'ocr32'):
        return {}
    sd = torch.load(os.path.join(model_dir, CKPT), map_location='cpu',
                    weights_only=True)
    model = ref.build(sd, spec['vocab'], device)
    low = control and precision.lowered(ref.build(sd, spec['vocab'],
                                                  device), control)
    lp_gap, tokens = [], 0
    for s in rec.samples['ocr32']:
        images, widths = s['images'].to(device), s['widths']
        with precision.computing('float32'):
            mem, mask = ref.memory(model, images, widths.to(device))
        got = mem
        if control:
            with precision.computing(control):
                got = ref.memory(low, images, widths.to(device))[0]
        for i in range(mem.shape[0]):
            if int(widths[i]) == 0:
                continue
            toks = ocr48_net.served(s['sequences'][i])
            inp = torch.tensor([[START] + toks[:-1]], device=device)
            at = (0, torch.arange(len(toks)), torch.tensor(toks))
            with precision.computing('float32'):
                lp = ref.sequence_logprobs(model, mem[i:i + 1],
                                           mask[i:i + 1], inp)[at]
            if control:
                with precision.computing(control):
                    lp_got = float(ref.sequence_logprobs(
                        low, got[i:i + 1], mask[i:i + 1], inp)[at]
                        .double().sum())
            else:
                lp_got = float(s['logprob'][i])
            lp_gap.append(abs(float(lp.double().sum()) - lp_got))
            tokens += len(toks)
    rec.compared['ocr32 tokens'] = tokens
    return {'ocr32_logprob_gap': max(lp_gap)}
