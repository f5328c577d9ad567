"""The ``lama_large`` inpainter's generator (``lama_large_512px.ckpt``).

Weights: He-normal convolutions times per-pattern gains (the second
convolution of each residual block and the last convolution scaled down,
so that 18 blocks do not blow the trunk up and the sigmoid's input stays
in its linear range; calibrated on the CPU, ``calibrate.py``), batch norms
at identity statistics.

Compared on the sampled pages: every generator call's composite (the
inpainted crop batch, float32, before it is rounded to bytes) against the
reference's for the same crops and masks: the RMS gap inside the mask,
in units of the [0, 1] pixel range. The crops are the program's (its
crop plan of the page and mask).
"""
from __future__ import annotations

import os

import torch

from . import conv_rule, draw_state_dict, sampled, save_atomic
from .. import precision, seams
from ..reference import lama as ref

FILE = 'inpainting/lama_large_512px.ckpt'


def files(spec):
    return [FILE]


def template(n_blocks):
    with torch.device('meta'):
        return ref.LamaGenerator(n_blocks).state_dict()


def transposed(n_blocks):
    up0 = 5 + n_blocks + 1
    return (rf'model\.({"|".join(str(up0 + 3 * i) for i in range(3))})'
            r'\.weight',)


def write(model_dir, spec, seed, device):
    n = spec['blocks']
    tpl = template(n)
    sd = draw_state_dict(tpl, conv_rule(tpl, spec.get('gains', {}),
                                        transposed(n)), seed, device)
    save_atomic(sd, os.path.join(model_dir, FILE))


def install(rec, spec):
    from manga_image_translator_tpu_torch.inpainting import inpainting_lama

    def make(original):
        def _lama_body(model, img, mask, dtype, embeddings=(None, None)):
            out = original(model, img, mask, dtype, embeddings)
            if rec.counting:
                rec.calls['lama'].append(tuple(img.shape))
            if rec.sampling:
                rec.samples['lama'].append({'img': seams.host(img),
                                            'mask': seams.host(mask),
                                            'out': seams.host(out)})
            return out
        return _lama_body
    seams.wrap(inpainting_lama, '_lama_body', make)


def check(rec, spec, model_dir, device, control=None):
    if not sampled(rec, 'lama'):
        return {}
    sd = torch.load(os.path.join(model_dir, FILE), map_location='cpu',
                    weights_only=True)
    model = ref.build(sd, spec['blocks'], device)
    low = control and precision.lowered(ref.build(sd, spec['blocks'],
                                                  device), control)
    gaps, pixels = [], 0
    for s in rec.samples['lama']:
        mask, img = s['mask'].to(device), s['img'].to(device)
        inside = mask.expand(-1, -1, -1, 3) > 0
        if not inside.any():
            continue
        for i in range(img.shape[0]):
            with precision.computing('float32'):
                out = ref.composite(model, img[i:i + 1], mask[i:i + 1])
            if control:
                with precision.computing(control):
                    got = ref.composite(low, img[i:i + 1], mask[i:i + 1])
            else:
                got = s['out'][i:i + 1].to(device)
            diff = (got - out)[inside[i:i + 1]]
            if diff.numel():
                gaps.append(float(diff.square().mean().sqrt()))
        pixels += int((mask > 0).sum())
    rec.compared['lama masked pixels'] = pixels
    return {'lama_masked_rms': max(gaps)} if gaps else {}
