"""The default detector's DBNet-ResNet34 (``detect-20241225.ckpt``).

Compared on the sampled pages: the network input the program built from
the page (the K1 bilateral prefilter and the pad) against the reference's
own prefilter of the same page (mean grey-level gap), and the DB head's
shrink logits the program's forward gave for that input against the
reference's (RMS gap over the RMS of the reference's logits).
"""
from __future__ import annotations

import os

import torch

from . import conv_rule, draw_state_dict, sampled, save_atomic
from .. import precision, seams
from ..reference import dbnet as ref

FILE = 'detection/detect-20241225.ckpt'
TRANSPOSED = (r'upconv\d+\.conv\.6\.weight',
              r'conv_db\.(binarize|thresh)\.[36]\.weight')


def files(spec):
    return [FILE]


def template():
    with torch.device('meta'):
        return ref.DBNet().state_dict()


def write(model_dir, spec, seed, device):
    tpl = template()
    sd = draw_state_dict(tpl, conv_rule(tpl, spec.get('gains', {}),
                                        TRANSPOSED), seed, device)
    save_atomic(sd, os.path.join(model_dir, FILE))


def install(rec, spec):
    seams.install_detection_seam(rec)


def check(rec, spec, model_dir, device, control=None):
    if not sampled(rec, 'dbnet'):
        return {}
    sd = torch.load(os.path.join(model_dir, FILE), map_location='cpu',
                    weights_only=True)
    model = ref.build(sd, device)
    low = control and precision.lowered(ref.build(sd, device), control)
    prefilter, logits = [], []
    for s in rec.samples['dbnet']:
        img = torch.from_numpy(s['image']).to(device)
        x = s['x'][0].to(device)
        with precision.computing('float32'):
            x_ref = ref.canvas(img, spec['detection_size'])
            db_ref = ref.logits(model, x[None])[0][..., 0]
        if control:
            with precision.computing(control):
                x = ref.canvas(img, spec['detection_size'],
                               dtype=precision.compute_dtype(control))
                db = ref.logits(low, s['x'].to(device))[0][..., 0].float()
        else:
            db = s['db'].to(device)
        prefilter.append(float(((x - x_ref).abs() * 127.5).mean()))
        logits.append(float((db - db_ref).square().mean().sqrt()
                            / db_ref.square().mean().sqrt()))
    return {'det_prefilter_grey': max(prefilter),
            'det_logit_rel': max(logits)}
