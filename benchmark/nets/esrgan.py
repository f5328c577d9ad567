"""The ``esrgan`` upscaler: Real-ESRGAN x4plus-anime-6B
(``upscaling/RealESRGAN_x4plus_anime_6B.pth``, the release's new-style
names under ``params_ema``), RRDBNet nb 6, nf 64, gc 32, run on 256-px
tiles with 8 px of context, 8 tiles a forward.

Weights: random weights make the upscaled page noise, on which every later
stage would work unlike on a scan. So the convolutions of the image path
(``identity``: the first, the two upsampling, the HR and the last) carry
the identity on the three colour channels at their centre tap beside
their random draw, and the trunk's last convolution is scaled down: the
network then upsamples the page close to nearest-neighbour, and every
convolution still runs at its published width.

Compared on the sampled pages: the first forward's output tiles (before
the clip to [0, 1]) against the reference's for the same input tiles
(RMS gap over the RMS of the reference's). The tiles are the program's
(its tile plan of the page).
"""
from __future__ import annotations

import os

import torch

from . import conv_rule, draw_state_dict, sampled, save_atomic
from .. import precision, seams
from ..reference import esrgan as ref

FILE = 'upscaling/RealESRGAN_x4plus_anime_6B.pth'


def files(spec):
    return [FILE]


def write(model_dir, spec, seed, device):
    nb = spec['blocks']
    with torch.device('meta'):
        tpl = ref.RRDBNet(nb).state_dict()
    sd = draw_state_dict(tpl, conv_rule(tpl, spec.get('gains', {})), seed,
                         device)
    for name in spec.get('identity', ()):
        w = sd[f'{name}.weight']
        sd[f'{name}.bias'].zero_()
        for c in range(3):
            w[c, c, w.shape[2] // 2, w.shape[3] // 2] += 1.0
    save_atomic({'params_ema': {ref.new_style_key(k, nb): v
                                for k, v in sd.items()}},
                os.path.join(model_dir, FILE))


def install(rec, spec):
    from manga_image_translator_tpu_torch.models import esrgan

    def make(original):
        def esrgan_forward(model, x):
            out = original(model, x)
            if rec.counting:
                rec.calls['esrgan'].append(tuple(x.shape))
            if rec.sampling and rec.last.get('esrgan.page') != rec.page.index:
                rec.last['esrgan.page'] = rec.page.index
                rec.samples['esrgan'].append({'x': seams.host(x),
                                              'out': seams.host(out)})
            return out
        return esrgan_forward
    seams.wrap(esrgan, 'esrgan_forward', make)


def check(rec, spec, model_dir, device, control=None):
    if not sampled(rec, 'esrgan'):
        return {}
    sd = torch.load(os.path.join(model_dir, FILE), map_location='cpu',
                    weights_only=True)['params_ema']
    with torch.device('meta'):
        keys = list(ref.RRDBNet(spec['blocks']).state_dict())
    old = {k: sd[ref.new_style_key(k, spec['blocks'])] for k in keys}
    model = ref.build(old, spec['blocks'], device)
    low = control and precision.lowered(ref.build(old, spec['blocks'],
                                                  device), control)
    gaps = []
    for s in rec.samples['esrgan']:
        x = s['x'].to(device)
        for i in range(x.shape[0]):
            with precision.computing('float32'):
                out = ref.forward(model, x[i:i + 1])
            if control:
                with precision.computing(control):
                    got = ref.forward(low, x[i:i + 1])
            else:
                got = s['out'][i:i + 1].to(device)
            gaps.append(float((got - out).square().mean().sqrt()
                              / out.square().mean().sqrt()))
    return {'esrgan_rel': max(gaps)}
