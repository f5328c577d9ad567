"""Calibrates, on the CPU at the published widths, the numbers in a
configuration file that stand in for what trained weights do: END's bias
in the 48px OCR's char head and EOS's in Sugoi's output projection (so
that searches end at lengths like real lines and translations), and the
LaMa generator's gains (so that its sigmoid's input stays in range).
Prints what each value gives; the chosen values are written into the
configuration file by hand, beside what they gave.

    python -m benchmark.calibrate benchmark/configs/default.json

A development tool: the benchmark's runs never import it.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

from . import nets, pages
from .nets import ocr48 as ocr48_net, sugoi as sugoi_net


def line_crops(n: int, seed: int):
    """48-px-tall crops of drawn lines, lengths spread over 2-16 glyphs,
    in [-1, 1], as the OCR's chunks hold them (N, 48, W, 3)."""
    rng = np.random.default_rng(seed)
    lengths = pages._spread(2, 16, n)
    crops, widths = [], []
    for k in lengths:
        strip = np.full((48, 48 * k, 3), 250, np.uint8)
        for c in range(k):
            g = pages._glyph(rng, 40)
            strip[4:44, 48 * c + 4:48 * c + 44][g > 0] = 10
        crops.append(strip)
        widths.append(strip.shape[1])
    width = max(widths) + 8
    batch = np.zeros((n, 48, width, 3), np.float32)
    for i, s in enumerate(crops):
        batch[i, :, :s.shape[1]] = s / 127.5 - 1.0
    return torch.from_numpy(batch), torch.tensor(widths)


def ocr_tokens(config, max_len=17):
    """What the 48px OCR with the configuration's own weights reads from
    drawn lines: token rows (N, max_len)."""
    from manga_image_translator_tpu_torch.models import ocr48
    from .harness import weight_seed
    spec = config['networks']['ocr48']
    images, widths = line_crops(8, 0)
    with tempfile.TemporaryDirectory() as d:
        ocr48_net.write(d, spec, weight_seed(config, 'ocr48'), 'cpu')
        sd = torch.load(os.path.join(d, ocr48_net.CKPT), weights_only=True)
    model = ocr48.build_ocr48(spec['vocab'], 'cpu', sd)
    return ocr48.beam_decode(model, images, widths,
                             max_len=max_len)['sequences']


def ocr_lengths(spec, biases, seed=0):
    from manga_image_translator_tpu_torch.models import ocr48
    images, widths = line_crops(24, seed)
    out = {}
    for bias in biases:
        with tempfile.TemporaryDirectory() as d:
            ocr48_net.write(d, spec, 11, 'cpu')
            sd = torch.load(os.path.join(d, ocr48_net.CKPT),
                            weights_only=True)
        sd['pred.bias'][ocr48_net.END] += bias
        model = ocr48.build_ocr48(spec['vocab'], 'cpu', sd)
        res = ocr48.beam_decode(model, images, widths, max_len=64)
        seq = res['sequences'].numpy()
        lens = [int(np.argmax(r == 2)) + 1 if (r == 2).any() else 64
                for r in seq]
        out[bias] = {'mean': float(np.mean(lens)), 'max': max(lens),
                     'lengths': lens}
        print('ocr48 end_bias', bias, out[bias], flush=True)
    return out


def sugoi_lengths(config, biases):
    """Translation lengths and search steps of the page's regions (2-5
    lines each) as the configuration's own OCR weights read them."""
    from manga_image_translator_tpu_torch.translators import ct2_model
    from .harness import weight_seed
    spec = config['networks']['sugoi']
    chars = ocr48_net.alphabet(spec['source_alphabet'])
    rows = ocr_tokens(config).numpy()
    line = [chars[int(t)] for t in rows[0] if int(t) > 3]
    print('ocr48 reads', ''.join(line), flush=True)
    sents = [['▁' + line[0]] + (line * n)[1:] for n in (2, 3, 3, 4, 4, 5, 3,
                                                          2, 4, 3)]
    out = {}
    for bias in biases:
        spec2 = dict(spec, eos_bias=bias)
        variables = dict(sugoi_net.variables(
            spec2, weight_seed(config, 'sugoi'), 'cpu'))
        deq = {}
        for k, a in variables.items():
            if k.endswith('_scale'):
                continue
            if a.dtype == np.int8:
                a = a.astype(np.float32) / variables[k + '_scale'][:, None]
            deq[k] = a
        src_v, tgt_v = sugoi_net.vocabularies(spec2)
        model = ct2_model.Ct2Transformer(deq, {'num_heads': spec['heads']},
                                         src_v, tgt_v, device='cpu')
        res = model.translate_batch(sents, beam_size=5, max_len=200)
        lens = [len(r) for r in res]
        out[bias] = {'source': [len(s) for s in sents], 'target': lens,
                     'steps': model.last_steps}
        print('sugoi eos_bias', bias, out[bias], flush=True)
        del model
    return out


def lama_range(spec, size=256, seed=0):
    from .reference import lama as ref
    from .nets import lama as lama_net
    tpl = lama_net.template(spec['blocks'])
    sd = nets.draw_state_dict(tpl, nets.conv_rule(
        tpl, spec.get('gains', {}), lama_net.transposed(spec['blocks'])),
        5, 'cpu')
    model = ref.build(sd, spec['blocks'], 'cpu')
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((1, size, size, 3), generator=g)
    mask = torch.zeros((1, size, size, 1))
    mask[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = 1
    pre = {}
    final = model.model[5 + spec['blocks'] + 1 + 3 * 3 + 1]
    final.register_forward_hook(lambda m, a, o: pre.update(x=o))
    with torch.no_grad():
        out = model(img * (1 - mask), mask)
    x = pre['x']
    stats = {'pre_sigmoid_std': float(x.std()),
             'saturated_share': float(((out < 0.01) | (out > 0.99))
                                      .float().mean())}
    print('lama', spec.get('gains'), stats, flush=True)
    return stats


def main(argv):
    cfg = json.load(open(argv[0]))
    what = argv[1] if len(argv) > 1 else 'all'
    torch.set_num_threads(4)
    if what in ('all', 'ocr48'):
        ocr_lengths(cfg['networks']['ocr48'],
                    [float(b) for b in os.environ.get(
                        'BIASES', '0,2,4,6').split(',')])
    if what in ('all', 'sugoi'):
        sugoi_lengths(cfg,
                      [float(b) for b in os.environ.get(
                          'BIASES', '0,4,8').split(',')])
    if what in ('all', 'lama'):
        lama_range(cfg['networks']['lama'])


if __name__ == '__main__':
    main(sys.argv[1:])
