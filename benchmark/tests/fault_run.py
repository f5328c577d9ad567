"""Drives one run of the tiny cell on the CPU with a fault planted in the
timed path, and prints the result's ``correct`` and numbers as JSON.

    python -m benchmark.tests.fault_run <fault> <work dir>

Faults: ``none``; ``control`` (no fault: the lower-precision control is
judged in the program's place, ``--control 1``); ``ocr_token`` (a token of each 48px OCR line altered
where the beam search produces it); ``sugoi_token`` (a token of each
translation altered where the search produces it); ``lama_pixels``
(inpainted pixels altered where the generator produces them);
``outside_mask`` (the inpainted page altered in a ring of pixels just
outside its mask, where the crops are written back); ``render_spill``
(each region's text drawn three glyphs below the rectangle the renderer
was handed).
"""
import json
import sys
import time

import torch


def plant(fault: str) -> None:
    if fault == 'ocr_token':
        from manga_image_translator_tpu_torch.models import ocr48
        original = ocr48.BeamLoop.search

        def search(self, *args):
            out = original(self, *args)
            out['best_seq'][:, 2] = (out['best_seq'][:, 2] + 7) % 100 + 4
            return out
        ocr48.BeamLoop.search = search
    elif fault == 'sugoi_token':
        from manga_image_translator_tpu_torch.translators import ct2_model
        original = ct2_model.BeamSearch.result

        def result(self):
            out = original(self).clone()
            out[:, 0] = (out[:, 0] + 11) % 1000 + 4
            return out
        ct2_model.BeamSearch.result = result
    elif fault == 'lama_pixels':
        from manga_image_translator_tpu_torch.inpainting import \
            inpainting_lama
        original = inpainting_lama._lama_body

        def _lama_body(model, img, mask, dtype, embeddings=(None, None)):
            out = original(model, img, mask, dtype, embeddings)
            return torch.where(mask > 0, 1.0 - out, out)
        inpainting_lama._lama_body = _lama_body
    elif fault == 'outside_mask':
        import cv2
        import numpy as np
        from manga_image_translator_tpu_torch.inpainting.common import \
            OfflineInpainter
        original = OfflineInpainter._inpaint_crops_multi

        def _inpaint_crops_multi(self, images, masks, *args, **kwargs):
            outs = original(self, images, masks, *args, **kwargs)
            for out, mask in zip(outs, masks):
                if out is not None:
                    inside = mask > 0
                    ring = cv2.dilate(inside.astype(np.uint8),
                                      np.ones((7, 7), np.uint8)) > 0
                    ring &= ~inside
                    out[ring] = 255 - out[ring]
            return outs
        OfflineInpainter._inpaint_crops_multi = _inpaint_crops_multi
    elif fault == 'render_spill':
        from manga_image_translator_tpu_torch import rendering
        original = rendering.render

        def render(img, region, dst_points, *args, **kwargs):
            return original(img, region, dst_points + [0, 66], *args,
                            **kwargs)
        rendering.render = render
    elif fault not in ('none', 'control'):
        raise SystemExit(f'unknown fault {fault}')


def main(argv):
    t0 = time.time()
    from benchmark import harness
    from benchmark.tests import tiny
    harness.WORK = argv[1]
    plant(argv[0])
    config, traffic = tiny.cell()
    # seed 3 sends the sampled page (the one with the most lines) first, so
    # the window serves it however slowly the CPU runs
    res = harness.run_cell(config, traffic, 3, 10.0, False, 'cpu', t0,
                           control=argv[0] == 'control',
                           log=lambda *_: None)
    print(json.dumps({'correct': res['correct'], 'checked': res['checked']}))


if __name__ == '__main__':
    main(sys.argv[1:])
