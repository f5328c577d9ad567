"""48px CTC OCR backend (``48px_ctc``) — PyTorch port.

Counterpart of the JAX package's ``ocr/model_48px_ctc.py`` (reference
``ocr/model_48px_ctc.py:18-163``: checkpoint ocr-ctc.ckpt +
alphabet-all-v5.txt, /127.5-1 normalisation, greedy CTC decode with
blank = 0, per-char 6-channel colours, prob threshold 0.5). Crops are host
cv2 warps (the JAX default), width-sorted and padded into 16-crop chunks at
``bucket_width(max + 128)``; each chunk is one ``ctc_forward`` on the
device; the CTC collapse and the colour averaging run on the host.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import OcrConfig
from ..models import ocr48_ctc
from ..utils.bubble import is_ignore
from ..utils.geometry import Quadrilateral
from .common import (AvgMeter, OfflineOCR, chunks, pad_chunk,
                     set_line_result)
from .model_48px import _placeholder_dictionary, bucket_width

TEXT_HEIGHT = 48
MAX_CHUNK = 16


def decode_ctc(logprobs: np.ndarray, colors: np.ndarray, blank: int = 0):
    """Greedy CTC collapse (reference decode_ctc_top1 :456-504): per row,
    ``(char id, log-prob, *6 colours)`` for each kept frame."""
    preds = logprobs.argmax(-1)
    out = []
    for b in range(logprobs.shape[0]):
        line = []
        last_ch = blank
        for t in range(logprobs.shape[1]):
            ch = int(preds[b, t])
            if ch != last_ch and ch != blank:
                line.append((ch, float(logprobs[b, t, ch]),
                             *[float(c) for c in colors[b, t]]))
            last_ch = ch
        out.append(line)
    return out


class Model48pxCTCOCR(OfflineOCR):
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/ocr-ctc.zip',
            'hash': 'fc61c52f7a811bc72c54f6be85df814c6b60f63585175db27cb94a08e0c30101',
            'archive': {
                'ocr-ctc.ckpt': '.',
                'alphabet-all-v5.txt': '.',
            },
        },
    }

    def __init__(self):
        super().__init__()
        self.model = None
        self.device = None
        self.dictionary: List[str] = []

    async def _load(self, device: str):
        dict_path = self._get_file_path('alphabet-all-v5.txt')
        if dict_path.is_file():
            with open(dict_path, encoding='utf-8') as fp:
                self.dictionary = [s.rstrip('\n') for s in fp.readlines()]
        else:
            self.logger.warning('alphabet file unavailable — using '
                                'placeholder dictionary')
            self.dictionary = _placeholder_dictionary()
        sd = self.load_state_dict(
            'model',
            init_fn=lambda: ocr48_ctc.init_state_dict(len(self.dictionary)))
        # the checkpoint's PE buffer is recomputed, as in the JAX package
        sd = {k: v for k, v in sd.items() if not k.endswith('pe.pe')}
        self.device = torch.device(device)
        self.model = ocr48_ctc.build_ocr48_ctc(len(self.dictionary),
                                               self.device, sd)

    async def _unload(self):
        self.model = None

    async def _infer(self, image: np.ndarray,
                     textlines: List[Quadrilateral], config: OcrConfig,
                     verbose: bool = False) -> List[Quadrilateral]:
        ignore_bubble = config.ignore_bubble
        threshold = 0.5 if config.prob is None else config.prob

        quadrilaterals, region_imgs, perm, is_quadrilaterals = \
            self._sorted_crops(image, textlines, TEXT_HEIGHT)
        out_regions = []
        skip = None
        if 1 <= ignore_bubble <= 50:
            def skip(crop):
                return is_ignore(crop, ignore_bubble)
        for indices in chunks(perm, MAX_CHUNK):
            bw = bucket_width(
                max(region_imgs[i].shape[1] for i in indices) + 128)
            batch, _, skipped = pad_chunk(region_imgs, indices, MAX_CHUNK,
                                          bw, skip)
            images = (torch.from_numpy(batch).to(self.device).float()
                      / 127.5 - 1.0)
            logprobs, colors = ocr48_ctc.ctc_forward(self.model, images)
            texts = decode_ctc(logprobs.cpu().numpy(), colors.cpu().numpy())

            for i in range(len(indices)):
                if i in skipped or not texts[i]:
                    continue
                cur_texts = []
                meters = [AvgMeter() for _ in range(6)]
                total_logprob = AvgMeter()
                for (chid, logprob, *cvals) in texts[i]:
                    if chid >= len(self.dictionary):
                        continue
                    ch = self.dictionary[chid]
                    if ch == '<SP>':
                        ch = ' '
                    cur_texts.append(ch)
                    total_logprob(logprob)
                    if ch != ' ':
                        for m, v in zip(meters, cvals):
                            m(int(v * 255))
                prob = float(np.exp(total_logprob()))
                if prob < threshold:
                    continue
                txt = ''.join(cur_texts)
                fr, fg, fb, br, bg, bb = [int(m()) for m in meters]
                self.logger.info(f'prob: {prob} {txt} fg: ({fr}, {fg}, {fb}) '
                                 f'bg: ({br}, {bg}, {bb})')
                cur_region = quadrilaterals[indices[i]][0]
                set_line_result(cur_region, txt, prob,
                                (fr, fg, fb, br, bg, bb))
                out_regions.append(cur_region)

        if is_quadrilaterals:
            return out_regions
        return textlines
