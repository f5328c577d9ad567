"""32px OCR backend (``32px``) — PyTorch port.

Counterpart of the JAX package's ``ocr/model_32px.py`` (reference
``ocr/model_32px.py:19-141``: checkpoint ocr.ckpt in ocr.zip, 32 px crops,
beam k=5, prob threshold 0.2, clipped-mean per-char colours). Crops are
host cv2 warps (the JAX default), width-sorted and padded into 16-crop
chunks; each chunk is one backbone + encoder forward and one beam search
(``models/ocr32.beam_decode``) on the device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import OcrConfig
from ..models import ocr32
from ..utils.geometry import Quadrilateral
from .common import OfflineOCR, chunks, pad_chunk, set_line_result
from .model_48px import MAX_SEQ_LEN, _placeholder_dictionary, bucket_width

TEXT_HEIGHT = 32
MAX_CHUNK = 16


class Model32pxOCR(OfflineOCR):
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/ocr.zip',
            'hash': '47405638b96fa2540a5ee841a4cd792f25062c09d9458a973362d40785f95d7a',
            'archive': {
                'ocr.ckpt': '.',
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
            init_fn=lambda: ocr32.init_state_dict(len(self.dictionary)))
        self.device = torch.device(device)
        self.model = ocr32.build_ocr32(len(self.dictionary), self.device,
                                       ocr32.checkpoint_state_dict(sd))

    async def _unload(self):
        self.model = None

    async def _infer(self, image: np.ndarray,
                     textlines: List[Quadrilateral], config: OcrConfig,
                     verbose: bool = False) -> List[Quadrilateral]:
        threshold = 0.2 if config.prob is None else config.prob

        quadrilaterals, region_imgs, perm, is_quadrilaterals = \
            self._sorted_crops(image, textlines, TEXT_HEIGHT)
        out_regions = []
        for indices in chunks(perm, MAX_CHUNK):
            bw = bucket_width(max(region_imgs[i].shape[1] for i in indices))
            batch, valid_widths, _ = pad_chunk(region_imgs, indices,
                                               MAX_CHUNK, bw)
            images = (torch.from_numpy(batch).to(self.device).float()
                      / 127.5 - 1.0)
            ret = ocr32.beam_decode(
                self.model, images,
                torch.from_numpy(valid_widths).to(self.device), beams_k=5,
                max_len=MAX_SEQ_LEN)
            sequences = ret['sequences'].cpu().numpy()
            probs = ret['probs'].cpu().numpy()
            colors = ret['colors'].float().cpu().numpy()

            for i in range(len(indices)):
                prob = float(probs[i])
                if prob < threshold:
                    continue
                seq = []
                n_chars = 0
                for chid in sequences[i]:
                    chid = int(chid)
                    if chid >= len(self.dictionary):
                        continue
                    ch = self.dictionary[chid]
                    if ch == '<S>':
                        continue
                    if ch == '</S>':
                        break
                    if ch == '<SP>':
                        ch = ' '
                    seq.append(ch)
                    n_chars += 1
                txt = ''.join(seq)
                if not txt:
                    continue
                # colors: mean over the sequence, clipped (reference :104-109)
                cmean = colors[i, :max(n_chars, 1)].mean(axis=0)
                fr, fg, fb, br, bg, bb = [int(np.clip(v, 0, 1) * 255)
                                          for v in cmean]
                self.logger.info(f'prob: {prob} {txt} fg: ({fr}, {fg}, {fb}) '
                                 f'bg: ({br}, {bg}, {bb})')
                cur_region = quadrilaterals[indices[i]][0]
                set_line_result(cur_region, txt, prob,
                                (fr, fg, fb, br, bg, bb))
                out_regions.append(cur_region)

        if is_quadrilaterals:
            return out_regions
        return textlines
