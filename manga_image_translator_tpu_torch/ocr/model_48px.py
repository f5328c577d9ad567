"""Default OCR backend: the 48px autoregressive recognizer, PyTorch port.

Counterpart of the JAX package's ``ocr/model_48px.py`` (reference
``ocr/model_48px.py:27-180``: ocr_ar_48px.ckpt + alphabet-all-v7.txt,
/127.5-1 normalization, beam k=5, prob threshold 0.2, per-char fg/bg colour
averaging). Crops are cut on the device by default (``MIT_TPU_DEVICE_CROPS``
``auto``, as in the JAX package: the separable resampler of ``ops.warp``
with the few rotated lines warped by cv2 and patched in; host cv2 warps
when more than half of a page's lines are rotated; ``0`` forces the host,
``1`` the device gather), width-sorted, padded into fixed width buckets
and 16/24-crop chunks; consecutive same-bucket chunks share one
backbone + encoder forward; each chunk decodes at a short first-tier length
and re-decodes only its unfinished rows at the full length. Batch mode
(``infer_pooled``) pools the lines of several pages into the same chunks.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..config import OcrConfig
from ..models import ocr48
from ..utils.geometry import Quadrilateral
from ..utils.profiling import count, span, to_host, tracing
from .common import (AvgMeter, HostCrops, OfflineOCR, chunks,
                     set_line_result, tokens_read)

TEXT_HEIGHT = 48
MAX_CHUNK = 16
BIG_CHUNK = 24
# consecutive same-bucket chunks sharing one backbone + encoder forward
MEM_GROUP_CHUNKS = 2
# width buckets bound the number of distinct decode shapes
WIDTH_BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024, 1536)
# reference decodes up to 255 tokens (model_48px.py:120); CPU test runs
# bound it with MIT_TPU_OCR_MAX_LEN, as they do for the JAX package
MAX_SEQ_LEN = int(os.environ.get('MIT_TPU_OCR_MAX_LEN', 255))
# first-tier decode budget: rows that do not finish re-decode at MAX_SEQ_LEN
# (MIT_TPU_OCR_FAST_LEN, as in the JAX package)
FAST_SEQ_LEN = int(os.environ.get('MIT_TPU_OCR_FAST_LEN', 64))
BEAMS = 5


def _placeholder_dictionary() -> List[str]:
    """Offline fallback alphabet with the reference's special tokens at the
    canonical indices (pad=0, start=1, end=2)."""
    specials = ['<PAD>', '<S>', '</S>', '<SP>']
    ascii_chars = [chr(c) for c in range(33, 127)]
    kana = [chr(c) for c in range(0x3041, 0x3097)] + \
           [chr(c) for c in range(0x30A1, 0x30FB)]
    cjk = [chr(c) for c in range(0x4E00, 0x4E00 + 2048)]
    return specials + ascii_chars + kana + cjk


def bucket_width(w: int) -> int:
    target = w + 8  # headroom mirroring the reference's max_width = w + 7
    for b in WIDTH_BUCKETS:
        if target <= b:
            return b
    return WIDTH_BUCKETS[-1]


def crop_mode() -> str:
    """Where the 48px OCR crops, from ``MIT_TPU_DEVICE_CROPS`` as in the
    JAX package: ``auto`` (the default) the separable device resampler
    with rotated lines patched in (``'auto'``), ``0`` the host, any other
    value the device gather path (``'gather'``)."""
    value = os.environ.get('MIT_TPU_DEVICE_CROPS', 'auto')
    return {'0': 'host', 'auto': 'auto'}.get(value, 'gather')


def bf16_backbone_enabled() -> bool:
    """bf16 backbone + encoder activations (default on, as in the JAX
    package); MIT_TPU_OCR_BF16_BACKBONE=0 runs them in f32."""
    return os.environ.get('MIT_TPU_OCR_BF16_BACKBONE', '1') != '0'


class Model48pxOCR(OfflineOCR):
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/ocr_ar_48px.ckpt',
            'hash': '29daa46d080818bb4ab239a518a88338cbccff8f901bef8c9db191a7cb97671d',
        },
        'dict': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/alphabet-all-v7.txt',
            'hash': 'f5722368146aa0fbcc9f4726866e4efc3203318ebb66c811d8cbbe915576538a',
        },
    }

    def __init__(self):
        super().__init__()
        self.model = None
        self.device = None
        self.dictionary: List[str] = []

    async def _load(self, device: str):
        dict_path = self._mapping_file_path('dict')
        if dict_path.is_file():
            with open(dict_path, 'r', encoding='utf-8') as fp:
                self.dictionary = [s.rstrip('\n') for s in fp.readlines()]
        else:
            self.logger.warning('alphabet file unavailable — using '
                                'placeholder dictionary')
            self.dictionary = _placeholder_dictionary()
        dict_size = len(self.dictionary)
        sd = self.load_state_dict(
            'model', init_fn=lambda: ocr48.init_state_dict(dict_size))
        self.device = torch.device(device)
        self.model = ocr48.build_ocr48(dict_size, self.device, sd)

    async def _unload(self):
        self.model = None

    def _compute_memory(self, images, valid_widths):
        with span('ocr.encode'):
            return ocr48.sharded_compute_memory(
                self.model, images, valid_widths, bf16_backbone_enabled())

    def _decode(self, memory, memory_mask, max_len):
        return ocr48.sharded_beam_decode_from_memory(
            self.model, memory, memory_mask, beams_k=BEAMS, max_len=max_len)

    async def _infer(self, image: np.ndarray,
                     textlines: List[Quadrilateral], config: OcrConfig,
                     verbose: bool = False, ignore_bubble: int = 0
                     ) -> List[Quadrilateral]:
        threshold = 0.2 if config.prob is None else config.prob
        quadrilaterals, crops, perm, is_quadrilaterals = self._sorted_crops(
            image, textlines, TEXT_HEIGHT, crop_mode())
        out_regions = []
        dump_dirs = [d for _q, d in quadrilaterals] if verbose else None
        for idx, prob, txt, colors in self._read_crops(
                crops, perm, threshold, dump_dirs):
            cur_region = quadrilaterals[idx][0]
            set_line_result(cur_region, txt, prob, colors)
            out_regions.append(cur_region)

        if is_quadrilaterals:
            return out_regions
        return textlines

    async def infer_pooled(self, images: List[np.ndarray],
                           textlines_list: List[List[Quadrilateral]],
                           config: OcrConfig, verbose: bool = False
                           ) -> List[List[Quadrilateral]]:
        """OCR several pages' text lines pooled into shared chunks: the
        lines of all pages are width-sorted together, so sparse pages fill
        one chunk instead of each decoding a partial one. Returns each
        page's recognised lines, in the order the per-page path gives.
        Crops are host cv2 warps, as in the JAX package: the device
        resamplers work on one page at a time."""
        threshold = 0.2 if config.prob is None else config.prob
        entries = []          # (page index, quad, direction)
        for pi, tls in enumerate(textlines_list):
            for q, d in self._generate_text_direction(tls):
                entries.append((pi, q, d))
        out: List[List[Quadrilateral]] = [[] for _ in images]
        if not entries:
            return out
        if not isinstance(entries[0][1], Quadrilateral):
            # TextBlock inputs keep the per-page path
            for pi, tls in enumerate(textlines_list):
                out[pi] = await self._infer(images[pi], tls, config,
                                            verbose)
            return out

        region_imgs = [q.get_transformed_region(images[pi], d, TEXT_HEIGHT)
                       for pi, q, d in entries]
        perm = sorted(range(len(entries)),
                      key=lambda i: region_imgs[i].shape[1])
        for idx, prob, txt, colors in self._read_crops(
                HostCrops(region_imgs, self.device), perm, threshold):
            pi, cur_region, _d = entries[idx]
            set_line_result(cur_region, txt, prob, colors)
            out[pi].append(cur_region)
        return out

    def _read_crops(self, crops, perm: List[int], threshold: float,
                    dump_dirs=None):
        """Recognise the lines of ``crops`` (``HostCrops`` or
        ``DeviceCrops``) in the order ``perm``: crop them into
        width-bucketed chunks of 16 crops (24 when there are more than 16),
        run one backbone + encoder forward for each run of up to
        ``MEM_GROUP_CHUNKS`` consecutive same-shape chunks, beam-decode each
        chunk in two tiers and turn the tokens into text and colours.
        Returns ``(index, prob, text, colours)`` for every crop whose
        probability reaches ``threshold`` and whose text is not empty, in
        chunk order. ``dump_dirs`` (a direction per crop) writes each crop
        to the debug directory."""
        chunk_size = BIG_CHUNK if len(perm) > MAX_CHUNK else MAX_CHUNK
        built = []
        ix = 0
        for indices in chunks(perm, chunk_size):
            bw = bucket_width(max(crops.width(i) for i in indices))
            with span('ocr.crop'):
                images, valid_widths, _ = crops.chunk(indices, chunk_size,
                                                      bw)
                widths = torch.from_numpy(valid_widths).to(self.device)
            if dump_dirs is not None:
                batch = torch.round((images + 1.0) * 127.5).to(
                    torch.uint8).cpu().numpy()
                for i, idx in enumerate(indices):
                    self._dump_crop(batch[i], dump_dirs[idx], ix + i)
            ix += len(indices)
            built.append((indices, images, widths))

        # consecutive same-shape chunks share one backbone + encoder forward
        results = []
        g = 0
        while g < len(built):
            group = [built[g]]
            while (len(group) < MEM_GROUP_CHUNKS
                   and g + len(group) < len(built)
                   and built[g + len(group)][1].shape == built[g][1].shape):
                group.append(built[g + len(group)])
            g += len(group)
            imgs = torch.cat([c[1] for c in group])
            vws = torch.cat([c[2] for c in group])
            memory, memory_mask = self._compute_memory(imgs, vws)
            off = 0
            for indices, images, _vw in group:
                cs = images.shape[0]
                mem = (memory[off:off + cs], memory_mask[off:off + cs])
                off += cs
                results.append((indices, self._two_tier_decode(mem)))

        found = []
        for indices, ret in results:
            if tracing():
                count('ocr.tokens', tokens_read(
                    ret['sequences'][:len(indices)], ocr48.END_TOK))
            with span('ocr.text'):
                for i, idx in enumerate(indices):
                    prob = float(ret['probs'][i])
                    if prob < threshold:
                        continue
                    txt, colors = self._decode_tokens(
                        ret['sequences'][i], ret['fg'][i], ret['bg'][i],
                        ret['fg_ind'][i], ret['bg_ind'][i])
                    if txt is None:
                        continue
                    self.logger.info('prob: %s %s fg: %s bg: %s', prob, txt,
                                     colors[:3], colors[3:])
                    found.append((idx, prob, txt, colors))
        return found

    def _two_tier_decode(self, memory):
        """Beam decode at FAST_SEQ_LEN first; rows whose best sequence never
        produced </S> re-decode at MAX_SEQ_LEN (compacted into a MAX_CHUNK
        batch when they fit). Identical to one MAX_SEQ_LEN pass for every
        sequence that terminates within the short budget. Returns numpy
        arrays."""
        with span('ocr.beam'):
            fast = min(FAST_SEQ_LEN, MAX_SEQ_LEN)
            first = self._decode(memory[0], memory[1], fast)
            ret = {k: to_host(v).numpy() for k, v in first.items()}
            if fast >= MAX_SEQ_LEN:
                return ret
            unfinished = ~(ret['sequences'] == ocr48.END_TOK).any(axis=1)
            if not unfinished.any():
                return ret
            idx = np.where(unfinished)[0]
            self.logger.info(f'{len(idx)} lines exceeded {fast} tokens — '
                             f're-decoding at {MAX_SEQ_LEN}')
            n_rows = memory[0].shape[0]
            if len(idx) <= MAX_CHUNK < n_rows:
                # padding rows duplicate a live row: they finish with it
                take = np.full((MAX_CHUNK,), int(idx[0]), np.int64)
                take[:len(idx)] = idx
                take_t = torch.from_numpy(take).to(memory[0].device)
                full = self._decode(memory[0][take_t], memory[1][take_t],
                                    MAX_SEQ_LEN)
                src_rows = np.arange(len(idx))
            else:
                full = self._decode(memory[0], memory[1], MAX_SEQ_LEN)
                src_rows = idx
            out = {}
            for key, a in ret.items():
                a = np.array(a)
                b = to_host(full[key]).numpy()
                if a.ndim >= 2 and a.shape[1] != b.shape[1]:
                    pad = [(0, 0)] * a.ndim
                    pad[1] = (0, b.shape[1] - a.shape[1])
                    fill = ocr48.END_TOK if key == 'sequences' else 0
                    a = np.pad(a, pad, constant_values=fill)
                a[idx] = b[src_rows]
                out[key] = a
            return out

    def _dump_crop(self, crop: np.ndarray, direction: str, index: int):
        """Debug crop dump (reference model_48px.py:90-113; directory
        overridable via MANGA_OCR_RESULT_DIR)."""
        import cv2
        out_dir = os.environ.get('MANGA_OCR_RESULT_DIR', 'result/ocrs/')
        os.makedirs(out_dir, exist_ok=True)
        img = cv2.cvtColor(crop, cv2.COLOR_RGB2BGR)
        if direction == 'v':
            img = cv2.rotate(img, cv2.ROTATE_90_CLOCKWISE)
        h, w = img.shape[:2]
        if max(h, w) > 200:
            scale = 200 / max(h, w)
            img = cv2.resize(img, (int(w * scale), int(h * scale)),
                             interpolation=cv2.INTER_AREA)
        cv2.imwrite(os.path.join(out_dir, f'{index}.png'), img,
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])

    def _decode_tokens(self, seq: np.ndarray, fg: np.ndarray, bg: np.ndarray,
                       fg_ind: np.ndarray, bg_ind: np.ndarray):
        """Token ids + per-step colour predictions → (text, avg colours)
        (reference model_48px.py:121-160)."""
        has_fg = fg_ind[:, 1] > fg_ind[:, 0]
        has_bg = bg_ind[:, 1] > bg_ind[:, 0]
        seq_chars = []
        fr, fgc, fb = AvgMeter(), AvgMeter(), AvgMeter()
        br, bgc, bb = AvgMeter(), AvgMeter(), AvgMeter()
        for t, chid in enumerate(seq):
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
            seq_chars.append(ch)
            if bool(has_fg[t]):
                fr(int(fg[t, 0] * 255))
                fgc(int(fg[t, 1] * 255))
                fb(int(fg[t, 2] * 255))
            if bool(has_bg[t]):
                br(int(bg[t, 0] * 255))
                bgc(int(bg[t, 1] * 255))
                bb(int(bg[t, 2] * 255))
            else:
                br(int(fg[t, 0] * 255))
                bgc(int(fg[t, 1] * 255))
                bb(int(fg[t, 2] * 255))
        txt = ''.join(seq_chars)
        if not txt:
            return None, None
        clamp = lambda v: min(max(int(v), 0), 255)
        return txt, (clamp(fr()), clamp(fgc()), clamp(fb()),
                     clamp(br()), clamp(bgc()), clamp(bb()))
