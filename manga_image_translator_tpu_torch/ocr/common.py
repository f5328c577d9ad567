"""OCR base classes (contract: reference ocr/common.py:12-63)."""
from __future__ import annotations

import os
from abc import abstractmethod
from collections import Counter
from typing import List, Union

import networkx as nx
import numpy as np
import torch

from ..config import OcrConfig
from ..ops import warp
from ..utils.geometry import Quadrilateral, merge_graph_edges
from ..utils.inference import InfererModule, ModelWrapper
from ..utils.profiling import span
from ..utils.textblock import TextBlock


class CommonOCR(InfererModule):

    def _generate_text_direction(self, bboxes: List[Union[Quadrilateral,
                                                          TextBlock]]):
        """Group quads into regions (merge-predicate graph CCs), majority-vote
        direction per region, and yield (quad, direction) in reading order."""
        if len(bboxes) == 0:
            return
        if isinstance(bboxes[0], TextBlock):
            for blk in bboxes:
                for line_idx in range(len(blk.lines)):
                    yield blk, line_idx
            return
        G = nx.Graph()
        G.add_nodes_from(range(len(bboxes)))
        G.add_edges_from(merge_graph_edges(bboxes, aspect_ratio_tol=1))
        for node_set in nx.algorithms.components.connected_components(G):
            nodes = list(node_set)
            dirs = [bboxes[i].direction for i in nodes]
            majority_dir = Counter(dirs).most_common(1)[0][0]
            if majority_dir == 'h':
                nodes = sorted(
                    nodes, key=lambda i: bboxes[i].aabb.y + bboxes[i].aabb.h // 2)
            elif majority_dir == 'v':
                nodes = sorted(
                    nodes, key=lambda i: -(bboxes[i].aabb.x + bboxes[i].aabb.w))
            for node in nodes:
                yield bboxes[node], majority_dir

    def _sorted_crops(self, image: np.ndarray, textlines, height: int,
                      mode: str = 'host'):
        """The lines with their directions (``_generate_text_direction``),
        their crops at ``height``, the order to read them in (by crop width
        for quadrilaterals), and whether the lines are quadrilaterals.

        ``mode`` picks where quadrilaterals are cropped: ``'host'`` (cv2
        warps, ``HostCrops``), ``'gather'`` (every chunk on the device,
        ``ops.warp.crop_batch_auto``) or ``'auto'`` (the separable device
        resampler with the rotated quads warped on the host and patched in,
        unless more than half of the quads are rotated: then the host). The
        device paths return ``DeviceCrops``, which hold crop plans; the
        page moves to ``self.device`` once."""
        with span('ocr.plan'):
            quads = list(self._generate_text_direction(textlines))
            is_quads = bool(quads and isinstance(quads[0][0], Quadrilateral))
            crops = None
            if is_quads and mode != 'host':
                crops = DeviceCrops.plan(image, quads, height, mode,
                                         self.device)
            if crops is None:
                crops = HostCrops([q.get_transformed_region(image, d, height)
                                   for q, d in quads], self.device)
            order = list(range(len(quads)))
            if is_quads:
                order.sort(key=crops.width)
            return quads, crops, order, is_quads

    async def recognize(self, image: np.ndarray,
                        textlines: List[Quadrilateral], config: OcrConfig,
                        verbose: bool = False) -> List[Quadrilateral]:
        return await self._recognize(image, textlines, config, verbose)

    @abstractmethod
    async def _recognize(self, image, textlines, config, verbose):
        ...


class OfflineOCR(CommonOCR, ModelWrapper):
    _MODEL_SUB_DIR = 'ocr'

    def __init__(self):
        ModelWrapper.__init__(self)

    async def _recognize(self, *args, **kwargs):
        return await self.infer(*args, **kwargs)


class AvgMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def __call__(self, val=None):
        if val is not None:
            self.sum += val
            self.count += 1
        return self.sum / self.count if self.count > 0 else 0


def pad_chunk(crops: List[np.ndarray], indices: List[int], rows: int,
              width: int, skip=None):
    """The crops ``indices`` zero-padded into one (rows, height, width, 3)
    uint8 batch, each cut at ``width``; each row's valid width; and the
    rows left empty because ``skip(crop)`` held."""
    height = crops[indices[0]].shape[0]
    batch = np.zeros((rows, height, width, 3), np.uint8)
    widths = np.zeros((rows,), np.int32)
    skipped = set()
    for i, idx in enumerate(indices):
        if skip is not None and skip(crops[idx]):
            skipped.add(i)
            continue
        w = min(crops[idx].shape[1], width)
        batch[i, :, :w] = crops[idx][:, :w]
        widths[i] = w
    return batch, widths, skipped


def opt_in_crop_mode() -> str:
    """Where the 32px and 48px_ctc OCRs crop: on the host unless
    ``MIT_TPU_DEVICE_CROPS=1`` asks for the device gather path
    (``'gather'``), as in the JAX package."""
    return ('gather' if os.environ.get('MIT_TPU_DEVICE_CROPS', '0') == '1'
            else 'host')


class HostCrops:
    """cv2 crops made on the host, padded into chunks and uploaded."""

    def __init__(self, crops: List[np.ndarray], device):
        self.crops = crops
        self.device = device

    def width(self, i: int) -> int:
        return self.crops[i].shape[1]

    def chunk(self, indices: List[int], rows: int, width: int, skip=None):
        """(rows, height, width, 3) f32 images in /127.5 - 1 on the
        device, the (rows,) int32 valid widths and the rows ``skip`` left
        empty."""
        batch, widths, skipped = pad_chunk(self.crops, indices, rows, width,
                                           skip)
        images = (torch.from_numpy(batch).to(self.device).float()
                  / 127.5 - 1.0)
        return images, widths, skipped


class DeviceCrops:
    """Crop plans of a page that lives on the device; each chunk's crops
    are resampled there (``ops.warp``)."""

    def __init__(self, page: torch.Tensor, plans, host_regions: dict,
                 mode: str, height: int):
        self.page = page
        self.plans = plans
        self.host_regions = host_regions
        self.mode = mode
        self.height = height

    @classmethod
    def plan(cls, image: np.ndarray, quads, height: int, mode: str, device):
        """Plan every quad (``warp.crop_plan_quad``). In ``'auto'`` mode
        probe each at its own width (chunk buckets are only wider, so
        separable here is separable at the bucket width): None when more
        than half fail, else the failing quads are cv2-warped now, to be
        patched over their rows."""
        plans = [warp.crop_plan_quad(q, d, height) for q, d in quads]
        host_regions = {}
        if mode == 'auto':
            sep = [warp.separable_plan(H, height, w, warp.SEP_SRC_H,
                                       2 * w) is not None
                   for w, H in plans]
            if sum(not s for s in sep) * 2 > len(sep):
                return None
            for i, ok in enumerate(sep):
                if not ok:
                    q, d = quads[i]
                    host_regions[i] = q.get_transformed_region(image, d,
                                                               height)
        page = torch.from_numpy(np.ascontiguousarray(image)).to(device)
        return cls(page, plans, host_regions, mode, height)

    def width(self, i: int) -> int:
        return self.plans[i][0]

    def chunk(self, indices: List[int], rows: int, width: int, skip=None):
        """As ``HostCrops.chunk`` (``skip`` is a host-crop test, unused
        here: the OCRs that skip crops keep host crops while they do)."""
        valid = np.zeros((rows,), np.int32)
        valid[:len(indices)] = [min(self.width(i), width) for i in indices]
        if self.mode == 'auto':
            images = warp.crop_chunk_mixed(
                self.page, self.plans, list(indices), self.host_regions,
                valid, self.height, width, rows)
        else:
            Hs = np.stack([self.plans[i][1] for i in indices]
                          + [warp._DEGENERATE_H] * (rows - len(indices)))
            images = warp.crop_batch_auto(self.page, Hs, valid, self.height,
                                          width)
        return images, valid, set()


def set_line_result(region, txt: str, prob: float, colors) -> None:
    """Write one recognised line (its text, probability and fg/bg colours
    ``(fr, fg, fb, br, bg, bb)``) into its Quadrilateral, or append it to
    its TextBlock."""
    fr, fg, fb, br, bg, bb = colors
    if isinstance(region, Quadrilateral):
        region.text = txt
        region.prob = prob
        region.fg_r, region.fg_g, region.fg_b = fr, fg, fb
        region.bg_r, region.bg_g, region.bg_b = br, bg, bb
    else:
        region.text.append(txt)
        region.update_font_colors(np.array([fr, fg, fb]),
                                  np.array([br, bg, bb]))


def tokens_read(sequences: np.ndarray, end: int) -> int:
    """The tokens of the best sequences (N, L) up to and including each
    one's first ``end``; all L where there is none (the loop ran L
    steps)."""
    ended = sequences == end
    return int(np.where(ended.any(axis=1), ended.argmax(axis=1) + 1,
                        sequences.shape[1]).sum())


def chunks(lst, n):
    for i in range(0, len(lst), n):
        yield lst[i:i + n]
