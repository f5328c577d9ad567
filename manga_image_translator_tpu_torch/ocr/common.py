"""OCR base classes (contract: reference ocr/common.py:12-63)."""
from __future__ import annotations

import itertools
from abc import abstractmethod
from collections import Counter
from typing import List, Union

import networkx as nx
import numpy as np

from ..config import OcrConfig
from ..utils.geometry import Quadrilateral, can_merge_textline
from ..utils.inference import InfererModule, ModelWrapper
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
        for (u, ubox), (v, vbox) in itertools.combinations(
                enumerate(bboxes), 2):
            if can_merge_textline(ubox, vbox, aspect_ratio_tol=1):
                G.add_edge(u, v)
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

    def _sorted_crops(self, image: np.ndarray, textlines, height: int):
        """The lines with their directions (``_generate_text_direction``),
        their host cv2 crops at ``height`` (the device-crop path waits for
        ROADMAP A.14), the order to read them in (by crop width for
        quadrilaterals), and whether the lines are quadrilaterals."""
        quads = list(self._generate_text_direction(textlines))
        crops = [q.get_transformed_region(image, d, height)
                 for q, d in quads]
        order = list(range(len(quads)))
        is_quads = bool(quads and isinstance(quads[0][0], Quadrilateral))
        if is_quads:
            order.sort(key=lambda i: crops[i].shape[1])
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


def chunks(lst, n):
    for i in range(0, len(lst), n):
        yield lst[i:i + n]
