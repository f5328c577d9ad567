"""manga-ocr backend (``mocr``) — PyTorch port.

Counterpart of the JAX package's ``ocr/model_manga_ocr.py`` (reference
``ocr/model_manga_ocr.py:25-295``): text comes from the
kha-white/manga-ocr-base VisionEncoderDecoder model through
``transformers`` (imported when the backend loads, never at import);
colours, and the lines' texts where that model reads nothing, come from the
port's 48px model, so its decode runs K2 and K3 on the card; the optional
``use_mocr_merge`` merges nearby boxes before recognition. The text model
and its inputs live on the device the backend was loaded on; a failure of
that model raises, where the JAX package logs it and keeps the 48px text.
"""
from __future__ import annotations

import itertools
from typing import List, Tuple

import networkx as nx
import numpy as np
from PIL import Image

from ..config import OcrConfig
from ..device import device_named
from ..utils.geometry import Quadrilateral, can_merge_textline
from .common import OfflineOCR
from .model_48px import Model48pxOCR

MOCR_HF_ID = 'kha-white/manga-ocr-base'


async def merge_bboxes(textlines: List[Quadrilateral], width: int,
                       height: int) -> Tuple[List[Quadrilateral], List[List[int]]]:
    """Merge overlapping/nearby boxes for whole-bubble recognition
    (reference model_manga_ocr.py:25-88 uses the textline-merge graph)."""
    G = nx.Graph()
    G.add_nodes_from(range(len(textlines)))
    for (u, ub), (v, vb) in itertools.combinations(enumerate(textlines), 2):
        if can_merge_textline(ub, vb, aspect_ratio_tol=1.3,
                              font_size_ratio_tol=2, char_gap_tolerance=1,
                              char_gap_tolerance2=3):
            G.add_edge(u, v)
    merged: List[Quadrilateral] = []
    merged_idx: List[List[int]] = []
    for comp in nx.connected_components(G):
        nodes = sorted(comp)
        pts = np.concatenate([textlines[i].pts for i in nodes])
        x1, y1 = pts.min(axis=0)
        x2, y2 = pts.max(axis=0)
        quad = Quadrilateral(np.array([[x1, y1], [x2, y1], [x2, y2],
                                       [x1, y2]]), '', 1.0)
        merged.append(quad)
        merged_idx.append(nodes)
    return merged, merged_idx


class ModelMangaOCR(OfflineOCR):
    _MODEL_MAPPING = dict(Model48pxOCR._MODEL_MAPPING)

    def __init__(self):
        super().__init__()
        self.mocr_model = None
        self.mocr_processor = None
        self.mocr_tokenizer = None
        self.device = None
        self.color_model = Model48pxOCR()

    async def _load(self, device: str):
        self.device = device_named(device)
        self._load_text_model()
        await self.color_model.load(device)

    def _load_text_model(self):
        """The Hugging Face model (``transformers`` and its weights), on
        ``self.device``."""
        from transformers import (
            AutoImageProcessor,
            AutoTokenizer,
            VisionEncoderDecoderModel,
        )
        self.mocr_model = VisionEncoderDecoderModel.from_pretrained(
            MOCR_HF_ID).to(self.device)
        self.mocr_model.eval()
        self.mocr_processor = AutoImageProcessor.from_pretrained(MOCR_HF_ID)
        self.mocr_tokenizer = AutoTokenizer.from_pretrained(MOCR_HF_ID)

    async def _unload(self):
        self.mocr_model = None
        await self.color_model.unload()

    def _mocr_text(self, img: np.ndarray) -> str:
        import torch
        pil = Image.fromarray(img).convert('L').convert('RGB')
        pixel_values = self.mocr_processor(
            pil, return_tensors='pt').pixel_values.to(self.device)
        with torch.no_grad():
            generated = self.mocr_model.generate(pixel_values,
                                                 max_length=300)[0]
        text = self.mocr_tokenizer.decode(generated, skip_special_tokens=True)
        return text.replace(' ', '')

    async def _infer(self, image: np.ndarray,
                     textlines: List[Quadrilateral], config: OcrConfig,
                     verbose: bool = False) -> List[Quadrilateral]:
        # colors (and a fallback text) from the 48px model
        regions = await self.color_model._infer(image, textlines, config,
                                                verbose)

        if config.use_mocr_merge:
            merged, merged_idx = await merge_bboxes(
                regions, image.shape[1], image.shape[0])
        else:
            merged = regions
            merged_idx = [[i] for i in range(len(regions))]

        for quad, idx_group in zip(merged, merged_idx):
            d = 'h' if quad.aspect_ratio >= 1 else 'v'
            textheight = int(quad.aabb.w if d == 'h' else quad.aabb.h)
            crop = quad.get_transformed_region(image, 'h',
                                               max(min(textheight, 1024), 16))
            # a failure of the text model raises: it never leaves a line
            # with its 48px text unnoticed
            text = self._mocr_text(crop)
            if not text:
                continue
            if len(idx_group) == 1 and idx_group[0] < len(regions):
                regions[idx_group[0]].text = text
            elif idx_group and idx_group[0] < len(regions):
                regions[idx_group[0]].text = text
                for j in idx_group[1:]:
                    if j < len(regions):
                        regions[j].text = ''
        return [r for r in regions if r.text]
