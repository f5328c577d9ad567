"""Wire schema for translation responses.

Contract from reference ``server/to_json.py:36-110``: the Translation record
(minX/minY/maxX/maxY, isBulletedList, angle, prob, fg/bg colors, per-language
text map, base64 background PNG) and its little-endian binary encoding — the
byte layout is fixed by the reference's shipped C++/Rust client decoders
(examples/response.cpp / response.rs).
"""
from __future__ import annotations

import base64
import struct
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
from pydantic import BaseModel, ConfigDict, Field

from ..utils.generic import Context


class TextColor(BaseModel):
    fg: Tuple[int, int, int]
    bg: Tuple[int, int, int]


class Translation(BaseModel):
    model_config = ConfigDict(arbitrary_types_allowed=True)

    minX: int
    minY: int
    maxX: int
    maxY: int
    is_bulleted_list: bool
    angle: float
    prob: float
    text_color: TextColor
    text: Dict[str, str]
    background: Optional[np.ndarray] = Field(default=None, exclude=True)

    def background_b64(self) -> str:
        if self.background is None:
            return ''
        _, buffer = cv2.imencode('.png', self.background)
        return ('data:image/png;base64,'
                + base64.b64encode(buffer).decode('utf-8'))

    def to_json_dict(self) -> dict:
        d = self.model_dump(exclude={'background'})
        d['background'] = self.background_b64()
        return d

    def to_bytes(self) -> bytes:
        """Little-endian struct layout matching examples/response.{cpp,rs}."""
        out = struct.pack('4i', self.minX, self.minY, self.maxX, self.maxY)
        out += struct.pack('?', self.is_bulleted_list)
        out += struct.pack('f', float(self.angle))
        out += struct.pack('f', float(self.prob))
        out += struct.pack('3B', *self.text_color.fg)
        out += struct.pack('3B', *self.text_color.bg)
        out += struct.pack('i', len(self.text))
        for key, value in self.text.items():
            kb, vb = key.encode('utf-8'), value.encode('utf-8')
            out += struct.pack('I', len(kb)) + kb
            out += struct.pack('I', len(vb)) + vb
        bg = self.background.tobytes() if self.background is not None else b''
        out += struct.pack('I', len(bg)) + bg
        return out


def _load_native_codec():
    """Native C++ codec (native/wirecodec.cpp) — byte-identical output,
    single-buffer encoding for large batch responses."""
    import importlib
    import os
    import sys
    native_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), 'native')
    if native_dir not in sys.path and os.path.isdir(native_dir):
        sys.path.append(native_dir)
    try:
        return importlib.import_module('wirecodec')
    except ImportError:
        return None


_native_codec = _load_native_codec()


class TranslationResponse(BaseModel):
    translations: List[Translation]
    debug_folder: Optional[str] = None

    def to_bytes(self) -> bytes:
        if _native_codec is not None:
            items = []
            for t in self.translations:
                items.append({
                    'minX': t.minX, 'minY': t.minY, 'maxX': t.maxX,
                    'maxY': t.maxY,
                    'is_bulleted_list': t.is_bulleted_list,
                    'angle': float(t.angle), 'prob': float(t.prob),
                    'fg': tuple(t.text_color.fg),
                    'bg': tuple(t.text_color.bg),
                    'text': t.text,
                    'background': (t.background.tobytes()
                                   if t.background is not None else b''),
                })
            return _native_codec.encode(items)
        items = [t.to_bytes() for t in self.translations]
        return struct.pack('i', len(items)) + b''.join(items)

    def to_bytes_python(self) -> bytes:
        items = [t.to_bytes() for t in self.translations]
        return struct.pack('i', len(items)) + b''.join(items)

    def to_json_dict(self) -> dict:
        return {'translations': [t.to_json_dict()
                                 for t in self.translations],
                'debug_folder': self.debug_folder}


def to_translation(ctx: Context) -> TranslationResponse:
    text_regions = ctx.get('text_regions') or []
    inpaint = ctx.get('img_inpainted')
    translations = ctx.get('translations') or {}
    results = []
    for i, region in enumerate(text_regions):
        minX, minY, maxX, maxY = [int(v) for v in region.xyxy]
        trans = {key: value[i] for key, value in translations.items()
                 if i < len(value)}
        trans[region.source_lang] = region.text
        if getattr(region, 'translation', ''):
            trans[region.target_lang] = region.translation
        region.adjust_bg_color = False
        fg, bg = region.get_font_colors()
        # clipped to the page: a box may reach past its edges (a negative
        # start would otherwise wrap around and give an empty crop)
        background = (inpaint[max(minY, 0):maxY, max(minX, 0):maxX]
                      if inpaint is not None else None)
        if background is not None and background.size == 0:
            background = None
        results.append(Translation(
            minX=minX, minY=minY, maxX=maxX, maxY=maxY,
            is_bulleted_list=region.is_bulleted_list,
            angle=float(region.angle), prob=float(region.prob),
            text_color=TextColor(fg=tuple(int(v) for v in fg),
                                 bg=tuple(int(v) for v in bg)),
            text=trans, background=background))
    return TranslationResponse(translations=results)
