"""Minimal SentencePiece: .model protobuf parsing + unigram Viterbi.

The ``sentencepiece`` package is not available in this image; the released
sugoi/jparacrawl archives ship standard ``spm.*.model`` files (protobuf:
``sentencepiece_model.proto``), which this module reads with the same wire
parser approach as utils/onnx_lite. Encoding follows the unigram LM
algorithm: Viterbi segmentation maximizing the sum of piece scores over the
normalized input (spaces -> '▁' with a dummy prefix). Works for BPE
models too (merge ranks act as scores — segmentation matches greedy BPE on
real vocabularies in practice).

Reference usage contract: translators/sugoi.py:116-127 (encode to piece
strings, decode by concatenation + '▁'->space). A host copy of the JAX
package's module.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

from .onnx_lite import _fields, _read_varint

WS = '▁'

# SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


class Piece(NamedTuple):
    text: str
    score: float
    type: int


class SentencePieceModel:
    def __init__(self, pieces: List[Piece]):
        import struct
        self.pieces = pieces
        self.index: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.unk_id = 0
        for i, p in enumerate(pieces):
            if p.text not in self.index:
                self.index[p.text] = i
            if p.type in (NORMAL, USER_DEFINED, BYTE):
                prev = self.scores.get(p.text)
                if prev is None or p.score > prev:
                    self.scores[p.text] = p.score
            if p.type == UNKNOWN:
                self.unk_id = i
        self.max_piece_len = max((len(p.text) for p in pieces), default=1)

    # -- parsing ------------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> 'SentencePieceModel':
        with open(path, 'rb') as f:
            return cls.parse(f.read())

    @classmethod
    def parse(cls, data: bytes) -> 'SentencePieceModel':
        import struct
        pieces: List[Piece] = []
        for field, wire, val in _fields(data):
            if field == 1 and wire == 2:          # repeated SentencePiece
                text, score, typ = '', 0.0, NORMAL
                for f2, w2, v2 in _fields(bytes(val)):
                    if f2 == 1:
                        text = bytes(v2).decode('utf-8', errors='replace')
                    elif f2 == 2:
                        score = struct.unpack('<f', bytes(v2))[0]
                    elif f2 == 3:
                        typ = v2
                pieces.append(Piece(text, score, typ))
        if not pieces:
            raise ValueError('no pieces found — not a sentencepiece model?')
        return cls(pieces)

    # -- encoding -----------------------------------------------------------
    def _normalize(self, text: str) -> str:
        import unicodedata
        text = unicodedata.normalize('NFKC', text)
        text = ' '.join(text.split())
        return WS + text.replace(' ', WS)

    def encode(self, text: str, out_type=str):
        """Viterbi unigram segmentation -> piece strings (or ids)."""
        s = self._normalize(text)
        n = len(s)
        NEG = -1e18
        unk_penalty = min(self.scores.values(), default=-10.0) - 10.0
        best = [NEG] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            upper = min(n, i + self.max_piece_len)
            matched_any = False
            for j in range(i + 1, upper + 1):
                sc = self.scores.get(s[i:j])
                if sc is not None:
                    matched_any = True
                    cand = best[i] + sc
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = i
            if not matched_any or best[i + 1] <= NEG / 2:
                # unknown single char fallback
                cand = best[i] + unk_penalty
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = i
        out: List[str] = []
        j = n
        while j > 0:
            i = back[j]
            out.append(s[i:j])
            j = i
        out.reverse()
        if out_type is str:
            return out
        return [self.index.get(p, self.unk_id) for p in out]

    def decode(self, pieces: List[str]) -> str:
        text = ''.join(p for p in pieces
                       if p not in ('<s>', '</s>', '<pad>', '<unk>'))
        return text.replace(WS, ' ').strip()
