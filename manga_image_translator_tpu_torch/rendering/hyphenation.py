"""Language-aware hyphenation for line breaking.

The reference uses pyhyphen (libhyphen + downloaded dictionaries,
rendering/text_render.py:582-611) and degrades to whole-word (<=3 chars) or
per-character splits without a dictionary. This module provides:

* a Knuth-Liang pattern engine that loads standard ``hyph_<lang>.dic``
  files (hunspell/libreoffice format) when present under
  ``$MIT_TPU_HYPHEN_DIR`` or ``fonts/hyphen/`` — drop-in offline support
  for any language;
* a built-in rule-based syllabifier for Latin scripts (vowel-nucleus
  splitting with onset maximization) so English-family text hyphenates
  sensibly even with no dictionary — strictly better than the reference's
  per-character fallback;
* the reference's fallback ladder on top (short words stay whole).

A copy of the JAX package's ``rendering/hyphenation.py`` without its
dictionary download: the port never downloads; dictionaries placed by hand
are used, and the rule syllabifier stays the fallback.
"""
from __future__ import annotations

import functools
import os
import re
from typing import Dict, List, Optional

_VOWELS = set('aeiouyáéíóúàèìòùâêîôûäëïöüœø')
# common onset clusters that should not be split (approximate English)
_ONSETS = {
    'bl', 'br', 'ch', 'cl', 'cr', 'dr', 'fl', 'fr', 'gl', 'gr', 'ph',
    'pl', 'pr', 'sc', 'sh', 'sk', 'sl', 'sm', 'sn', 'sp', 'st', 'sw',
    'th', 'tr', 'tw', 'wh', 'wr', 'sch', 'scr', 'shr', 'spl', 'spr',
    'squ', 'str', 'thr', 'qu',
}


class LiangHyphenator:
    """Knuth-Liang pattern hyphenation from a hyph_*.dic pattern file."""

    def __init__(self, patterns: List[str]):
        self.patterns: Dict[str, List[int]] = {}
        for pat in patterns:
            chars = re.sub(r'\d', '', pat)
            values = [0] * (len(chars) + 1)
            i = 0
            for ch in pat:
                if ch.isdigit():
                    values[i] = max(values[i], int(ch))
                else:
                    i += 1
            self.patterns[chars] = values

    @classmethod
    def from_file(cls, path: str) -> 'LiangHyphenator':
        pats = []
        with open(path, encoding='utf-8', errors='replace') as f:
            first = f.readline().strip()     # encoding line (ignored)
            if re.fullmatch(r'[\w-]+', first) is None and first:
                pats.append(first)
            for line in f:
                line = line.strip()
                if not line or line.startswith(('%', '#', 'LEFTHYPHENMIN',
                                                'RIGHTHYPHENMIN',
                                                'COMPOUNDLEFTHYPHENMIN',
                                                'COMPOUNDRIGHTHYPHENMIN')):
                    continue
                # hunspell non-standard extensions (with '/') unsupported
                pats.append(line.split('/')[0])
        return cls(pats)

    def positions(self, word: str) -> List[int]:
        w = f'.{word.lower()}.'
        points = [0] * (len(w) + 1)
        for start in range(len(w)):
            for end in range(start + 1, min(len(w), start + 9) + 1):
                vals = self.patterns.get(w[start:end])
                if vals:
                    for k, v in enumerate(vals):
                        points[start + k] = max(points[start + k], v)
        # odd values mark hyphen points; skip margins (min 2 chars each side)
        return [i - 1 for i in range(2, len(word) + 1 - 1)
                if points[i] % 2 == 1 and 2 <= i - 1 <= len(word) - 2]

    def syllables(self, word: str) -> List[str]:
        pos = self.positions(word)
        if not pos:
            return [word]
        out = []
        prev = 0
        for p in pos:
            out.append(word[prev:p])
            prev = p
        out.append(word[prev:])
        return [s for s in out if s]


def _rule_syllables(word: str) -> List[str]:
    """Vowel-nucleus syllabification for Latin script (fallback)."""
    lower = word.lower()
    if not any(c in _VOWELS for c in lower):
        return [word]
    # nuclei = maximal vowel groups
    groups = [(m.start(), m.end())
              for m in re.finditer(r'[aeiouyáéíóúàèìòùâêîôûäëïöüœø]+', lower)]
    if len(groups) <= 1:
        return [word]
    cuts = []
    for (s1, e1), (s2, e2) in zip(groups, groups[1:]):
        cluster = lower[e1:s2]
        if not cluster:
            cuts.append(e1)        # hiatus: split between vowels
            continue
        # onset maximization: give the largest known onset to the right
        cut = s2
        for take in range(min(3, len(cluster)), 0, -1):
            if cluster[-take:] in _ONSETS or take == 1:
                cut = s2 - take
                break
        cuts.append(max(cut, e1))
    out = []
    prev = 0
    for c in cuts:
        if c - prev >= 2 and len(word) - c >= 2:
            out.append(word[prev:c])
            prev = c
    out.append(word[prev:])
    return [s for s in out if s]


@functools.lru_cache(maxsize=16)
def _load_dict(lang: str) -> Optional[LiangHyphenator]:
    base = lang.replace('-', '_')
    cands = [base, base.split('_')[0]]
    dirs = [os.environ.get('MIT_TPU_HYPHEN_DIR', ''),
            os.path.join(os.path.dirname(__file__), '..', '..', 'fonts',
                         'hyphen')]
    for d in dirs:
        if not d:
            continue
        for c in cands:
            for name in (f'hyph_{c}.dic', f'{c}.dic'):
                path = os.path.join(d, name)
                if os.path.isfile(path):
                    try:
                        return LiangHyphenator.from_file(path)
                    except Exception:
                        pass
    return None


_LATIN_LANGS = ('en', 'de', 'fr', 'es', 'it', 'pt', 'nl', 'pl', 'cs', 'hu',
                'ro', 'hr', 'sr', 'tr', 'id', 'tl', 'vi')

# the app's 3-letter target codes -> ISO 639-1 (translators/common.py)
_APP_CODES = {
    'eng': 'en', 'deu': 'de', 'fra': 'fr', 'esp': 'es', 'ita': 'it',
    'ptb': 'pt_BR', 'nld': 'nl', 'pol': 'pl', 'csy': 'cs', 'hun': 'hu',
    'rom': 'ro', 'hrv': 'hr', 'srp': 'sr', 'trk': 'tr', 'ind': 'id',
    'fil': 'tl', 'vin': 'vi', 'rus': 'ru', 'ukr': 'uk', 'ara': 'ar',
    'tha': 'th', 'jpn': 'ja', 'kor': 'ko', 'chs': 'zh', 'cht': 'zh',
}


def syllables(word: str, language: str = 'en_US') -> List[str]:
    """Reference fallback ladder (text_render.py:641-652): dictionary
    syllables -> rule-based (Latin) -> whole word (<=3 chars) -> chars."""
    if len(word) <= 3:
        return [word]
    language = _APP_CODES.get(language.lower(), language)
    hyph = _load_dict(language)
    if hyph is not None:
        syls = hyph.syllables(word)
        if len(syls) > 1 or len(word) <= 6:
            return syls
    base = language.split('_')[0].split('-')[0].lower()
    if base in _LATIN_LANGS and word.isalpha():
        return _rule_syllables(word)
    return list(word)
