"""Offline translator selection by detected source language
(contract: reference translators/selective.py). The chosen translator loads
on the device this one was loaded with."""
from __future__ import annotations

from typing import List

from .common import OfflineTranslator

_get_translator = None


def prepare(get_translator_fn):
    global _get_translator
    _get_translator = get_translator_fn


class SelectiveOfflineTranslator(OfflineTranslator):
    """Picks the best offline translator for the detected source language."""

    _LANGUAGE_CODE_MAP = {}

    def __init__(self):
        super().__init__()
        self._real = None
        self.device = None

    def is_downloaded(self) -> bool:
        return True

    def _select_key(self, from_lang: str):
        from ..config import Translator
        if from_lang == 'JPN':
            # prefer the dedicated ja->en engines, fall back to the HF stack
            for key in (Translator.sugoi, Translator.m2m100_hf,
                        Translator.nllb):
                yield key
        else:
            for key in (Translator.m2m100_hf, Translator.nllb):
                yield key

    async def _load(self, device: str):
        self.device = device

    async def _infer(self, from_lang: str, to_lang: str,
                     queries: List[str]) -> List[str]:
        from ..utils.textblock import _simple_langid
        from .common import ISO_639_1_TO_VALID_LANGUAGES
        if from_lang == 'auto' or not from_lang:
            iso = _simple_langid('\n'.join(queries))
            from_lang = ISO_639_1_TO_VALID_LANGUAGES.get(iso, 'JPN')
        last_err = None
        for key in self._select_key(from_lang):
            try:
                translator = _get_translator(key)
                await translator.load('auto', to_lang, self.device)
                return await translator._translate(
                    *translator.parse_language_codes(from_lang, to_lang),
                    queries)
            except Exception as e:
                last_err = e
                self.logger.warning(f'{key} unavailable: {e}')
        raise last_err or RuntimeError('No offline translator available')
