"""Translator base classes.

Contract from reference ``translators/common.py:14-310``: the 25+1 language
codes, code-map resolution, rate limiting, invalid-translation repeat logic,
and output cleaning. Translators are host-side by design — they overlap with
device compute in the pipeline dispatcher.
"""
from __future__ import annotations

import asyncio
import re
import time
from abc import abstractmethod
from typing import Dict, List, Tuple, Union

from ..utils.generic import is_valuable_text, repeating_sequence
from ..utils.inference import InfererModule, ModelWrapper

VALID_LANGUAGES = {
    'CHS': 'Chinese (Simplified)',
    'CHT': 'Chinese (Traditional)',
    'CSY': 'Czech',
    'NLD': 'Dutch',
    'ENG': 'English',
    'FRA': 'French',
    'DEU': 'German',
    'HUN': 'Hungarian',
    'ITA': 'Italian',
    'JPN': 'Japanese',
    'KOR': 'Korean',
    'POL': 'Polish',
    'PTB': 'Portuguese (Brazil)',
    'ROM': 'Romanian',
    'RUS': 'Russian',
    'ESP': 'Spanish',
    'TRK': 'Turkish',
    'UKR': 'Ukrainian',
    'VIN': 'Vietnamese',
    'ARA': 'Arabic',
    'CNR': 'Montenegrin',
    'SRP': 'Serbian',
    'HRV': 'Croatian',
    'THA': 'Thai',
    'IND': 'Indonesian',
    'FIL': 'Filipino (Tagalog)',
}

ISO_639_1_TO_VALID_LANGUAGES = {
    'zh': 'CHS', 'ja': 'JPN', 'en': 'ENG', 'ko': 'KOR', 'vi': 'VIN',
    'cs': 'CSY', 'nl': 'NLD', 'fr': 'FRA', 'de': 'DEU', 'hu': 'HUN',
    'it': 'ITA', 'pl': 'POL', 'pt': 'PTB', 'ro': 'ROM', 'ru': 'RUS',
    'es': 'ESP', 'tr': 'TRK', 'uk': 'UKR', 'ar': 'ARA', 'cnr': 'CNR',
    'sr': 'SRP', 'hr': 'HRV', 'th': 'THA', 'id': 'IND', 'tl': 'FIL',
}


class InvalidServerResponse(Exception):
    pass


class MissingAPIKeyException(Exception):
    pass


class LanguageUnsupportedException(Exception):
    def __init__(self, language_code: str, translator: str = None,
                 supported_languages: List[str] = None):
        error = 'Language not supported for %s: "%s"' % (
            translator if translator else 'chosen translator', language_code)
        if supported_languages:
            error += '. Supported languages: "%s"' % ','.join(
                supported_languages)
        super().__init__(error)


class MTPEAdapter:
    """Interactive machine-translation post-editing (linux terminals)."""

    async def dispatch(self, queries: List[str],
                       translations: List[str]) -> List[str]:
        try:
            import readline
        except Exception:
            print('MTPE is currently only supported on linux')
            return translations
        new_translations = []
        print('Running Machine Translation Post Editing (MTPE)')
        for i, (query, translation) in enumerate(zip(queries, translations)):
            print(f'\n[{i + 1}/{len(queries)}] {query}:')
            readline.set_startup_hook(
                lambda: readline.insert_text(translation.replace('\n', '\\n')))
            try:
                new_translation = input(' -> ').replace('\\n', '\n')
            finally:
                readline.set_startup_hook()
            new_translations.append(new_translation)
        print()
        return new_translations


class CommonTranslator(InfererModule):
    # Language codes resolved through _LANGUAGE_CODE_MAP (dict) or passed
    # through (list).
    _LANGUAGE_CODE_MAP: Union[Dict[str, str], List[str]] = {}
    _INVALID_REPEAT_COUNT = 0
    _MAX_REQUESTS_PER_MINUTE = -1

    def __init__(self):
        super().__init__()
        self.mtpe_adapter = MTPEAdapter()
        self._last_request_ts = 0.0

    def parse_args(self, args):
        """Hook for per-request TranslatorConfig."""

    async def unload(self, device: str = None):
        pass

    def supports_languages(self, from_lang: str, to_lang: str,
                           fatal: bool = False) -> bool:
        supported = (list(self._LANGUAGE_CODE_MAP)
                     if self._LANGUAGE_CODE_MAP else list(VALID_LANGUAGES))
        if from_lang not in supported and from_lang != 'auto':
            if fatal:
                raise LanguageUnsupportedException(
                    from_lang, type(self).__name__, supported)
            return False
        if to_lang not in supported:
            if fatal:
                raise LanguageUnsupportedException(
                    to_lang, type(self).__name__, supported)
            return False
        return True

    def parse_language_codes(self, from_lang: str, to_lang: str,
                             fatal: bool = False) -> Tuple[str, str]:
        if not self._LANGUAGE_CODE_MAP or isinstance(
                self._LANGUAGE_CODE_MAP, list):
            return from_lang, to_lang
        _from = (self._LANGUAGE_CODE_MAP.get(from_lang)
                 if from_lang != 'auto' else 'auto')
        _to = self._LANGUAGE_CODE_MAP.get(to_lang)
        if fatal and (_to is None or (_from is None and from_lang != 'auto')):
            self.supports_languages(from_lang, to_lang, fatal=True)
        return _from, _to

    async def translate(self, from_lang: str, to_lang: str,
                        queries: List[str], use_mtpe: bool = False
                        ) -> List[str]:
        if to_lang not in VALID_LANGUAGES:
            raise ValueError(
                'Invalid language code: "%s". Choose from the following: %s'
                % (to_lang, ', '.join(VALID_LANGUAGES)))
        if from_lang not in VALID_LANGUAGES and from_lang != 'auto':
            raise ValueError(
                'Invalid language code: "%s". Choose from the following: '
                'auto, %s' % (from_lang, ', '.join(VALID_LANGUAGES)))
        self.logger.info(f'Translating into {VALID_LANGUAGES[to_lang]}')
        if from_lang == to_lang:
            return queries

        query_indices = []
        final_translations: List[str] = []
        for i, query in enumerate(queries):
            if not is_valuable_text(query):
                final_translations.append(queries[i])
            else:
                final_translations.append(None)
                query_indices.append(i)
        queries = [queries[i] for i in query_indices]
        if not queries:
            return final_translations

        translations = [''] * len(queries)
        untranslated = list(range(len(queries)))
        for attempt in range(1 + self._INVALID_REPEAT_COUNT):
            if attempt > 0:
                self.logger.warning(
                    f'Repeating because of invalid translation. '
                    f'Attempt: {attempt + 1}')
                await asyncio.sleep(0.1)
            await self._ratelimit_sleep()
            _translations = await self._translate(
                *self.parse_language_codes(from_lang, to_lang, fatal=True),
                queries)
            if len(_translations) < len(queries):
                _translations.extend([''] * (len(queries) - len(_translations)))
            else:
                _translations = _translations[:len(queries)]
            for j in untranslated:
                translations[j] = _translations[j]
            if self._INVALID_REPEAT_COUNT == 0:
                break
            still_invalid = []
            for j in untranslated:
                q, t = queries[j], translations[j]
                if self._is_translation_invalid(q, t):
                    still_invalid.append(j)
                    queries[j] = self._modify_invalid_translation_query(q, t)
            untranslated = still_invalid
            if not untranslated:
                break

        translations = [self._clean_translation_output(q, t, to_lang)
                        for q, t in zip(queries, translations)]

        if to_lang == 'ARA':
            try:
                import arabic_reshaper
                import bidi.algorithm
                translations = [bidi.algorithm.get_display(
                    arabic_reshaper.reshape(t)) for t in translations]
            except ImportError:
                pass

        if use_mtpe:
            translations = await self.mtpe_adapter.dispatch(queries,
                                                            translations)
        for i, trans in enumerate(translations):
            final_translations[query_indices[i]] = trans
            self.logger.info(f'{i}: {queries[i]} => {trans}')
        return final_translations

    @abstractmethod
    async def _translate(self, from_lang: str, to_lang: str,
                         queries: List[str]) -> List[str]:
        ...

    async def _ratelimit_sleep(self):
        if self._MAX_REQUESTS_PER_MINUTE > 0:
            now = time.time()
            deadline = self._last_request_ts + 60 / self._MAX_REQUESTS_PER_MINUTE
            if deadline > now:
                self.logger.info(f'Ratelimit sleep: {deadline - now:.2f}s')
                await asyncio.sleep(deadline - now)
            self._last_request_ts = time.time()

    def _is_translation_invalid(self, query: str, trans: str) -> bool:
        if not trans and query:
            return True
        if not query or not trans:
            return False
        query_symbols = len(set(query))
        trans_symbols = len(set(trans))
        if (query_symbols > 6 and trans_symbols < 6
                and trans_symbols < 0.25 * len(trans)):
            return True
        return False

    def _modify_invalid_translation_query(self, query: str,
                                          trans: str) -> str:
        return query

    def _clean_translation_output(self, query: str, trans: str,
                                  to_lang: str) -> str:
        """Spot and skim down degenerate model output."""
        if not query or not trans:
            return ''
        trans = re.sub(r'\s+', r' ', trans)
        trans = re.sub(r'(?<![.,;!?])([.,;!?])(?=\w)', r'\1 ', trans)
        trans = re.sub(r'([.,;!?])\s+(?=[.,;!?]|$)', r'\1', trans)
        if to_lang != 'ARA':
            trans = re.sub(r'(?<=[.,;!?\w])\s+([.,;!?])', r'\1', trans)
            trans = re.sub(r'((?:\s|^)\.+)\s+(?=\w)', r'\1', trans)
        seq = repeating_sequence(trans.lower())
        if len(trans) < len(query) and len(seq) < 0.5 * len(trans):
            trans = seq * max(len(query) // len(seq), 1)
            fixed = ''
            for i in range(min(len(trans), len(query))):
                fixed += trans[i].upper() if query[i].isupper() else trans[i]
            trans = fixed
        return trans


class OfflineTranslator(CommonTranslator, ModelWrapper):
    _MODEL_SUB_DIR = 'translators'

    def __init__(self):
        CommonTranslator.__init__(self)
        ModelWrapper.__init__(self)
        self.mtpe_adapter = MTPEAdapter()
        self._last_request_ts = 0.0

    async def _translate(self, from_lang: str, to_lang: str,
                         queries: List[str]) -> List[str]:
        return await self.infer(from_lang, to_lang, queries)

    @abstractmethod
    async def _infer(self, from_lang: str, to_lang: str,
                     queries: List[str]) -> List[str]:
        ...

    async def load(self, from_lang: str = 'auto', to_lang: str = 'ENG',
                   device: str = 'cuda'):
        if not self.is_loaded:
            await ModelWrapper.load(self, device)

    async def unload(self, device: str = None):
        pass
