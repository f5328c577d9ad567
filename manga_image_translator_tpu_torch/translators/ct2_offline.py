"""CTranslate2-model offline NMT: sugoi / jparacrawl / m2m100.

Contracts from reference ``translators/sugoi.py`` and ``m2m100.py``: the
same released model archives (ct2-converted weights + sentencepiece
models), unpacked by hand under ``MIT_TPU_MODEL_DIR/translators`` (the
``archive`` maps below give the layout; the port never downloads). The
native ctranslate2/sentencepiece libraries are not required: the model.bin
parses through translators/ct2_model.py and the spm models through
utils/spm_lite.py, with the transformer running in PyTorch on the device
``load`` is given. A ct2 model has no random-weight fallback: a missing
file raises ``MissingWeightsError`` naming its path."""
from __future__ import annotations

import re
from pathlib import Path
from typing import List

from ..utils.inference import MissingWeightsError
from .common import OfflineTranslator


def chunks(lst, n):
    for i in range(0, len(lst), n):
        yield lst[i:i + n]


class _CT2Translator(OfflineTranslator):
    """Base: one ct2 model dir per language pair + spm models
    (reference sugoi.py:14-29 archive layout)."""

    # lang-pair -> model dir relative to the archive root
    _CT2_MODEL_FOLDERS = {}
    _SPM_DIR = ''
    _DEFAULT_PAIR = ('ja', 'en')

    def __init__(self):
        super().__init__()
        self.model = None
        self.sp = {}
        self._loaded_pair = None
        self.device = None

    def _require(self, path: Path) -> Path:
        if not path.exists():
            raise MissingWeightsError(
                f'{type(self).__name__}: {path} not found (ct2 models have '
                f'no random-weight fallback; unpack the released archive '
                f'under MIT_TPU_MODEL_DIR)')
        return path

    def _read_model(self, model_dir: Path):
        from .ct2_model import (Ct2Transformer, load_vocabulary,
                                read_config, read_ct2_model)
        variables = read_ct2_model(str(self._require(model_dir /
                                                     'model.bin')))
        src_v, tgt_v = load_vocabulary(str(model_dir))
        return Ct2Transformer(variables, read_config(str(model_dir)), src_v,
                              tgt_v, device=self.device)

    def _resolve_pair(self, from_lang: str, to_lang: str):
        if from_lang == 'auto':
            from_lang = self._DEFAULT_PAIR[0] if to_lang != \
                self._DEFAULT_PAIR[0] else self._DEFAULT_PAIR[1]
        return from_lang, to_lang

    def _load_pair(self, from_lang: str, to_lang: str):
        from ..utils import spm_lite
        pair = f'{from_lang}-{to_lang}'
        folder = self._CT2_MODEL_FOLDERS.get(pair)
        if folder is None:
            raise ValueError(f'unsupported language pair {pair} for '
                             f'{type(self).__name__}')
        self.model = None           # the previous pair's weights go first
        self.model = self._read_model(self._get_file_path(folder))
        for lang in (from_lang, to_lang):
            p = self._require(self._get_file_path(
                f'{self._SPM_DIR}/spm.{lang}.nopretok.model'))
            self.sp[lang] = spm_lite.SentencePieceModel.load(str(p))
        self._loaded_pair = (from_lang, to_lang)

    async def load(self, from_lang: str = 'auto', to_lang: str = 'ENG',
                   device: str = 'cuda'):
        """``ModelWrapper.load`` without its random-weight fallback: the
        files are read by ``_load`` (m2m100) or at a language pair's first
        translation (the pair is not known here), and a missing one raises
        naming its path."""
        if not self.is_loaded:
            await self._load(device)
            self._loaded = True

    async def _load(self, device: str):
        self.device = device

    async def _unload(self):
        self.model = None
        self.sp = {}
        self._loaded_pair = None

    def tokenize(self, queries: List[str], lang: str) -> List[List[str]]:
        sp = self.sp[lang]
        return [sp.encode(q, out_type=str) for q in queries]

    def detokenize(self, token_lists: List[List[str]], lang: str
                   ) -> List[str]:
        sp = self.sp[lang]
        return [sp.decode(toks) for toks in token_lists]

    async def _infer(self, from_lang: str, to_lang: str,
                     queries: List[str]) -> List[str]:
        from_lang, to_lang = self._resolve_pair(from_lang, to_lang)
        if self._loaded_pair != (from_lang, to_lang):
            self._load_pair(from_lang, to_lang)
        tokenized = self.tokenize(queries, from_lang)
        results = self.model.translate_batch(
            tokenized, beam_size=5, repetition_penalty=3.0)
        return self.detokenize(results, to_lang)


class JparacrawlTranslator(_CT2Translator):
    """JParaCrawl ja<->en NMT (reference sugoi.py:9-120)."""

    _LANGUAGE_CODE_MAP = {'JPN': 'ja', 'ENG': 'en'}
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/jparacrawl-base-models.zip',
            'hash': 'e98e0fa35a80d2bc48c16673914639db66da1013ec66cc7b79119cdd3b542ebb',
            # real zip layout (reference sugoi.py:18-29): root-level spm
            # models + ct2 model dirs, moved into jparacrawl/
            'archive': {
                'spm.ja.nopretok.model': 'jparacrawl/',
                'spm.en.nopretok.model': 'jparacrawl/',
                'base-ja-en': 'jparacrawl/base-ja-en',
                'base-en-ja': 'jparacrawl/base-en-ja',
            },
        },
    }
    _CT2_MODEL_FOLDERS = {'ja-en': 'jparacrawl/base-ja-en',
                          'en-ja': 'jparacrawl/base-en-ja'}
    _SPM_DIR = 'jparacrawl'


class JparacrawlBigTranslator(JparacrawlTranslator):
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/jparacrawl-big-models.zip',
            'hash': '5e0c4cea5a5098152f566de3694602ed3db52927d3df22d2a7bfb8dba2bebe33',
            # reference sugoi.py:129-145 layout
            'archive': {
                'spm.ja.nopretok.model': 'jparacrawl/',
                'spm.en.nopretok.model': 'jparacrawl/',
                'big-ja-en': 'jparacrawl/big-ja-en',
                'big-en-ja': 'jparacrawl/big-en-ja',
            },
        },
    }
    _CT2_MODEL_FOLDERS = {'ja-en': 'jparacrawl/big-ja-en',
                          'en-ja': 'jparacrawl/big-en-ja'}
    _SPM_DIR = 'jparacrawl'


class SugoiTranslator(JparacrawlBigTranslator):
    """Sugoi V4 ja->en (reference sugoi.py:121-209) — en->ja falls back to
    jparacrawl-big. Splits queries into <=2-sentence chunks with '.'->'@'
    protection, rejoining after translation (reference :179-209)."""

    _LANGUAGE_CODE_MAP = {'JPN': 'ja', 'ENG': 'en'}
    _MODEL_MAPPING = {
        **JparacrawlBigTranslator._MODEL_MAPPING,
        'model-sugoi': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/sugoi-models.zip',
            'hash': '67e060a62dc16211157a5eaa4fa8f72c86db5999fc69322606a6fcdf57f587f7',
            # reference sugoi.py:155-166 layout
            'archive': {
                'spm.ja.nopretok.model': 'sugoi/',
                'spm.en.nopretok.model': 'sugoi/',
                'big-ja-en': 'sugoi/big-ja-en',
            },
        },
    }
    _CT2_MODEL_FOLDERS = {'ja-en': 'sugoi/big-ja-en',
                          'en-ja': 'jparacrawl/big-en-ja'}

    def __init__(self):
        super().__init__()
        self.query_split_sizes: List[int] = []

    def _spm_dir_for(self, lang_pair: str) -> str:
        return 'sugoi' if lang_pair == 'ja-en' else 'jparacrawl'

    def _load_pair(self, from_lang: str, to_lang: str):
        self._SPM_DIR = self._spm_dir_for(f'{from_lang}-{to_lang}')
        super()._load_pair(from_lang, to_lang)

    def tokenize(self, queries: List[str], lang: str) -> List[List[str]]:
        if lang == 'ja':
            new_queries = []
            self.query_split_sizes = []
            for q in queries:
                sentences = re.split(r'(\w[.‥…!?。・]+)', q)
                chunk_queries = []
                for chunk in chunks(sentences, 4):
                    s = ''.join(chunk)
                    chunk_queries.append(re.sub(r'[.。]', '@', s))
                self.query_split_sizes.append(len(chunk_queries))
                new_queries.extend(chunk_queries)
            queries = new_queries
        return super().tokenize(queries, lang)

    def detokenize(self, token_lists: List[List[str]], lang: str
                   ) -> List[str]:
        translations = super().detokenize(token_lists, lang)
        if lang == 'en' and self.query_split_sizes:
            rejoined = []
            i = 0
            for count in self.query_split_sizes:
                s = ' '.join(translations[i:i + count])
                i += count
                rejoined.append(s.replace('@', '.').replace('▁', ' ')
                                .replace('<unk>', ''))
            translations = rejoined
        return translations


class M2M100Translator(_CT2Translator):
    """m2m100 ct2-converted (reference m2m100.py)."""

    _LANGUAGE_CODE_MAP = {
        'CHS': '__zh__', 'CHT': '__zh__', 'CSY': '__cs__', 'NLD': '__nl__',
        'ENG': '__en__', 'FRA': '__fr__', 'DEU': '__de__', 'HUN': '__hu__',
        'ITA': '__it__', 'JPN': '__ja__', 'KOR': '__ko__', 'POL': '__pl__',
        'PTB': '__pt__', 'ROM': '__ro__', 'RUS': '__ru__', 'ESP': '__es__',
        'TRK': '__tr__', 'UKR': '__uk__', 'VIN': '__vi__', 'ARA': '__ar__',
        'SRP': '__sr__', 'HRV': '__hr__', 'THA': '__th__', 'IND': '__id__',
        'FIL': '__tl__',
    }
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/m2m100_418m_ct2.zip',
            'hash': '8a9cd0e00505a7879f26e5a1b396b447bc29967783a1e17e8df5eecb0c13d1c3',
            # reference m2m100.py:46-52: whole model dir at zip root
            'archive': {'m2m100_418m/': '.'},
        },
    }
    _CT2_MODEL_DIR = 'm2m100_418m'

    async def _load(self, device: str):
        from ..utils import spm_lite
        self.device = device
        model_dir = self._get_file_path(self._CT2_MODEL_DIR)
        self.model = self._read_model(model_dir)
        self.spm = spm_lite.SentencePieceModel.load(
            str(self._require(model_dir / 'sentencepiece.model')))
        self._loaded_pair = ('multi', 'multi')

    async def _infer(self, from_lang: str, to_lang: str,
                     queries: List[str]) -> List[str]:
        # language-token prefix on source + FORCED target language prefix
        # (reference m2m100.py:82-91: target_prefix=[[to_lang]]) — without
        # the forcing the model free-runs and picks its own output
        # language (ADVICE r2 high #2)
        tokenized = [[from_lang] + self.spm.encode(q, out_type=str)
                     for q in queries]
        results = self.model.translate_batch(
            tokenized, beam_size=5,
            target_prefix=[[to_lang]] * len(queries))
        out = []
        for toks in results:
            toks = [t for t in toks if not (t.startswith('__')
                                            and t.endswith('__'))]
            out.append(self.spm.decode(toks))
        return out


class M2M100BigTranslator(M2M100Translator):
    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/m2m100_12b_ct2.zip',
            'hash': '742d5380c2837affd3680339145d37fc78f537ad633958347b76e9be9c577662',
            'archive': {'m2m100_12b/': '.'},
        },
    }
    _CT2_MODEL_DIR = 'm2m100_12b'
