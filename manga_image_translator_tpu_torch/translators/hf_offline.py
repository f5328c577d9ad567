"""Offline NMT translators backed by HuggingFace transformers.

Contracts from reference ``translators/nllb.py``, ``m2m100_hf.py``,
``mbart50.py``, ``qwen2.py`` — same model checkpoints and language maps.
``transformers`` is imported only when one of these loads (a machine
without it raises an ``ImportError`` naming it); the model and its inputs
live on the device ``load`` is given. Model weights come from the HF hub
cache; in offline environments loading raises a clear error instead of
silently degrading.
"""
from __future__ import annotations

from typing import List

from ..device import device_named
from .common import OfflineTranslator


class _HFSeq2SeqTranslator(OfflineTranslator):
    _HF_MODEL_ID = ''
    _MODEL_MAPPING = {}

    def __init__(self):
        super().__init__()
        self.model = None
        self.tokenizer = None

    def is_downloaded(self) -> bool:
        # delegated to the HF hub cache: from_pretrained raises when the
        # model is absent
        return True

    async def _load(self, device: str):
        from transformers import AutoModelForSeq2SeqLM, AutoTokenizer
        self.device = device_named(device)
        self.tokenizer = AutoTokenizer.from_pretrained(self._HF_MODEL_ID)
        self.model = AutoModelForSeq2SeqLM.from_pretrained(
            self._HF_MODEL_ID).to(self.device)
        self.model.eval()

    async def _unload(self):
        self.model = None
        self.tokenizer = None

    def _tokenizer_kwargs(self, from_lang: str, to_lang: str) -> dict:
        return {}

    def _generate_kwargs(self, from_lang: str, to_lang: str) -> dict:
        return {}

    async def _infer(self, from_lang: str, to_lang: str,
                     queries: List[str]) -> List[str]:
        import torch
        if from_lang == 'auto':
            from_lang = self._detect_lang(queries)
        tok_kwargs = self._tokenizer_kwargs(from_lang, to_lang)
        if 'src_lang' in tok_kwargs:
            self.tokenizer.src_lang = tok_kwargs['src_lang']
        inputs = self.tokenizer(queries, return_tensors='pt', padding=True,
                                truncation=True,
                                max_length=512).to(self.device)
        with torch.no_grad():
            generated = self.model.generate(
                **inputs, max_length=512,
                **self._generate_kwargs(from_lang, to_lang))
        return self.tokenizer.batch_decode(generated,
                                           skip_special_tokens=True)

    def _detect_lang(self, queries: List[str]) -> str:
        from ..utils.textblock import _simple_langid
        iso = _simple_langid('\n'.join(queries))
        return {'ja': 'JPN', 'ko': 'KOR', 'zh': 'CHS', 'ru': 'RUS',
                'ar': 'ARA', 'en': 'ENG'}.get(iso, 'ENG')


class NLLBTranslator(_HFSeq2SeqTranslator):
    _HF_MODEL_ID = 'facebook/nllb-200-distilled-600M'
    _LANGUAGE_CODE_MAP = {
        'CHS': 'zho_Hans', 'CHT': 'zho_Hant', 'CSY': 'ces_Latn',
        'NLD': 'nld_Latn', 'ENG': 'eng_Latn', 'FRA': 'fra_Latn',
        'DEU': 'deu_Latn', 'HUN': 'hun_Latn', 'ITA': 'ita_Latn',
        'JPN': 'jpn_Jpan', 'KOR': 'kor_Hang', 'POL': 'pol_Latn',
        'PTB': 'por_Latn', 'ROM': 'ron_Latn', 'RUS': 'rus_Cyrl',
        'ESP': 'spa_Latn', 'TRK': 'tur_Latn', 'UKR': 'ukr_Cyrl',
        'VIN': 'vie_Latn', 'ARA': 'arb_Arab', 'SRP': 'srp_Cyrl',
        'HRV': 'hrv_Latn', 'THA': 'tha_Thai', 'IND': 'ind_Latn',
        'FIL': 'tgl_Latn',
    }

    def _tokenizer_kwargs(self, from_lang, to_lang):
        return {'src_lang': from_lang}

    def _generate_kwargs(self, from_lang, to_lang):
        return {'forced_bos_token_id':
                self.tokenizer.convert_tokens_to_ids(to_lang)}


class NLLBBigTranslator(NLLBTranslator):
    _HF_MODEL_ID = 'facebook/nllb-200-1.3B'


class M2M100HFTranslator(_HFSeq2SeqTranslator):
    _HF_MODEL_ID = 'facebook/m2m100_418M'
    _LANGUAGE_CODE_MAP = {
        'CHS': 'zh', 'CHT': 'zh', 'CSY': 'cs', 'NLD': 'nl', 'ENG': 'en',
        'FRA': 'fr', 'DEU': 'de', 'HUN': 'hu', 'ITA': 'it', 'JPN': 'ja',
        'KOR': 'ko', 'POL': 'pl', 'PTB': 'pt', 'ROM': 'ro', 'RUS': 'ru',
        'ESP': 'es', 'TRK': 'tr', 'UKR': 'uk', 'VIN': 'vi', 'ARA': 'ar',
        'SRP': 'sr', 'HRV': 'hr', 'THA': 'th', 'IND': 'id', 'FIL': 'tl',
    }

    def _tokenizer_kwargs(self, from_lang, to_lang):
        return {'src_lang': from_lang}

    def _generate_kwargs(self, from_lang, to_lang):
        return {'forced_bos_token_id':
                self.tokenizer.get_lang_id(to_lang)}


class M2M100HFBigTranslator(M2M100HFTranslator):
    _HF_MODEL_ID = 'facebook/m2m100_1.2B'


class MBart50Translator(_HFSeq2SeqTranslator):
    _HF_MODEL_ID = 'facebook/mbart-large-50-many-to-many-mmt'
    _LANGUAGE_CODE_MAP = {
        'CHS': 'zh_CN', 'CHT': 'zh_CN', 'CSY': 'cs_CZ', 'NLD': 'nl_XX',
        'ENG': 'en_XX', 'FRA': 'fr_XX', 'DEU': 'de_DE', 'ITA': 'it_IT',
        'JPN': 'ja_XX', 'KOR': 'ko_KR', 'POL': 'pl_PL', 'PTB': 'pt_XX',
        'ROM': 'ro_RO', 'RUS': 'ru_RU', 'ESP': 'es_XX', 'TRK': 'tr_TR',
        'UKR': 'uk_UA', 'VIN': 'vi_VN', 'ARA': 'ar_AR', 'HRV': 'hr_HR',
        'THA': 'th_TH', 'IND': 'id_ID', 'FIL': 'tl_XX',
    }

    def _tokenizer_kwargs(self, from_lang, to_lang):
        return {'src_lang': from_lang}

    def _generate_kwargs(self, from_lang, to_lang):
        return {'forced_bos_token_id':
                self.tokenizer.lang_code_to_id[to_lang]}


class Qwen2Translator(OfflineTranslator):
    """Local Qwen2 instruct model as translator (reference qwen2.py)."""

    _HF_MODEL_ID = 'Qwen/Qwen2-1.5B-Instruct'
    _MODEL_MAPPING = {}
    _LANGUAGE_CODE_MAP = {k: k for k in (
        'CHS', 'CHT', 'CSY', 'NLD', 'ENG', 'FRA', 'DEU', 'HUN', 'ITA',
        'JPN', 'KOR', 'POL', 'PTB', 'ROM', 'RUS', 'ESP', 'TRK', 'UKR',
        'VIN', 'ARA', 'THA', 'IND')}

    def __init__(self):
        super().__init__()
        self.model = None
        self.tokenizer = None

    def is_downloaded(self) -> bool:
        return True                 # as above: the HF hub cache

    async def _load(self, device: str):
        from transformers import AutoModelForCausalLM, AutoTokenizer
        self.device = device_named(device)
        self.tokenizer = AutoTokenizer.from_pretrained(self._HF_MODEL_ID)
        self.model = AutoModelForCausalLM.from_pretrained(
            self._HF_MODEL_ID).to(self.device)
        self.model.eval()

    async def _unload(self):
        self.model = None
        self.tokenizer = None

    async def _infer(self, from_lang: str, to_lang: str,
                     queries: List[str]) -> List[str]:
        import torch
        from .common import VALID_LANGUAGES
        lang = VALID_LANGUAGES.get(to_lang, to_lang)
        prompt = ('Translate the following text into %s. Output each line '
                  'with its <|n|> prefix and only the translation.\n' % lang)
        prompt += '\n'.join(f'<|{i + 1}|>{q}' for i, q in enumerate(queries))
        messages = [{'role': 'user', 'content': prompt}]
        text = self.tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        inputs = self.tokenizer([text], return_tensors='pt').to(self.device)
        with torch.no_grad():
            out = self.model.generate(**inputs, max_new_tokens=1024)
        response = self.tokenizer.decode(
            out[0][inputs['input_ids'].shape[1]:], skip_special_tokens=True)
        import re
        results = [''] * len(queries)
        for num, t in re.findall(r'<\|(\d+)\|>([\s\S]*?)(?=<\|\d+\|>|$)',
                                 response):
            idx = int(num) - 1
            if 0 <= idx < len(queries):
                results[idx] = t.strip()
        return results


class Qwen2BigTranslator(Qwen2Translator):
    _HF_MODEL_ID = 'Qwen/Qwen2-7B-Instruct'
