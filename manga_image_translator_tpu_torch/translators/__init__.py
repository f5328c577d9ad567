"""Translator stage: registry, chain dispatch, batch dispatch.

Contract from reference ``translators/__init__.py:32-167``. Every
``Translator`` name has a factory; all but ``none``, ``original`` and
``offline`` import their module at first use, so a machine without
``aiohttp`` or ``transformers`` runs the others.
"""
from __future__ import annotations

from typing import List, Optional

from ..config import Translator, TranslatorChain, TranslatorConfig
from ..utils.generic import Context
from ..utils.textblock import _simple_langid
from .common import (
    VALID_LANGUAGES,
    ISO_639_1_TO_VALID_LANGUAGES,
    CommonTranslator,
    InvalidServerResponse,
    LanguageUnsupportedException,
    MissingAPIKeyException,
    MTPEAdapter,
    OfflineTranslator,
)
from .trivial import NoneTranslator, OriginalTranslator
from .selective import SelectiveOfflineTranslator, prepare as prepare_selective


def _lazy(module: str, cls: str):
    def factory():
        import importlib
        mod = importlib.import_module(f'.{module}', __package__)
        return getattr(mod, cls)()
    factory.__name__ = cls
    return factory


OFFLINE_TRANSLATORS = {
    Translator.offline: SelectiveOfflineTranslator,
    Translator.nllb: _lazy('hf_offline', 'NLLBTranslator'),
    Translator.nllb_big: _lazy('hf_offline', 'NLLBBigTranslator'),
    Translator.sugoi: _lazy('ct2_offline', 'SugoiTranslator'),
    Translator.jparacrawl: _lazy('ct2_offline', 'JparacrawlTranslator'),
    Translator.jparacrawl_big: _lazy('ct2_offline', 'JparacrawlBigTranslator'),
    Translator.m2m100: _lazy('ct2_offline', 'M2M100Translator'),
    Translator.m2m100_big: _lazy('ct2_offline', 'M2M100BigTranslator'),
    Translator.m2m100_hf: _lazy('hf_offline', 'M2M100HFTranslator'),
    Translator.m2m100_hf_big: _lazy('hf_offline', 'M2M100HFBigTranslator'),
    Translator.mbart50: _lazy('hf_offline', 'MBart50Translator'),
    Translator.qwen2: _lazy('hf_offline', 'Qwen2Translator'),
    Translator.qwen2_big: _lazy('hf_offline', 'Qwen2BigTranslator'),
}

GPT_TRANSLATORS = {
    Translator.chatgpt: _lazy('chatgpt', 'OpenAITranslator'),
    Translator.chatgpt_2stage: _lazy('two_stage', 'ChatGPT2StageTranslator'),
    Translator.deepseek: _lazy('chatgpt', 'DeepseekTranslator'),
    Translator.groq: _lazy('chatgpt', 'GroqTranslator'),
    Translator.custom_openai: _lazy('chatgpt', 'CustomOpenAiTranslator'),
    Translator.gemini: _lazy('gemini', 'GeminiTranslator'),
    Translator.gemini_2stage: _lazy('two_stage', 'Gemini2StageTranslator'),
}

TRANSLATORS = {
    Translator.youdao: _lazy('web', 'YoudaoTranslator'),
    Translator.baidu: _lazy('web', 'BaiduTranslator'),
    Translator.deepl: _lazy('web', 'DeeplTranslator'),
    Translator.papago: _lazy('web', 'PapagoTranslator'),
    Translator.caiyun: _lazy('web', 'CaiyunTranslator'),
    Translator.none: NoneTranslator,
    Translator.original: OriginalTranslator,
    Translator.sakura: _lazy('sakura', 'SakuraTranslator'),
    **GPT_TRANSLATORS,
    **OFFLINE_TRANSLATORS,
}

translator_cache = {}


def get_translator(key: Translator) -> CommonTranslator:
    if key not in TRANSLATORS:
        raise ValueError(f'Could not find translator for: "{key}". Choose '
                         f'from the following: %s' % ','.join(
                             str(k) for k in TRANSLATORS))
    if key not in translator_cache:
        translator_cache[key] = TRANSLATORS[key]()
    return translator_cache[key]


prepare_selective(get_translator)


async def dispatch(chain: TranslatorChain, queries: List[str],
                   translator_config: Optional[TranslatorConfig] = None,
                   use_mtpe: bool = False, args: Optional[Context] = None,
                   device: str = 'cuda') -> List[str]:
    if not queries:
        return queries

    if chain.target_lang is not None:
        for i, (key, lang) in enumerate(chain.chain):
            translator = get_translator(chain.translators[i])
            if isinstance(translator, OfflineTranslator):
                await translator.load('auto', chain.langs[i], device)
            if translator_config:
                translator.parse_args(translator_config)
            if key in (Translator.gemini_2stage, Translator.chatgpt_2stage):
                queries = await translator.translate('auto', chain.langs[i],
                                                     queries, args)
            else:
                queries = await translator.translate('auto', chain.langs[i],
                                                     queries, use_mtpe)
            await translator.unload(device)
        return queries

    if args is not None:
        args['translations'] = {}
    for key, tgt_lang in chain.chain:
        translator = get_translator(key)
        if isinstance(translator, OfflineTranslator):
            await translator.load('auto', tgt_lang, device)
        if translator_config:
            translator.parse_args(translator_config)
        if key in (Translator.gemini_2stage, Translator.chatgpt_2stage):
            queries = await translator.translate('auto', tgt_lang, queries,
                                                 args)
        else:
            queries = await translator.translate('auto', tgt_lang, queries,
                                                 use_mtpe)
        if args is not None:
            args['translations'][tgt_lang] = queries
    return queries


async def dispatch_batch(chain: TranslatorChain,
                         batch_queries: List[List[str]],
                         translator_config: Optional[TranslatorConfig] = None,
                         use_mtpe: bool = False,
                         args: Optional[Context] = None,
                         device: str = 'cuda') -> List[List[str]]:
    """Flatten page batches into one translator call, then regroup
    (reference translators/__init__.py:134-167)."""
    if not batch_queries or not any(batch_queries):
        return batch_queries
    flat_queries: List[str] = []
    mapping: List[int] = []
    for batch_idx, queries in enumerate(batch_queries):
        for query in queries:
            flat_queries.append(query)
            mapping.append(batch_idx)
    flat_results = await dispatch(chain, flat_queries, translator_config,
                                  use_mtpe, args, device)
    batch_results: List[List[str]] = [[] for _ in batch_queries]
    for result, batch_idx in zip(flat_results, mapping):
        batch_results[batch_idx].append(result)
    return batch_results


LANGDETECT_MAP = ISO_639_1_TO_VALID_LANGUAGES
