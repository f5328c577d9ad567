"""Sakura translator: local llama.cpp-style JP→CN model behind an
OpenAI-compatible API (contract: reference translators/sakura.py — dict
injection for v0.10, galtransl-style prompts)."""
from __future__ import annotations

import os
from typing import Dict, List

from . import keys
from .chatgpt import OpenAITranslator


class SakuraTranslator(OpenAITranslator):
    _LANGUAGE_CODE_MAP = {'JPN': 'ja', 'CHS': 'zh-CN', 'CHT': 'zh-TW'}
    _INVALID_REPEAT_COUNT = 1

    def __init__(self):
        super().__init__()
        self.api_key = 'sk-sakura'
        self.api_base = keys.SAKURA_API_BASE
        self.model = 'sukinishiro'
        self.version = keys.SAKURA_VERSION
        self.dict_path = keys.SAKURA_DICT_PATH
        self.temperature = 0.1
        self.top_p = 0.3

    def _check_keys(self):
        pass  # local server, no key

    def _load_sakura_dict(self) -> Dict[str, str]:
        terms = {}
        if self.dict_path and os.path.isfile(self.dict_path):
            with open(self.dict_path, encoding='utf8') as f:
                for line in f:
                    parts = line.rstrip('\n').split('\t')
                    if len(parts) >= 2 and parts[0]:
                        terms[parts[0]] = parts[1]
        return terms

    async def _translate(self, from_lang: str, to_lang: str,
                         queries: List[str]) -> List[str]:
        text = '\n'.join(queries)
        system = ('你是一个轻小说翻译模型，可以流畅通顺地以日本轻小说的风格'
                  '将日文翻译成简体中文，并联系上下文正确使用人称代词，不擅自'
                  '添加原文中没有的代词。')
        if self.version == '0.10':
            terms = {k: v for k, v in self._load_sakura_dict().items()
                     if k in text}
            if terms:
                gloss = '\n'.join(f'{k}->{v}' for k, v in terms.items())
                user = (f'根据以下术语表（可以为空）：\n{gloss}\n'
                        f'将下面的日文文本根据对应关系和备注翻译成中文：{text}')
            else:
                user = f'将下面的日文文本翻译成中文：{text}'
        else:
            user = f'将下面的日文文本翻译成中文：{text}'
        messages = [{'role': 'system', 'content': system},
                    {'role': 'user', 'content': user}]
        response = await self._request(messages)
        lines = response.split('\n')
        if len(lines) < len(queries):
            lines.extend([''] * (len(queries) - len(lines)))
        return lines[:len(queries)]
