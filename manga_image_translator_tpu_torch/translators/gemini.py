"""Gemini translator over the Generative Language REST API.

Contract from reference ``translators/gemini.py`` (same prompt method as the
chatgpt family); implemented with aiohttp against
generativelanguage.googleapis.com — no google-genai SDK dependency.
"""
from __future__ import annotations

import asyncio
import json
from typing import List

from . import keys
from .chatgpt import OpenAITranslator, _CHAT_SYSTEM_TEMPLATE
from .common import MissingAPIKeyException, VALID_LANGUAGES


class GeminiTranslator(OpenAITranslator):
    def __init__(self):
        super().__init__()
        self.api_key = keys.GEMINI_API_KEY
        self.model = keys.GEMINI_MODEL
        self.temperature = 0.3

    def _check_keys(self):
        if not self.api_key:
            raise MissingAPIKeyException(
                'Please set the GEMINI_API_KEY environment variable.')

    async def _request(self, messages: List[dict]) -> str:
        import aiohttp
        system_parts = [m['content'] for m in messages
                        if m['role'] == 'system']
        user_parts = [m['content'] for m in messages if m['role'] == 'user']
        url = (f'https://generativelanguage.googleapis.com/v1beta/models/'
               f'{self.model}:generateContent?key={self.api_key}')
        payload = {
            'system_instruction': {'parts': [{'text': '\n'.join(system_parts)}]},
            'contents': [{'role': 'user',
                          'parts': [{'text': '\n'.join(user_parts)}]}],
            'generationConfig': {'temperature': self.temperature,
                                 'topP': self.top_p},
            'safetySettings': [
                {'category': c, 'threshold': 'BLOCK_NONE'}
                for c in ('HARM_CATEGORY_HARASSMENT',
                          'HARM_CATEGORY_HATE_SPEECH',
                          'HARM_CATEGORY_SEXUALLY_EXPLICIT',
                          'HARM_CATEGORY_DANGEROUS_CONTENT')],
        }
        last_err = None
        for attempt in range(self._RETRY_ATTEMPTS):
            try:
                timeout = aiohttp.ClientTimeout(total=self._TIMEOUT)
                async with aiohttp.ClientSession(timeout=timeout) as session:
                    async with session.post(url, json=payload) as resp:
                        data = await resp.json()
                        if resp.status != 200:
                            raise RuntimeError(
                                f'HTTP {resp.status}: '
                                f'{json.dumps(data)[:500]}')
                        return data['candidates'][0]['content']['parts'][0][
                            'text']
            except Exception as e:
                last_err = e
                self.logger.warning(
                    f'Request attempt {attempt + 1} failed: {e}')
                await asyncio.sleep(1.5 * (attempt + 1))
        raise last_err
