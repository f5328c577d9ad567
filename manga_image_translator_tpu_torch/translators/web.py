"""Classic web-API translators: deepl / youdao / baidu / papago / caiyun.

Contracts from the reference's per-service files (translators/deepl.py,
youdao.py, baidu.py, papago.py, caiyun.py): same language-code maps, same
endpoints, keys from environment. All are thin async REST clients.
"""
from __future__ import annotations

import asyncio
import hashlib
import random
import time
import uuid
from typing import List

import aiohttp

from . import keys
from .common import (
    CommonTranslator,
    InvalidServerResponse,
    MissingAPIKeyException,
)


async def _post_json(url: str, *, data=None, json_payload=None, headers=None,
                     timeout_s: int = 40):
    timeout = aiohttp.ClientTimeout(total=timeout_s)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        async with session.post(url, data=data, json=json_payload,
                                headers=headers) as resp:
            return await resp.json(content_type=None)


class DeeplTranslator(CommonTranslator):
    _LANGUAGE_CODE_MAP = {
        'CHS': 'ZH', 'CHT': 'ZH', 'CSY': 'CS', 'NLD': 'NL', 'ENG': 'EN-US',
        'FRA': 'FR', 'DEU': 'DE', 'HUN': 'HU', 'ITA': 'IT', 'JPN': 'JA',
        'KOR': 'KO', 'POL': 'PL', 'PTB': 'PT-BR', 'ROM': 'RO', 'RUS': 'RU',
        'ESP': 'ES', 'TRK': 'TR', 'UKR': 'UK', 'IND': 'ID',
    }

    def __init__(self):
        super().__init__()
        if not keys.DEEPL_AUTH_KEY:
            raise MissingAPIKeyException(
                'Please set the DEEPL_AUTH_KEY environment variable.')

    async def _translate(self, from_lang: str, to_lang: str,
                         queries: List[str]) -> List[str]:
        base = ('https://api-free.deepl.com'
                if keys.DEEPL_AUTH_KEY.endswith(':fx')
                else 'https://api.deepl.com')
        data = [('text', q) for q in queries]
        data.append(('target_lang', to_lang))
        if from_lang != 'auto' and from_lang:
            data.append(('source_lang', from_lang.split('-')[0]))
        result = await _post_json(
            f'{base}/v2/translate', data=data,
            headers={'Authorization':
                     f'DeepL-Auth-Key {keys.DEEPL_AUTH_KEY}'})
        if 'translations' not in result:
            raise InvalidServerResponse(str(result)[:300])
        return [t['text'] for t in result['translations']]


class YoudaoTranslator(CommonTranslator):
    _LANGUAGE_CODE_MAP = {
        'CHS': 'zh-CHS', 'CHT': 'zh-CHT', 'ENG': 'en', 'JPN': 'ja',
        'KOR': 'ko', 'FRA': 'fr', 'DEU': 'de', 'ESP': 'es', 'PTB': 'pt',
        'RUS': 'ru', 'VIN': 'vi', 'ARA': 'ar', 'NLD': 'nl', 'ITA': 'it',
        'THA': 'th', 'IND': 'id',
    }
    _API_URL = 'https://openapi.youdao.com/api'

    def __init__(self):
        super().__init__()
        if not keys.YOUDAO_APP_KEY or not keys.YOUDAO_SECRET_KEY:
            raise MissingAPIKeyException(
                'Please set the YOUDAO_APP_KEY and YOUDAO_SECRET_KEY '
                'environment variables.')

    @staticmethod
    def _truncate(q: str) -> str:
        if len(q) <= 20:
            return q
        return q[:10] + str(len(q)) + q[-10:]

    async def _translate(self, from_lang: str, to_lang: str,
                         queries: List[str]) -> List[str]:
        out = []
        for q in queries:
            salt = str(uuid.uuid1())
            curtime = str(int(time.time()))
            sign_str = (keys.YOUDAO_APP_KEY + self._truncate(q) + salt
                        + curtime + keys.YOUDAO_SECRET_KEY)
            sign = hashlib.sha256(sign_str.encode()).hexdigest()
            data = {
                'q': q, 'from': from_lang or 'auto', 'to': to_lang,
                'appKey': keys.YOUDAO_APP_KEY, 'salt': salt, 'sign': sign,
                'signType': 'v3', 'curtime': curtime,
            }
            result = await _post_json(self._API_URL, data=data)
            if result.get('errorCode') != '0':
                raise InvalidServerResponse(str(result)[:300])
            out.append(result['translation'][0])
        return out


class BaiduTranslator(CommonTranslator):
    _LANGUAGE_CODE_MAP = {
        'CHS': 'zh', 'CHT': 'cht', 'ENG': 'en', 'JPN': 'jp', 'KOR': 'kor',
        'FRA': 'fra', 'DEU': 'de', 'ESP': 'spa', 'PTB': 'pt', 'RUS': 'ru',
        'VIN': 'vie', 'ARA': 'ara', 'NLD': 'nl', 'ITA': 'it', 'POL': 'pl',
        'ROM': 'rom', 'CSY': 'cs', 'HUN': 'hu', 'THA': 'th',
    }
    _API_URL = 'https://fanyi-api.baidu.com/api/trans/vip/translate'

    def __init__(self):
        super().__init__()
        if not keys.BAIDU_APP_ID or not keys.BAIDU_SECRET_KEY:
            raise MissingAPIKeyException(
                'Please set the BAIDU_APP_ID and BAIDU_SECRET_KEY '
                'environment variables.')

    async def _translate(self, from_lang: str, to_lang: str,
                         queries: List[str]) -> List[str]:
        text = '\n'.join(queries)
        salt = str(random.randint(32768, 65536))
        sign = hashlib.md5((keys.BAIDU_APP_ID + text + salt
                            + keys.BAIDU_SECRET_KEY).encode()).hexdigest()
        data = {'q': text, 'from': from_lang or 'auto', 'to': to_lang,
                'appid': keys.BAIDU_APP_ID, 'salt': salt, 'sign': sign}
        result = await _post_json(self._API_URL, data=data)
        if 'trans_result' not in result:
            raise InvalidServerResponse(str(result)[:300])
        return [item['dst'] for item in result['trans_result']]


class PapagoTranslator(CommonTranslator):
    _LANGUAGE_CODE_MAP = {
        'CHS': 'zh-CN', 'CHT': 'zh-TW', 'ENG': 'en', 'JPN': 'ja',
        'KOR': 'ko', 'FRA': 'fr', 'DEU': 'de', 'ESP': 'es', 'RUS': 'ru',
        'VIN': 'vi', 'THA': 'th', 'IND': 'id', 'ITA': 'it',
    }
    _API_URL = 'https://naveropenapi.apigw.ntruss.com/nmt/v1/translation'

    def __init__(self):
        super().__init__()
        if not keys.PAPAGO_CLIENT_ID or not keys.PAPAGO_SECRET_KEY:
            raise MissingAPIKeyException(
                'Please set the PAPAGO_CLIENT_ID and PAPAGO_SECRET_KEY '
                'environment variables.')

    async def _translate(self, from_lang: str, to_lang: str,
                         queries: List[str]) -> List[str]:
        out = []
        headers = {
            'X-NCP-APIGW-API-KEY-ID': keys.PAPAGO_CLIENT_ID,
            'X-NCP-APIGW-API-KEY': keys.PAPAGO_SECRET_KEY,
        }
        for q in queries:
            data = {'source': from_lang if from_lang != 'auto' else 'auto',
                    'target': to_lang, 'text': q}
            result = await _post_json(self._API_URL, data=data,
                                      headers=headers)
            try:
                out.append(result['message']['result']['translatedText'])
            except KeyError:
                raise InvalidServerResponse(str(result)[:300])
        return out


class CaiyunTranslator(CommonTranslator):
    _LANGUAGE_CODE_MAP = {
        'CHS': 'zh', 'ENG': 'en', 'JPN': 'ja',
    }
    _API_URL = 'http://api.interpreter.caiyunai.com/v1/translator'

    def __init__(self):
        super().__init__()
        if not keys.CAIYUN_TOKEN:
            raise MissingAPIKeyException(
                'Please set the CAIYUN_TOKEN environment variable.')

    async def _translate(self, from_lang: str, to_lang: str,
                         queries: List[str]) -> List[str]:
        direction = (f'{from_lang}2{to_lang}'
                     if from_lang != 'auto' else f'auto2{to_lang}')
        payload = {'source': queries, 'trans_type': direction,
                   'request_id': 'manga-image-translator-tpu',
                   'detect': from_lang == 'auto'}
        headers = {'content-type': 'application/json',
                   'x-authorization': f'token {keys.CAIYUN_TOKEN}'}
        result = await _post_json(self._API_URL, json_payload=payload,
                                  headers=headers)
        if 'target' not in result:
            raise InvalidServerResponse(str(result)[:300])
        return result['target']
