"""Two-stage LLM translators (chatgpt_2stage / gemini_2stage).

Contract from reference ``translators/chatgpt_2stage.py`` and
``gemini_2stage.py``: stage 1 translates with the standard numbered prompt;
stage 2 feeds the page image with drawn region boxes to a vision model to
verify/correct region-text association. The 2-stage translate() signature
takes the pipeline Context instead of use_mtpe (reference
translators/__init__.py:110-113).
"""
from __future__ import annotations

import base64
from typing import List, Optional

from .chatgpt import OpenAITranslator
from .gemini import GeminiTranslator


class _TwoStageMixin:
    async def translate(self, from_lang: str, to_lang: str,
                        queries: List[str], args=None) -> List[str]:
        translations = await super().translate(from_lang, to_lang, queries,
                                               use_mtpe=False)
        ctx = args if isinstance(args, dict) else None
        image = ctx.get('img_rgb') if ctx else None
        regions = ctx.get('text_regions') if ctx else None
        if image is None or not regions:
            return translations
        try:
            return await self._stage2_check(image, regions, queries,
                                            translations, to_lang)
        except Exception as e:
            self.logger.warning(f'2nd stage skipped: {e}')
            return translations

    async def _stage2_check(self, image, regions, queries: List[str],
                            translations: List[str], to_lang: str
                            ) -> List[str]:
        import cv2
        import numpy as np
        img = np.ascontiguousarray(image.copy())
        for i, region in enumerate(regions):
            x1, y1, x2, y2 = [int(v) for v in region.xyxy]
            cv2.rectangle(img, (x1, y1), (x2, y2), (255, 0, 0), 3)
            cv2.putText(img, str(i + 1), (x1, max(y1 - 4, 12)),
                        cv2.FONT_HERSHEY_SIMPLEX, 1.0, (255, 0, 0), 2)
        ok, buf = cv2.imencode('.png', cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        if not ok:
            return translations
        b64 = base64.b64encode(buf.tobytes()).decode()
        prompt = ('The image shows a manga page with numbered text regions. '
                  'Check the following translations against the visual '
                  'context and return corrected translations in the same '
                  '<|n|> format:\n')
        prompt += '\n'.join(f'<|{i + 1}|>{t}'
                            for i, t in enumerate(translations))
        messages = [
            {'role': 'user', 'content': [
                {'type': 'text', 'text': prompt},
                {'type': 'image_url',
                 'image_url': {'url': f'data:image/png;base64,{b64}'}},
            ]},
        ]
        response = await self._request(messages)
        fixed = self._parse_response(response, len(translations))
        return [f or t for f, t in zip(fixed, translations)]


class ChatGPT2StageTranslator(_TwoStageMixin, OpenAITranslator):
    pass


class Gemini2StageTranslator(_TwoStageMixin, GeminiTranslator):
    pass
