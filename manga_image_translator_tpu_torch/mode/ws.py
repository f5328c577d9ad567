"""WebSocket worker mode.

Contract from reference ``mode/ws.py:14-264``: the worker connects OUT to a
central server over websocket and processes translation tasks pushed to it.
The reference's protobuf module (``ws_pb2``) is generated code that is not
checked into its repo; this implementation speaks a JSON-framed equivalent
(msg: {"type": "new_task", "id", "image_b64", "config"} →
{"type": "status"|"result"|"error", ...}) over the same connection flow.
The worker's translator runs on the CUDA card; it raises without one
unless a Python caller passes ``use_gpu=False``.
"""
from __future__ import annotations

import asyncio
import base64
import io
import json
from typing import Optional

from PIL import Image

from ..config import Config
from ..manga_translator import MangaTranslator, logger


class MangaTranslatorWS(MangaTranslator):
    def __init__(self, params: Optional[dict] = None):
        super().__init__(params)
        params = params or {}
        self.url = params.get('ws_url', 'ws://localhost:5000')
        self.secret = params.get('ws_secret') or params.get('nonce', '')
        self._current_ws = None

    async def listen(self, translation_params: Optional[dict] = None):
        import websockets
        headers = {'x-secret': self.secret} if self.secret else None
        # websockets >= 14 renamed extra_headers -> additional_headers
        hdr_kw = ('additional_headers'
                  if 'additional_headers' in
                  __import__('inspect').signature(
                      websockets.connect).parameters
                  else 'extra_headers')
        while True:
            try:
                async with websockets.connect(
                        self.url, max_size=1 << 30,
                        **{hdr_kw: headers}) as ws:
                    self._current_ws = ws
                    logger.info(f'Connected to {self.url}')
                    async for raw in ws:
                        await self._handle_message(ws, raw)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.warning(f'WS connection lost: {e}; retrying in 5s')
                await asyncio.sleep(5)

    async def _handle_message(self, ws, raw):
        try:
            msg = json.loads(raw)
        except (ValueError, TypeError):
            return
        if msg.get('type') != 'new_task':
            return
        task_id = msg.get('id')

        async def hook(state: str, finished: bool):
            await ws.send(json.dumps(
                {'type': 'status', 'id': task_id, 'status': state}))

        self.add_progress_hook(hook)
        try:
            image = Image.open(io.BytesIO(
                base64.b64decode(msg['image_b64'])))
            config = Config(**(msg.get('config') or {}))
            ctx = await self.translate(image, config)
            buf = io.BytesIO()
            if ctx.result is not None:
                ctx.result.save(buf, format='PNG')
            await ws.send(json.dumps({
                'type': 'result', 'id': task_id,
                'image_b64': base64.b64encode(buf.getvalue()).decode(),
            }))
        except Exception as e:
            await ws.send(json.dumps(
                {'type': 'error', 'id': task_id, 'error': str(e)}))
        finally:
            self._progress_hooks.remove(hook)
