"""Shared/executor mode: RPC server exposing MangaTranslator methods.

Contract from reference ``mode/share.py:47-174``: POST
``/simple_execute/{method}`` (pickled kwargs → pickled result) and
``/execute/{method}`` (streaming: 1-byte status + 4-byte big-endian length +
payload frames; status 0=result 1=progress 2=error), restricted-pickle
argument decoding, nonce auth, single-flight lock, ``/is_locked``.

Implemented with aiohttp (FastAPI/uvicorn are not part of this stack).
The executor's translator runs on the CUDA card; it raises without one
unless a Python caller passes ``use_gpu=False``.
"""
from __future__ import annotations

import asyncio
import io
import pickle
import secrets
import signal
import threading
from typing import Optional

from aiohttp import web

from ..manga_translator import MangaTranslator

_ALLOWED_PICKLE = {
    ('builtins', 'dict'), ('builtins', 'list'), ('builtins', 'tuple'),
    ('builtins', 'str'), ('builtins', 'int'), ('builtins', 'float'),
    ('builtins', 'bool'), ('builtins', 'bytes'), ('builtins', 'set'),
    ('collections', 'OrderedDict'),
    ('PIL.Image', 'Image'),
    ('numpy', 'ndarray'), ('numpy', 'dtype'),
    ('numpy.core.multiarray', '_reconstruct'),
    ('numpy._core.multiarray', '_reconstruct'),
}
# the port's own classes and PIL's; the JAX package's are refused
_ALLOWED_PREFIXES = ('manga_image_translator_tpu_torch.', 'PIL.',)


class RestrictedUnpickler(pickle.Unpickler):
    """Only allows framework/PIL/numpy types (reference share.py:27-37)."""

    def find_class(self, module, name):
        if (module, name) in _ALLOWED_PICKLE or any(
                module.startswith(p) for p in _ALLOWED_PREFIXES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f'global {module}.{name} is forbidden')


def restricted_loads(data: bytes):
    return RestrictedUnpickler(io.BytesIO(data)).load()


def _frame(status: int, payload: bytes) -> bytes:
    return bytes([status]) + len(payload).to_bytes(4, 'big') + payload


class MangaShare:
    def __init__(self, params: Optional[dict] = None):
        params = params or {}
        self.manga = MangaTranslator(params)
        self.host = params.get('host', '127.0.0.1')
        self.port = int(params.get('port', 5003))
        nonce = params.get('nonce')
        if not nonce:
            nonce = secrets.token_hex(16)
        if nonce == 'None':
            nonce = None
        self.nonce = nonce
        self.progress_queue: asyncio.Queue = asyncio.Queue()
        self.lock = threading.Lock()
        # progress frames are queued only while a streaming call reads
        # them: a simple call's would pile up unread
        self.streaming = False

        async def hook(state: str, finished: bool):
            if self.streaming:
                await self.progress_queue.put(_frame(1,
                                                     state.encode('utf8')))
            await asyncio.sleep(0)

        self.manga.add_progress_hook(hook)

    def check_nonce(self, request: web.Request):
        if self.nonce and request.headers.get('X-Nonce') != self.nonce:
            raise web.HTTPUnauthorized(text='Nonce does not match')

    def check_lock(self):
        if not self.lock.acquire(blocking=False):
            raise web.HTTPTooManyRequests(
                text='some Method is already being executed.')

    def get_fn(self, method_name: str):
        if method_name.startswith('__'):
            raise web.HTTPForbidden(
                text='These functions are not allowed to be executed '
                     'remotely')
        method = getattr(self.manga, method_name, None)
        if method is None:
            raise web.HTTPNotFound(text='Method not found')
        return method

    async def run_method(self, method, **attributes):
        try:
            if asyncio.iscoroutinefunction(method):
                result = await method(**attributes)
            else:
                result = method(**attributes)
            await self.progress_queue.put(_frame(0, pickle.dumps(result)))
        except Exception as e:
            await self.progress_queue.put(_frame(2, str(e).encode('utf8')))
        finally:
            self.streaming = False
            self.lock.release()

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=256 * 1024 * 1024)

        async def is_locked(request):
            return web.json_response({'locked': self.lock.locked()})

        async def simple_execute(request: web.Request):
            self.check_nonce(request)
            # resolve the method and decode args BEFORE taking the lock: a
            # 403/404/unpickle failure after acquisition would leak it and
            # wedge the executor into permanent 429 (caught by
            # tests/test_share.py::test_nonce_and_method_guards)
            method = self.get_fn(request.match_info['method_name'])
            attr = restricted_loads(await request.read())
            self.check_lock()
            try:
                if asyncio.iscoroutinefunction(method):
                    result = await method(**attr)
                else:
                    result = method(**attr)
            except Exception as e:
                raise web.HTTPInternalServerError(text=str(e))
            finally:
                self.lock.release()
            return web.Response(body=pickle.dumps(result),
                                content_type='application/octet-stream')

        async def execute(request: web.Request):
            self.check_nonce(request)
            method = self.get_fn(request.match_info['method_name'])
            attr = restricted_loads(await request.read())
            self.check_lock()
            resp = web.StreamResponse()
            resp.content_type = 'application/octet-stream'
            await resp.prepare(request)
            self.streaming = True
            task = asyncio.create_task(self.run_method(method, **attr))
            try:
                while True:
                    frame = await self.progress_queue.get()
                    await resp.write(frame)
                    if frame[0] != 1:
                        break
            finally:
                if not task.done():
                    task.cancel()
            await resp.write_eof()
            return resp

        app.router.add_get('/is_locked', is_locked)
        app.router.add_post('/simple_execute/{method_name}', simple_execute)
        app.router.add_post('/execute/{method_name}', execute)
        return app

    async def listen(self, translation_params: Optional[dict] = None):
        app = self.build_app()
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, self.host, self.port)
        await site.start()
        print(f'Serving executor API on http://{self.host}:{self.port} '
              f'(nonce: {self.nonce})', flush=True)
        # SIGINT / SIGTERM stop the server and return (exit code 0)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await runner.cleanup()
