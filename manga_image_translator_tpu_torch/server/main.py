"""HTTP API gateway.

Contract from reference ``server/main.py:26-402``: REST endpoints
``/translate/{json,bytes,image}[/stream]``, ``/translate/with-form/*``,
``/translate/batch/{json,images}``, ``/queue-size``, ``/register``; the
gateway queues tasks (myqueue) and fans out to ``shared``-mode executor
processes over HTTP, optionally spawning one with ``--start-instance``.

Implemented with aiohttp; the streaming byte protocol (1-byte status +
4-byte BE length + payload) is unchanged from the reference so existing
clients keep working. ``--start-instance`` spawns ``python -m
manga_image_translator_tpu_torch shared``, which runs on the CUDA card
(``--use-gpu`` is accepted and changes nothing); the gateway refuses to
start one on a machine without a card.

Run: ``python -m manga_image_translator_tpu_torch.server.main --host
127.0.0.1 --port 8000 --start-instance``
"""
from __future__ import annotations

import argparse
import asyncio
import builtins
import io
import json
import os
import secrets
import subprocess
import sys
from typing import List, Optional

from aiohttp import web
from PIL import Image

from ..config import Config
from .instance import ExecutorInstance, executor_instances
from .myqueue import BatchQueueElement, QueueElement, task_queue, wait_in_queue
from .to_json import to_translation

NONCE = ''


def _frame(status: int, payload: bytes) -> bytes:
    return bytes([status]) + len(payload).to_bytes(4, 'big') + payload


async def _parse_request_image_config(request: web.Request):
    ctype = request.content_type
    if ctype.startswith('multipart/'):
        data = await request.post()
        image_field = data.get('image')
        conf_field = data.get('config') or '{}'
        if hasattr(conf_field, 'file'):
            conf_field = conf_field.file.read().decode('utf8')
        image = Image.open(io.BytesIO(image_field.file.read()))
        config = Config(**json.loads(conf_field))
    elif ctype == 'application/json':
        body = await request.json()
        import base64
        image = Image.open(io.BytesIO(base64.b64decode(body['image'])))
        config = Config(**(body.get('config') or {}))
    else:
        raw = await request.read()
        image = Image.open(io.BytesIO(raw))
        config = Config()
    return image, config


def _ctx_to_image_bytes(ctx) -> bytes:
    buf = io.BytesIO()
    result = ctx.result if ctx is not None else None
    if result is None:
        result = Image.new('RGB', (1, 1), 'white')
    result.save(buf, format='PNG')
    return buf.getvalue()


async def _run_task(request, image, config, notify=None):
    task = QueueElement(request, image, config)
    task_queue.add_task(task)
    task_queue.update_event()
    return await wait_in_queue(task, notify)


def make_response(fmt: str, ctx) -> web.Response:
    if fmt == 'image':
        return web.Response(body=_ctx_to_image_bytes(ctx),
                            content_type='image/png')
    translation = to_translation(ctx if ctx is not None else {})
    if fmt == 'bytes':
        return web.Response(body=translation.to_bytes(),
                            content_type='application/octet-stream')
    return web.json_response(translation.to_json_dict())


def build_app() -> web.Application:
    app = web.Application(client_max_size=256 * 1024 * 1024)

    def endpoint(fmt: str, streaming: bool):
        async def handler(request: web.Request):
            image, config = await _parse_request_image_config(request)
            if not streaming:
                ctx = await _run_task(request, image, config)
                return make_response(fmt, ctx)
            resp = web.StreamResponse()
            resp.content_type = 'application/octet-stream'
            await resp.prepare(request)

            async def notify(status: int, data: bytes):
                await resp.write(_frame(status, data))

            try:
                ctx = await _run_task(request, image, config, notify)
                if fmt == 'image':
                    payload = _ctx_to_image_bytes(ctx)
                elif fmt == 'bytes':
                    payload = to_translation(ctx or {}).to_bytes()
                else:
                    payload = json.dumps(
                        to_translation(ctx or {}).to_json_dict()).encode()
                await resp.write(_frame(0, payload))
            except Exception as e:
                await resp.write(_frame(2, str(e).encode('utf8')))
            await resp.write_eof()
            return resp
        return handler

    for fmt in ('json', 'bytes', 'image'):
        app.router.add_post(f'/translate/{fmt}', endpoint(fmt, False))
        app.router.add_post(f'/translate/{fmt}/stream', endpoint(fmt, True))
        app.router.add_post(f'/translate/with-form/{fmt}',
                            endpoint(fmt, False))
        app.router.add_post(f'/translate/with-form/{fmt}/stream',
                            endpoint(fmt, True))

    async def batch_json(request: web.Request):
        body = await request.json()
        import base64
        images, configs = [], []
        for item in body.get('images', []):
            images.append(Image.open(io.BytesIO(
                base64.b64decode(item['image']))))
            configs.append(Config(**(item.get('config') or {})))
        task = BatchQueueElement(request, images, configs)
        task_queue.add_task(task)
        task_queue.update_event()
        contexts = await wait_in_queue(task, None)
        return web.json_response(
            [to_translation(ctx or {}).to_json_dict()
             for ctx in (contexts or [])])

    app.router.add_post('/translate/batch/json', batch_json)

    async def batch_images(request: web.Request):
        """Batch endpoint returning a zip of translated PNGs (reference
        server/main.py batch endpoints)."""
        import zipfile
        body = await request.json()
        import base64
        images, configs = [], []
        for item in body.get('images', []):
            images.append(Image.open(io.BytesIO(
                base64.b64decode(item['image']))))
            configs.append(Config(**(item.get('config') or {})))
        task = BatchQueueElement(request, images, configs)
        task_queue.add_task(task)
        task_queue.update_event()
        contexts = await wait_in_queue(task, None)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, 'w') as zf:
            for i, ctx in enumerate(contexts or []):
                zf.writestr(f'{i:04d}.png', _ctx_to_image_bytes(ctx))
        return web.Response(body=buf.getvalue(),
                            content_type='application/zip')

    app.router.add_post('/translate/batch/images', batch_images)

    async def queue_size(request):
        return web.json_response({'size': len(task_queue.queue)})

    app.router.add_get('/queue-size', queue_size)

    async def register(request: web.Request):
        if NONCE and request.headers.get('X-Nonce') != NONCE:
            raise web.HTTPUnauthorized()
        body = await request.json()
        executor_instances.register(
            ExecutorInstance(ip=body['ip'], port=int(body['port']),
                             nonce=NONCE or None))
        executor_instances.event.set()
        return web.json_response({'ok': True})

    app.router.add_post('/register', register)

    async def result_file(request: web.Request):
        folder = request.match_info['folder']
        if '..' in folder or '/' in folder:
            raise web.HTTPForbidden()
        path = os.path.join('result', folder, 'final.png')
        if not os.path.exists(path):
            raise web.HTTPNotFound()
        return web.FileResponse(path)

    app.router.add_get('/result/{folder}/final.png', result_file)

    async def index(request):
        path = os.path.join(os.path.dirname(__file__), 'index.html')
        return web.FileResponse(path)

    app.router.add_get('/', index)

    async def manual(request):
        """Manual-translation page (reference server/manual.html parity):
        upload -> streamed regions JSON -> hand-edit translations."""
        path = os.path.join(os.path.dirname(__file__), 'manual.html')
        return web.FileResponse(path)

    app.router.add_get('/manual', manual)
    return app


def start_instance(host: str, port: int, nonce: str, params: List[str]):
    cmd = [sys.executable, '-m', 'manga_image_translator_tpu_torch', 'shared',
           '--host', host, '--port', str(port + 1), '--nonce', nonce,
           *params]
    proc = subprocess.Popen(cmd)
    executor_instances.register(
        ExecutorInstance(ip=host, port=port + 1, nonce=nonce))
    return proc


def main():
    global NONCE
    parser = argparse.ArgumentParser(prog='server')
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', default=8000, type=int)
    parser.add_argument('--nonce', default=os.getenv('MT_WEB_NONCE', ''))
    parser.add_argument('--start-instance', action='store_true')
    parser.add_argument('--use-gpu', action='store_true',
                        help='accepted for compatibility: the executor '
                             'always runs on the card')
    args, rest = parser.parse_known_args()
    NONCE = args.nonce or secrets.token_hex(16)
    proc = None
    if args.start_instance:
        # the executor runs the models here: fail now, not at its first
        # request, when there is no card
        from ..device import resolve_device
        resolve_device(None)
        proc = start_instance(args.host, args.port, NONCE,
                              ['--use-gpu'] if args.use_gpu else [])
    try:
        web.run_app(build_app(), host=args.host, port=args.port)
    finally:
        if proc is not None:    # the spawned executor stops with the gateway
            proc.terminate()
            proc.wait(timeout=60)
    if proc is not None and proc.returncode:
        sys.exit(f'the executor exited with code {proc.returncode}')


if __name__ == '__main__':
    main()
