"""PyTorch port, the serving entry points on the CPU: the wire format
(byte-identical to the JAX package's, with the native codec and with the
Python path), the task queue, the HTTP gateway in front of an in-process
``shared`` executor, the executor's framed RPC and its guards, the ws
worker, the async primitives and the terminal studio's ``batch`` command;
and that each entry point refuses to run without a card unless a Python
caller asks for the CPU."""
import asyncio
import base64
import importlib.util
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from manga_image_translator_tpu.server import to_json as jax_to_json
from manga_image_translator_tpu.utils.generic import Context as JContext
from manga_image_translator_tpu.utils.textblock import TextBlock as JTextBlock
from manga_image_translator_tpu_torch.config import Config
from manga_image_translator_tpu_torch.device import CudaUnavailableError
from manga_image_translator_tpu_torch.mode.share import (MangaShare,
                                                         restricted_loads)
from manga_image_translator_tpu_torch.mode.ws import MangaTranslatorWS
from manga_image_translator_tpu_torch.server import main as server_main
from manga_image_translator_tpu_torch.server import myqueue
from manga_image_translator_tpu_torch.server import to_json
from manga_image_translator_tpu_torch.server.instance import (
    ExecutorInstance, executor_instances)
from manga_image_translator_tpu_torch.utils.generic import Context
from manga_image_translator_tpu_torch.utils.textblock import TextBlock
from manga_image_translator_tpu_torch.utils.threading import (PriorityLock,
                                                              Throttler)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# a page the pipeline passes through without a model: no detector, no
# translator, no inpainter
PLAIN = {'detector': {'detector': 'none'},
         'translator': {'translator': 'none', 'target_lang': 'ENG'},
         'inpainter': {'inpainter': 'none'}}


def _contexts():
    """The same two regions and inpainted page as a port and a JAX
    Context."""
    rs = np.random.RandomState(0)
    page = rs.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    out = []
    for ctx_cls, blk_cls in ((Context, TextBlock), (JContext, JTextBlock)):
        ctx = ctx_cls()
        a = blk_cls([[[10, 10], [90, 10], [90, 40], [10, 40]]],
                    texts=['こんにちは'], fg_color=(10, 20, 30),
                    bg_color=(250, 240, 230), angle=3.5, prob=0.75)
        a.translation = 'hello'
        a.target_lang = 'ENG'
        b = blk_cls([[[20, 60], [140, 60], [140, 110], [20, 110]]],
                    texts=['漫画', 'です'], prob=0.5)
        b.translation = ''
        b.target_lang = 'ENG'
        ctx.text_regions = [a, b]
        ctx.img_inpainted = page
        ctx.translations = {'FRA': ['bonjour', 'manga']}
        out.append(ctx)
    return out


@pytest.fixture(scope='module')
def native_codec(tmp_path_factory):
    """native/wirecodec.cpp built into a temporary directory (the repo's
    build dir stays untouched)."""
    cxx = shutil.which('g++') or shutil.which('c++')
    assert cxx, 'no C++ compiler to build native/wirecodec.cpp'
    out = tmp_path_factory.mktemp('wirecodec') / (
        'wirecodec' + sysconfig.get_config_var('EXT_SUFFIX'))
    subprocess.run([cxx, '-O1', '-std=c++17', '-shared', '-fPIC',
                    '-I' + sysconfig.get_paths()['include'],
                    str(ROOT / 'native' / 'wirecodec.cpp'), '-o', str(out)],
                   check=True, timeout=120)
    spec = importlib.util.spec_from_file_location('wirecodec', out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('codec', ['python', 'native'])
def test_wire_bytes_equal_jax(codec, request, monkeypatch):
    native = request.getfixturevalue('native_codec') \
        if codec == 'native' else None
    monkeypatch.setattr(to_json, '_native_codec', native)
    monkeypatch.setattr(jax_to_json, '_native_codec', native)
    port_ctx, jax_ctx = _contexts()
    got = to_json.to_translation(port_ctx)
    ref = jax_to_json.to_translation(jax_ctx)
    assert got.to_bytes() == ref.to_bytes()
    assert got.to_bytes() == got.to_bytes_python()
    assert got.to_json_dict() == ref.to_json_dict()
    assert len(got.translations) == 2
    assert got.translations[0].text['ENG'] == 'hello'
    assert got.translations[0].text['FRA'] == 'bonjour'
    if native is not None:
        decoded = native.decode(got.to_bytes())
        assert [d['text'] for d in decoded] == [t.text for t in
                                                got.translations]


def test_background_clipped_to_the_page():
    """A box reaching past the page's top-left edge crops the page inside
    it (a negative start would wrap around to an empty crop)."""
    ctx = Context()
    blk = TextBlock([[[-6, -4], [30, -4], [30, 20], [-6, 20]]],
                    texts=['端'])
    ctx.text_regions = [blk]
    ctx.img_inpainted = np.full((40, 50, 3), 7, np.uint8)
    ctx.translations = {}
    t = to_json.to_translation(ctx).translations[0]
    assert (t.minX, t.minY) == (-6, -4)
    assert t.background.shape == (20, 30, 3)
    ctx.text_regions = [TextBlock([[[60, 50], [70, 50], [70, 60],
                                    [60, 60]]], texts=['外'])]
    t = to_json.to_translation(ctx).translations[0]
    assert t.background is None and t.background_b64() == ''


def test_wait_in_queue_with_fake_executor(monkeypatch):
    async def fake_sent(self, image, config):
        ctx = Context()
        ctx.result = image
        return ctx

    monkeypatch.setattr(ExecutorInstance, 'sent', fake_sent)
    inst = ExecutorInstance(ip='127.0.0.1', port=9999)
    monkeypatch.setattr(executor_instances, 'list', [inst])

    async def run():
        task = myqueue.QueueElement(None, Image.new('RGB', (8, 8)), None)
        myqueue.task_queue.add_task(task)
        myqueue.task_queue.update_event()
        return await myqueue.wait_in_queue(task, None)

    ctx = asyncio.run(run())
    assert ctx.result.size == (8, 8)
    assert not inst.busy            # released after completion


def _png_b64(size=(48, 40), seed=0):
    rs = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, size[::-1] + (3,)).astype(
        np.uint8)).save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


def test_gateway_with_inprocess_executor(monkeypatch):
    """HTTP gateway -> queue -> the port's shared executor over real
    HTTP (its nonce checked) -> MangaTranslator on the CPU, for the single
    and the batch JSON endpoints and the framed stream."""
    from aiohttp.test_utils import TestClient, TestServer
    share = MangaShare({'nonce': 'n0nce', 'use_gpu': False})
    calls = []
    translate_batch = share.manga.translate_batch

    async def counted_batch(images_with_configs, batch_size=None):
        calls.append(len(images_with_configs))
        return await translate_batch(images_with_configs, batch_size)
    share.manga.translate_batch = counted_batch

    async def run():
        executor = TestServer(share.build_app(), host='127.0.0.1')
        await executor.start_server()
        monkeypatch.setattr(executor_instances, 'list', [ExecutorInstance(
            ip='127.0.0.1', port=executor.port, nonce='n0nce')])
        try:
            async with TestClient(TestServer(server_main.build_app())) as cl:
                resp = await cl.get('/queue-size')
                assert (await resp.json()) == {'size': 0}
                resp = await cl.post('/translate/json', json={
                    'image': _png_b64(), 'config': PLAIN})
                assert resp.status == 200, await resp.text()
                body = await resp.json()
                assert body == {'translations': [], 'debug_folder': None}
                resp = await cl.post('/translate/batch/json', json={
                    'images': [{'image': _png_b64(seed=1), 'config': PLAIN},
                               {'image': _png_b64(seed=2), 'config': PLAIN}]})
                assert resp.status == 200, await resp.text()
                assert await resp.json() == [
                    {'translations': [], 'debug_folder': None}] * 2
                resp = await cl.post('/translate/image/stream', json={
                    'image': _png_b64(seed=3), 'config': PLAIN})
                frames = _frames(await resp.read())
                assert frames[-1][0] == 0
                assert any(s == 1 for s, _ in frames)
                out = Image.open(io.BytesIO(frames[-1][1]))
                assert out.size == (48, 40)
        finally:
            await executor.close()

    asyncio.run(run())
    assert calls == [2]


def _frames(body: bytes):
    frames, i = [], 0
    while i < len(body):
        n = int.from_bytes(body[i + 1:i + 5], 'big')
        frames.append((body[i], body[i + 5:i + 5 + n]))
        i += 5 + n
    return frames


@pytest.fixture()
def share():
    s = MangaShare({'nonce': 'secret', 'use_gpu': False})

    async def echo(x=0):
        return {'doubled': x * 2}

    async def boom():
        raise ValueError('intentional')

    async def with_progress(x=0):
        await s.manga._report_progress('stage-one')
        await s.manga._report_progress('stage-two')
        return x + 1

    s.manga.echo = echo
    s.manga.boom = boom
    s.manga.with_progress = with_progress
    return s


def _client(share):
    from aiohttp.test_utils import TestClient, TestServer
    return TestClient(TestServer(share.build_app()))


def test_share_simple_streaming_and_error_frames(share):
    async def run():
        async with _client(share) as client:
            resp = await client.post(
                '/simple_execute/echo', data=pickle.dumps({'x': 21}),
                headers={'X-Nonce': 'secret'})
            assert resp.status == 200
            assert pickle.loads(await resp.read()) == {'doubled': 42}
            # a simple call queues no progress frame for a later stream
            await client.post('/simple_execute/with_progress',
                              data=pickle.dumps({'x': 0}),
                              headers={'X-Nonce': 'secret'})
            resp = await client.post(
                '/execute/with_progress', data=pickle.dumps({'x': 41}),
                headers={'X-Nonce': 'secret'})
            frames = _frames(await resp.read())
            assert [s for s, _ in frames] == [1, 1, 0]
            assert frames[0][1] == b'stage-one'
            assert pickle.loads(frames[-1][1]) == 42
            resp = await client.post('/execute/boom', data=pickle.dumps({}),
                                     headers={'X-Nonce': 'secret'})
            frames = _frames(await resp.read())
            assert frames[-1][0] == 2 and b'intentional' in frames[-1][1]
            resp = await client.get('/is_locked')
            assert (await resp.json()) == {'locked': False}
    asyncio.run(run())


def test_share_nonce_and_method_guards(share):
    async def run():
        async with _client(share) as client:
            resp = await client.post('/simple_execute/echo',
                                     data=pickle.dumps({'x': 1}))
            assert resp.status == 401
            resp = await client.post(
                '/simple_execute/__class__', data=pickle.dumps({}),
                headers={'X-Nonce': 'secret'})
            assert resp.status == 403
            resp = await client.post(
                '/simple_execute/no_such_method', data=pickle.dumps({}),
                headers={'X-Nonce': 'secret'})
            assert resp.status == 404
            # the lock was not leaked by the refused calls
            resp = await client.post(
                '/simple_execute/echo', data=pickle.dumps({'x': 2}),
                headers={'X-Nonce': 'secret'})
            assert resp.status == 200
    asyncio.run(run())


class _Evil:
    def __reduce__(self):
        return (os.system, ('true',))


def test_restricted_unpickler():
    """The port's classes, PIL and numpy load; the JAX package's classes
    and os.system do not."""
    from manga_image_translator_tpu.config import Config as JConfig
    ok = restricted_loads(pickle.dumps({'a': [1, 2], 'b': np.arange(3),
                                        'config': Config(**PLAIN),
                                        'image': Image.new('RGB', (4, 4))}))
    assert list(ok['b']) == [0, 1, 2]
    assert ok['config'].detector.detector.value == 'none'
    assert ok['image'].size == (4, 4)
    with pytest.raises(pickle.UnpicklingError,
                       match='manga_image_translator_tpu.config'):
        restricted_loads(pickle.dumps(JConfig()))
    with pytest.raises(pickle.UnpicklingError):
        restricted_loads(pickle.dumps(_Evil()))


def test_ws_round_trip():
    """A local websocket server pushes one task; the worker streams status
    frames and answers with the translated page."""
    import websockets
    received = []
    done = asyncio.Event()

    async def run():
        async def handler(ws):
            req = getattr(ws, 'request', None)
            if req is not None:
                assert req.headers.get('x-secret') == 's3cret'
            await ws.send(json.dumps({'type': 'new_task', 'id': 'task-1',
                                      'image_b64': _png_b64((64, 64)),
                                      'config': PLAIN}))
            async for raw in ws:
                received.append(json.loads(raw))
                if received[-1]['type'] in ('result', 'error'):
                    done.set()
                    return

        async with websockets.serve(handler, '127.0.0.1', 0) as server:
            port = server.sockets[0].getsockname()[1]
            worker = MangaTranslatorWS({'ws_url': f'ws://127.0.0.1:{port}',
                                        'ws_secret': 's3cret',
                                        'use_gpu': False})
            task = asyncio.create_task(worker.listen())
            try:
                await asyncio.wait_for(done.wait(), timeout=60)
            finally:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass

    asyncio.run(run())
    types = [m['type'] for m in received]
    assert types[-1] == 'result' and 'status' in types, types
    assert received[-1]['id'] == 'task-1'
    out = Image.open(io.BytesIO(base64.b64decode(received[-1]['image_b64'])))
    assert out.size == (64, 64)


def test_priority_lock_orders_waiters():
    order = []

    async def run():
        lock = PriorityLock()
        await lock.acquire(0)

        async def worker(prio, name):
            async with lock(prio):
                order.append(name)

        tasks = [asyncio.create_task(worker(5, 'low')),
                 asyncio.create_task(worker(1, 'high')),
                 asyncio.create_task(worker(3, 'mid'))]
        await asyncio.sleep(0.05)
        lock.release()
        await asyncio.gather(*tasks)
        assert not lock.locked()

    asyncio.run(run())
    assert order == ['high', 'mid', 'low']


def test_throttler_spaces_calls():
    async def run():
        th = Throttler(0.05)
        t0 = time.monotonic()
        for _ in range(3):
            await th.wait()
        return time.monotonic() - t0

    assert asyncio.run(run()) >= 0.09


def test_studio_batch_command(tmp_path, monkeypatch, capsys):
    """Two queued pages through ``batch`` (translate_batch) on a CPU
    translator: both written, both jobs done, the queue persisted in the
    port's own state directory."""
    from manga_image_translator_tpu_torch import studio as studio_mod
    assert studio_mod.PROFILE_DIR.endswith('manga-image-translator-tpu-torch')
    monkeypatch.setattr(studio_mod, 'PROFILE_DIR', str(tmp_path / 'state'))
    pages = tmp_path / 'pages'
    pages.mkdir()
    for i in range(2):
        Image.open(io.BytesIO(base64.b64decode(_png_b64(seed=i)))).save(
            pages / f'p{i}.png')
    studio = studio_mod.Studio({'use_gpu': False})
    studio.dest = str(tmp_path / 'out')
    for key, value in (('detector.detector', 'none'),
                       ('translator.translator', 'none'),
                       ('inpainter.inpainter', 'none')):
        studio.do_profile(f'set {key} {value}')
    studio.do_add(f'{pages / "p0.png"} {pages / "p1.png"}')
    calls = []
    original = studio_mod.MangaTranslatorLocal.translate_batch

    async def counted(self, images_with_configs, batch_size=None):
        calls.append(len(images_with_configs))
        return await original(self, images_with_configs, batch_size)
    monkeypatch.setattr(studio_mod.MangaTranslatorLocal, 'translate_batch',
                        counted)
    studio.do_batch('')
    assert 'batching 2 page(s)' in capsys.readouterr().out
    assert calls == [2]
    assert sorted(os.listdir(tmp_path / 'out')) == ['p0.png', 'p1.png']
    assert [j['status'] for j in studio.queue] == ['done', 'done']
    with open(tmp_path / 'state' / 'queue.json', encoding='utf8') as f:
        assert [j['status'] for j in json.load(f)] == ['done', 'done']


def test_entry_points_refuse_cpu_unless_asked(monkeypatch, tmp_path):
    """Without a card the executor, the ws worker, the studio and the
    gateway's --start-instance raise, unless a Python caller asks for the
    CPU."""
    from manga_image_translator_tpu_torch import studio as studio_mod
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(studio_mod, 'PROFILE_DIR', str(tmp_path))
    for make in (lambda p: MangaShare(p), lambda p: MangaTranslatorWS(p),
                 lambda p: studio_mod.Studio(p)):
        with pytest.raises(CudaUnavailableError):
            make({})
        with pytest.raises(CudaUnavailableError):
            make({'use_gpu': None})
        make({'use_gpu': False})
    spawned = []
    monkeypatch.setattr(server_main.subprocess, 'Popen',
                        lambda *a, **k: spawned.append(a))
    monkeypatch.setattr(server_main, 'NONCE', server_main.NONCE)
    monkeypatch.setattr(sys, 'argv', ['server', '--start-instance',
                                      '--use-gpu'])
    with pytest.raises(CudaUnavailableError):
        server_main.main()
    assert not spawned


def test_cli_has_the_serving_modes(monkeypatch):
    from manga_image_translator_tpu_torch.args import parser
    args = parser.parse_args(['shared', '--port', '5010', '--nonce', 'x'])
    assert (args.mode, args.port, args.nonce) == ('shared', 5010, 'x')
    args = parser.parse_args(['ws', '--ws-url', 'ws://127.0.0.1:9'])
    assert (args.mode, args.ws_url) == ('ws', 'ws://127.0.0.1:9')
    spawned = []
    monkeypatch.setattr(server_main.subprocess, 'Popen',
                        lambda cmd, **k: spawned.append(cmd))
    monkeypatch.setattr(executor_instances, 'list', [])
    server_main.start_instance('127.0.0.1', 8000, 'n', [])
    assert spawned[0][1:4] == ['-m', 'manga_image_translator_tpu_torch',
                               'shared']
    assert executor_instances.list[0].nonce == 'n'
    assert executor_instances.list[0].port == 8001


def test_index_and_manual_pages_served():
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        async with TestClient(TestServer(server_main.build_app())) as cl:
            resp = await cl.get('/')
            assert resp.status == 200
            assert 'PyTorch' in await resp.text()
            resp = await cl.get('/manual')
            assert resp.status == 200
            assert '/translate/with-form/' in await resp.text()

    asyncio.run(run())
