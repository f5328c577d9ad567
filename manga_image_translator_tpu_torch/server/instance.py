"""Executor pool (contract: reference server/instance.py:10-67):
ExecutorInstance{ip, port, busy} + Executors.find_executor with lock+event.
Each RPC carries the executor's nonce in ``X-Nonce``, which the executor
(``mode/share.py``) checks."""
from __future__ import annotations

import asyncio
import pickle
from typing import List, Optional

import aiohttp
from pydantic import BaseModel

from ..utils.generic import Context


class ExecutorInstance(BaseModel):
    ip: str
    port: int
    nonce: Optional[str] = None
    busy: bool = False

    def free_executor(self):
        self.busy = False

    def _url(self, endpoint: str) -> str:
        return f'http://{self.ip}:{self.port}/{endpoint}'

    def _headers(self) -> dict:
        return {'X-Nonce': self.nonce} if self.nonce else {}

    async def sent(self, image, config) -> Context:
        """Simple (non-streaming) RPC to the executor."""
        payload = pickle.dumps({'image': image, 'config': config})
        async with aiohttp.ClientSession() as session:
            async with session.post(self._url('simple_execute/translate'),
                                    data=payload,
                                    headers=self._headers()) as resp:
                if resp.status != 200:
                    raise RuntimeError(await resp.text())
                return pickle.loads(await resp.read())

    async def sent_stream(self, image, config, sender):
        """Streaming RPC: forwards progress frames to ``sender(status,
        payload)``; returns the final Context."""
        payload = pickle.dumps({'image': image, 'config': config})
        result = None
        async with aiohttp.ClientSession() as session:
            async with session.post(self._url('execute/translate'),
                                    data=payload,
                                    headers=self._headers()) as resp:
                buffer = b''
                async for chunk in resp.content.iter_any():
                    buffer += chunk
                    while len(buffer) >= 5:
                        status = buffer[0]
                        size = int.from_bytes(buffer[1:5], 'big')
                        if len(buffer) < 5 + size:
                            break
                        data = buffer[5:5 + size]
                        buffer = buffer[5 + size:]
                        if status == 0:
                            result = pickle.loads(data)
                        elif status == 2:
                            raise RuntimeError(data.decode('utf8'))
                        else:
                            await sender(status, data)
        return result

    async def sent_batch(self, images_with_configs) -> List[Context]:
        payload = pickle.dumps(
            {'images_with_configs': images_with_configs})
        async with aiohttp.ClientSession() as session:
            async with session.post(
                    self._url('simple_execute/translate_batch'),
                    data=payload, headers=self._headers()) as resp:
                if resp.status != 200:
                    raise RuntimeError(await resp.text())
                return pickle.loads(await resp.read())


class Executors:
    def __init__(self):
        self.list: List[ExecutorInstance] = []
        self.lock = asyncio.Lock()
        self.event = asyncio.Event()

    def register(self, instance: ExecutorInstance):
        self.list.append(instance)

    def free_executors(self) -> int:
        return len([e for e in self.list if not e.busy])

    async def _find_instance(self) -> Optional[ExecutorInstance]:
        while True:
            for e in self.list:
                if not e.busy:
                    e.busy = True
                    return e
            self.event.clear()
            await self.event.wait()

    async def find_executor(self) -> ExecutorInstance:
        async with self.lock:
            return await self._find_instance()

    def free_executor(self, instance: ExecutorInstance):
        instance.free_executor()
        self.event.set()


executor_instances = Executors()
