"""Async concurrency primitives (contract: reference utils/threading.py —
PriorityLock :3-46, Throttler :48-106)."""
from __future__ import annotations

import asyncio
import heapq
import time
from typing import Optional


class PriorityLock:
    """An asyncio lock whose waiters are released in priority order
    (lower value = higher priority)."""

    def __init__(self):
        self._locked = False
        self._waiters: list = []
        self._counter = 0

    def locked(self) -> bool:
        return self._locked

    async def acquire(self, priority: int = 0):
        if not self._locked and not self._waiters:
            self._locked = True
            return True
        fut = asyncio.get_event_loop().create_future()
        self._counter += 1
        heapq.heappush(self._waiters, (priority, self._counter, fut))
        try:
            await fut
            return True
        except asyncio.CancelledError:
            if not fut.cancelled() and fut.done():
                # lock was handed to us as we were cancelled: pass it on
                self.release()
            raise

    def release(self):
        if not self._locked:
            raise RuntimeError('release of un-acquired PriorityLock')
        while self._waiters:
            _, _, fut = heapq.heappop(self._waiters)
            if not fut.done():
                fut.set_result(True)
                return
        self._locked = False

    class _Ctx:
        def __init__(self, lock: 'PriorityLock', priority: int):
            self.lock = lock
            self.priority = priority

        async def __aenter__(self):
            await self.lock.acquire(self.priority)

        async def __aexit__(self, *exc):
            self.lock.release()

    def __call__(self, priority: int = 0) -> '_Ctx':
        return self._Ctx(self, priority)


class Throttler:
    """Rate limiter: at most one pass per ``delay`` seconds; extra calls
    wait (used to throttle websocket status updates)."""

    def __init__(self, delay: float):
        self.delay = delay
        self._last = 0.0
        self._lock = asyncio.Lock()

    async def wait(self):
        async with self._lock:
            now = time.monotonic()
            wait_for = self._last + self.delay - now
            if wait_for > 0:
                await asyncio.sleep(wait_for)
            self._last = time.monotonic()

    async def __aenter__(self):
        await self.wait()

    async def __aexit__(self, *exc):
        pass
