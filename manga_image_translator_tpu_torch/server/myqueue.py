"""In-memory task queue with position notifications
(contract: reference server/myqueue.py:62-150)."""
from __future__ import annotations

import asyncio
from typing import List, Optional

from ..config import Config
from .instance import executor_instances


class QueueElement:
    def __init__(self, request, image, config: Config, priority: int = 0):
        self.request = request
        self.image = image
        self.config = config
        self.priority = priority

    def is_client_disconnected(self) -> bool:
        try:
            transport = getattr(self.request, 'transport', None)
            return transport is not None and transport.is_closing()
        except Exception:
            return False


class BatchQueueElement(QueueElement):
    def __init__(self, request, images, configs):
        super().__init__(request, None, None)
        self.images = images
        self.configs = configs


class TaskQueue:
    def __init__(self):
        self.queue: List[QueueElement] = []
        self.queue_event: asyncio.Event = asyncio.Event()

    def add_task(self, task: QueueElement):
        self.queue.append(task)

    def get_pos(self, task: QueueElement) -> Optional[int]:
        try:
            return self.queue.index(task)
        except ValueError:
            return None

    def update_event(self):
        self.queue_event.set()
        self.queue_event.clear()

    def remove(self, task: QueueElement):
        if task in self.queue:
            self.queue.remove(task)
        self.update_event()

    async def wait_for_event(self):
        await self.queue_event.wait()


task_queue = TaskQueue()


async def wait_in_queue(task: QueueElement, notify):
    """Block until the task reaches the executor pool; streams queue-position
    notifications through ``notify(status=3, data)`` (reference
    myqueue.py:89-150)."""
    while True:
        pos = task_queue.get_pos(task)
        if pos is None:
            return None
        if task.is_client_disconnected():
            task_queue.remove(task)
            raise asyncio.CancelledError('client disconnected')
        if pos < executor_instances.free_executors():
            break
        if notify:
            await notify(3, str(pos).encode('utf8'))
        await task_queue.wait_for_event()

    instance = await executor_instances.find_executor()
    task_queue.remove(task)
    try:
        if isinstance(task, BatchQueueElement):
            result = await instance.sent_batch(
                list(zip(task.images, task.configs)))
        elif notify:
            result = await instance.sent_stream(task.image, task.config,
                                                notify)
        else:
            result = await instance.sent(task.image, task.config)
        return result
    finally:
        executor_instances.free_executor(instance)
