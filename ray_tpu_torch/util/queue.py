"""Distributed Queue backed by an async actor.

Parity target: reference python/ray/util/queue.py (Queue — an actor
wrapping asyncio.Queue; put/get with block/timeout, qsize/empty/full,
put_nowait/get_nowait, shutdown).

Counterpart: ray_tpu/util/queue.py (copied).
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            await self.q.put(item)
            return True
        try:
            await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return (True, await self.q.get())
        try:
            return (True, await asyncio.wait_for(self.q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    async def put_nowait(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get_nowait(self):
        try:
            return (True, self.q.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    async def qsize(self) -> int:
        return self.q.qsize()

    async def empty(self) -> bool:
        return self.q.empty()

    async def full(self) -> bool:
        return self.q.full()


class Queue:
    """Driver/worker-side handle; picklable (ships the actor handle)."""

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None,
                 _actor=None):
        if _actor is not None:
            self.actor = _actor
            return
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        opts.setdefault("max_concurrency", 64)
        self.actor = ray_tpu_torch.remote(**opts)(_QueueActor).remote(maxsize)

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        if not block:
            ok = ray_tpu_torch.get(self.actor.put_nowait.remote(item), timeout=30)
            if not ok:
                raise Full()
            return
        ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout),
                         timeout=None if timeout is None else timeout + 30)
        if not ok:
            raise Full()

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote(), timeout=30)
            if not ok:
                raise Empty()
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout),
                               timeout=None if timeout is None else timeout + 30)
        if not ok:
            raise Empty()
        return item

    def put_nowait(self, item):
        self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote(), timeout=30)

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote(), timeout=30)

    def shutdown(self):
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass

    def __reduce__(self):
        return (_rebuild_queue, (self.actor,))


def _rebuild_queue(actor) -> "Queue":
    return Queue(_actor=actor)
