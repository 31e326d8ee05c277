"""Distributed FIFO queue backed by an async actor.

Parity with the reference's `ray.util.queue.Queue`
(ref: python/ray/util/queue.py — the queue IS an asyncio.Queue inside an
async actor; blocking put/get are awaits parked on the actor's event
loop). No client-side polling: a blocked `get` costs one in-flight actor
call, not a wakeup loop — the difference between 10k parked consumers
and 10k × 200 RPCs/s of poll traffic (SURVEY §6 envelope).
"""
from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    """Async actor: every blocked producer/consumer is a parked coroutine
    on this actor's loop (ref: util/queue.py _QueueActor)."""

    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            if timeout is None:
                await self._q.put(item)
            else:
                await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None) -> tuple:
        try:
            if timeout is None:
                return (True, await self._q.get())
            return (True, await asyncio.wait_for(self._q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    async def get_nowait(self) -> tuple:
        try:
            return (True, self._q.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    async def get_batch(self, max_items: int) -> List[Any]:
        out: List[Any] = []
        while len(out) < max_items:
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    async def qsize(self) -> int:
        return self._q.qsize()


class Queue:
    def __init__(self, maxsize: int = 0,
                 actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        # parked producers/consumers each hold one concurrency slot
        opts.setdefault("max_concurrency", 1000)
        cls = ray_tpu_torch.remote(_QueueActor)
        self.actor = cls.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full("Queue is full")
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full("Queue put timed out")

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty("Queue is empty")
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty("Queue get timed out")
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_batch(self, max_items: int = 64) -> List[Any]:
        return ray_tpu_torch.get(self.actor.get_batch.remote(max_items))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass
