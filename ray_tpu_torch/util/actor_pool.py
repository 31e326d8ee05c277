"""ActorPool — fan a stream of work over a fixed set of actors.

API parity with `ray.util.ActorPool` (ref: python/ray/util/actor_pool.py
public surface: submit/get_next/get_next_unordered/map/map_unordered/
has_next/has_free/push/pop_idle). The implementation is this repo's own:
work is ticketed in submission order, a FIFO backlog feeds freed actors,
and ordered retrieval walks the ticket sequence while unordered
retrieval leans on `ray_tpu_torch.wait`.
"""
from __future__ import annotations

import collections
import itertools
from typing import Any, Callable, Iterable, Iterator, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._free = collections.deque(actors)
        self._backlog: collections.deque = collections.deque()
        self._inflight: dict = {}       # ref -> (ticket, actor)
        self._by_ticket: dict = {}      # ticket -> ref
        self._tickets = itertools.count()
        self._head = 0                  # oldest ticket not yet returned

    # -- submission ----------------------------------------------------------

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; parks in the backlog when every
        actor is busy."""
        if self._free:
            self._launch(fn, value)
        else:
            self._backlog.append((fn, value))

    def _launch(self, fn: Callable, value: Any) -> None:
        actor = self._free.popleft()
        ref = fn(actor, value)
        ticket = next(self._tickets)
        self._inflight[ref] = (ticket, actor)
        self._by_ticket[ticket] = ref

    def _recycle(self, actor: Any) -> None:
        self._free.append(actor)
        while self._backlog and self._free:
            self._launch(*self._backlog.popleft())

    # -- retrieval -----------------------------------------------------------

    def has_next(self) -> bool:
        return bool(self._inflight)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order. A timeout leaves the pool
        state untouched so the call can simply be retried."""
        if not self._inflight:
            raise StopIteration("No more results to get")
        head = self._head
        while head not in self._by_ticket:
            head += 1  # that ticket was consumed unordered; skip
        ref = self._by_ticket[head]
        value = ray_tpu_torch.get(ref, timeout=timeout)  # may raise: state intact
        del self._by_ticket[head]
        self._head = head + 1
        _, actor = self._inflight.pop(ref)
        self._recycle(actor)
        return value

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result in COMPLETION order."""
        if not self._inflight:
            raise StopIteration("No more results to get")
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise TimeoutError("Timed out waiting for result")
        ref = ready[0]
        ticket, actor = self._inflight.pop(ref)
        self._by_ticket.pop(ticket, None)
        self._recycle(actor)
        return ray_tpu_torch.get(ref)

    # -- bulk ----------------------------------------------------------------

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- membership ----------------------------------------------------------

    def push(self, actor: Any) -> None:
        self._recycle(actor)

    def pop_idle(self) -> Optional[Any]:
        return self._free.pop() if self._free else None

    def has_free(self) -> bool:
        return bool(self._free) and not self._backlog
