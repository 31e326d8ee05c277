"""Task manager + reference counter (owner-side bookkeeping).

Equivalent of the reference's core-worker TaskManager
(ref: src/ray/core_worker/task_manager.h:173 — pending table, retries
:367 RetryTaskIfPossible, lineage-based resubmission :234 ResubmitTask with a
byte budget :180) and ReferenceCounter (reference_count.h:61 —
ownership-based distributed refcounting).

Deviation from the reference: ownership is centralized on the head runtime
(single-controller), so the borrower protocol reduces to per-process refcount
reports aggregated here rather than owner-to-borrower long-poll chains.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from ..devtools.locks import instrumented_lock
from .ids import ObjectId, TaskId
from .task_spec import TaskSpec


@dataclass
class PendingTask:
    spec: TaskSpec
    retries_left: int
    reconstructions_left: int = 3
    submitted_at: float = field(default_factory=time.monotonic)
    state: str = "PENDING"  # PENDING | RUNNING | FINISHED | FAILED


class TaskManager:
    def __init__(self, lineage_max_bytes: int = 256 * 1024 * 1024):
        self._lock = instrumented_lock("task_manager", reentrant=True)
        self._pending: Dict[TaskId, PendingTask] = {}
        # lineage: task prefix (first 12 id bytes) -> spec of the task that
        # created those objects; bounded by _lineage_bytes budget
        self._lineage: Dict[bytes, TaskSpec] = {}
        self._lineage_bytes = 0
        self._lineage_max_bytes = lineage_max_bytes
        self._lineage_order: List[bytes] = []

    def register(self, spec: TaskSpec) -> PendingTask:
        with self._lock:
            pt = PendingTask(spec=spec, retries_left=spec.max_retries)
            self._pending[spec.task_id] = pt
            self._record_lineage(spec)
            return pt

    def _record_lineage(self, spec: TaskSpec) -> None:
        prefix = spec.task_id.binary()[:12]
        if prefix in self._lineage:
            return
        approx = 256 + sum(
            len(a[1]) if a[0] == 0 and isinstance(a[1], bytes) else 64
            for a in spec.args)
        self._lineage[prefix] = spec
        self._lineage_order.append(prefix)
        self._lineage_bytes += approx
        while self._lineage_bytes > self._lineage_max_bytes and self._lineage_order:
            old = self._lineage_order.pop(0)
            self._lineage.pop(old, None)
            self._lineage_bytes -= 256  # rough; budget is advisory

    def get(self, task_id: TaskId) -> Optional[PendingTask]:
        with self._lock:
            return self._pending.get(task_id)

    def mark_running(self, task_id: TaskId) -> None:
        with self._lock:
            pt = self._pending.get(task_id)
            if pt:
                pt.state = "RUNNING"

    def complete(self, task_id: TaskId) -> None:
        with self._lock:
            pt = self._pending.pop(task_id, None)
            if pt:
                pt.state = "FINISHED"

    def fail(self, task_id: TaskId) -> None:
        with self._lock:
            pt = self._pending.pop(task_id, None)
            if pt:
                pt.state = "FAILED"

    def try_retry(self, task_id: TaskId) -> Optional[TaskSpec]:
        """Consume one retry; returns the spec to resubmit, or None if
        exhausted. (ref: task_manager.h:367 RetryTaskIfPossible)"""
        with self._lock:
            pt = self._pending.get(task_id)
            if pt is None or pt.retries_left == 0:
                return None
            if pt.retries_left > 0:
                pt.retries_left -= 1
            pt.state = "PENDING"
            return pt.spec

    def lineage_for_object(self, object_id: ObjectId) -> Optional[TaskSpec]:
        with self._lock:
            return self._lineage.get(object_id.task_prefix())

    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)


class _RefShard:
    """One shard of the reference counter: its own lock + the per-object
    tables for the object ids hashing here."""

    __slots__ = ("lock", "local", "task_pins", "holders", "owned",
                 "dead_holders")

    def __init__(self, index: int):
        self.lock = instrumented_lock(f"refcounter.s{index}")
        self.local: Dict[ObjectId, int] = {}
        self.task_pins: Dict[ObjectId, int] = {}
        self.holders: Dict[ObjectId, Dict[object, int]] = {}
        self.owned: Set[ObjectId] = set()
        # holders whose process has died: a late add_holder_ref (a relayed
        # call racing the exit notification) must not resurrect a count
        # nothing will ever decrement. WorkerIds are never reused, so the
        # set only grows by one entry per worker lifetime (per shard).
        self.dead_holders: Set[object] = set()


class ReferenceCounter:
    """Aggregated reference counts per object, SHARDED by object id.

    Counts: python-local references in the driver, per-HOLDER references
    reported by worker processes (a holder is a WorkerId; all of a dead
    worker's refs are dropped in one sweep — the single-controller
    reduction of the reference's borrower protocol), plus pins from
    pending task arguments. An object is freeable only when all three
    reach zero. (ref: reference_count.h:61)

    Sharding (docs/DISPATCH.md): every operation touches exactly one
    object id, so the tables split into N independent lock+dict shards —
    submit bursts from many clients stop serializing on one refcount
    lock. Only release_holder (a worker died) sweeps all shards."""

    def __init__(self, on_free: Callable[[ObjectId], None],
                 shards: int = 16):
        self._shards = [_RefShard(i) for i in range(max(1, int(shards)))]
        self._n = len(self._shards)
        self._on_free = on_free

    def _shard(self, object_id: ObjectId) -> _RefShard:
        return self._shards[hash(object_id) % self._n]

    @staticmethod
    def _freeable_locked(s: _RefShard, object_id: ObjectId) -> bool:
        return (object_id not in s.local
                and object_id not in s.task_pins
                and object_id not in s.holders
                and object_id in s.owned)

    def add_owned(self, object_id: ObjectId) -> None:
        s = self._shard(object_id)
        with s.lock:
            s.owned.add(object_id)

    def add_local(self, object_id: ObjectId, n: int = 1) -> None:
        s = self._shard(object_id)
        with s.lock:
            s.local[object_id] = s.local.get(object_id, 0) + n

    def remove_local(self, object_id: ObjectId, n: int = 1) -> None:
        s = self._shard(object_id)
        free = False
        with s.lock:
            c = s.local.get(object_id, 0) - n
            if c <= 0:
                s.local.pop(object_id, None)
                free = self._freeable_locked(s, object_id)
            else:
                s.local[object_id] = c
        if free:
            self._on_free(object_id)

    def add_holder_ref(self, object_id: ObjectId, holder, n: int = 1) -> None:
        """A worker process holds (another) reference to the object."""
        s = self._shard(object_id)
        with s.lock:
            if holder in s.dead_holders:
                return
            h = s.holders.setdefault(object_id, {})
            h[holder] = h.get(holder, 0) + n

    def remove_holder_ref(self, object_id: ObjectId, holder,
                          n: int = 1) -> None:
        s = self._shard(object_id)
        free = False
        with s.lock:
            h = s.holders.get(object_id)
            if h is None:
                return
            c = h.get(holder, 0) - n
            if c <= 0:
                h.pop(holder, None)
            else:
                h[holder] = c
            if not h:
                s.holders.pop(object_id, None)
                free = self._freeable_locked(s, object_id)
        if free:
            self._on_free(object_id)

    def release_holder(self, holder) -> None:
        """Drop every reference a (dead) worker held (all shards)."""
        to_free = []
        for s in self._shards:
            with s.lock:
                s.dead_holders.add(holder)
                for oid in list(s.holders):
                    h = s.holders[oid]
                    if holder in h:
                        h.pop(holder, None)
                        if not h:
                            s.holders.pop(oid, None)
                            if self._freeable_locked(s, oid):
                                to_free.append(oid)
        for oid in to_free:
            self._on_free(oid)

    def pin_for_task(self, object_id: ObjectId) -> None:
        s = self._shard(object_id)
        with s.lock:
            s.task_pins[object_id] = s.task_pins.get(object_id, 0) + 1

    def unpin_for_task(self, object_id: ObjectId) -> None:
        s = self._shard(object_id)
        free = False
        with s.lock:
            c = s.task_pins.get(object_id, 0) - 1
            if c <= 0:
                s.task_pins.pop(object_id, None)
                free = self._freeable_locked(s, object_id)
            else:
                s.task_pins[object_id] = c
        if free:
            self._on_free(object_id)

    def forget(self, object_id: ObjectId) -> None:
        """Freed object: drop residual bookkeeping (the owned marker and
        any stale per-holder rows) so long sessions don't accumulate ids."""
        s = self._shard(object_id)
        with s.lock:
            s.owned.discard(object_id)
            s.holders.pop(object_id, None)
            s.local.pop(object_id, None)
            s.task_pins.pop(object_id, None)

    def counts(self, object_id: ObjectId) -> tuple:
        s = self._shard(object_id)
        with s.lock:
            return (s.local.get(object_id, 0),
                    s.task_pins.get(object_id, 0),
                    sum(s.holders.get(object_id, {}).values()))
