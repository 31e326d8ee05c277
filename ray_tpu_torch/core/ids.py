"""Unique identifiers for objects, tasks, actors, nodes, jobs, placement groups.

Design follows the reference's ID scheme in spirit (ref: src/ray/design_docs/
id_specification.md — ids are fixed-size random byte strings with embedded
provenance), simplified: every id is 16 random bytes, hex-printable. ObjectIds
embed the creating task's id plus a return/put index so lineage can be derived
without a lookup table.
"""
from __future__ import annotations

import os
import threading

_ID_SIZE = 16

_NIL = b"\x00" * _ID_SIZE

_rand_local = threading.local()


class BaseId:
    __slots__ = ("_bytes", "_hash")
    _kind = "Id"

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != _ID_SIZE:
            raise ValueError(f"{self._kind} requires {_ID_SIZE} bytes, got {id_bytes!r}")
        self._bytes = id_bytes

    @classmethod
    def from_random(cls):
        # os.urandom is a syscall (~100us under load): batch a page of
        # entropy per thread and slice ids from it (task-heavy drivers
        # mint thousands of ids per second)
        local = _rand_local
        buf = getattr(local, "buf", b"")
        pos = getattr(local, "pos", 0)
        if pos + _ID_SIZE > len(buf):
            buf = local.buf = os.urandom(_ID_SIZE * 256)
            pos = local.pos = 0
        local.pos = pos + _ID_SIZE
        return cls(buf[pos:pos + _ID_SIZE])

    @classmethod
    def nil(cls):
        return cls(_NIL)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def is_nil(self) -> bool:
        return self._bytes == _NIL

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        # ids key every hot table; cache the hash (immutable value).
        try:
            return self._hash
        except AttributeError:
            h = self._hash = hash((self._kind, self._bytes))
            return h

    def __reduce__(self):
        # NEVER pickle the cached hash: bytes hashing is salted per
        # process (PYTHONHASHSEED), so a hash computed in a worker is
        # wrong in the driver — equal ids would miss every dict lookup
        return (type(self), (self._bytes,))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:12]})"


class JobId(BaseId):
    _kind = "Job"


class NodeId(BaseId):
    _kind = "Node"


class WorkerId(BaseId):
    _kind = "Worker"


class ActorId(BaseId):
    _kind = "Actor"


class PlacementGroupId(BaseId):
    _kind = "PlacementGroup"


class TaskId(BaseId):
    _kind = "Task"


class ObjectId(BaseId):
    """Object ids embed provenance: first 12 bytes = owning task id prefix,
    last 4 bytes = index (put or return slot). Mirrors the reference's scheme
    where ObjectIDs are computed from TaskID + index (id_specification.md)."""

    _kind = "Object"

    @classmethod
    def for_task_return(cls, task_id: TaskId, index: int) -> "ObjectId":
        return cls(task_id.binary()[:12] + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskId, put_index: int) -> "ObjectId":
        # puts use the high bit of the index to avoid clashing with returns
        return cls(task_id.binary()[:12] + (put_index | 0x8000_0000).to_bytes(4, "little"))

    def task_prefix(self) -> bytes:
        return self._bytes[:12]

    def index(self) -> int:
        return int.from_bytes(self._bytes[12:], "little")


class _Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def next(self) -> int:
        with self._lock:
            self._n += 1
            return self._n


__all__ = [
    "BaseId",
    "JobId",
    "NodeId",
    "WorkerId",
    "ActorId",
    "PlacementGroupId",
    "TaskId",
    "ObjectId",
]
