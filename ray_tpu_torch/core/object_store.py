"""Per-node shared-memory object store + per-process memory store.

Equivalent of the reference's plasma store + core-worker memory store
(ref: src/ray/object_manager/plasma/store.h:55 ObjectLifecycleManager,
eviction_policy.h LRUCache, create_request_queue.h backpressure;
src/ray/core_worker/store_provider/memory_store/ for small objects).

TPU-host design: one store per node; each sealed object lives in its own
POSIX shared-memory segment (mmap) so any process on the host maps it
zero-copy. Creation follows the plasma protocol shape: clients ask the store
to create (reserving capacity, may trigger LRU eviction or disk spill), write
into the mapped buffer, then seal. Primary copies are pinned (not evictable)
until the owner releases them; unpinned copies are LRU-evicted or spilled to
disk under memory pressure (ref: src/ray/raylet/local_object_manager.h:41).

The C++ store (ray_tpu_torch/native/store.cpp, wrapped by NativePlasmaStore
below) plugs in behind the same interface when the toolchain can build
it — `make_store` picks it by default; this Python implementation is the
always-available fallback and the semantics reference.
"""
from __future__ import annotations

import mmap
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from multiprocessing import shared_memory
from typing import Dict, Optional

from ..devtools.locks import instrumented_lock
from ..exceptions import ObjectStoreFullError
from ..util import metrics as _metrics
from .ids import NodeId, ObjectId
from .serialization import SerializedObject

# store-op latency + transfer volume (ref: the reference's plasma store
# and object_manager stats). In worker/agent processes these live in the
# local registry and ship to the head node-tagged via metrics_push /
# heartbeat piggyback.
_H_STORE_OP = _metrics.Histogram(
    "ray_tpu_object_store_op_seconds",
    "shared-memory store operation latency",
    boundaries=_metrics.FAST_BOUNDARIES, tag_keys=("op",))
_C_TRANSFER_BYTES = _metrics.Counter(
    "ray_tpu_object_transfer_bytes_total",
    "bytes moved by store puts/gets and inter-node pulls",
    tag_keys=("op",))


def _observe_op(op: str, t0: float, nbytes: Optional[int] = None) -> None:
    _H_STORE_OP.observe(time.perf_counter() - t0, tags={"op": op})
    if nbytes:
        _C_TRANSFER_BYTES.inc(nbytes, tags={"op": op})


# Note on resource tracking: only the driver process creates SharedMemory
# segments (workers attach via /dev/shm mmap — see SegmentReader), so the
# stock resource_tracker bookkeeping is already balanced: __init__ registers,
# unlink() unregisters, and a crashed driver leaves the tracker to clean up.


@dataclass
class _Entry:
    shm: Optional[shared_memory.SharedMemory]
    size: int
    sealed: bool = False
    pinned: bool = False
    spilled_path: Optional[str] = None
    created_at: float = field(default_factory=time.monotonic)



def _assemble_chunk(partial, object_id, offset, total, data,
                    create, write, finish) -> bool:
    """Shared chunked-push state machine for both store classes. Chunks
    must arrive in order; offset 0 RESTARTS the object (a caller retrying
    a failed push from scratch must not inherit a stale byte counter and
    seal with an unwritten tail). Returns True when the object seals."""
    if offset == 0:
        create()
        partial[object_id] = 0
    expect = partial.get(object_id)
    if expect is None or offset != expect:
        raise ValueError(
            f"out-of-order chunk for {object_id.hex()[:12]}: "
            f"offset {offset}, expected {expect}")
    write(offset, data)
    partial[object_id] = offset + len(data)
    if partial[object_id] >= total:
        del partial[object_id]
        finish()
        return True
    return False


class PlasmaStore:
    """Host shared-memory store for one (possibly simulated) node."""

    def __init__(self, node_id: NodeId, capacity_bytes: int, spill_dir: str = "",
                 min_spilling_size: int = 1024 * 1024):
        self._node_id = node_id
        self._prefix = f"rtpu{node_id.hex()[:10]}"
        self._capacity = capacity_bytes
        self._min_spilling_size = min_spilling_size
        self._used = 0
        self._lock = instrumented_lock("object_store", reentrant=True)
        self._partial: Dict[ObjectId, int] = {}  # chunked-push progress
        self._entries: "OrderedDict[ObjectId, _Entry]" = OrderedDict()
        self._spill_dir = spill_dir
        # external storage tier: an fsspec URL ("s3://...", "gs://...",
        # "memory://...") spills over the network instead of local disk
        # (ref: python/ray/_private/external_storage.py:72 — there via
        # smart_open; here the same fsspec machinery as tune/syncer.py)
        self._spill_fs = None
        self._spill_root = ""
        if spill_dir and "://" in spill_dir:
            from ..util.fs import split_fs_url

            self._spill_fs, self._spill_root = split_fs_url(spill_dir)
            try:
                self._spill_fs.makedirs(self._spill_root, exist_ok=True)
            except Exception:
                pass
            spill_dir = ""  # no local mkdir below
        self._destroyed = False
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self.num_evictions = 0
        self.num_spills = 0
        self._channels: set = set()  # live compiled-graph channel segments

    # -- plasma protocol: create -> write -> seal ------------------------------

    def segment_name(self, object_id: ObjectId) -> str:
        return f"{self._prefix}_{object_id.hex()}"

    def create(self, object_id: ObjectId, size: int) -> str:
        """Reserve capacity and create the segment; returns the shm name the
        client should attach to and write into. Raises ObjectStoreFullError if
        space cannot be made (create-queue backpressure is handled by caller)."""
        with self._lock:
            if object_id in self._entries:
                # idempotent re-create: lineage reconstruction may re-run the
                # producing task while a stale entry lingers
                self._release_entry(self._entries.pop(object_id))
            self._ensure_space(size)
            name = self.segment_name(object_id)
            try:
                shm = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
            except FileExistsError:
                # stale segment from a previous run; reclaim it
                stale = shared_memory.SharedMemory(name=name)
                stale.close()
                stale.unlink()
                shm = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
            self._entries[object_id] = _Entry(shm=shm, size=size)
            self._used += size
            return name

    def seal(self, object_id: ObjectId) -> None:
        with self._lock:
            e = self._entries[object_id]
            e.sealed = True
            self._entries.move_to_end(object_id)

    def put_serialized(self, object_id: ObjectId, sobj: SerializedObject,
                       pin: bool = True) -> None:
        """Create+write+seal in one step (server-local fast path)."""
        t0 = time.perf_counter()
        # hold the (reentrant) lock across create->write->seal: a
        # concurrent create's eviction pass must not drop the entry
        # mid-write (same discipline as the native store's put path)
        with self._lock:
            self.create(object_id, sobj.total_bytes)
            e = self._entries[object_id]
            sobj.write_into(memoryview(e.shm.buf))
            e.pinned = pin
            self.seal(object_id)
        _observe_op("put", t0, sobj.total_bytes)

    def put_bytes(self, object_id: ObjectId, data: bytes, pin: bool = True) -> None:
        t0 = time.perf_counter()
        with self._lock:  # see put_serialized: write under the lock
            self.create(object_id, len(data))
            e = self._entries[object_id]
            e.shm.buf[: len(data)] = data
            e.pinned = pin
            self.seal(object_id)
        _observe_op("put", t0, len(data))

    def put_chunk(self, object_id: ObjectId, offset: int, total: int,
                  data: bytes, pin: bool = True) -> bool:
        """Incremental create->write->seal for chunked pushes (the head's
        remote-put path; mirror of read_store_chunk on the pull side).
        Returns True when the final chunk seals the object."""
        with self._lock:
            def finish():
                e = self._entries[object_id]
                e.pinned = pin
                self.seal(object_id)

            return _assemble_chunk(
                self._partial, object_id, offset, total, data,
                create=lambda: self.create(object_id, total),
                write=lambda off, d: self._entries[object_id].shm.buf
                .__setitem__(slice(off, off + len(d)), d),
                finish=finish)

    # -- compiled-graph channels (ray_tpu_torch/cgraph) ------------------------------
    # A channel is a pre-allocated single-slot segment reused for the life
    # of a compiled graph: created once at compile time, written/read in
    # place by the producer/consumer processes (never sealed — sealing
    # means immutable), pinned so neither eviction nor spilling can touch
    # it, and released by teardown. Backpressure comes from slot occupancy
    # in the channel header (cgraph/channel.py), not from store capacity.

    def allocate_channel(self, channel_id: ObjectId, size: int) -> str:
        """Reserve a mutable, pinned segment for a compiled-graph channel;
        returns the shm name both endpoints attach to."""
        with self._lock:
            name = self.create(channel_id, size)
            e = self._entries[channel_id]
            e.pinned = True  # belt: unsealed entries are already
            # invisible to the LRU/spill scans, which require sealed
            self._channels.add(channel_id)
            return name

    def release_channel(self, channel_id: ObjectId) -> None:
        """Teardown: unlink the channel segment and return its capacity.
        Attached readers keep their mapping until they release it (POSIX
        unlink semantics), so a racing in-flight read cannot fault."""
        with self._lock:
            self._channels.discard(channel_id)
            self.delete(channel_id)

    # -- reads -----------------------------------------------------------------

    def contains(self, object_id: ObjectId) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.sealed

    def get_bytes(self, object_id: ObjectId) -> Optional[bytes]:
        """Copy out the object payload (used for inter-node transfer and
        restore; local readers should attach to the segment instead)."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                return None
            if e.shm is None:
                return self._read_spilled(e)
            self._entries.move_to_end(object_id)
            return bytes(e.shm.buf[: e.size])

    def object_size(self, object_id: ObjectId) -> Optional[int]:
        with self._lock:
            e = self._entries.get(object_id)
            return None if e is None else e.size

    def get_segment(self, object_id: ObjectId) -> Optional[tuple[str, int]]:
        """Return (shm_name, size) for zero-copy local access; restores a
        spilled object back into shared memory first if needed."""
        t0 = time.perf_counter()
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.sealed:
                return None
            if e.shm is None:  # spilled: restore
                data = self._read_spilled(e)
                if data is None:
                    # external spill copy lost/unreachable: report the
                    # object missing (lineage recovery's signal) rather
                    # than poisoning the entry with a half-made segment
                    return None
                self._ensure_space(e.size)
                shm = shared_memory.SharedMemory(
                    name=self.segment_name(object_id), create=True, size=max(e.size, 1))
                shm.buf[: e.size] = data
                e.shm = shm
                self._used += e.size
            self._entries.move_to_end(object_id)
            size = e.size
        _observe_op("get", t0, size)
        return self.segment_name(object_id), size

    # -- lifetime --------------------------------------------------------------

    def pin(self, object_id: ObjectId) -> None:
        with self._lock:
            if object_id in self._entries:
                self._entries[object_id].pinned = True

    def unpin(self, object_id: ObjectId) -> None:
        with self._lock:
            if object_id in self._entries:
                self._entries[object_id].pinned = False

    def delete(self, object_id: ObjectId) -> None:
        with self._lock:
            e = self._entries.pop(object_id, None)
            if e is None:
                return
            self._release_entry(e)

    def _release_entry(self, e: _Entry) -> None:
        if e.shm is not None:
            self._used -= e.size
            try:
                e.shm.close()
                e.shm.unlink()
            except FileNotFoundError:
                pass
        if e.spilled_path:
            if self._spill_fs is not None:
                try:
                    self._spill_fs.rm(e.spilled_path)
                except Exception:
                    pass  # remote tier cleanup is best-effort
            else:
                try:
                    os.unlink(e.spilled_path)
                except FileNotFoundError:
                    pass  # anything else (EPERM, EROFS) must surface

    def _ensure_space(self, size: int) -> None:
        if size > self._capacity:
            raise ObjectStoreFullError(
                f"Object of {size} bytes exceeds store capacity {self._capacity}")
        while self._used + size > self._capacity:
            victim = None
            spill_only = False
            for oid, e in self._entries.items():  # LRU order
                if e.sealed and not e.pinned and e.shm is not None:
                    victim = (oid, e)
                    break
            if victim is None and self._spill_dir:
                # second pass: PINNED primaries may spill (never evict) —
                # the data survives in the spill tier and restores on
                # access. This is what spilling is FOR in the reference
                # (local_object_manager.cc spills pinned primary copies
                # when memory pressure demands it).
                for oid, e in self._entries.items():
                    if e.sealed and e.shm is not None \
                            and e.size >= self._min_spilling_size:
                        victim = (oid, e)
                        spill_only = True
                        break
            if victim is None:
                raise ObjectStoreFullError(
                    f"Store full ({self._used}/{self._capacity} bytes) and no "
                    f"evictable objects (all pinned)")
            oid, e = victim
            # large objects are worth a disk write (restorable later); small
            # ones are simply evicted — their owner can reconstruct
            # (ref: min_spilling_size, local_object_manager.h:110)
            if self._spill_dir and e.size >= self._min_spilling_size:
                if not self._spill(oid, e) and spill_only:
                    # spill tier failed for a PINNED primary: its bytes
                    # must not be dropped — surface the pressure
                    raise ObjectStoreFullError(
                        f"Store full and spill tier unavailable for "
                        f"pinned {oid.hex()[:12]}")
            else:
                self._evict(oid, e)

    def _spill(self, oid: ObjectId, e: _Entry) -> bool:
        """-> True if the bytes landed in the spill tier (False = the
        entry was evicted instead; only legal for unpinned copies)."""
        name = f"{self._prefix}_{oid.hex()}"
        if self._spill_fs is not None:
            path = f"{self._spill_root}/{name}"
            try:
                with self._spill_fs.open(path, "wb") as f:
                    f.write(bytes(e.shm.buf[: e.size]))
            except Exception:
                # unreachable external storage: evict instead — the
                # owner reconstructs via lineage (failure path, tested)
                if not e.pinned:
                    self._evict(oid, e)
                return False
        else:
            path = os.path.join(self._spill_dir, name)
            with open(path, "wb") as f:
                f.write(e.shm.buf[: e.size])
        e.spilled_path = path
        e.shm.close()
        e.shm.unlink()
        e.shm = None
        self._used -= e.size
        self.num_spills += 1
        return True

    def _evict(self, oid: ObjectId, e: _Entry) -> None:
        self._entries.pop(oid)
        self._release_entry(e)
        self.num_evictions += 1

    def _read_spilled(self, e: _Entry) -> Optional[bytes]:
        if not e.spilled_path:
            return None
        if self._spill_fs is not None:
            try:
                with self._spill_fs.open(e.spilled_path, "rb") as f:
                    return f.read()
            except Exception:
                return None  # external copy gone: surfaces as object lost
        with open(e.spilled_path, "rb") as f:
            return f.read()

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self._capacity,
                "used": self._used,
                "num_objects": len(self._entries),
                "num_evictions": self.num_evictions,
                "num_spills": self.num_spills,
                "num_channels": len(self._channels),
            }

    def destroy(self) -> None:
        """Unlink every segment — simulates node loss for chaos tests."""
        with self._lock:
            if self._destroyed:
                return
            self._destroyed = True
            for e in self._entries.values():
                self._release_entry(e)
            self._entries.clear()
            self._used = 0


class NativePlasmaStore:
    """PlasmaStore surface over the C++ core (ray_tpu_torch/native/store.cpp):
    segment lifecycle, LRU/spill/evict decisions, capacity accounting and
    crc32c seal checksums run native; Python only moves payload bytes
    through zero-copy memoryviews of the C++-owned mappings. Same
    file-per-object /dev/shm layout, so SegmentReader and the transfer
    protocol are untouched."""

    def __init__(self, lib, node_id: NodeId, capacity_bytes: int,
                 spill_dir: str = "", min_spilling_size: int = 1024 * 1024):
        self._lib = lib
        self._node_id = node_id
        self._prefix = f"rtpu{node_id.hex()[:10]}"
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self._h = lib.rtpu_store_open(self._prefix.encode(),
                                      capacity_bytes,
                                      spill_dir.encode() or None,
                                      min_spilling_size)
        self._destroyed = False
        self._lock = instrumented_lock("object_store.native", reentrant=True)
        self._partial: Dict[ObjectId, int] = {}  # chunked-push progress
        self._channels: set = set()  # live compiled-graph channel segments

    def segment_name(self, object_id: ObjectId) -> str:
        return f"{self._prefix}_{object_id.hex()}"

    def _view(self, object_id: ObjectId):
        import ctypes

        if self._h is None:  # destroyed (simulated node death)
            return None, 0, False
        ptr = ctypes.c_void_p()
        size = ctypes.c_uint64()
        sealed = ctypes.c_int()
        rc = self._lib.rtpu_store_get(self._h, object_id.hex().encode(),
                                      ctypes.byref(ptr), ctypes.byref(size),
                                      ctypes.byref(sealed))
        if rc != 0:
            return None, 0, False
        n = size.value
        buf = (ctypes.c_char * max(n, 1)).from_address(ptr.value)
        return memoryview(buf).cast("B")[:n], n, bool(sealed.value)

    # -- plasma protocol ---------------------------------------------------

    def create(self, object_id: ObjectId, size: int) -> str:
        with self._lock:
            if self._h is None:
                raise ObjectStoreFullError("store destroyed")
            rc = self._lib.rtpu_store_create(self._h,
                                             object_id.hex().encode(), size)
        if rc == -1:
            raise ObjectStoreFullError(
                f"Object of {size} bytes exceeds store capacity")
        if rc != 0:
            raise ObjectStoreFullError(
                "Store full and no evictable objects (all pinned)")
        return self.segment_name(object_id)

    def _call(self, fn, *args) -> int:
        with self._lock:
            if self._h is None:
                return -1
            return fn(self._h, *args)

    def seal(self, object_id: ObjectId) -> None:
        self._call(self._lib.rtpu_store_seal, object_id.hex().encode(), 1)

    def put_serialized(self, object_id: ObjectId, sobj: SerializedObject,
                       pin: bool = True) -> None:
        # the whole create->write->seal sequence runs under the store
        # lock: a concurrent delete/destroy/re-create of the same oid
        # would munmap the segment mid-write and the ctypes view write
        # would SIGSEGV (the Python store fails safe via BufferError;
        # the native mapping has no such guard)
        t0 = time.perf_counter()
        with self._lock:
            self.create(object_id, sobj.total_bytes)
            mv, _, _ = self._view(object_id)
            sobj.write_into(mv)
            del mv
            if pin:
                self.pin(object_id)
            self.seal(object_id)
        _observe_op("put", t0, sobj.total_bytes)

    def put_chunk(self, object_id: ObjectId, offset: int, total: int,
                  data: bytes, pin: bool = True) -> bool:
        """Chunked create->write->seal (native-store mirror of the Python
        store's put_chunk; the RLock makes nested create/pin/seal safe)."""
        with self._lock:
            def write(off, d):
                mv, _n, _sealed = self._view(object_id)
                mv[off:off + len(d)] = d
                del mv

            def finish():
                if pin:
                    self.pin(object_id)
                self.seal(object_id)

            return _assemble_chunk(
                self._partial, object_id, offset, total, data,
                create=lambda: self.create(object_id, total),
                write=write, finish=finish)

    def put_bytes(self, object_id: ObjectId, data: bytes,
                  pin: bool = True) -> None:
        t0 = time.perf_counter()
        with self._lock:  # see put_serialized: write under the lock
            self.create(object_id, len(data))
            mv, _, _ = self._view(object_id)
            mv[:len(data)] = data
            del mv
            if pin:
                self.pin(object_id)
            self.seal(object_id)
        _observe_op("put", t0, len(data))

    # -- compiled-graph channels (same contract as PlasmaStore's) ----------

    def allocate_channel(self, channel_id: ObjectId, size: int) -> str:
        with self._lock:
            name = self.create(channel_id, size)
            self.pin(channel_id)  # channels must never evict or spill
            self._channels.add(channel_id)
            return name

    def release_channel(self, channel_id: ObjectId) -> None:
        with self._lock:
            self._channels.discard(channel_id)
            self.delete(channel_id)

    # -- reads -------------------------------------------------------------

    def contains(self, object_id: ObjectId) -> bool:
        return self._call(self._lib.rtpu_store_contains,
                          object_id.hex().encode()) == 1

    def get_bytes(self, object_id: ObjectId) -> Optional[bytes]:
        with self._lock:
            mv, n, _ = self._view(object_id)
            if mv is None:
                return None
            out = bytes(mv[:n])
            del mv
            return out

    def get_segment(self, object_id: ObjectId) -> Optional[tuple]:
        t0 = time.perf_counter()
        with self._lock:
            mv, n, sealed = self._view(object_id)  # restores spilled
            if mv is None or not sealed:
                return None
            del mv
        _observe_op("get", t0, n)
        return self.segment_name(object_id), n

    def object_size(self, object_id: ObjectId) -> Optional[int]:
        with self._lock:
            mv, n, _ = self._view(object_id)
            if mv is None:
                return None
            del mv
            return n

    def verify(self, object_id: ObjectId) -> Optional[bool]:
        """crc32c integrity check of a sealed in-memory object: True ok,
        False CORRUPTED, None unknown/spilled."""
        rc = self._call(self._lib.rtpu_store_verify,
                        object_id.hex().encode())
        return None if rc < 0 else bool(rc)

    # -- lifetime ----------------------------------------------------------

    def pin(self, object_id: ObjectId) -> None:
        self._call(self._lib.rtpu_store_pin, object_id.hex().encode(), 1)

    def unpin(self, object_id: ObjectId) -> None:
        self._call(self._lib.rtpu_store_pin, object_id.hex().encode(), 0)

    def delete(self, object_id: ObjectId) -> None:
        self._call(self._lib.rtpu_store_delete, object_id.hex().encode())

    def stats(self) -> dict:
        import ctypes

        vals = [ctypes.c_uint64() for _ in range(5)]
        with self._lock:
            if self._h is None:
                return {"native": True, "destroyed": True}
            self._lib.rtpu_store_stats(self._h,
                                       *[ctypes.byref(v) for v in vals])
        return {"capacity": vals[1].value, "used": vals[0].value,
                "num_objects": vals[2].value,
                "num_evictions": vals[3].value,
                "num_spills": vals[4].value, "native": True,
                "num_channels": len(self._channels)}

    def destroy(self) -> None:
        with self._lock:
            if self._destroyed:
                return
            self._destroyed = True
            self._lib.rtpu_store_destroy(self._h)
            self._h = None


def make_store(node_id: NodeId, capacity_bytes: int, spill_dir: str = "",
               min_spilling_size: int = 1024 * 1024):
    """Native store when the C++ layer builds (default), else the Python
    reference implementation. RTPU_NATIVE_STORE=0 forces Python."""
    from ..native import load_store_lib

    lib = load_store_lib()
    if lib is not None and "://" not in (spill_dir or ""):
        # fsspec spill URLs route through the Python store (the C++ core
        # spills to local paths only)
        return NativePlasmaStore(lib, node_id, capacity_bytes, spill_dir,
                                 min_spilling_size)
    return PlasmaStore(node_id, capacity_bytes, spill_dir,
                       min_spilling_size)


# ---------------------------------------------------------------------------
# chunked object transfer (ref: object_manager.h:117; 5 MiB chunks per
# ray_config_def.h:348). Shared by both transfer directions: the head
# pulling from an agent and an agent pulling from the head.
# ---------------------------------------------------------------------------

TRANSFER_CHUNK = 5 * 1024 * 1024


def read_store_chunk(store: "PlasmaStore", reader: "SegmentReader",
                     object_id: ObjectId, offset: int, length: int):
    """Serve one chunk of a sealed object's bytes, or None if gone."""
    seg = store.get_segment(object_id)
    if seg is None:
        return None
    name, size = seg
    mv = reader.read(name, size)
    try:
        return bytes(mv[offset:offset + length])
    finally:
        del mv
        reader.release(name)


def pull_chunks(fetch_chunk, total: int) -> Optional[bytes]:
    """Assemble an object from sequential fetch_chunk(offset, length) calls;
    None if the source loses the object mid-transfer."""
    buf = bytearray(total)
    off = 0
    while off < total:
        n = min(TRANSFER_CHUNK, total - off)
        chunk = fetch_chunk(off, n)
        if chunk is None:
            return None
        buf[off:off + len(chunk)] = chunk
        off += len(chunk)
    return bytes(buf)


class SegmentReader:
    """Client-side zero-copy attach to sealed segments; caches attachments.

    Attaches via direct /dev/shm mmap rather than
    multiprocessing.shared_memory, so Python's global resource_tracker (one
    per cluster, inherited from the driver) never sees attach-side
    register/unregister pairs — those collide across processes on 3.12.
    The memoryview handed out references the mmap; the attachment stays open
    until release() (equivalent of the plasma client's object release)."""

    def __init__(self):
        self._attached: Dict[str, mmap.mmap] = {}
        self._lock = instrumented_lock("segment_reader")

    def read(self, shm_name: str, size: int) -> memoryview:
        with self._lock:
            mm = self._attached.get(shm_name)
            if mm is None:
                with open("/dev/shm/" + shm_name, "r+b") as f:
                    mm = mmap.mmap(f.fileno(), 0)
                self._attached[shm_name] = mm
            return memoryview(mm)[:size]

    def release(self, shm_name: str) -> None:
        with self._lock:
            mm = self._attached.pop(shm_name, None)
            if mm is not None:
                try:
                    mm.close()
                except Exception:
                    pass

    def close(self) -> None:
        with self._lock:
            for mm in self._attached.values():
                try:
                    mm.close()
                except Exception:
                    pass
            self._attached.clear()
