"""Head-side handle for a node living in another OS process / host.

The reference splits this across the raylet daemon plus the head's
gcs_node_manager and object_manager (ref: src/ray/raylet/node_manager.h:119;
src/ray/object_manager/object_manager.h:117 — chunked pulls;
python/ray/_private/node.py:1183,1220 process bring-up). The TPU-native
reduction keeps the single-controller design: ALL scheduling state (lease
queue, resource ledger, PG bundles) stays on the head in this class, which
reuses Node's logic wholesale; the remote agent process hosts only the
worker subprocesses and the shared-memory store. Control flows over one
duplex TCP channel; bulk object bytes move as chunked reads
(ref: ray_config_def.h:348 — 5 MiB chunks).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .ids import NodeId, ObjectId, WorkerId
from .node import Node, WorkerHandle
from .object_store import SegmentReader, pull_chunks
from .resources import ResourceSet
from .rpc import RpcChannel


class RemoteStoreProxy:
    """The slice of the PlasmaStore interface the head calls on a node.
    Bytes never move through here except via explicit chunk reads."""

    def __init__(self, node: "RemoteNode"):
        self._node = node

    def delete(self, object_id: ObjectId) -> None:
        ch = self._node.channel
        if ch is not None and not ch.closed:
            ch.notify("store_delete", {"object_id": object_id})

    def get_segment(self, object_id: ObjectId):
        # head cannot mmap a remote /dev/shm segment; fetch_one special-
        # cases remote nodes through pull_object_bytes instead
        return None

    def put_serialized(self, object_id, sobj, pin=True):
        """Push a serialized object into the remote agent's store in
        chunks (the inverse of the chunked pull path; ref:
        object_manager.h:117 Push). Unused by the default placement
        policy (driver puts land on the head; remote copies appear via
        execution locality) but fully functional for explicit remote
        placement."""
        data = sobj.to_bytes()
        total = len(data)
        chunk = 5 << 20  # mirror the pull path's 5 MiB chunks
        ch = self._node.channel
        if ch is None or ch.closed:
            raise ConnectionError(
                f"node {self._node.node_id.hex()[:8]} channel closed")
        off = 0
        try:
            while True:
                end = min(off + chunk, total)
                sealed = ch.call("store_put_chunk",
                                 {"object_id": object_id, "offset": off,
                                  "total": total, "data": data[off:end]},
                                 timeout=60)
                off = end
                if off >= total:
                    break
        except Exception:
            # a half-pushed object is an unsealed, unevictable reservation
            # of `total` bytes in the agent's store — release it
            try:
                ch.notify("store_delete", {"object_id": object_id})
            except Exception:
                pass
            raise
        if not sealed:
            raise RuntimeError(
                f"remote put of {object_id.hex()[:12]} did not seal")

    def stats(self) -> dict:
        try:
            return self._node.channel.call("store_stats", None, timeout=10)
        except Exception:
            return {}

    def destroy(self) -> None:
        pass  # owned by the agent process


class RemoteNode(Node):
    """A Node whose workers and store live behind a TCP channel.

    Scheduling (leases, resources, bundles) is inherited from Node and runs
    head-side; worker lifecycle operations are forwarded to the agent.
    """

    is_remote = True

    def __init__(self, runtime, node_id: NodeId, resources: ResourceSet,
                 config, channel: RpcChannel,
                 labels: Optional[Dict[str, str]] = None):
        # deliberately NOT calling Node.__init__ — no local store, no local
        # RpcServer, no prestarted subprocesses. Mirror its ledger state.
        from collections import deque

        from .resources import normalize

        self.runtime = runtime
        self.node_id = node_id
        self.config = config
        self.total_resources = normalize(resources)
        self.available = dict(self.total_resources)
        self.labels = labels or {}
        self.session_dir = runtime.session_dir
        self.store = RemoteStoreProxy(self)
        self.total_resources.pop("object_store_memory", None)
        self.available.pop("object_store_memory", None)
        self._lock = threading.RLock()
        self._workers: Dict[WorkerId, WorkerHandle] = {}
        self._idle = deque()
        self._lease_queue = {}  # (demand, pg, env) sig -> deque (Node's shape)
        self._bundles = {}
        self._starting_count = 0
        self._prefetch_depth = max(1, int(config.worker_task_prefetch))
        self._launch_failures = {}  # Node's launch-strike breaker state
        self.alive = True
        self.draining = False  # preemption-noticed: no NEW work lands here
        self.channel = channel
        self.peer_addr = None  # agent's P2P object-server (host, port)
        self._server = None
        self._reader = SegmentReader()
        self._max_workers = max(int(config.num_workers_soft_limit),
                                int(self.total_resources.get("CPU", 1)))
        channel.on_close(self._on_channel_close)
        # same idle-worker reclamation as the in-process Node: remote
        # workers are terminated over the channel when idle past the limit
        threading.Thread(target=self._idle_reaper_loop, daemon=True,
                         name="idle-reaper").start()

    # ---- worker lifecycle (forwarded) ---------------------------------------

    def _start_worker(self, container=None,
                      env_hash=None) -> WorkerHandle:
        worker_id = WorkerId.from_random()
        handle = WorkerHandle(worker_id=worker_id, proc=None,  # type: ignore
                              started_at=time.monotonic())
        if env_hash is not None:
            handle.env_hash = env_hash  # container workers: dedicated
        with self._lock:  # reentrant: callers may already hold it
            self._workers[worker_id] = handle
            self._starting_count += 1
        msg = {"worker_id": worker_id}
        if container is not None:
            # the agent launches inside the container on ITS host via
            # its configured launcher (same contract as the local Node)
            msg["container"] = dict(container)
        try:
            self.channel.notify("start_worker", msg)
        except Exception:
            self._on_worker_exit(handle)
        return handle

    def on_remote_worker_register(self, worker_id: WorkerId, pid: int,
                                  direct_addr: Optional[str] = None) -> None:
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is None:
                handle = WorkerHandle(worker_id=worker_id, proc=None,  # type: ignore
                                      pid=pid)
                self._workers[worker_id] = handle
            handle.pid = pid
            handle.direct_addr = direct_addr
            handle.state = "idle"
            self._starting_count = max(0, self._starting_count - 1)
            self._launch_failures.pop(handle.env_hash or "", None)
            self._idle.append(handle)
        self._dispatch()

    def on_remote_worker_exit(self, worker_id: WorkerId,
                              error: str = None) -> None:
        fail_req = None
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is None:
                return
            launch_failed = handle.state == "starting" and error
            if handle.state == "starting":
                self._starting_count = max(0, self._starting_count - 1)
            if launch_failed:
                # the worker never came up (e.g. container launcher
                # missing on the agent host): fail one queued request of
                # the env this worker was started for, instead of
                # looping start->fail forever
                want_env = handle.env_hash or ""
                for sig in list(self._lease_queue.keys()):
                    if sig[2] == want_env:
                        bucket = self._lease_queue[sig]
                        fail_req = bucket.popleft()
                        if not bucket:
                            del self._lease_queue[sig]
                        break
        if fail_req is not None and not fail_req.future.done():
            from ..exceptions import WorkerCrashedError

            fail_req.future.set_exception(WorkerCrashedError(
                f"remote worker launch failed on node "
                f"{self.node_id.hex()[:8]}: {error}"))
        self._on_worker_exit(handle)

    def _worker_alive(self, w: WorkerHandle) -> bool:
        # no head-side channel object; liveness is tracked by agent exit
        # notifications (the dedication loop lives in Node._pop_idle)
        return True

    def push_task(self, worker: WorkerHandle, spec) -> None:
        from .task_spec import TaskType

        with self._lock:
            worker.in_flight[spec.task_id] = spec
            if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                worker.state = "actor"
                worker.actor_id = spec.actor_id
        if not self.alive or self.channel.closed:
            self._on_worker_exit(worker)
            return
        self.channel.notify("push_task", {"worker_id": worker.worker_id,
                                          "spec": spec})

    def _terminate_worker(self, worker: WorkerHandle) -> None:
        with self._lock:  # the pop must not race a dispatch pass
            worker.state = "dead"
            self._workers.pop(worker.worker_id, None)
        self.runtime.refcount.release_holder(worker.worker_id)
        try:
            self.channel.notify("kill_worker", {"worker_id": worker.worker_id,
                                                "force": False})
        except Exception:
            pass

    def kill_worker(self, worker: WorkerHandle, force: bool = True) -> None:
        try:
            self.channel.notify("kill_worker", {"worker_id": worker.worker_id,
                                                "force": force})
        except Exception:
            pass

    # ---- on-demand introspection (relayed through the agent) -----------------

    def worker_stack(self, worker: WorkerHandle,
                     timeout: float = 5.0) -> dict:
        return self.channel.call(
            "worker_stack", {"worker_id": worker.worker_id,
                             "timeout": float(timeout)},
            timeout=float(timeout) + 10.0)

    def worker_profile(self, worker: WorkerHandle, duration_s: float = 5.0,
                       interval_s: float = 0.01) -> dict:
        return self.channel.call(
            "worker_profile", {"worker_id": worker.worker_id,
                               "duration_s": float(duration_s),
                               "interval_s": float(interval_s)},
            timeout=float(duration_s) + 40.0)

    # ---- compiled-graph control plane (relayed through the agent) ------------

    def worker_notify(self, worker: WorkerHandle, method: str,
                      payload) -> None:
        # raise on a provably-dead channel: the caller (cgraph execute /
        # head routing) must see the envelope as undelivered and run its
        # retraction/abort path rather than strand the consumer on a
        # seq that never arrives
        if not self.alive or self.channel.closed:
            raise RuntimeError(
                f"node {self.node_id.hex()[:8]} channel closed")
        self.channel.notify("worker_notify",
                            {"worker_id": worker.worker_id,
                             "method": method, "payload": payload})

    def worker_cgraph_call(self, worker: WorkerHandle, method: str,
                           payload, timeout: float = 30.0):
        return self.channel.call(
            "worker_relay_call", {"worker_id": worker.worker_id,
                                  "method": method, "payload": payload,
                                  "timeout": float(timeout)},
            timeout=timeout + 10.0)

    # ---- object transfer -----------------------------------------------------

    def pull_object_bytes(self, oid: ObjectId) -> Optional[bytes]:
        """Chunked pull of a remote object's serialized bytes
        (ref: object_manager.h:117 PullManager; 5 MiB chunks).

        Returns None ONLY when the agent definitively reports the object
        absent from its store (copy gone -> caller drops the directory
        entry and lineage recovery can run). Transient RPC failures RAISE
        so the caller retries instead of wrongly declaring the copy lost
        — conflating the two made a get() on an evicted remote copy hang
        forever (advisor r2)."""
        import time as _time

        from .object_store import _observe_op

        t0 = _time.perf_counter()
        size = self.channel.call("object_info", {"object_id": oid},
                                 timeout=30)
        if size is None:
            return None
        data = pull_chunks(
            lambda off, n: self.channel.call(
                "read_chunk",
                {"object_id": oid, "offset": off, "length": n},
                timeout=60),
            size)
        _observe_op("pull", t0, len(data) if data is not None else 0)
        return data

    # ---- lifecycle -----------------------------------------------------------

    def _on_channel_close(self) -> None:
        if not self.alive:
            return
        self.runtime.on_remote_node_lost(self.node_id)

    def shutdown(self, kill: bool = False) -> None:
        from ..exceptions import WorkerCrashedError

        with self._lock:
            if not self.alive:
                return
            self.alive = False
            queued = [r for b in self._lease_queue.values() for r in b]
            self._lease_queue.clear()
        for req in queued:
            if not req.future.done():
                req.future.set_exception(
                    WorkerCrashedError(f"node {self.node_id.hex()[:8]} shut down"))
        try:
            self.channel.notify("shutdown", {"kill": kill})
        except Exception:
            pass
        try:
            self.channel.close()
        except Exception:
            pass
