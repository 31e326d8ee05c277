"""The per-process runtime: driver (head) and worker variants.

Equivalent of the reference's CoreWorker (ref: src/ray/core_worker/
core_worker.h:284 — Put :558, Get :665, Wait :704, SubmitTask :828,
CreateActor :849, SubmitActorTask :895) plus the direct task submitter
(transport/direct_task_transport.h:75) and the object directory.

Single-controller deviation (TPU-native stance): the head process owns the
control plane (GCS), the cluster view, and object ownership. Worker processes
run a thin WorkerRuntime that proxies the same API over their node channel —
the analog of the Cython binding calling into CoreWorker
(python/ray/_raylet.pyx:3111 submit_task).
"""
from __future__ import annotations

import collections
import contextvars
import hashlib
import os
import tempfile
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .._vendor import cloudpickle

from .. import exceptions as exc
from ..devtools.locks import instrumented_lock
from ..perf.recorder import get_recorder as _get_recorder
from ..util import metrics as metrics_mod
from ..util.retry import RetryPolicy
from . import serialization
from .config import Config
from .gcs import ActorInfo, ActorState, Gcs, JobInfo, NodeInfo
from .ids import ActorId, JobId, NodeId, ObjectId, PlacementGroupId, TaskId, WorkerId
from .node import Node, WorkerHandle
from .object_ref import ObjectRef
from .object_store import SegmentReader
from .resources import ResourceSet, normalize, res_ge
from .scheduling_policy import NodeView, Scheduler
from .task_manager import ReferenceCounter, TaskManager
from .task_spec import (ARG_REF, ARG_VALUE, STREAMING_RETURNS,
                        SchedulingStrategy, TaskSpec, TaskType)

# the serve controller's actor name (ray_tpu/serve/controller.py:22); the
# serve control plane is not ported yet, so the value lives here
CONTROLLER_NAME = "SERVE_CONTROLLER"

_runtime_lock = instrumented_lock("runtime.global_registry")
_runtime: Optional[object] = None

# fault-injection hook (ray_tpu_torch.chaos): None until chaos.enable()
# installs an engine; the pull path pays one global is-None test
_CHAOS = None

_C_HEARTBEAT_MISSES = metrics_mod.Counter(
    "ray_tpu_heartbeat_misses_total",
    "health-check periods that elapsed without an agent heartbeat",
    tag_keys=("node",))

# elastic capacity (docs/FAULT_TOLERANCE.md "Elasticity"): every node
# that leaves after a preemption notice counts here — outcome=drained
# when it left with no busy workers (the notice worked), outcome=lost
# when the axe beat the drain and live work died with it
_C_PREEMPTIONS = metrics_mod.Counter(
    "ray_tpu_node_preemptions_total",
    "preemption-noticed nodes that left the cluster, by drain outcome",
    tag_keys=("outcome",))

# dispatch-fallback reconnect policy (util/retry.py): how long a failed
# direct-peer connect keeps the actor on the routed path before the next
# attempt — grows per consecutive failure, resets on success
_DIRECT_RECONNECT = RetryPolicy(initial_backoff_s=2.5, multiplier=2.0,
                                max_backoff_s=30.0, jitter=0.3)

# hot-path latency instruments (head side; the worker-side mirrors live
# in each worker's registry and ship to the head via metrics_push)
_H_GET_WAIT = metrics_mod.Histogram(
    "ray_tpu_get_wait_seconds",
    "blocking wait in ray_tpu_torch.get() / fetch_one")
_H_RESULT_PUT = metrics_mod.Histogram(
    "ray_tpu_task_result_put_seconds",
    "head-side intake of a finished task's results",
    boundaries=metrics_mod.FAST_BOUNDARIES)
# decentralized dispatch (docs/DISPATCH.md): per-process counters for the
# two submission paths; worker processes' increments ship to the head via
# the metrics plane, so a cluster-wide scrape shows the split
_C_DIRECT = metrics_mod.Counter(
    "ray_tpu_task_direct_total",
    "actor tasks submitted on the direct path (no head hop)")
_C_ROUTED = metrics_mod.Counter(
    "ray_tpu_task_routed_total",
    "tasks submitted through the head (routed path)")


def dispatch_counts() -> Tuple[float, float]:
    """(direct, routed) submissions counted IN THIS PROCESS — the test
    hook for 'steady-state actor calls make zero head RPCs'."""
    return _C_DIRECT.total(), _C_ROUTED.total()


# flight recorder (ray_tpu_torch.perf): dispatch decisions land in the
# per-process ring so a post-mortem bundle shows what was routed where
# in the seconds before an abort
_FLREC = _get_recorder()


def _rec_dispatch(path: str, spec) -> None:
    if _FLREC.enabled:
        _FLREC.record(f"dispatch.{path}", spec.description,
                      {"task": spec.task_id.hex()[:12]})


class ShardedLoop:
    """N worker threads, each owning a FIFO queue; work is keyed so every
    item with one key runs on one thread IN ORDER (docs/DISPATCH.md —
    the sharded head event loop).

    The agent channel multiplexes every remote worker onto ONE oneway
    lane; keying its intake (task_done / object_sealed / worker_call /
    worker_exit) by worker id spreads the head's dispatch work across
    cores while preserving the per-worker FIFO that the crash/completion
    protocol relies on."""

    def __init__(self, name: str, shards: int):
        import queue as _q

        self._queues = [_q.SimpleQueue() for _ in range(max(1, shards))]
        self._n = len(self._queues)
        for i, q in enumerate(self._queues):
            threading.Thread(target=self._run, args=(q,), daemon=True,
                             name=f"{name}-s{i}").start()

    def submit(self, key, fn, *args) -> None:
        self._queues[hash(key) % self._n].put((fn, args))

    @staticmethod
    def _run(q) -> None:
        import traceback as _tb

        while True:
            fn, args = q.get()
            try:
                fn(*args)
            except Exception:
                _tb.print_exc()


def set_runtime(rt) -> None:
    global _runtime
    with _runtime_lock:
        _runtime = rt


def get_runtime():
    if _runtime is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init() first.")
    return _runtime


def maybe_runtime():
    return _runtime


@dataclass
class RuntimeContext:
    job_id: JobId
    node_id: Optional[NodeId]
    worker_id: WorkerId
    task_id: Optional[TaskId] = None
    actor_id: Optional[ActorId] = None
    namespace: str = "default"

    def get_job_id(self):
        return self.job_id.hex()

    def get_node_id(self):
        return self.node_id.hex() if self.node_id else None

    def get_actor_id(self):
        return self.actor_id.hex() if self.actor_id else None


class _ObjShard:
    """One shard of the head's object state (docs/DISPATCH.md): the
    in-memory store, location directory, availability events, waiter
    lists, sizes, nested-result pins, and in-flight pull futures for the
    object ids hashing here — under one shard lock. Every object
    operation is single-oid, so shards never deadlock each other; only
    node-death sweeps iterate all shards."""

    __slots__ = ("lock", "mem", "dir", "events", "sizes", "waiters",
                 "nested", "pulls")

    def __init__(self, index: int):
        self.lock = instrumented_lock(f"runtime.obj.s{index}")
        self.mem: Dict[ObjectId, bytes] = {}
        self.dir: Dict[ObjectId, Set[NodeId]] = {}
        self.events: Dict[ObjectId, threading.Event] = {}
        self.sizes: Dict[ObjectId, int] = {}
        self.waiters: Dict[ObjectId, list] = {}
        self.nested: Dict[ObjectId, list] = {}
        self.pulls: Dict[ObjectId, Future] = {}


@dataclass
class _ActorRecord:
    info: ActorInfo
    seq: int = 0
    worker: Optional[WorkerHandle] = None
    node_id: Optional[NodeId] = None
    queued: List[TaskSpec] = field(default_factory=list)
    lock: Any = field(
        default_factory=lambda: instrumented_lock("runtime.actor_record"))
    # direct dispatch (docs/DISPATCH.md): placement epoch (bumped each
    # time the actor lands on a worker — the version stamp callers cache),
    # the driver's own direct-lane sequence counter, its in-flight direct
    # tasks (resubmitted via the head on worker/peer failure), and the
    # cached peer channel for remote-node workers
    epoch: int = 0
    dseq: int = 0
    # connection-era token for the direct lane: bumped on every new peer
    # channel (dseq restarts at 0 with it), carried in each direct_submit
    # frame so the worker's lane can distinguish a reconnected caller
    # (reset the lane) from a straggler frame of the dead connection
    # (drop it — its task was recovered through the routed path). Local
    # workers ride the node channel, which lives as long as the worker,
    # so their era never moves within an epoch.
    dlane: int = 0
    direct_inflight: Dict[TaskId, TaskSpec] = field(default_factory=dict)
    direct_chan: Any = None
    # negative cache for the peer connect: monotonic deadline before which
    # no reconnect is attempted (0.0 = try). Time-bounded, not permanent:
    # a transiently refused connect (accept backlog, listener busy) must
    # not strand the actor on the routed path for the whole epoch, while
    # a truly unreachable socket (cross-host) costs one failed connect
    # per window instead of one per call. The window grows per
    # consecutive failure on the shared reconnect policy (util/retry.py)
    # and resets on success / new placement epoch.
    direct_bad: float = 0.0
    direct_fails: int = 0


class DriverRuntime:
    """Head-process runtime: owns GCS, nodes, objects, and scheduling."""

    def __init__(self, resources: Optional[ResourceSet] = None,
                 num_nodes: int = 1,
                 config: Optional[Config] = None,
                 namespace: str = "default",
                 session_dir: Optional[str] = None):
        self.config = config or Config()
        self.job_id = JobId.from_random()
        self.worker_id = WorkerId.from_random()
        self.driver_task_id = TaskId.from_random()
        self.namespace = namespace
        # under the process's temp dir, with a short name: the node's
        # AF_UNIX socket path inside it must stay under 108 bytes
        self.session_dir = session_dir or tempfile.mkdtemp(
            prefix="ray_tpu_torch_")
        os.makedirs(self.session_dir, exist_ok=True)
        self.gcs = Gcs(storage_path=self.config.gcs_storage_path,
                       config=self.config)
        self.gcs.register_job(JobInfo(job_id=self.job_id, driver_pid=os.getpid()))
        self.gcs.schedule_actor_cb = self._restart_actor
        self.gcs.pubsub.subscribe("actor", self._on_actor_state)
        self.gcs.pubsub.subscribe("node", self._on_node_state)
        self.scheduler = Scheduler(self.config.scheduler_spread_threshold)
        self.task_manager = TaskManager(self.config.lineage_max_bytes)
        self.refcount = ReferenceCounter(
            self._free_object, shards=int(self.config.refcount_shards))
        self.nodes: Dict[NodeId, Node] = {}
        # object state lives in per-oid shards (memory store, directory,
        # events, waiters, sizes, nested pins, pull dedup) — the head's
        # hottest tables no longer serialize on the big runtime lock
        self._oshards = [_ObjShard(i) for i in range(16)]
        self._no = len(self._oshards)
        # PG placement: one dedicated placer thread drains a FIFO of
        # pending groups (ref: gcs_placement_group_scheduler.cc — the GCS
        # schedules PGs from a single queue). A per-PG thread-pool task per
        # cluster event flooded the shared pool O(N^2) at 1k PGs.
        self._pg_cv = threading.Condition()
        self._pg_pending: "collections.deque[PlacementGroupId]" = collections.deque()
        self._pg_parked: Set[PlacementGroupId] = set()
        self._recovering: Set[ObjectId] = set()
        # attributed worker logs live in gcs.logs (LogStore); the mirror
        # prints remote workers' lines on the driver console with a
        # colored provenance prefix + repeated-line dedup (ref:
        # log_monitor.py -> driver stdout mirroring, `log_to_driver`)
        from ..util.logs import DriverMirror

        self._log_mirror = DriverMirror(
            enabled=bool(int(self.config.log_to_driver)))
        # compiled graphs (ray_tpu_torch/cgraph): live graphs by id, the
        # actor-exclusivity ledger, and the cross-node channel routing
        # table (cid hex -> ("driver", dag, None, gid) |
        # ("worker", node, worker, gid))
        self._cgraphs: Dict[bytes, object] = {}
        self._cgraph_actors: Dict[bytes, bytes] = {}
        self._cgraph_routes: Dict[str, tuple] = {}
        self._generators: Dict[TaskId, dict] = {}
        self._released_generators: Set[TaskId] = set()
        self._reader = SegmentReader()
        self._actors: Dict[ActorId, _ActorRecord] = {}
        self._parked: List[TaskSpec] = []
        self._put_counter = 0
        self._fn_cache: Dict[int, str] = {}
        self._renv_cache: Dict[str, dict] = {}
        self.default_runtime_env: Optional[dict] = None  # job-level env
        self._lock = instrumented_lock("runtime.driver", reentrant=True)
        self._pool = ThreadPoolExecutor(
            max_workers=int(self.config.driver_pool_threads),
            thread_name_prefix="rt")
        # direct dispatch: steady-state actor calls skip the routed path
        # (task_manager / GCS events / lease machinery) and go straight to
        # the owning worker; see docs/DISPATCH.md
        self._direct_enabled = bool(int(self.config.direct_actor_calls))
        self._shutdown = False
        self._shutdown_lock = threading.Lock()
        self._shutdown_owner: Optional[int] = None
        threading.Thread(target=self._pg_placer_loop, daemon=True,
                         name="pg-placer").start()
        default_res = resources or {"CPU": float(os.cpu_count() or 1)}
        for i in range(num_nodes):
            self.add_node(dict(default_res))
        self.head_node_id = next(iter(self.nodes), None)
        # refs the driver receives INSIDE fetched values (borrows) must be
        # counted like refs it created via make_ref
        from .object_ref import _set_borrow_hook

        def _driver_borrow(ref: ObjectRef) -> None:
            self.refcount.add_local(ref.id)
            weakref.finalize(ref, self.refcount.remove_local, ref.id)

        _set_borrow_hook(_driver_borrow)
        # deterministic fault injection (RAY_TPU_CHAOS env): installs the
        # seeded drop/delay/kill hooks and starts the kill schedule
        from .. import chaos as _chaos_mod

        _chaos_mod.maybe_enable_from_env(runtime=self)
        self._revive_detached_actors()
        # head restart: PGs restored as RESCHEDULING (gcs restore path)
        # need a placement pass once nodes re-register
        with self._pg_cv:
            for pg in self.gcs.list_pgs():
                if pg.state in ("PENDING", "RESCHEDULING"):
                    self._pg_pending.append(pg.pg_id)
            self._pg_cv.notify()

    def _revive_detached_actors(self) -> None:
        """Head restart: re-create detached actors whose metadata survived
        in the persisted GCS tables (ref: gcs_server.cc:521 restart path;
        detached lifetime semantics)."""
        for info in self.gcs.detached_actors_to_revive():
            with self._lock:
                self._actors[info.actor_id] = _ActorRecord(info=info)
            try:
                self._restart_actor(info)
            except Exception:
                self.gcs.set_actor_state(info.actor_id, ActorState.DEAD,
                                         death_cause="revival failed")

    # ---- cluster membership --------------------------------------------------

    def enable_remote_nodes(self, host: str = "127.0.0.1", port: int = 0):
        """Start the TCP listener node agents join (the head half of the
        multi-host runtime; ref: gcs_server.h:79 node registration +
        node_manager.proto lease/transfer RPCs collapsed onto one duplex
        channel per agent). Returns the (host, port) address agents pass
        as --address."""
        from .rpc import RpcServer

        if getattr(self, "_remote_server", None) is not None:
            return self._remote_server.address
        # the agent channel multiplexes every remote worker onto one
        # oneway lane: shard its intake by worker id so dispatch work
        # parallelizes across cores with per-worker FIFO preserved
        self._agent_loop = ShardedLoop(
            "head-agent", min(8, (os.cpu_count() or 2) * 2))
        # one agent channel multiplexes every worker on that host; size the
        # pool so blocking fetches can't starve the worker_call relay
        self._remote_server = RpcServer(
            (host, port), self._make_agent_handler, family="AF_INET",
            num_handler_threads=int(self.config.agent_server_threads))
        # health monitor: remote nodes must keep heartbeating or be
        # declared dead even with the TCP channel still open (hung agent,
        # network partition) — ref: gcs_health_check_manager.h:39
        self._health_thread = threading.Thread(
            target=self._health_check_loop, daemon=True, name="health-check")
        self._health_thread.start()
        return self._remote_server.address

    def _health_check_loop(self) -> None:
        period = float(self.config.health_check_period_s)
        timeout = float(self.config.health_check_timeout_s)
        # consecutive-miss fencing: heartbeat_miss_threshold > 0 extends
        # the death bar to threshold*period when that is stricter than
        # timeout alone (docs/FAULT_TOLERANCE.md); every silent period
        # counts in ray_tpu_heartbeat_misses_total{node} either way
        threshold = int(self.config.heartbeat_miss_threshold)
        if threshold > 0:
            timeout = max(timeout, threshold * period)
        while not self._shutdown:
            time.sleep(period)
            now = time.monotonic()
            with self._lock:
                remote_ids = [nid for nid, n in self.nodes.items()
                              if getattr(n, "is_remote", False) and n.alive]
            for nid in remote_ids:
                info = next((i for i in self.gcs.nodes()
                             if i.node_id == nid), None)
                if info is None or not info.alive:
                    continue
                silent = now - info.last_heartbeat
                if silent > period:
                    _C_HEARTBEAT_MISSES.inc(
                        tags={"node": nid.hex()[:12]})
                if silent > timeout:
                    self.on_remote_node_lost(nid)

    def _make_agent_handler(self, channel):
        from .node import WorkerHandle
        from .remote_node import RemoteNode

        state = {"node": None}

        def handler(method: str, payload):
            node: Optional[RemoteNode] = state["node"]
            # job-submission plane: served to UNREGISTERED client channels
            # (a second process submitting work to this running head; ref:
            # dashboard/modules/job/job_manager.py REST surface)
            if method == "submit_job":
                from .. import jobs

                return jobs.submit_job(payload["entrypoint"],
                                       env=payload.get("env"),
                                       working_dir=payload.get("working_dir"))
            if method == "job_info":
                from .. import jobs

                return jobs.get_job_info(payload)
            if method == "list_jobs":
                from .. import jobs

                return jobs.list_jobs()
            if method == "list_nodes":
                # launcher/status plane (ref: state API list_nodes)
                return [{"node_id": n.node_id.hex(), "alive": n.alive,
                         "resources": dict(n.total_resources)}
                        for n in self.gcs.nodes()]
            if method == "perf_snapshot":
                # `ray_tpu_torch top` plane: ONE RPC returns nodes + every
                # ray_tpu_* scalar + latency summaries (perf/snapshot.py)
                from ..perf.snapshot import head_snapshot

                return head_snapshot(self)
            # debugging plane, served to unregistered channels too so
            # `ray_tpu_torch logs/stack/profile --address H:P` work against a
            # running head (ref: `ray logs` / `ray stack` CLI)
            if method == "logs_query":
                return self.query_logs(**(payload or {}))
            if method == "traces_query":
                return self.gcs.traces.query(**(payload or {}))
            if method == "trace_get":
                return self.gcs.traces.get(payload)
            if method == "trace_chrome":
                from ..util.state import _span_trace_events

                tr = self.gcs.traces.get(payload)
                return (_span_trace_events(list(tr.get("spans_detail", ())))
                        if tr else None)
            if method == "stack_report":
                return self.stack_report(
                    float((payload or {}).get("timeout", 5.0)))
            if method == "profile_worker":
                return self.profile_worker(
                    payload["worker_id"],
                    duration_s=float(payload.get("duration_s", 5.0)),
                    interval_s=float(payload.get("interval_s", 0.01)))
            if method == "stop_job":
                from .. import jobs

                return jobs.stop_job(payload)
            if method == "register_client":
                # Ray-Client plane (ref: python/ray/util/client/ server/
                # proxier.py): a REMOTE DRIVER attaches to this running
                # head; its channel speaks the same worker-call protocol
                # with byte-valued object transfer (no shared /dev/shm
                # across hosts). Holder refs key off the client id and are
                # dropped wholesale on disconnect.
                shell = _ClientShell(WorkerId.from_random())
                state["client"] = shell
                channel.on_close(
                    lambda cid=shell.worker_id:
                    self.refcount.release_holder(cid))
                return {"client_id": shell.worker_id.hex(),
                        "job_id": self.job_id.hex(),
                        "namespace": self.namespace}
            client = state.get("client")
            if client is not None:
                return self._handle_client_call(client, method, payload)
            if method == "register_node":
                node = RemoteNode(self, payload["node_id"],
                                  payload["resources"], self.config, channel,
                                  labels=payload.get("labels"))
                node.peer_addr = payload.get("object_server_addr")
                state["node"] = node
                with self._lock:
                    self.nodes[node.node_id] = node
                self.gcs.register_node(node.info())
                self._reschedule_parked()
                # new capacity: spill leases stuck behind full nodes
                self._spill_queued_leases()
                # the head's health cadence governs the agent's heartbeat
                # period — local agent config must not race a stricter head
                return {"health_check_period_s":
                        float(self.config.health_check_period_s)}
            if node is None:
                raise RuntimeError("agent sent a message before register_node")
            if not node.alive:
                # fenced-off node (declared dead by heartbeat timeout):
                # drop everything — its tasks were already rescheduled
                return None
            if method == "heartbeat":
                self.gcs.heartbeat(node.node_id)
                # agents piggyback their process's metric deltas (store
                # ops, RPC latency, user metrics) on the liveness signal
                if payload:
                    metrics_mod.merge_remote(
                        payload, node=node.node_id.hex()[:12])
                return None
            if method == "worker_register":
                node.on_remote_worker_register(
                    payload["worker_id"], payload.get("pid", 0),
                    direct_addr=payload.get("direct_addr"))
                return True
            if method == "worker_exit":
                # sharded with task_done on the same worker-id key: exit
                # processing must not overtake a completion already queued
                self._agent_loop.submit(
                    payload["worker_id"], node.on_remote_worker_exit,
                    payload["worker_id"], payload.get("error"))
                return None
            if method == "task_done":
                self._agent_loop.submit(payload["worker_id"],
                                        self._agent_task_done, node, payload)
                return None
            if method == "object_sealed":
                self._agent_loop.submit(
                    payload.get("worker_id") or payload["object_id"],
                    self._agent_object_sealed, node, payload)
                return None
            if method == "object_copy":
                oid = payload["object_id"]
                sh = self._oshard(oid)
                with sh.lock:
                    sh.dir.setdefault(oid, set()).add(node.node_id)
                return None
            if method == "fetch_for_agent":
                return self._fetch_for_agent(node, payload["object_id"],
                                             payload.get("timeout"),
                                             relay=payload.get("relay",
                                                               False))
            if method == "head_read_chunk":
                return self._read_local_chunk(payload["object_id"],
                                              payload["offset"],
                                              payload["length"])
            if method == "worker_call":
                if payload["method"] in ("metrics_push", "worker_log",
                                         "log_event", "task_events_batch"):
                    # always notify-relayed by the agent (no reply):
                    # sharded off the channel lane, keyed per worker
                    self._agent_loop.submit(
                        payload.get("worker_id") or 0,
                        self._agent_worker_call, node, payload)
                    return None
                return self._agent_worker_call(node, payload)
            raise ValueError(f"unknown agent message {method}")

        return handler

    def _agent_task_done(self, node, payload: dict) -> None:
        worker = node.get_worker(payload["worker_id"])
        if worker is not None:
            node.on_task_done(worker, payload["payload"])

    def _agent_object_sealed(self, node, payload: dict) -> None:
        self.on_object_sealed(payload["object_id"], node.node_id,
                              size=payload.get("size"))
        if payload.get("is_put") and payload.get("worker_id"):
            self.refcount.add_holder_ref(payload["object_id"],
                                         payload["worker_id"])

    def _agent_worker_call(self, node, payload: dict):
        from .node import WorkerHandle

        worker = node.get_worker(payload["worker_id"])
        if worker is None:
            # raced an exit notification; holder accounting still
            # needs the id, nothing else does
            worker = WorkerHandle(worker_id=payload["worker_id"],
                                  proc=None)  # type: ignore
        return self.handle_worker_call(node, worker, payload["method"],
                                       payload["payload"])

    def _fetch_for_agent(self, node, oid: ObjectId,
                         timeout: Optional[float], relay: bool = False):
        """Answer an agent's fetch: ("inline", bytes) for small objects,
        ("remote", [peer_addrs]) when other agents hold the only copies —
        the requester pulls chunks from them DIRECTLY (P2P, the head never
        touches the bytes; ref: object_manager.h:117) — or ("sized", n)
        when the head's own store has (or, with relay=True, pulls) a copy
        to serve via head_read_chunk."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not relay:
            ev = self._event(oid)
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not ev.wait(remaining):
                raise exc.GetTimeoutError(
                    f"Get timed out waiting for object {oid.hex()[:12]}")
            sh = self._oshard(oid)
            with sh.lock:
                data = sh.mem.get(oid)
                copies = list(sh.dir.get(oid, ()))
            if data is not None:
                return ("inline", data)
            peers = []
            head_local = False
            for nid in copies:
                n = self.nodes.get(nid)
                if n is None or not n.alive:
                    continue
                if not getattr(n, "is_remote", False):
                    head_local = True
                elif nid != node.node_id and getattr(n, "peer_addr", None):
                    peers.append(tuple(n.peer_addr))
            if head_local:
                break  # serve from the head's own store below
            if peers:
                return ("remote", peers)
            break  # copies lost or only on the requester: relay path
        res = self.fetch_one(oid, (None if deadline is None
                                   else max(0.0,
                                            deadline - time.monotonic())))
        if res[0] == "inline":
            return res
        return ("sized", res[2])  # agent pulls via head_read_chunk

    def _read_local_chunk(self, oid: ObjectId, offset: int, length: int):
        """Serve a chunk of a locally-stored object (transfer source side)."""
        from .object_store import read_store_chunk

        sh = self._oshard(oid)
        with sh.lock:
            copies = list(sh.dir.get(oid, ()))
        for nid in copies:
            n = self.nodes.get(nid)
            if n is None or not n.alive or getattr(n, "is_remote", False):
                continue
            chunk = read_store_chunk(n.store, self._reader, oid, offset,
                                     length)
            if chunk is not None:
                return chunk
        return None

    def on_preemption_notice(self, node_id: NodeId, grace_s: float,
                             reason: str = "") -> None:
        """Planned capacity loss: a provider preemption notice (or chaos
        ``preempt=`` schedule) says ``node_id`` dies in ``grace_s``
        seconds. The node stays ALIVE and keeps serving in-flight work,
        but (a) the scheduler stops placing new leases/bundles on it
        (``_views`` drain filter), (b) the GCS publishes a
        ``NODE_PREEMPTING`` event workloads subscribe to (pipeline
        engines resize, docs/FAULT_TOLERANCE.md), (c) the serve
        controller — when one is running — is told to drain the replicas
        living there, and (d) a remote agent gets a ``drain`` command so
        it exits cleanly once its workers are gone instead of waiting
        for the axe."""
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return
        already = getattr(node, "draining", False)
        node.draining = True
        if already:
            return  # one notice per axe window
        self.gcs.mark_node_preempting(node_id, grace_s, reason)
        # queued-but-ungranted work must not start on a doomed node:
        # spill it back through the scheduler (other nodes or parked)
        self._spill_queued_leases(node=node, everything=True)
        if getattr(node, "is_remote", False):
            try:
                node.channel.notify("drain", {"grace_s": float(grace_s)})
            except Exception:
                pass
        self._notify_serve_drain(node_id, grace_s)

    def _notify_serve_drain(self, node_id: NodeId, grace_s: float) -> None:
        """Best-effort: hand the serve controller the actor ids living on
        the preempting node so it marks those replicas draining (router
        stops assigning new streams; in-flight ones finish or fail over
        before the node dies). The controller runs in a worker process
        and cannot subscribe to head pubsub itself."""
        try:
            info = self.gcs.get_named_actor(CONTROLLER_NAME, self.namespace)
            if info is None or info.state != ActorState.ALIVE:
                return
            ids = [a.actor_id.hex()
                   for a in self.gcs.actors_on_node(node_id)
                   if a.actor_id != info.actor_id]
            if not ids:
                return
            import ray_tpu_torch

            ray_tpu_torch.get_actor(CONTROLLER_NAME).drain_replicas.remote(
                ids, float(grace_s))
        except Exception:
            pass

    def _count_preempt_outcome(self, node) -> None:
        """Called exactly when a node leaves (lost channel or explicit
        removal): if it had a preemption notice, grade the drain."""
        if not getattr(node, "draining", False) \
                or getattr(node, "_preempt_counted", False):
            return
        node._preempt_counted = True
        with node._lock:
            busy = any(w.state in ("leased", "actor")
                       for w in node._workers.values())
        _C_PREEMPTIONS.inc(tags={"outcome": "lost" if busy else "drained"})

    def on_remote_node_lost(self, node_id: NodeId) -> None:
        """Agent channel dropped: fail in-flight work, restart actors
        (ref: gcs_node_manager.cc death broadcast)."""
        node = self.nodes.get(node_id)
        if node is None:
            return
        self._count_preempt_outcome(node)
        with node._lock:
            if not node.alive:
                return
            node.alive = False
            workers = list(node._workers.values())
            queued = [r for b in node._lease_queue.values() for r in b]
            node._lease_queue.clear()
        from ..exceptions import WorkerCrashedError

        for req in queued:
            if not req.future.done():
                req.future.set_exception(WorkerCrashedError(
                    f"node {node_id.hex()[:8]} disconnected"))
        for w in workers:
            node._on_worker_exit(w)
        # fence the evicted agent: close its channel so a merely-stalled
        # (not dead) agent can't keep executing and report stale results —
        # the agent shuts itself down on head-channel loss
        try:
            node.channel.close()
        except Exception:
            pass
        self.gcs.mark_node_dead(node_id, "agent disconnected")
        self._drop_node_copies(node_id)
        self._reschedule_parked()

    def _drop_node_copies(self, node_id: NodeId) -> None:
        """Node died: purge it from every object's location set."""
        for sh in self._oshards:
            with sh.lock:
                for copies in sh.dir.values():
                    copies.discard(node_id)

    def add_node(self, resources: ResourceSet,
                 labels: Optional[Dict[str, str]] = None) -> Node:
        node = Node(self, NodeId.from_random(), resources, self.session_dir,
                    self.config, labels)
        with self._lock:
            self.nodes[node.node_id] = node
            if getattr(self, "head_node_id", None) is None:
                self.head_node_id = node.node_id
        self.gcs.register_node(node.info())
        self._reschedule_parked()
        self._spill_queued_leases()
        return node

    def remove_node(self, node_id: NodeId, kill: bool = True) -> None:
        with self._lock:
            node = self.nodes.get(node_id)
        if node is None:
            return
        self._count_preempt_outcome(node)
        node.shutdown(kill=kill)
        self.gcs.mark_node_dead(node_id, "removed" if not kill else "killed")
        # objects whose only copies were on this node are now lost
        self._drop_node_copies(node_id)

    def _on_node_state(self, msg) -> None:
        state, node_id = msg[0], msg[1]
        if state == "DEAD":
            self._reschedule_parked()
        elif state == "PREEMPTING":
            # keep the runtime-side drain flag in sync no matter which
            # entrypoint published the notice (autoscaler, chaos, API)
            node = self.nodes.get(node_id)
            if node is not None:
                node.draining = True

    def _views(self) -> List[NodeView]:
        # draining nodes (preemption-noticed) are excluded: no new
        # leases, actors, or placement-group bundles land on a node the
        # provider has promised to kill — in-flight work drains instead
        with self._lock:
            return [
                NodeView(node_id=n.node_id, total=dict(n.total_resources),
                         available=dict(n.available), alive=n.alive,
                         labels=dict(n.labels))
                for n in self.nodes.values()
                if n.alive and not getattr(n, "draining", False)
            ]

    # ---- function export (ref: python/ray/_private/function_manager.py) -----

    def export_function(self, fn: Any) -> str:
        # cache holds the referent so a reused id() can't alias a new function
        key = id(fn)
        cached = self._fn_cache.get(key)
        if cached is not None and cached[0] is fn:
            return cached[1]
        blob = cloudpickle.dumps(fn)
        func_id = hashlib.sha1(blob).hexdigest()
        self.gcs.kv_put("fn:" + func_id, blob, namespace="fn", overwrite=False)
        self._fn_cache[key] = (fn, func_id)
        return func_id

    def get_function_blob(self, func_id: str) -> bytes:
        blob = self.gcs.kv_get("fn:" + func_id, namespace="fn")
        if blob is None:
            raise KeyError(f"function {func_id} not found")
        return blob

    # ---- object API ----------------------------------------------------------

    def _oshard(self, oid: ObjectId) -> _ObjShard:
        return self._oshards[hash(oid) % self._no]

    def object_locations(self, oid: ObjectId) -> Set[NodeId]:
        sh = self._oshard(oid)
        with sh.lock:
            return set(sh.dir.get(oid, ()))

    def add_object_location(self, oid: ObjectId, node_id: NodeId) -> None:
        sh = self._oshard(oid)
        with sh.lock:
            sh.dir.setdefault(oid, set()).add(node_id)

    def object_size_hint(self, oid: ObjectId) -> Optional[int]:
        """Serialized size of a completed object, if the head knows it:
        store-resident objects report the sealed segment size, inline
        results their byte length. None for unknown/in-flight ids — the
        data plane's byte-budget accounting (data/executor.py) treats
        that as 'estimate instead'."""
        sh = self._oshard(oid)
        with sh.lock:
            size = sh.sizes.get(oid)
            if size is not None:
                return int(size)
            data = sh.mem.get(oid)
            return len(data) if data is not None else None

    def object_table_snapshot(self) -> Tuple[Dict[ObjectId, Set[NodeId]],
                                             Set[ObjectId]]:
        """(directory, inline-object ids) merged over the shards — the
        state-API view; not a hot path."""
        directory: Dict[ObjectId, Set[NodeId]] = {}
        inline: Set[ObjectId] = set()
        for sh in self._oshards:
            with sh.lock:
                for oid, nids in sh.dir.items():
                    directory[oid] = set(nids)
                inline.update(sh.mem)
        return directory, inline

    def _event(self, oid: ObjectId) -> threading.Event:
        sh = self._oshard(oid)
        with sh.lock:
            ev = sh.events.get(oid)
            if ev is None:
                ev = sh.events[oid] = threading.Event()
            return ev

    def _notify_object(self, oid: ObjectId) -> None:
        """Object became available: fire its event AND wake any wait()
        callers multi-waiting on it (threading.Event has no select(); the
        waiter list is the event-driven replacement for wait()'s old 2 ms
        polling loop — SURVEY §6's 10k-concurrent-task envelope dies on
        N_waiters × 500 wakeups/s)."""
        self._event(oid).set()
        sh = self._oshard(oid)
        with sh.lock:
            waiters = sh.waiters.pop(oid, None)
        if waiters:
            for w in waiters:
                w.set()

    def _object_available(self, oid: ObjectId) -> bool:
        sh = self._oshard(oid)
        with sh.lock:
            if oid in sh.mem:
                return True
            copies = sh.dir.get(oid) or ()
            return any(
                (n := self.nodes.get(nid)) is not None and n.alive
                for nid in copies)

    def make_ref(self, oid: ObjectId, add_ref: bool = True) -> ObjectRef:
        ref = ObjectRef(oid, owner=self.worker_id)
        if add_ref:
            self.refcount.add_local(oid)
            weakref.finalize(ref, self.refcount.remove_local, oid)
        return ref

    def next_put_id(self, task_id: Optional[TaskId] = None) -> ObjectId:
        with self._lock:
            self._put_counter += 1
            return ObjectId.for_put(task_id or self.driver_task_id, self._put_counter)

    def put(self, value: Any, _owner=None) -> ObjectRef:
        oid = self.next_put_id()
        sobj = serialization.serialize(value)
        self.store_serialized(oid, sobj)
        self.refcount.add_owned(oid)
        return self.make_ref(oid)

    def store_serialized(self, oid: ObjectId, sobj: serialization.SerializedObject,
                         node_id: Optional[NodeId] = None) -> None:
        if sobj.total_bytes <= self.config.max_direct_call_object_size:
            sh = self._oshard(oid)
            with sh.lock:
                sh.mem[oid] = sobj.to_bytes()
        else:
            node = self.nodes.get(node_id) if node_id else None
            if node is None:
                if self.head_node_id is None:
                    raise RuntimeError(
                        "Cannot store a large object: cluster has no nodes yet")
                node = self.nodes[self.head_node_id]
            node.store.put_serialized(oid, sobj, pin=True)
            sh = self._oshard(oid)
            with sh.lock:
                sh.dir.setdefault(oid, set()).add(node.node_id)
                sh.sizes[oid] = sobj.total_bytes
        self._notify_object(oid)

    def store_inline_bytes(self, oid: ObjectId, data: bytes) -> None:
        sh = self._oshard(oid)
        with sh.lock:
            sh.mem[oid] = data
        self._notify_object(oid)

    def on_object_sealed(self, oid: ObjectId, node_id: NodeId,
                         size: Optional[int] = None) -> None:
        sh = self._oshard(oid)
        with sh.lock:
            sh.dir.setdefault(oid, set()).add(node_id)
            if size:
                sh.sizes[oid] = int(size)
        self.refcount.add_owned(oid)
        self._notify_object(oid)

    def _free_object(self, oid: ObjectId) -> None:
        sh = self._oshard(oid)
        with sh.lock:
            sh.mem.pop(oid, None)
            copies = sh.dir.pop(oid, set())
            sh.events.pop(oid, None)
            sh.sizes.pop(oid, None)
            nodes = [self.nodes.get(n) for n in copies]
            nested = sh.nested.pop(oid, [])
        for node in nodes:
            if node is not None:
                node.store.delete(oid)
        self.refcount.forget(oid)
        # the return object dies -> its nested-result borrows unpin
        for inner in nested:
            self.refcount.remove_local(inner)

    def free(self, refs: Sequence[ObjectRef]) -> None:
        for r in refs:
            self._free_object(r.id)

    # fetch: returns ("inline", bytes) or ("shm", name, size)
    # pull-retry backoff (util/retry.py): transient RPC failures against
    # a live holder back off exponentially instead of hammering at a
    # fixed 10ms; the fetch deadline still bounds the whole wait
    _PULL_RETRY = RetryPolicy(initial_backoff_s=0.01, multiplier=1.5,
                              max_backoff_s=0.25, jitter=0.2)

    def fetch_one(self, oid: ObjectId, timeout: Optional[float],
                  on_block=None) -> Tuple:
        deadline = None if timeout is None else time.monotonic() + timeout
        attempts = 0
        transient_attempts = 0
        while True:
            ev = self._event(oid)
            if on_block is not None and not ev.is_set():
                on_block()  # about to actually wait: release caller's lease
                on_block = None
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not ev.wait(remaining):
                raise exc.GetTimeoutError(
                    f"Get timed out waiting for object {oid.hex()[:12]}")
            sh = self._oshard(oid)
            with sh.lock:
                data = sh.mem.get(oid)
                copies = list(sh.dir.get(oid, ()))
            if data is not None:
                return ("inline", data)
            transient_failure = False
            for nid in copies:
                node = self.nodes.get(nid)
                if node is not None and node.alive:
                    if getattr(node, "is_remote", False):
                        # chunked pull from the agent, promoted into the
                        # head node's store so later readers are zero-copy.
                        # Concurrent getters share one transfer via the
                        # in-flight pull table (ref: object_manager.h:117
                        # PullManager dedup).
                        try:
                            res = self._pull_once(oid, node)
                        except Exception:
                            # transient RPC failure: the copy may still
                            # exist — retry while the channel stays open
                            if not node.channel.closed:
                                transient_failure = True
                                continue
                            res = None
                        if res is not None:
                            return res
                        # res None = the agent definitively reported the
                        # object gone: fall through to drop the directory
                        # entry so lineage recovery can run
                    else:
                        try:
                            seg = node.store.get_segment(oid)
                        except Exception:
                            # store momentarily full etc. — the copy still
                            # exists
                            transient_failure = True
                            continue
                        if seg is not None:
                            return ("shm", seg[0], seg[1])
                # node dead, or store confirms the object is gone
                with sh.lock:
                    d = sh.dir.get(oid)
                    if d is not None:
                        d.discard(nid)
            if transient_failure:
                # a set availability event makes ev.wait(0) return True,
                # so the deadline must be enforced here too or transient
                # failures past the timeout would retry forever
                if deadline is not None and time.monotonic() > deadline:
                    raise exc.GetTimeoutError(
                        f"Get timed out retrying transient pull "
                        f"failures for object {oid.hex()[:12]}")
                time.sleep(self._PULL_RETRY.backoff(transient_attempts))
                transient_attempts += 1
                continue
            transient_attempts = 0
            # all copies gone -> lineage reconstruction
            attempts += 1
            if attempts > 5:
                raise exc.ObjectLostError(oid.hex())
            self._recover_object(oid)

    def _pull_once(self, oid: ObjectId, node) -> Optional[Tuple]:
        """One chunked transfer per object however many getters: the first
        caller pulls, the rest wait on its Future."""
        sh = self._oshard(oid)
        with sh.lock:
            fut = sh.pulls.get(oid)
            owner = fut is None
            if owner:
                fut = sh.pulls[oid] = Future()
        if not owner:
            # propagate the owner's outcome: None = definitively absent,
            # exception = transient failure (caller retries)
            return fut.result(timeout=300)
        try:
            if _CHAOS is not None and _CHAOS.pull_fail(oid.hex()):
                raise RuntimeError(
                    f"chaos: injected pull failure for {oid.hex()[:12]}")
            data = node.pull_object_bytes(oid)
            res = None if data is None else self._promote_pulled(oid, data)
            fut.set_result(res)
            return res
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            with sh.lock:
                sh.pulls.pop(oid, None)

    def _promote_pulled(self, oid: ObjectId, data: bytes) -> Tuple:
        """Store bytes pulled from a remote node into the head-local store
        and return a fetch result for them."""
        head = self.nodes.get(self.head_node_id)
        if head is not None and head.alive and not getattr(head, "is_remote",
                                                           False):
            try:
                if not head.store.contains(oid):
                    head.store.put_bytes(oid, data, pin=True)
                sh = self._oshard(oid)
                with sh.lock:
                    sh.dir.setdefault(oid, set()).add(head.node_id)
                seg = head.store.get_segment(oid)
                if seg is not None:
                    return ("shm", seg[0], seg[1])
            except Exception:
                pass
        return ("inline", data)

    def _recover_object(self, oid: ObjectId) -> None:
        """Lost-object recovery via lineage re-execution
        (ref: object_recovery_manager.h:41, task_manager.h:234 ResubmitTask)."""
        spec = self.task_manager.lineage_for_object(oid)
        if spec is None:
            raise exc.ObjectLostError(
                oid.hex(), f"Object {oid.hex()[:12]} lost and no lineage available "
                "(put objects and actor-task returns are not reconstructable).")
        if spec.task_type != TaskType.NORMAL_TASK:
            raise exc.ObjectLostError(
                oid.hex(), "Only normal-task outputs can be reconstructed.")
        sh = self._oshard(oid)
        with sh.lock:
            ev = sh.events.get(oid)
            if ev is not None:
                ev.clear()
        with self._lock:
            # single reconstruction per task, however many getters noticed
            if spec.task_id in self._recovering:
                return
            if spec.task_id in {s.task_id for s in self._parked}:
                return
            already = self.task_manager.get(spec.task_id)
            if already is not None and already.state in ("PENDING", "RUNNING"):
                return  # reconstruction already in flight
            self._recovering.add(spec.task_id)
        try:
            self.task_manager.register(spec)
            self._schedule(spec)
        finally:
            with self._lock:
                self._recovering.discard(spec.task_id)

    def deserialize_fetched(self, result: Tuple) -> Any:
        kind = result[0]
        if kind == "inline":
            value = serialization.loads(result[1])
        else:
            _, name, size = result
            mv = self._reader.read(name, size)
            value = serialization.loads(mv)
        if isinstance(value, exc.TaskError):
            cause = value.cause
            if isinstance(cause, exc.RayTpuError):
                raise cause
            raise value
        if isinstance(value, exc.RayTpuError):
            raise value
        return value

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        t0 = time.perf_counter()
        try:
            out = [self.deserialize_fetched(self.fetch_one(r.id, timeout))
                   for r in refs]
        finally:
            _H_GET_WAIT.observe(time.perf_counter() - t0)
        return out[0] if single else out

    def get_many(self, oids: List[ObjectId], timeout: Optional[float] = None):
        return [self.deserialize_fetched(self.fetch_one(o, timeout)) for o in oids]

    def get_async(self, ref: ObjectRef):
        import asyncio

        loop = asyncio.get_event_loop()
        return loop.run_in_executor(self._pool, lambda: self.get(ref))

    def as_future(self, ref: ObjectRef) -> Future:
        return self._pool.submit(self.get, ref)

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True, on_block=None
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: List[ObjectRef] = []
        while True:
            for r in list(pending):
                if len(ready) >= num_returns:
                    break  # contract: ready has AT MOST num_returns
                    # entries (ref: ray.wait docs) — extras stay pending
                if self._event(r.id).is_set():
                    ready.append(r)
                    pending.remove(r)
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            # event-driven sleep: one waiter event registered on every
            # pending object; _notify_object wakes us on the first arrival
            # (no polling — the old 2 ms loop burned a core per waiter)
            wake = threading.Event()
            registered: List[ObjectId] = []
            fired = False
            for r in pending:
                sh = self._oshard(r.id)
                with sh.lock:
                    # per-oid atomicity is what matters: the event-set
                    # check and waiter registration can't race THIS oid's
                    # _notify_object
                    ev = sh.events.get(r.id)
                    if ev is not None and ev.is_set():
                        fired = True  # raced a completion: re-scan now
                        break
                    sh.waiters.setdefault(r.id, []).append(wake)
                    registered.append(r.id)
            if not fired:
                if on_block is not None:
                    on_block()
                    on_block = None
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                wake.wait(remaining)
            for oid in registered:
                sh = self._oshard(oid)
                with sh.lock:
                    ws = sh.waiters.get(oid)
                    if ws is not None:
                        try:
                            ws.remove(wake)
                        except ValueError:
                            pass
                        if not ws:
                            sh.waiters.pop(oid, None)
        return ready, pending

    # ---- task submission -----------------------------------------------------

    def new_task_id(self) -> TaskId:
        return TaskId.from_random()

    def prepare_runtime_env(self, renv: Optional[dict]) -> Optional[dict]:
        """Merge with the job-level default, zip+upload local dirs into the
        GCS KV, and stamp the dedication hash — once per distinct env
        (content-addressed cache). ref: runtime_env_agent.py:161, here run
        submitter-side because the KV is the package store."""
        from . import runtime_env as renv_mod

        merged = renv_mod.merge(self.default_runtime_env,
                                renv_mod.validate(renv))
        if not merged:
            return None
        key = renv_mod.cache_key(merged)
        cached = self._renv_cache.get(key)
        if cached is None:
            cached = renv_mod.package(
                merged,
                lambda k, b: self.gcs.kv_put(
                    k, b, namespace=renv_mod.KV_NAMESPACE, overwrite=False))
            self._renv_cache[key] = cached
        return cached

    def submit_spec(self, spec: TaskSpec, _count: bool = True) -> List[ObjectRef]:
        if spec.task_type == TaskType.ACTOR_TASK and self._direct_enabled:
            refs = self._submit_actor_direct(spec)
            if refs is not None:
                return refs
        if _count:
            _C_ROUTED.inc()
            _rec_dispatch("routed", spec)
        self.task_manager.register(spec)
        # SUBMITTED opens the lifecycle phase chain (-> SCHEDULED ->
        # RUNNING -> FINISHED); the GCS derives phase histograms from it
        ev = {"task_id": spec.task_id.hex(), "name": spec.description,
              "state": "SUBMITTED", "time": time.time()}
        if spec.actor_id is not None:
            ev["actor_id"] = spec.actor_id.hex()
        self.gcs.add_task_event(ev)
        for ref in spec.arg_refs():
            self.refcount.pin_for_task(ref.id)
        for oid in spec.return_ids():
            self.refcount.add_owned(oid)
        refs = [self.make_ref(oid) for oid in spec.return_ids()]
        if spec.task_type == TaskType.ACTOR_TASK:
            self._submit_actor_spec(spec)
        else:
            self._schedule(spec)
        return refs

    def _schedule(self, spec: TaskSpec) -> None:
        strat = spec.scheduling_strategy
        demand = spec.__dict__.get("_demand")
        if demand is None:
            demand = normalize(spec.resources)
        node: Optional[Node] = None
        if strat.kind == "PLACEMENT_GROUP" and strat.placement_group_id is not None:
            pg = self.gcs.get_pg(strat.placement_group_id)
            if pg is None or pg.state == "REMOVED":
                self._fail_task(spec, exc.PlacementGroupUnschedulableError(
                    "placement group removed"))
                return
            if pg.state != "CREATED":
                with self._lock:
                    self._parked.append(spec)
                # the placer may have committed (or a remove landed)
                # between the state read and the append — its
                # _reschedule_parked_tasks would then have missed this
                # spec; re-check so no task parks forever
                if pg.state in ("CREATED", "REMOVED"):
                    self._reschedule_parked_tasks()
                return
            candidates = (
                [pg.bundle_nodes[strat.bundle_index]]
                if strat.bundle_index >= 0 else list(dict.fromkeys(pg.bundle_nodes))
            )
            for nid in candidates:
                n = self.nodes.get(nid)
                if n is not None and n.alive:
                    node = n
                    break
        elif strat.kind == "DEFAULT" and len(self.nodes) == 1:
            # single-node fast path: locality and hybrid scoring are
            # cross-node concerns; the only question is feasibility
            # (infeasible demand still parks, same as pick_node=None)
            n = next(iter(self.nodes.values()))
            node = n if (n.alive and not getattr(n, "draining", False)
                         and res_ge(n.total_resources, demand)) \
                else None
        else:
            if strat.kind == "NODE_AFFINITY" and not strat.soft:
                target = self.nodes.get(strat.node_id)
                if target is None or not target.alive:
                    self._fail_task(spec, exc.RayTpuError(
                        f"Task {spec.description}: hard node affinity to "
                        f"dead/unknown node {strat.node_id.hex()[:8]}"))
                    return
            nid = self.scheduler.pick_node(self._views(), demand, strat,
                                           local_node_id=self.head_node_id,
                                           locality=self._arg_locality(spec))
            node = self.nodes.get(nid) if nid is not None else None
        if node is None:
            with self._lock:
                self._parked.append(spec)
            return
        self.gcs.add_task_event({
            "task_id": spec.task_id.hex(), "name": spec.description,
            "state": "SCHEDULED", "node_id": node.node_id.hex(),
            "time": time.time()})
        if _FLREC.enabled:
            _FLREC.record("sched.place", spec.description,
                          {"task": spec.task_id.hex()[:12],
                           "node": node.node_id.hex()[:12],
                           "strategy": strat.kind})
        self.task_manager.mark_running(spec.task_id)
        fut = node.request_lease(spec)

        def _granted(f: Future, node=node):
            try:
                worker = f.result()
            except Exception as e:
                # the lease error (e.g. container launcher failure) rides
                # into the final retries-exhausted message
                self.on_worker_crashed(spec, node.node_id, reason=str(e))
                return
            self._event_running(spec, node.node_id)
            node.push_task(worker, spec)

        fut.add_done_callback(_granted)

    def _arg_locality(self, spec: TaskSpec) -> Dict[NodeId, int]:
        """Bytes of the task's arguments resident per node (the input to
        the locality-aware lease policy; ref: lease_policy.cc:22 builds
        the same map from the ownership/locality data). Inline args are
        location-free and contribute nothing."""
        weights: Dict[NodeId, int] = {}
        for ref in spec.arg_refs():
            oid = ref.id
            sh = self._oshard(oid)
            with sh.lock:
                nodes = list(sh.dir.get(oid) or ())
                # real sealed sizes tracked at seal/put time; unknown
                # sizes weigh 1 MiB (big enough to beat emptiness, small
                # enough not to drown real size info)
                size = sh.sizes.get(oid) or (1 << 20)
            for nid in nodes:
                weights[nid] = weights.get(nid, 0) + size
        return weights

    def _reschedule_parked_tasks(self) -> None:
        with self._lock:
            parked, self._parked = self._parked, []
        for spec in parked:
            try:
                self._schedule(spec)
            except Exception as e:
                # one bad spec (e.g. a node channel dying mid-lease) must
                # not drop the rest of the swapped-out parked list
                try:
                    self._fail_task(spec, exc.RayTpuError(
                        f"reschedule failed: {e!r}"))
                except Exception:
                    pass

    def _reschedule_parked(self) -> None:
        self._reschedule_parked_tasks()
        # cluster membership/capacity changed: parked pending PGs get
        # another placement pass through the single placer thread
        self._wake_pg_placer(recheck_parked=True)

    def _spill_queued_leases(self, node=None,
                             everything: bool = False) -> int:
        """Lease spillback (the reference's raylet spillback, reduced):
        queued-but-ungranted lease requests move back through the
        scheduler when the cluster's shape changed under them — a new
        node joined (a request stuck behind a full node can run there
        NOW), or ``node`` started draining (``everything=True``: nothing
        new may start there). Without this, a request queued on a
        busy-but-feasible node waits for THAT node forever and fresh
        autoscaler capacity goes unused."""
        victims = [node] if node is not None else [
            n for n in list(self.nodes.values())
            if n.alive and not getattr(n, "draining", False)]
        moved = 0
        for n in victims:
            try:
                stolen = n.steal_queued_leases(everything=everything)
            except Exception:
                continue
            for req in stolen:
                moved += 1
                try:
                    self._schedule(req.spec)
                except Exception as e:
                    try:
                        self._fail_task(req.spec, exc.RayTpuError(
                            f"lease spillback failed: {e!r}"))
                    except Exception:
                        pass
        return moved

    # ---- streaming generators (ref: core_worker.proto:436) -------------------

    def _gen_state(self, task_id: TaskId) -> dict:
        with self._lock:
            g = self._generators.get(task_id)
            if g is None:
                g = self._generators[task_id] = {
                    "items": {}, "done": False, "error": None,
                    "event": threading.Event()}
            return g

    def on_generator_item(self, task_id: TaskId, index: int, oid: ObjectId,
                          data: Optional[bytes] = None) -> bool:
        """A worker reported one yielded item (inline bytes, or already
        sealed into a store). Returns False when the consumer dropped the
        generator — the worker stops producing (the cancellation half of
        the streaming protocol)."""
        if data is not None:
            self.store_inline_bytes(oid, data)
        # Tombstone check, item insertion, AND the ownership count must share
        # one lock acquisition: a release interleaved between them would
        # either resurrect the popped generator dict or free-check the item
        # before it is owned, leaking it permanently. (_lock is an RLock, so
        # the nested _gen_state/add_owned calls are safe.)
        with self._lock:
            released = task_id in self._released_generators
            if not released:
                g = self._gen_state(task_id)
                g["items"][index] = oid
                self.refcount.add_owned(oid)
        if released:
            self._free_object(oid)
            return False
        g["event"].set()
        return True

    def _generator_finish(self, task_id: TaskId,
                          error: Optional[bytes] = None) -> None:
        with self._lock:
            if task_id in self._released_generators:
                # stream ended after the consumer dropped it: tombstone done
                self._released_generators.discard(task_id)
                return
        g = self._gen_state(task_id)
        with self._lock:
            g["done"] = True
            if error is not None:
                g["error"] = error
        g["event"].set()

    def next_generator_item(self, task_id: TaskId, index: int,
                            timeout: Optional[float] = None,
                            on_block=None) -> Optional[ObjectRef]:
        """Blocks until item `index` exists; None = generator exhausted."""
        g = self._gen_state(task_id)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                oid = g["items"].get(index)
                if oid is not None:
                    return self.make_ref(oid)
                if g["error"] is not None:
                    err = serialization.loads(g["error"])
                    raise err if isinstance(err, BaseException) \
                        else exc.TaskError(cause=RuntimeError(str(err)))
                if g["done"]:
                    return None
                g["event"].clear()
            if on_block is not None:
                on_block()
                on_block = None
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not g["event"].wait(remaining):
                raise exc.GetTimeoutError(
                    f"generator item {index} of {task_id.hex()[:12]}")

    def release_generator(self, task_id: TaskId) -> None:
        """Generator GC'd: free yielded items nothing ever referenced and
        tombstone the task so late items are rejected (which tells the
        producing worker to stop)."""
        with self._lock:
            g = self._generators.pop(task_id, None)
            spec = self.task_manager.get(task_id)
            if spec is not None and spec.state in ("PENDING", "RUNNING"):
                self._released_generators.add(task_id)
        if g is None:
            return
        for oid in g["items"].values():
            # atomic check-and-free through the refcounter (a zero-count
            # decrement frees only when truly unreferenced)
            self.refcount.remove_local(oid, 0)

    def _event_running(self, spec: TaskSpec, node_id: NodeId) -> None:
        """Start-of-execution event: pairs with the FINISHED/FAILED event
        to give the timeline durations (ref: task_event_buffer.h:199 state
        transitions feeding GcsTaskManager)."""
        ev = {"task_id": spec.task_id.hex(), "name": spec.description,
              "state": "RUNNING", "node_id": node_id.hex(),
              "time": time.time()}
        if spec.actor_id is not None:
            ev["actor_id"] = spec.actor_id.hex()  # drill-down join key
        self.gcs.add_task_event(ev)

    def _fail_task(self, spec: TaskSpec, error: Exception) -> None:
        self.task_manager.fail(spec.task_id)
        blob = serialization.dumps(error)
        for oid in spec.return_ids():
            # results sealed before the failure was noticed stay valid (the
            # task_done message races the store seal on deliberate kills)
            if not self._object_available(oid):
                self.store_inline_bytes(oid, blob)
        if spec.num_returns == STREAMING_RETURNS:
            self._generator_finish(spec.task_id, error=blob)
        for ref in spec.arg_refs():
            self.refcount.unpin_for_task(ref.id)
        self.gcs.add_task_event({"task_id": spec.task_id.hex(), "name": spec.description,
                                 "state": "FAILED", "time": time.time()})

    # called by Node when a worker reports a finished task
    def on_task_done(self, spec: TaskSpec, payload: dict, node_id: NodeId,
                     worker: WorkerHandle) -> None:
        error = payload.get("error")
        if error is not None:
            # streaming tasks never retry transparently: a rerun would
            # re-mint the same item ids under refs already consumed
            if spec.retry_exceptions \
                    and spec.num_returns != STREAMING_RETURNS:
                retry = self.task_manager.try_retry(spec.task_id)
                if retry is not None:
                    self._schedule(retry)
                    return
            self.task_manager.fail(spec.task_id)
            for oid in spec.return_ids():
                self.store_inline_bytes(oid, error)
            if spec.num_returns == STREAMING_RETURNS:
                self._generator_finish(spec.task_id, error=error)
            if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                self._on_actor_creation_failed(spec, node_id, worker)
        else:
            results = payload.get("results") or []
            borrowed = payload.get("borrowed") or []
            if borrowed and spec.num_returns > 0:
                # refs nested inside EACH return value borrow through
                # THAT return object: pin them for its lifetime so the
                # producing worker dropping its own ref (function exit)
                # can't free them before the caller deserializes
                # (borrower protocol; ref: reference_count.h:61
                # nested-ref ownership). `borrowed` aligns with
                # return_ids; a legacy flat list pins through ret 0.
                rids = spec.return_ids()
                if borrowed and not isinstance(borrowed[0], list):
                    borrowed = [list(borrowed)]
                for rid, nested in zip(rids, borrowed):
                    if nested:
                        sh = self._oshard(rid)
                        with sh.lock:
                            sh.nested.setdefault(rid, []).extend(nested)
                for nested in borrowed:
                    for oid in nested:
                        self.refcount.add_local(oid)
            t_put = time.perf_counter()
            for oid, res in zip(spec.return_ids(), results):
                if res[0] == "inline":
                    self.store_inline_bytes(oid, res[1])
                # "stored" results were registered at seal time
            if results:
                _H_RESULT_PUT.observe(time.perf_counter() - t_put)
            if spec.num_returns == STREAMING_RETURNS:
                self._generator_finish(spec.task_id)
            self.task_manager.complete(spec.task_id)
            if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                self._on_actor_created(spec, node_id, worker)
        for ref in spec.arg_refs():
            self.refcount.unpin_for_task(ref.id)
        ev = {"task_id": spec.task_id.hex(), "name": spec.description,
              "state": "FAILED" if error is not None else "FINISHED",
              "node_id": node_id.hex(), "time": time.time()}
        if spec.actor_id is not None:
            ev["actor_id"] = spec.actor_id.hex()
        self.gcs.add_task_event(ev)

    def on_worker_crashed(self, spec: TaskSpec, node_id: NodeId,
                          reason: str = "") -> None:
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            return  # actor FSM handles restart / death
        if spec.num_returns == STREAMING_RETURNS:
            # no transparent re-run: items already delivered would repeat
            self._fail_task(spec, exc.WorkerCrashedError(
                f"Worker died while streaming {spec.description}"))
            return
        if spec.num_returns > 0 and all(
                self._object_available(oid) for oid in spec.return_ids()):
            # results were sealed (on a live node) before the crash: the task
            # finished, only its task_done message was lost
            self.task_manager.complete(spec.task_id)
            for ref in spec.arg_refs():
                self.refcount.unpin_for_task(ref.id)
            return
        if spec.task_type == TaskType.ACTOR_TASK:
            rec = self._actors.get(spec.actor_id)
            info = self.gcs.get_actor(spec.actor_id)
            if rec is not None and info is not None \
                    and info.state != ActorState.DEAD:
                # single retry budget: TaskManager's retries_left (registered
                # from max_task_retries) — not a second in-spec counter
                retry = self.task_manager.try_retry(spec.task_id)
                if retry is not None:
                    with rec.lock:
                        rec.queued.insert(0, retry)
                    return
            err = exc.ActorDiedError(
                f"Actor {spec.actor_id.hex()[:8]} died while running "
                f"{spec.description}")
            self._fail_task(spec, err)
            return
        retry = self.task_manager.try_retry(spec.task_id)
        if retry is not None:
            self._schedule(retry)
            return
        detail = f": {reason}" if reason else ""
        self._fail_task(spec, exc.WorkerCrashedError(
            f"Worker died while running {spec.description} "
            f"(node {node_id.hex()[:8]}); retries exhausted{detail}"))

    # ---- actors --------------------------------------------------------------

    def create_actor(self, spec: TaskSpec, name: str = "", detached: bool = False,
                     meta: Optional[dict] = None) -> None:
        info = ActorInfo(
            actor_id=spec.actor_id, name=name, namespace=self.namespace,
            job_id=self.job_id, state=ActorState.PENDING_CREATION,
            creation_spec=spec, max_restarts=spec.max_restarts, detached=detached)
        self.gcs.register_actor(info)
        if meta is not None:
            self.gcs.kv_put("actor_meta:" + spec.actor_id.hex(),
                            cloudpickle.dumps(meta), namespace="actor")
        with self._lock:
            self._actors[spec.actor_id] = _ActorRecord(info=info)
        self.submit_spec(spec)

    def _on_actor_created(self, spec: TaskSpec, node_id: NodeId,
                          worker: WorkerHandle) -> None:
        rec = self._actors.get(spec.actor_id)
        info = self.gcs.get_actor(spec.actor_id)
        if info is not None and info.state == ActorState.DEAD:
            # killed while the creation task was in flight — don't resurrect
            node = self.nodes.get(node_id)
            if node is not None:
                node.kill_worker(worker, force=True)
            return
        if rec is None:
            return
        with rec.lock:
            rec.worker = worker
            rec.node_id = node_id
            rec.seq = 0  # fresh worker instance expects sequence from 0;
            # must happen BEFORE ALIVE is visible so no direct submission can
            # grab a sequence number that the flush below will reuse
            # new placement epoch: direct callers' cached lanes are keyed
            # by it (a restarted actor's fresh ActorQueue expects every
            # lane from 0) and the peer channel must be re-established
            rec.epoch += 1
            rec.dseq = 0
            rec.dlane = 0  # fresh ActorQueue: lane numbering starts over
            rec.direct_chan = None
            rec.direct_bad = 0.0
        self.gcs.set_actor_state(spec.actor_id, ActorState.ALIVE,
                                 node_id=node_id, worker_id=worker.worker_id)
        self._flush_actor_queue(spec.actor_id)

    def _on_actor_creation_failed(self, spec: TaskSpec, node_id: NodeId,
                                  worker: WorkerHandle) -> None:
        self.gcs.set_actor_state(spec.actor_id, ActorState.DEAD,
                                 death_cause="creation task failed")
        self._drain_actor_queue_with_error(spec.actor_id,
                                           "actor creation failed")
        # the dedicated worker holds a lease; tear it down so resources return
        node = self.nodes.get(node_id)
        if node is not None:
            node.release_lease(worker, terminate=True)

    def _restart_actor(self, info: ActorInfo) -> None:
        """GCS FSM asked for a restart: resubmit the creation task."""
        import copy

        spec = copy.copy(info.creation_spec)
        spec.task_id = self.new_task_id()
        rec = self._actors.get(info.actor_id)
        if rec is not None:
            with rec.lock:
                rec.worker = None
        self.task_manager.register(spec)
        self._schedule(spec)

    def _on_actor_state(self, msg) -> None:
        actor_id, state = msg
        if state == ActorState.DEAD:
            # direct in-flights first: their routed resubmission hits the
            # DEAD record and surfaces the typed ActorDiedError
            self._recover_direct_inflight(actor_id)
            self._drain_actor_queue_with_error(actor_id, "actor is dead")
        elif state == ActorState.RESTARTING:
            # re-queue un-answered direct calls through the head; they run
            # on the new incarnation in head-lane order
            self._recover_direct_inflight(actor_id)

    def _submit_actor_spec(self, spec: TaskSpec) -> None:
        rec = self._actors.get(spec.actor_id)
        if rec is None:
            self._fail_task(spec, exc.ActorDiedError(
                f"Actor {spec.actor_id.hex()[:8]}: unknown actor"))
            return
        with rec.lock:
            # state read and enqueue are atomic w.r.t. _on_actor_created's
            # seq reset + flush, so no submission can straddle a restart
            info = self.gcs.get_actor(spec.actor_id)
            if info is None or info.state == ActorState.DEAD:
                cause = info.death_cause if info else "unknown actor"
                dead_cause = cause
            elif info.state == ActorState.ALIVE and rec.worker is not None \
                    and not rec.queued:
                # direct path only when no earlier tasks are still queued —
                # otherwise this call would overtake them in sequence order
                spec.seq_no = rec.seq
                rec.seq += 1
                node = self.nodes.get(rec.node_id)
                worker = rec.worker
                dead_cause = None
            else:
                rec.queued.append(spec)
                return
        if dead_cause is not None:
            self._fail_task(spec, exc.ActorDiedError(
                f"Actor {spec.actor_id.hex()[:8]} is dead: {dead_cause}"))
            return
        if node is None or not node.alive:
            # same node-death window as in _flush_actor_queue: park, don't
            # burn a retry — the actor FSM decides restart vs DEAD.
            restarted = False
            with rec.lock:
                if rec.worker is worker:
                    rec.seq -= 1
                    rec.queued.insert(0, spec)
                    rec.worker = None
                else:
                    # restart completed in the window: rec.seq/worker belong
                    # to the new epoch — don't clobber them, requeue for a
                    # fresh seq assignment on the new worker
                    rec.queued.insert(0, spec)
                    restarted = rec.worker is not None
            if restarted:
                self._flush_actor_queue(spec.actor_id)
            return
        self._event_running(spec, node.node_id)
        node.push_task(worker, spec)

    def _flush_actor_queue(self, actor_id: ActorId) -> None:
        rec = self._actors.get(actor_id)
        if rec is None:
            return
        # drain one at a time, assigning sequence numbers under the lock, so
        # concurrent direct submissions (which defer while the queue is
        # non-empty) can never overtake queued tasks
        while True:
            with rec.lock:
                info = self.gcs.get_actor(actor_id)
                if info is None or info.state != ActorState.ALIVE \
                        or rec.worker is None or not rec.queued:
                    break
                spec = rec.queued.pop(0)
                spec.seq_no = rec.seq
                rec.seq += 1
                node = self.nodes.get(rec.node_id)
                worker = rec.worker
            if node is None or not node.alive:
                # node-death window (node dead, actor FSM not yet notified):
                # park the task and stop — no retry consumed, no busy-spin.
                # The restart (or DEAD transition) re-drives this queue.
                with rec.lock:
                    if rec.worker is worker:
                        rec.seq -= 1
                        rec.queued.insert(0, spec)
                        rec.worker = None
                        break
                    # restart won the race — requeue and retry on the new
                    # worker epoch (loop re-pops with a fresh seq)
                    rec.queued.insert(0, spec)
                continue
            self._event_running(spec, node.node_id)
            node.push_task(worker, spec)
        # a task may have been appended after the final lock release — if the
        # queue is non-empty and the actor is alive, a new flush is required
        with rec.lock:
            again = bool(rec.queued) and rec.worker is not None
        if again:
            info = self.gcs.get_actor(actor_id)
            if info is not None and info.state == ActorState.ALIVE:
                self._flush_actor_queue(actor_id)

    def _drain_actor_queue_with_error(self, actor_id: ActorId, cause: str) -> None:
        rec = self._actors.get(actor_id)
        if rec is None:
            return
        with rec.lock:
            queued, rec.queued = rec.queued, []
        for spec in queued:
            self._fail_task(spec, exc.ActorDiedError(
                f"Actor {actor_id.hex()[:8]}: {cause}"))

    # ---- direct dispatch (docs/DISPATCH.md) ----------------------------------
    #
    # Steady-state actor calls bypass the routed machinery: once the actor
    # is ALIVE with no queued backlog, the driver numbers the call in its
    # own lane (owner_id = driver worker id) and ships it straight to the
    # owning worker — over the worker's own channel (local nodes: that
    # channel already connects this process to the worker process) or a
    # cached peer connection to the worker's direct socket (remote nodes).
    # No task_manager entry, no per-call GCS events, no lease traffic; the
    # worker replies with a direct_result frame and batches lifecycle
    # events separately. Fallback on any failure is resubmission through
    # the routed path, which owns the actor FSM / retry / typed-error
    # semantics.

    @staticmethod
    def _direct_eligible(spec: TaskSpec) -> bool:
        if spec.num_returns == STREAMING_RETURNS:
            return False
        # ref args would make the executing worker fetch through the head
        # anyway, and need submit-time pinning the direct path skips
        for a in spec.args:
            if a[0] == ARG_REF:
                return False
        for a in spec.kwargs.values():
            if a[0] == ARG_REF:
                return False
        return True

    def _submit_actor_direct(self, spec: TaskSpec) -> Optional[List[ObjectRef]]:
        if not self._direct_eligible(spec):
            return None
        rec = self._actors.get(spec.actor_id)
        if rec is None:
            return None
        new_chan = None
        with rec.lock:
            if rec.worker is None or rec.queued:
                return None
            info = self.gcs.get_actor(spec.actor_id)
            if info is None or info.state != ActorState.ALIVE:
                return None
            node = self.nodes.get(rec.node_id)
            if node is None or not node.alive:
                return None
            worker = rec.worker
            if not getattr(node, "is_remote", False):
                chan = worker.channel
                if chan is None or chan.closed:
                    return None
            else:
                chan = rec.direct_chan
                if chan is None or chan.closed:
                    if rec.direct_bad > time.monotonic() \
                            or not worker.direct_addr:
                        return None
                    from .rpc import connect as _rpc_connect

                    try:
                        # same-host agents expose the worker's unix socket;
                        # an unreachable path (true cross-host, or a
                        # transiently refused connect) stays routed for the
                        # negative-cache window, then retries
                        chan = _rpc_connect(worker.direct_addr,
                                            handler=self._direct_peer_handler,
                                            name="dpeer")
                    except Exception:
                        # dispatch-fallback backoff (util/retry.py): the
                        # routed window grows with consecutive failures
                        rec.direct_bad = time.monotonic() + \
                            _DIRECT_RECONNECT.backoff(rec.direct_fails)
                        rec.direct_fails += 1
                        return None
                    rec.direct_fails = 0
                    new_chan = chan
                    rec.direct_chan = chan
                    # new connection era: seq numbering restarts with it
                    # (frames lost in the old socket would otherwise leave
                    # the worker lane's expected counter behind forever)
                    rec.dlane += 1
                    rec.dseq = 0
            spec.owner_id = self.worker_id
            spec.seq_no = rec.dseq
            rec.dseq += 1
            # gate: the worker runs this lane only after dispatching every
            # head-routed task numbered below rec.seq — my earlier routed
            # calls all are, so per-caller FIFO survives the transition
            gate = rec.seq
            era = rec.dlane
            rec.direct_inflight[spec.task_id] = spec
        if new_chan is not None:
            # registered only after rec.lock is dropped: on_close fires the
            # callback synchronously when the channel already died, and
            # _on_direct_peer_close re-takes this record's non-reentrant
            # lock — registering under it would self-deadlock. A close in
            # the unregistered window is caught by the chan.closed check
            # below (recovery is idempotent).
            new_chan.on_close(
                lambda aid=spec.actor_id, ch=new_chan:
                self._on_direct_peer_close(aid, ch))
        for oid in spec.return_ids():
            self.refcount.add_owned(oid)
        refs = [self.make_ref(oid) for oid in spec.return_ids()]
        chan.notify("direct_submit", {"spec": spec, "gate": gate,
                                      "lane": era})
        _C_DIRECT.inc()
        _rec_dispatch("direct", spec)
        if chan.closed:
            # raced the worker's death: the notify may be lost — recover
            # now (idempotent; results that did land are respected)
            self._recover_direct_inflight(spec.actor_id)
        return refs

    def _direct_peer_handler(self, method: str, payload):
        if method == "direct_result":
            self.on_direct_result(payload)
            return None
        raise ValueError(f"unknown direct peer message {method}")

    def _on_direct_peer_close(self, actor_id: ActorId, chan=None) -> None:
        rec = self._actors.get(actor_id)
        if rec is None:
            return
        with rec.lock:
            # a late close callback must not clobber a channel that was
            # already re-established; recovery still runs (idempotent —
            # results that landed are respected, the rest resubmit routed)
            if chan is None or rec.direct_chan is chan:
                rec.direct_chan = None
        self._recover_direct_inflight(actor_id)

    def on_direct_result(self, payload: dict) -> None:
        """A worker finished one of this driver's direct calls: results
        land straight in the driver's store — no refcount pins, no
        task_manager entry to retire, no per-call GCS event."""
        rec = self._actors.get(payload.get("actor_id"))
        if rec is None:
            return
        with rec.lock:
            spec = rec.direct_inflight.pop(payload["task_id"], None)
        if spec is None:
            return
        if payload.get("stale"):
            # the socket now belongs to a process not hosting this actor:
            # drop the cache and re-route through the head (the next
            # placement epoch resets the deadline early)
            with rec.lock:
                rec.direct_bad = time.monotonic() + \
                    _DIRECT_RECONNECT.backoff(rec.direct_fails)
                rec.direct_fails += 1
                rec.direct_chan = None
            self._resubmit_direct(spec)
            return
        error = payload.get("error")
        if error is not None:
            for oid in spec.return_ids():
                self.store_inline_bytes(oid, error)
            return
        for oid, res in zip(spec.return_ids(), payload.get("results") or []):
            if res[0] == "inline":
                self.store_inline_bytes(oid, res[1])
            # ("stored", None): sealed into a store / shipped via
            # direct_result_stored — registered at seal time

    def _recover_direct_inflight(self, actor_id: ActorId) -> None:
        """Peer/worker failure or actor restart: every un-answered direct
        call re-enters the routed path, which applies the actor FSM's
        semantics (queue for restart, or typed ActorDiedError)."""
        rec = self._actors.get(actor_id)
        if rec is None:
            return
        with rec.lock:
            inflight = sorted(rec.direct_inflight.values(),
                              key=lambda s: s.seq_no)
            rec.direct_inflight.clear()
        for spec in inflight:
            self._resubmit_direct(spec)

    def _resubmit_direct(self, spec: TaskSpec) -> None:
        import copy

        if spec.num_returns > 0 and all(
                self._object_available(oid) for oid in spec.return_ids()):
            return  # the result landed before the failure was noticed
        # Routed-path retry semantics: a direct task in flight when its
        # worker died is "crashed while running" — it re-runs only with a
        # retry budget (max_task_retries), else fails typed. Re-running
        # unconditionally would replay a crash-causing call into the
        # restarted incarnation and burn its restart budget. If the actor
        # is still ALIVE (a dropped peer connection, not a death), the
        # call may simply have been lost — resubmit regardless.
        info = self.gcs.get_actor(spec.actor_id)
        alive = info is not None and info.state == ActorState.ALIVE
        if not alive and spec.max_retries == 0:
            self._fail_task(spec, exc.ActorDiedError(
                f"Actor {spec.actor_id.hex()[:8]} died while running "
                f"{spec.description}"))
            return
        # copy before mutating: the original direct frame may still sit in
        # an outbox, and a late encode must not see head-lane fields
        spec = copy.copy(spec)
        spec.owner_id = None  # back to the head-routed lane
        spec.seq_no = 0
        _C_ROUTED.inc()
        _rec_dispatch("routed", spec)
        self.task_manager.register(spec)
        self._submit_actor_spec(spec)

    def resolve_actor(self, actor_id: ActorId) -> Optional[dict]:
        """Placement lookup for a direct caller (worker): returns the
        owning worker's direct address + the epoch stamp callers key
        their lane state by + the head-lane gate. None = not directly
        reachable right now (not ALIVE, queued backlog, or no direct
        socket) — the caller stays routed and may re-resolve later."""
        if not self._direct_enabled:
            return None
        rec = self._actors.get(actor_id)
        if rec is None:
            return None
        with rec.lock:
            info = self.gcs.get_actor(actor_id)
            if info is None or info.state != ActorState.ALIVE:
                return None
            if rec.worker is None or rec.queued:
                return None
            addr = rec.worker.direct_addr
            if not addr:
                return None
            return {"addr": addr, "worker_id": rec.worker.worker_id,
                    "node_id": rec.node_id, "epoch": rec.epoch,
                    "gate": rec.seq}

    def ensure_published(self, oid: ObjectId) -> None:
        """Driver direct results land in the store at arrival — nothing
        to publish (the WorkerRuntime override is the real one)."""

    def dispatch_stats(self) -> dict:
        d, r = dispatch_counts()
        return {"direct": d, "routed": r}

    def kill_actor(self, actor_id: ActorId, no_restart: bool = True) -> None:
        info = self.gcs.get_actor(actor_id)
        if info is None:
            return
        if no_restart:
            info.max_restarts = 0
        rec = self._actors.get(actor_id)
        worker = rec.worker if rec else None
        node = self.nodes.get(rec.node_id) if rec and rec.node_id else None
        if worker is not None and node is not None:
            node.kill_worker(worker, force=True)
        else:
            self.gcs.on_actor_failure(actor_id, "killed via ray_tpu_torch.kill")

    def actor_state(self, actor_id: ActorId) -> str:
        info = self.gcs.get_actor(actor_id)
        return info.state.name if info else "UNKNOWN"

    def wait_for_actor(self, actor_id: ActorId, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = self.gcs.get_actor(actor_id)
            if info is not None and info.state == ActorState.ALIVE:
                return
            if info is not None and info.state == ActorState.DEAD:
                raise exc.ActorDiedError(info.death_cause)
            time.sleep(0.01)
        raise exc.GetTimeoutError(f"actor {actor_id.hex()[:8]} not alive in time")

    # ---- placement groups (ref: gcs_placement_group_manager.cc 2PC) ----------

    def create_placement_group(self, bundles: List[ResourceSet], strategy: str,
                               name: str = "") -> PlacementGroupId:
        from .gcs import PlacementGroupInfo

        pg_id = PlacementGroupId.from_random()
        info = PlacementGroupInfo(pg_id=pg_id, bundles=[normalize(b) for b in bundles],
                                  strategy=strategy, name=name)
        self.gcs.register_pg(info)
        with self._pg_cv:
            self._pg_pending.append(pg_id)
            self._pg_cv.notify()
        return pg_id

    def _wake_pg_placer(self, recheck_parked: bool = False) -> None:
        """Capacity or membership changed: move parked (unplaceable) PGs
        back into the placer's queue and wake it."""
        with self._pg_cv:
            if recheck_parked and self._pg_parked:
                self._pg_pending.extend(self._pg_parked)
                self._pg_parked.clear()
                self._pg_last_fp = None  # explicit event: force a real pass
            self._pg_cv.notify()

    def _capacity_fingerprint(self):
        """Cheap O(nodes) digest of per-node available resources — the
        placer's 500 ms tick skips re-placing parked PGs when nothing has
        changed since their last failed pass (permanently-unplaceable
        groups must not churn pick_bundle_nodes forever)."""
        with self._lock:
            return tuple(sorted(
                (n.node_id, tuple(sorted(n.available.items())))
                for n in self.nodes.values() if n.alive))

    def _pg_placer_loop(self) -> None:
        """Single placer thread. Placement decisions are serialized, so
        two groups can never race prepare_bundle into mutual abort, and a
        burst of N creations costs N placement passes — not N^2 pool
        submissions. Parked groups (no capacity) retry on cluster events
        and on a 500 ms tick (lease releases free capacity without an
        event)."""
        # graftcheck: disable=GC050 — placer-thread-private fingerprint
        self._pg_last_fp = None
        while True:
            with self._pg_cv:
                while not self._pg_pending and not self._shutdown:
                    if self._pg_parked:
                        tick = float(self.config.pg_placer_tick_s)
                        if not self._pg_cv.wait(tick) \
                                and not self._pg_pending:
                            fp = self._capacity_fingerprint()
                            if fp != self._pg_last_fp:
                                self._pg_pending.extend(self._pg_parked)
                                self._pg_parked.clear()
                                self._pg_last_fp = fp
                    else:
                        self._pg_cv.wait()
                if self._shutdown:
                    return
                pg_id = self._pg_pending.popleft()
            try:
                placed = self._place_pg_once(pg_id)
            except Exception:
                import traceback

                traceback.print_exc()
                placed = False  # park, never drop: a transient error (node
                # channel death mid-prepare) must not strand the PG forever
            if not placed:
                with self._pg_cv:
                    self._pg_parked.add(pg_id)

    def _place_pg_once(self, pg_id: PlacementGroupId) -> bool:
        """One 2PC placement pass. True = done (created, removed, or
        gone); False = no capacity, park for retry."""
        info = self.gcs.get_pg(pg_id)
        if info is None or info.state in ("REMOVED", "CREATED"):
            return True
        placement = self.scheduler.pick_bundle_nodes(
            self._views(), info.bundles, info.strategy)
        if placement is None:
            return self._mark_pg_pending(info)
        # phase 1: prepare all bundles
        prepared = []
        ok = True
        try:
            for idx, nid in enumerate(placement):
                node = self.nodes.get(nid)
                if node is None or not node.prepare_bundle(
                        pg_id, idx, info.bundles[idx]):
                    ok = False
                    break
                prepared.append((node, idx))
        except Exception:
            ok = False
        if not ok:
            for node, idx in prepared:
                node.return_bundle(pg_id, idx)
            return self._mark_pg_pending(info)
        # phase 2: commit. The CREATED transition is serialized with
        # remove_placement_group's REMOVED transition under _pg_cv — an
        # unsynchronized write here could overwrite REMOVED and resurrect
        # a removed group with its bundles reserved forever.
        for node, idx in prepared:
            node.commit_bundle(pg_id, idx)
        info.bundle_nodes = list(placement)
        with self._pg_cv:
            if info.state == "REMOVED":
                removed = True
            else:
                removed = False
                info.state = "CREATED"
        if removed:
            # the remover may have run mid-prepare and seen no
            # bundle_nodes to return — return them here (return_bundle
            # pops its entry, so a double return no-ops)
            for node, idx in prepared:
                node.return_bundle(pg_id, idx)
            return True
        self.gcs.pubsub.publish("pg", (pg_id, "CREATED"))
        try:
            self._reschedule_parked_tasks()
        except Exception:
            pass  # placement bookkeeping is done; scheduling errors
            # surface on the affected tasks, not the placer
        return True

    def _mark_pg_pending(self, info) -> bool:
        """Transition to PENDING unless a concurrent remove won. Returns
        True when the group was removed (caller must NOT park it)."""
        with self._pg_cv:
            if info.state == "REMOVED":
                return True
            info.state = "PENDING"
            return False

    def pg_ready(self, pg_id: PlacementGroupId, timeout: float = 30.0) -> bool:
        """Event-driven: parks on the GCS 'pg' pubsub channel rather than
        polling get_pg (1k concurrent PGs × 100 polls/s was the first
        casualty of SURVEY §6's envelope)."""
        ev = threading.Event()

        def _on_pg(msg) -> None:
            pid, state = msg
            if pid == pg_id and state == "CREATED":
                ev.set()

        unsub = self.gcs.pubsub.subscribe("pg", _on_pg)
        try:
            # check AFTER subscribing: a publish between check and
            # subscribe would otherwise be missed forever
            info = self.gcs.get_pg(pg_id)
            if info is not None and info.state == "CREATED":
                return True
            return ev.wait(timeout)
        finally:
            unsub()

    def remove_placement_group(self, pg_id: PlacementGroupId) -> None:
        info = self.gcs.get_pg(pg_id)
        if info is None:
            return
        with self._pg_cv:
            info.state = "REMOVED"
            try:
                self._pg_pending.remove(pg_id)
            except ValueError:
                pass
            self._pg_parked.discard(pg_id)
        for idx, nid in enumerate(info.bundle_nodes):
            node = self.nodes.get(nid)
            if node is not None:
                node.return_bundle(pg_id, idx)
        # returned bundles free capacity parked PGs may be waiting on
        self._wake_pg_placer(recheck_parked=True)
        # tasks parked against this group must fail (via _schedule's
        # REMOVED check) rather than stay parked forever
        self._reschedule_parked_tasks()

    # ---- worker RPC dispatch (the node-side core-worker service) -------------

    def _handle_client_call(self, client: "_ClientShell", method: str,
                            payload):
        """Remote-driver calls: object payloads travel as bytes (the
        client cannot mmap the head's segments); everything else reuses
        the worker-call surface with the client as the holder identity."""
        head = self.nodes.get(self.head_node_id)
        if method == "client_get_objects":
            out = []
            for oid in payload["ids"]:
                res = self.fetch_one(oid, payload.get("timeout"))
                if res[0] == "inline":
                    out.append(("inline", res[1]))
                else:
                    _, name, size = res
                    mv = self._reader.read(name, size)
                    try:
                        out.append(("inline", bytes(mv[:size])))
                    finally:
                        del mv
                        self._reader.release(name)
            return out
        if method == "client_put":
            oid = payload["object_id"]
            data = payload["data"]
            # the HEAD's config (system_config overrides included), not
            # the module default — DEFAULT doesn't see init() overrides
            if len(data) <= self.config.max_direct_call_object_size:
                self.store_inline_bytes(oid, data)
            else:
                head.store.put_bytes(oid, data, pin=True)
                sh = self._oshard(oid)
                with sh.lock:
                    sh.dir.setdefault(oid, set()).add(head.node_id)
                self._notify_object(oid)
            self.refcount.add_owned(oid)
            self.refcount.add_holder_ref(oid, client.worker_id)
            return True
        return self.handle_worker_call(head, client, method, payload)

    def _block_guard(self, node: Node, worker: Optional[WorkerHandle]):
        """Blocked-worker accounting for worker-originated blocking calls:
        `on_block` (invoked lazily, only if the call actually waits) returns
        the worker's lease resources to its node's pool; `unblock` re-takes
        them on the way out (ref: local_task_manager.cc:57)."""
        state = {"blocked": False}

        def on_block():
            if worker is not None and not state["blocked"]:
                state["blocked"] = True
                node.notify_worker_blocked(worker)

        def unblock():
            if state["blocked"]:
                node.notify_worker_unblocked(worker)

        return on_block, unblock

    def query_logs(self, **kw) -> dict:
        """Attributed log query against the GCS LogStore —
        {"records": [...], "cursor": n}; kwargs are LogStore.query's
        (job/task/actor/worker/node id prefixes, stream, errors_only,
        since, limit, follow_timeout)."""
        return self.gcs.logs.query(**kw)

    def recent_logs(self, worker_id: Optional[str] = None,
                    node_id: Optional[str] = None,
                    pid: Optional[int] = None,
                    limit: int = 500) -> list:
        """Legacy tail view over the attributed store (dashboard log
        view / `util.state.recent_logs`); rows keep the pre-LogStore
        `t` field alongside `ts`."""
        res = self.gcs.logs.query(worker_id=worker_id or None,
                                  node_id=node_id or None,
                                  limit=max(limit, 1)
                                  if not pid else 100000)
        rows = [{**r, "t": r.get("ts")} for r in res["records"]]
        if pid:
            rows = [r for r in rows if r.get("pid") == pid]
        return rows[-limit:]

    def stack_report(self, timeout_s: float = 5.0) -> dict:
        """Merged thread stacks from the driver and EVERY live worker
        (local and remote), fanned out in parallel — the `ray stack`
        analog. Workers that fail to answer in time appear with an
        `error` entry instead of blocking the merge."""
        from ..util.introspect import dump_stacks

        report = {"driver": dump_stacks(), "workers": []}
        targets = []
        for node in list(self.nodes.values()):
            if not node.alive:
                continue
            for w in node.list_workers():
                targets.append((node, w))

        def one(node, w):
            base = {"node_id": node.node_id.hex(),
                    "worker_id": w.worker_id.hex(),
                    "pid": w.pid, "state": w.state,
                    "actor_id": w.actor_id.hex() if w.actor_id else ""}
            try:
                base.update(node.worker_stack(w, timeout=timeout_s))
            except Exception as e:
                base["error"] = repr(e)
            return base

        if targets:
            pool = ThreadPoolExecutor(
                max_workers=min(16, len(targets)),
                thread_name_prefix="stack-fanout")
            try:
                futs = [pool.submit(one, n, w) for n, w in targets]
                for f in futs:
                    try:
                        report["workers"].append(
                            f.result(timeout=timeout_s + 15.0))
                    except Exception as e:  # noqa: BLE001 — merge goes on
                        report["workers"].append({"error": repr(e)})
            finally:
                pool.shutdown(wait=False)
        return report

    def profile_worker(self, worker_id_prefix: str,
                       duration_s: float = 5.0,
                       interval_s: float = 0.01) -> dict:
        """On-demand sampling profile of one live worker, addressed by
        worker-id prefix; returns the collapsed-stack + function table
        result (ray_tpu_torch profile CLI / state API)."""
        for node in list(self.nodes.values()):
            if not node.alive:
                continue
            for w in node.list_workers():
                if w.worker_id.hex().startswith(worker_id_prefix):
                    res = node.worker_profile(w, duration_s=duration_s,
                                              interval_s=interval_s)
                    res["worker_id"] = w.worker_id.hex()
                    res["node_id"] = node.node_id.hex()
                    return res
        raise ValueError(
            f"no live worker with id prefix {worker_id_prefix!r}")

    def _ingest_worker_logs(self, node: Node,
                            worker: Optional[WorkerHandle],
                            payload: dict) -> None:
        """A worker_log batch arrived: stamp node/worker provenance,
        index into the GCS LogStore, and mirror remote stdout/stderr to
        the driver console."""
        from ..util import logs as logs_mod

        recs = payload.get("recs") or ()
        pid = payload.get("pid")
        nhex = node.node_id.hex()
        whex = worker.worker_id.hex() if worker is not None else ""
        out = []
        mirror: Dict[str, list] = {}
        counts: Dict[str, int] = {}
        for rec in recs:
            try:
                stream, seq, ts, job, task, actor, level, line = rec
            except Exception:
                continue  # one malformed record must not drop the batch
            out.append({"ts": ts, "node_id": nhex, "worker_id": whex,
                        "pid": pid, "job_id": job, "task_id": task,
                        "actor_id": actor, "stream": stream,
                        "level": level, "seq": seq, "line": line})
            counts[stream] = counts.get(stream, 0) + 1
            if stream in ("stdout", "stderr"):
                mirror.setdefault(stream, []).append(line)
            elif stream == "log":
                # structured lines (incl. the rpdb connect banner) must
                # reach the driver console too — the remote machine's
                # stderr is invisible to the operator
                mirror.setdefault("log", []).append(
                    f"{level} {line}" if level else line)
        dropped = int(payload.get("dropped") or 0)
        if dropped:
            # surface the gap IN the stream, where a reader will see it
            out.append({"ts": time.time(), "node_id": nhex,
                        "worker_id": whex, "pid": pid, "job_id": "",
                        "task_id": "", "actor_id": "", "stream": "log",
                        "level": "WARNING", "seq": -1,
                        "line": f"[ray_tpu_torch] {dropped} log line(s) dropped "
                                f"by the per-worker rate limit"})
        if not out:
            return
        self.gcs.logs.append(out)
        for stream, n in counts.items():
            logs_mod.LINES_TOTAL.inc(n, tags={"stream": stream})
        if getattr(node, "is_remote", False):
            for stream, lines in mirror.items():
                self._log_mirror.emit(nhex, pid, stream, lines)

    def handle_worker_call(self, node: Node, worker: Optional[WorkerHandle],
                           method: str, payload):
        if method == "get_objects":
            ids = payload["ids"]
            timeout = payload.get("timeout")
            on_block, unblock = self._block_guard(node, worker)
            try:
                return [self.fetch_one(oid, timeout, on_block=on_block)
                        for oid in ids]
            finally:
                unblock()
        if method == "put_inline":
            oid = payload["object_id"]
            self.store_inline_bytes(oid, payload["data"])
            self.refcount.add_owned(oid)
            if worker is not None:
                # the putting worker holds the ref; without this the object
                # has zero counted references and a later unpin frees it
                # out from under the worker (round-1 weak #4)
                self.refcount.add_holder_ref(oid, worker.worker_id)
            return True
        if method == "export_function":
            self.gcs.kv_put("fn:" + payload["func_id"], payload["blob"],
                            namespace="fn", overwrite=False)
            return True
        if method == "get_function":
            return self.get_function_blob(payload)
        if method == "submit_task":
            # the submitting process already counted this task in its own
            # direct/routed split
            refs = self.submit_spec(payload, _count=False)
            if worker is not None:
                # count the submitting worker as holder of the return refs;
                # the transient driver-side refs created by submit_spec are
                # balanced (add_local now, remove_local at GC) and must not
                # be the only thing keeping the results alive
                for r in refs:
                    self.refcount.add_holder_ref(r.id, worker.worker_id)
            return True
        if method == "create_actor":
            self.create_actor(payload["spec"], name=payload.get("name", ""),
                              detached=payload.get("detached", False),
                              meta=payload.get("meta"))
            return True
        if method == "wait":
            refs = [ObjectRef(o) for o in payload["ids"]]
            on_block, unblock = self._block_guard(node, worker)
            try:
                ready, pending = self.wait(refs, payload["num_returns"],
                                           payload.get("timeout"),
                                           on_block=on_block)
            finally:
                unblock()
            return ([r.id for r in ready], [r.id for r in pending])
        if method == "kill_actor":
            self.kill_actor(payload["actor_id"], payload.get("no_restart", True))
            return True
        if method == "cancel_task":
            self.cancel(payload["task_id"], payload.get("force", False))
            return True
        if method == "actor_state":
            return self.actor_state(payload)
        if method == "wait_for_actor":
            on_block, unblock = self._block_guard(node, worker)
            on_block()  # not a hot path: treat the whole call as blocked
            try:
                self.wait_for_actor(payload["actor_id"],
                                    payload.get("timeout", 60.0))
            finally:
                unblock()
            return True
        if method == "get_named_actor":
            info = self.gcs.get_named_actor(payload["name"], payload["namespace"])
            if info is None or info.state == ActorState.DEAD:
                return None
            meta = self.gcs.kv_get("actor_meta:" + info.actor_id.hex(),
                                   namespace="actor")
            return {"actor_id": info.actor_id, "meta": meta}
        if method == "kv_put":
            return self.gcs.kv_put(payload["key"], payload["value"],
                                   namespace=payload.get("namespace", "user"),
                                   overwrite=payload.get("overwrite", True))
        if method == "kv_get":
            return self.gcs.kv_get(payload["key"],
                                   namespace=payload.get("namespace", "user"))
        if method == "kv_del":
            return self.gcs.kv_del(payload["key"],
                                   namespace=payload.get("namespace", "user"))
        if method == "kv_keys":
            return self.gcs.kv_keys(payload.get("prefix", ""),
                                    namespace=payload.get("namespace", "user"))
        if method == "create_pg":
            return self.create_placement_group(payload["bundles"],
                                               payload["strategy"],
                                               payload.get("name", ""))
        if method == "pg_ready":
            on_block, unblock = self._block_guard(node, worker)
            on_block()  # not a hot path: treat the whole call as blocked
            try:
                return self.pg_ready(payload["pg_id"],
                                     payload.get("timeout", 30.0))
            finally:
                unblock()
        if method == "remove_pg":
            self.remove_placement_group(payload["pg_id"])
            return True
        if method == "generator_item":
            # The boolean is the cancellation half of the protocol: False
            # tells the producing worker the consumer dropped the generator.
            return self.on_generator_item(payload["task_id"], payload["index"],
                                          payload["object_id"],
                                          payload.get("data"))
        if method == "generator_next":
            on_block, unblock = self._block_guard(node, worker)
            try:
                ref = self.next_generator_item(payload["task_id"],
                                               payload["index"],
                                               payload.get("timeout"),
                                               on_block=on_block)
            except exc.GetTimeoutError:
                raise
            except BaseException as e:  # generator failed: typed error back
                return ("error", serialization.dumps(e))
            finally:
                unblock()
            if ref is None:
                return ("done", None)
            if worker is not None:
                self.refcount.add_holder_ref(ref.id, worker.worker_id)
            return ("ref", ref.id)
        if method == "release_generator":
            self.release_generator(payload)
            return None
        if method == "add_ref":
            if worker is not None:
                self.refcount.add_holder_ref(payload, worker.worker_id)
            else:
                self.refcount.add_local(payload)
            return None
        if method == "remove_ref":
            if worker is not None:
                self.refcount.remove_holder_ref(payload, worker.worker_id)
            else:
                self.refcount.remove_local(payload)
            return None
        if method == "node_info":
            return {"node_id": node.node_id, "job_id": self.job_id,
                    "namespace": self.namespace}
        if method == "log_event":
            self.gcs.add_task_event(payload)
            return None
        if method == "metrics_push":
            # worker-process metric deltas -> the head's single /metrics
            # exposition, tagged with their origin (the metrics-agent
            # aggregation path; ref: python/ray/_private/metrics_agent.py)
            metrics_mod.merge_remote(
                payload.get("deltas") or [],
                node=node.node_id.hex()[:12],
                worker=(worker.worker_id.hex()[:12]
                        if worker is not None else ""))
            return None
        if method == "task_events":
            return list(self.gcs.task_events())
        if method == "worker_log":
            # attributed log batches: LogStore index + driver mirroring
            self._ingest_worker_logs(node, worker, payload or {})
            return None
        if method == "logs_query":
            return self.query_logs(**(payload or {}))
        if method == "traces_query":
            return self.gcs.traces.query(**(payload or {}))
        if method == "trace_get":
            return self.gcs.traces.get(payload)
        if method == "trace_chrome":
            from ..util.state import _span_trace_events

            tr = self.gcs.traces.get(payload)
            return (_span_trace_events(list(tr.get("spans_detail", ())))
                    if tr else None)
        if method == "cgraph_send":
            # compiled-graph cross-node edge: producer -> head -> consumer
            return self._cgraph_route(payload)
        if method == "resolve_actor":
            # direct dispatch: a worker asks where an actor lives (once
            # per caller x actor x epoch — NOT per call)
            return self.resolve_actor(payload)
        if method == "direct_result_stored":
            # a direct result whose value contains ObjectRefs (or is
            # large): it must live in the head's store so the borrower
            # pins (_nested_refs) protect the nested objects exactly as
            # the routed path does
            oid = payload["object_id"]
            nested = payload.get("borrowed") or []
            if nested:
                sh = self._oshard(oid)
                with sh.lock:
                    sh.nested.setdefault(oid, []).extend(nested)
                for n in nested:
                    self.refcount.add_local(n)
            self.store_inline_bytes(oid, payload["data"])
            self.refcount.add_owned(oid)
            return True
        if method == "task_events_batch":
            # batched lifecycle events for direct-path tasks: the head
            # learns of completions in one message per interval instead
            # of per-call GCS traffic
            self.gcs.add_task_events(payload or [])
            return None
        raise ValueError(f"unknown worker call: {method}")

    # ---- compiled graphs (ray_tpu_torch/cgraph) ------------------------------------

    def _cgraph_register(self, dag) -> None:
        with self._lock:
            self._cgraphs[dag.graph_id] = dag
            for akey in dag._actor_plans:
                self._cgraph_actors[akey] = dag.graph_id

    def _cgraph_unregister(self, dag) -> None:
        with self._lock:
            self._cgraphs.pop(dag.graph_id, None)
            for akey in [k for k, g in self._cgraph_actors.items()
                         if g == dag.graph_id]:
                self._cgraph_actors.pop(akey, None)
            for cid in [c for c, r in self._cgraph_routes.items()
                        if r[3] == dag.graph_id]:
                self._cgraph_routes.pop(cid, None)

    def _cgraph_actor_in_use(self, actor_id: ActorId) -> bool:
        with self._lock:
            return actor_id.binary() in self._cgraph_actors

    def _cgraph_route(self, payload: dict) -> bool:
        """Route one cross-node compiled-graph envelope: a producer
        worker shipped it up its node channel; deliver it to the
        consumer process (driver queue, or a worker's cgraph_push)."""
        with self._lock:
            route = self._cgraph_routes.get(payload["cid"])
        if route is None:
            return False  # late send after teardown: drop
        kind, target, worker, gid = route
        msg = {"graph_id": gid, "cid": payload["cid"],
               "seq": payload["seq"], "data": payload["data"]}
        if kind == "driver":
            target._deliver(payload["cid"], payload["seq"],
                            payload["data"])
        else:
            target.worker_notify(worker, "cgraph_push", msg)
        return True

    # ---- cancellation --------------------------------------------------------

    def cancel(self, task_id_or_ref, force: bool = False) -> None:
        if isinstance(task_id_or_ref, ObjectRef):
            spec = self.task_manager.lineage_for_object(task_id_or_ref.id)
        else:
            pt = self.task_manager.get(task_id_or_ref)
            spec = pt.spec if pt else None
        if spec is None:
            return
        pt = self.task_manager.get(spec.task_id)
        if pt is None:
            return
        pt.retries_left = 0
        found_running = False
        for node in list(self.nodes.values()):
            for w in list(node._workers.values()):
                if spec.task_id in w.in_flight:
                    found_running = True
                    if force:
                        node.kill_worker(w, force=True)
                    elif w.channel is not None:
                        w.channel.notify("cancel_task", spec.task_id)
        if not found_running:
            self._fail_task(spec, exc.TaskCancelledError(
                f"Task {spec.description} cancelled before execution"))

    # ---- context & lifecycle -------------------------------------------------

    def runtime_context(self) -> RuntimeContext:
        return RuntimeContext(job_id=self.job_id, node_id=self.head_node_id,
                              worker_id=self.worker_id, namespace=self.namespace)

    def cluster_resources(self) -> ResourceSet:
        total: ResourceSet = {}
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.total_resources.items():
                    total[k] = total.get(k, 0) + v
        return total

    def available_resources(self) -> ResourceSet:
        total: ResourceSet = {}
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.available.items():
                    total[k] = total.get(k, 0) + v
        return total

    def shutdown(self) -> None:
        """Idempotent and race-safe: concurrent callers (atexit hook vs
        signal handler vs explicit call) serialize on the shutdown lock —
        the loser blocks until teardown actually finished instead of
        returning while nodes/channels are still being released. A
        REENTRANT call from the same thread (a signal delivered inside
        shutdown, or an on_close callback calling back in) returns
        immediately: blocking would self-deadlock."""
        # no unlocked fast path on the _shutdown flag: the flag is set
        # BEFORE the body runs, so a concurrent caller reading it early
        # would return while teardown is still in progress — it must
        # block on the lock below instead
        if not self._shutdown_lock.acquire(blocking=False):
            # a true compare only ever observes the reading thread's own
            # earlier write, so reading the owner field unlocked is safe
            # graftcheck: disable=GC050 — reentrancy probe
            if self._shutdown_owner == threading.get_ident():
                return  # reentrant (signal handler / close callback)
            with self._shutdown_lock:  # concurrent: wait for completion
                return
        try:
            if self._shutdown:
                return
            self._shutdown_owner = threading.get_ident()
            self._shutdown = True
            self._shutdown_body()
        finally:
            self._shutdown_owner = None
            self._shutdown_lock.release()

    def _shutdown_body(self) -> None:
        for dag in list(self._cgraphs.values()):
            try:
                dag.teardown()  # release channel segments + stop loops
            except Exception:
                pass
        for rec in list(self._actors.values()):
            chan = rec.direct_chan
            if chan is not None:
                try:
                    chan.close()
                except Exception:
                    pass
        with self._pg_cv:
            self._pg_cv.notify()
        for node in list(self.nodes.values()):
            try:
                node.shutdown(kill=False)
            except Exception:
                pass
        if getattr(self, "_remote_server", None) is not None:
            try:
                self._remote_server.close()
            except Exception:
                pass
        self.gcs.finish_job(self.job_id)
        self.gcs.stop()
        self._reader.close()
        self._pool.shutdown(wait=False)


class _TaskCtx:
    __slots__ = ("spec", "put_index")

    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.put_index = 0


class _ClientShell:
    """Holder identity + no-op lease surface for a remote-driver client
    (quacks enough like a WorkerHandle for handle_worker_call and
    _block_guard; clients hold no lease, so blocking accounting no-ops)."""

    __slots__ = ("worker_id", "lease_resources", "state", "blocked_depth")

    def __init__(self, worker_id: WorkerId):
        self.worker_id = worker_id
        self.lease_resources: dict = {}
        self.state = "client"
        self.blocked_depth = 0


class _WorkerDirectState:
    """Worker-side half of decentralized dispatch (docs/DISPATCH.md).

    A worker calling ``handle.method.remote()`` resolves the actor's
    placement ONCE through the head, then submits every subsequent call
    straight to the owning worker over a cached peer connection — zero
    head RPCs in steady state. Results come back inline on the peer
    channel and are resolved from a local table; refs that ESCAPE this
    process (task args, values put/returned containing them) are first
    published to the head so the rest of the cluster can see them. Any
    peer failure falls back to the routed path."""

    def __init__(self, wr: "WorkerRuntime"):
        self.wr = wr
        self._lock = instrumented_lock("worker.direct")
        self._actors: Dict[ActorId, dict] = {}   # actor -> cache entry
        self._peers: Dict[str, Any] = {}         # addr -> RpcChannel
        self._rows: Dict[ObjectId, dict] = {}    # return oid -> row
        self._tasks: Dict[TaskId, dict] = {}     # task_id -> task row

    # -- submission -----------------------------------------------------------

    def try_submit(self, spec: TaskSpec) -> Optional[List[ObjectRef]]:
        if not DriverRuntime._direct_eligible(spec):
            return None
        entry = self._entry_for(spec.actor_id)
        if entry is None:
            return None
        chan = entry["chan"]
        ev = threading.Event()
        trow = {"spec": spec, "event": ev, "done": False, "chan": chan,
                "actor_id": spec.actor_id}
        with self._lock:
            if not entry.get("ok"):
                return None
            spec.owner_id = self.wr.worker_id
            spec.seq_no = entry["seq"]
            entry["seq"] += 1
            gate, era = entry["gate"], entry["lane"]
            self._tasks[spec.task_id] = trow
            for oid in spec.return_ids():
                self._rows[oid] = {"state": "pending", "data": None,
                                   "trow": trow, "head_ref": False}
        chan.notify("direct_submit", {"spec": spec, "gate": gate,
                                      "lane": era})
        _C_DIRECT.inc()
        _rec_dispatch("direct", spec)
        if chan.closed:
            # raced the peer's death: on_close may have swept before our
            # rows registered — run the fallback for this task explicitly
            self._fallback_task(trow)
        refs = []
        for oid in spec.return_ids():
            ref = ObjectRef(oid)
            weakref.finalize(ref, self._drop, oid)
            refs.append(ref)
        return refs

    def _entry_for(self, actor_id: ActorId) -> Optional[dict]:
        with self._lock:
            entry = self._actors.get(actor_id)
            if entry is not None and entry.get("ok") \
                    and not entry["chan"].closed \
                    and not entry.get("stale_gate"):
                return entry
            if entry is not None and entry.get("bad_until", 0) \
                    > time.monotonic():
                return None  # negative cache: don't pay a resolve RPC
                # per call while the actor stays routed-only
        try:
            res = self.wr.channel.call("resolve_actor", actor_id, timeout=30)
        except Exception:
            res = None
        with self._lock:
            old = self._actors.get(actor_id)
            if res is None or not res.get("addr"):
                # mutate the EXISTING entry in place (never replace it:
                # an in-flight try_submit may hold the dict — a fresh
                # copy forks the seq counter, and in-place mutation is
                # also what makes its ok-recheck see this failure)
                if old is None:
                    old = {"seq": 0, "lane": 0, "chan": None,
                           "epoch": -1}
                    self._actors[actor_id] = old
                old["ok"] = False
                old["bad_until"] = time.monotonic() + 0.5
                return None
        chan = self._peer(res["addr"])
        if chan is None:
            with self._lock:
                old = self._actors.get(actor_id)
                if old is None:
                    old = {"seq": 0, "lane": 0}
                    self._actors[actor_id] = old
                fails = old.get("fails", 0)
                old["ok"] = False
                old["bad_until"] = time.monotonic() \
                    + _DIRECT_RECONNECT.backoff(fails)
                old["fails"] = fails + 1
                old["epoch"] = res["epoch"]
                # the old socket is gone: dropping the chan forces the
                # recovery path into a new lane era (seq restarts there)
                old.pop("chan", None)
            return None
        with self._lock:
            old = self._actors.get(actor_id) or {}
            # same epoch over the SAME live connection: the worker's lane
            # for this caller survives — seq continues (a restart would
            # collide with frames already buffered there), so the entry
            # is refreshed IN PLACE. Replacing the dict forked the seq
            # counter: a racing try_submit (first-call burst, or a
            # stale_gate refresh racing an in-flight call) still held
            # the old dict, two frames went out with the same lane+seq,
            # the receiver dropped one as a duplicate and that caller
            # hung to its get() timeout (found by scripts/locks_gate.py:
            # instrumented-lock overhead widens the window to every run).
            if old.get("epoch") == res["epoch"] and old.get("chan") is chan:
                old.update({"ok": True, "addr": res["addr"],
                            "gate": res["gate"], "actor_id": actor_id,
                            "chan": chan, "epoch": res["epoch"]})
                old.pop("stale_gate", None)
                old.setdefault("lane", 0)
                old.setdefault("seq", 0)
                self._actors[actor_id] = old
                return old
            # a new channel is a new era: frames lost in the old socket
            # would strand the receiver's expected counter, so bump the
            # lane and restart seq (the receiver resets on a higher era)
            entry = {"ok": True, "addr": res["addr"], "chan": chan,
                     "epoch": res["epoch"], "gate": res["gate"],
                     "actor_id": actor_id,
                     "lane": old.get("lane", 0) + 1, "seq": 0}
            self._actors[actor_id] = entry
            return entry

    def note_routed(self, actor_id: Optional[ActorId]) -> None:
        """A routed actor submission happened (streaming / ref args): the
        cached gate no longer covers it — force a re-resolve (fresh gate,
        same lane) before the next direct call so per-caller FIFO holds."""
        if actor_id is None:
            return
        with self._lock:
            entry = self._actors.get(actor_id)
            if entry is not None and entry.get("ok"):
                entry["stale_gate"] = True

    def _peer(self, addr: str):
        with self._lock:
            ch = self._peers.get(addr)
            if ch is not None and not ch.closed:
                return ch
        from .rpc import connect as _rpc_connect

        try:
            ch = _rpc_connect(addr, handler=self._peer_handler, name="dpeer")
        except Exception:
            return None
        ch.on_close(lambda a=addr, c=ch: self._on_peer_close(a, c))
        dup = None
        with self._lock:
            old = self._peers.get(addr)
            if old is not None and not old.closed:
                dup = ch
                ch = old
            else:
                self._peers[addr] = ch
        if dup is not None:
            # lost the connect race: close the duplicate OUTSIDE the
            # lock — close() runs on_close callbacks synchronously, and
            # _on_peer_close takes the same (non-reentrant) lock. Closing
            # under the lock self-deadlocked every router thread in the
            # process (100-in-flight serve load on multi-core boxes).
            dup.close()
        return ch

    def _peer_handler(self, method: str, payload):
        if method == "direct_result":
            self.on_direct_result(payload)
            return None
        raise ValueError(f"unknown direct peer message {method}")

    # -- results --------------------------------------------------------------

    def on_direct_result(self, payload: dict) -> None:
        with self._lock:
            trow = self._tasks.pop(payload["task_id"], None)
            if trow is None or trow["done"]:
                return
            trow["done"] = True
            spec = trow["spec"]
            if payload.get("stale"):
                entry = self._actors.get(spec.actor_id)
                if entry is not None:
                    entry["ok"] = False
                stale = True
            else:
                stale = False
                error = payload.get("error")
                rids = spec.return_ids()
                results = payload.get("results") or []
                add_refs = []
                for i, oid in enumerate(rids):
                    row = self._rows.get(oid)
                    if row is None:
                        continue
                    if error is not None:
                        row["state"] = "error"
                        row["data"] = error
                    elif i < len(results) and results[i][0] == "inline":
                        row["state"] = "done"
                        row["data"] = results[i][1]
                    else:
                        # ("stored"): the head's store owns it — count
                        # this process as holder for the ref's lifetime
                        row["state"] = "stored"
                        row["head_ref"] = True
                        add_refs.append(oid)
        if stale:
            self._fallback_task(trow)
            return
        for oid in add_refs:
            try:
                self.wr.channel.notify("add_ref", oid)
            except Exception:
                pass
        trow["event"].set()

    def _on_peer_close(self, addr: str, ch=None) -> None:
        with self._lock:
            # identity check: a duplicate connection losing the connect
            # race must not evict the winner from the cache (mirrors the
            # driver-side _on_direct_peer_close hardening)
            if ch is None or self._peers.get(addr) is ch:
                self._peers.pop(addr, None)
            victims = [t for t in self._tasks.values()
                       if not t["done"] and t["chan"].closed]
            for e in self._actors.values():
                if e.get("ok") and e.get("addr") == addr \
                        and (ch is None or e.get("chan") is ch):
                    e["ok"] = False
        for trow in sorted(victims, key=lambda t: t["spec"].seq_no):
            self._fallback_task(trow)

    def _fallback_task(self, trow: dict) -> None:
        """Peer died / stale placement: resubmit through the head, which
        owns restart/death semantics. Idempotent per task. Mirrors the
        driver's retry rule: a task whose worker died re-runs only with a
        retry budget (or when the actor is in fact still ALIVE — lost
        connection, not a death); otherwise it fails typed."""
        with self._lock:
            if trow.get("routed"):
                return
            if not trow["done"]:
                self._tasks.pop(trow["spec"].task_id, None)
                trow["done"] = True
            trow["routed"] = True
            spec = trow["spec"]
            rows = [self._rows.get(oid) for oid in spec.return_ids()]
        if spec.max_retries == 0:
            try:
                alive = self.wr.channel.call(
                    "actor_state", spec.actor_id, timeout=30) == "ALIVE"
            except Exception:
                alive = False
            if not alive:
                blob = serialization.dumps(exc.ActorDiedError(
                    f"Actor {spec.actor_id.hex()[:8]} died while running "
                    f"{spec.description}"))
                with self._lock:
                    for row in rows:
                        if row is not None and row["state"] == "pending":
                            row["state"] = "error"
                            row["data"] = blob
                trow["event"].set()
                return
        import copy

        spec = copy.copy(spec)  # the direct frame may still be queued
        spec.owner_id = None
        spec.seq_no = 0
        _C_ROUTED.inc()
        try:
            self.wr.channel.call("submit_task", spec)
        except Exception:
            # head unreachable too: the worker is dying; leave rows
            # pending — getters time out
            return
        with self._lock:
            for row in rows:
                if row is not None and row["state"] == "pending":
                    # the head now counts this worker as holder of the
                    # return refs (submit_task handler)
                    row["state"] = "routed"
                    row["head_ref"] = True
        trow["event"].set()

    def _drop(self, oid: ObjectId) -> None:
        with self._lock:
            row = self._rows.pop(oid, None)
        if row is not None and row.get("head_ref"):
            try:
                self.wr.channel.notify("remove_ref", oid)
            except Exception:
                pass

    # -- resolution into the get/wait planes ----------------------------------

    def involves(self, oids) -> bool:
        with self._lock:
            return any(o in self._rows for o in oids)

    def ensure_published(self, oid: ObjectId) -> None:
        """This ref is escaping the process (task arg, nested in a put or
        a return): the head must own a copy first, or the consumer's
        fetch would hang on an object only this process knows about.
        Blocks until the direct result arrives if it is still in flight."""
        with self._lock:
            row = self._rows.get(oid)
            if row is None or row.get("published") or row.get("head_ref"):
                return
            trow = row["trow"]
        trow["event"].wait(300)
        with self._lock:
            if row.get("published") or row["state"] not in ("done", "error"):
                return  # stored/routed rows already live head-side;
                # error blobs publish too (the consumer must see the
                # typed failure, not hang)
            data = row["data"]
            row["published"] = True
            row["head_ref"] = True
        try:
            self.wr.channel.call("put_inline", {"object_id": oid,
                                                "data": data})
        except Exception:
            pass

    def get_many(self, oids: List[ObjectId], timeout: Optional[float]):
        """Resolve direct-result oids locally; delegate the rest to the
        head. Returns fetch-result tuples aligned with oids (the caller
        deserializes)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out: Dict[int, Tuple] = {}
        head_ids: List[Tuple[int, ObjectId]] = []
        for i, oid in enumerate(oids):
            with self._lock:
                row = self._rows.get(oid)
            if row is None:
                head_ids.append((i, oid))
                continue
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not row["trow"]["event"].wait(remaining):
                raise exc.GetTimeoutError(
                    f"Get timed out waiting for object {oid.hex()[:12]}")
            with self._lock:
                state, data = row["state"], row["data"]
            if state in ("done", "error"):
                out[i] = ("inline", data)
            else:  # stored / routed / pending-after-fallback: head-side
                head_ids.append((i, oid))
        if head_ids:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            fetched = self.wr.channel.call(
                "get_objects", {"ids": [o for _, o in head_ids],
                                "timeout": remaining}, timeout=None)
            for (i, _), res in zip(head_ids, fetched):
                out[i] = res
        return [out[i] for i in range(len(oids))]

    def wait(self, refs, num_returns: int, timeout: Optional[float]):
        """wait() over a mix of local direct results and head-side refs."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ready, pending = [], []
            head_pending = []
            for r in refs:
                with self._lock:
                    row = self._rows.get(r.id)
                if row is None or row["state"] in ("stored", "routed"):
                    head_pending.append(r)
                    pending.append(r)
                elif row["trow"]["event"].is_set():
                    ready.append(r)
                else:
                    pending.append(r)
            if len(ready) >= num_returns or not pending:
                return ready[:num_returns], \
                    [r for r in refs if r not in ready[:num_returns]]
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                return ready, pending
            if head_pending:
                if len(head_pending) < len(pending):
                    # mixed wait: short head slices so a local direct
                    # result firing mid-wait can still cut it short
                    slice_t = 0.1 if remaining is None \
                        else max(0.0, min(0.1, remaining))
                else:
                    # every pending ref is head-side: nothing local can
                    # change, so ONE blocking call with the full budget
                    # (the head's wait is event-driven) — not a 100 ms
                    # poll loop multiplying head traffic per waiter
                    slice_t = remaining
                ready_ids, _ = self.wr.channel.call(
                    "wait", {"ids": [r.id for r in head_pending],
                             "num_returns": min(num_returns - len(ready),
                                                len(head_pending)),
                             "timeout": slice_t}, timeout=None)
                ready_set = set(ready_ids)
                newly = [r for r in head_pending if r.id in ready_set]
                if newly:
                    ready.extend(newly)
                    if len(ready) >= num_returns:
                        return ready[:num_returns], \
                            [r for r in refs if r not in ready[:num_returns]]
            else:
                # purely local: park on the first pending event briefly
                first = next((r for r in pending), None)
                with self._lock:
                    row = self._rows.get(first.id) if first else None
                if row is not None:
                    slice_t = 0.1 if remaining is None \
                        else max(0.0, min(0.1, remaining))
                    row["trow"]["event"].wait(slice_t)


class WorkerRuntime:
    """Thin runtime inside worker processes: proxies the core API over the
    node channel (the analog of _raylet.pyx calling into CoreWorker)."""

    def __init__(self, worker_process):
        self.worker = worker_process
        self.channel = worker_process.channel
        # contextvars, not thread-locals: async-actor coroutines interleave
        # on one event-loop thread, but each asyncio.Task carries its own
        # Context, so per-task state stays isolated
        self._current: "contextvars.ContextVar[Optional[_TaskCtx]]" = \
            contextvars.ContextVar("rtpu_current_task", default=None)
        self._fn_cache: Dict[int, tuple] = {}
        self._put_lock = instrumented_lock("worker.put_counter")
        self._put_counter = 0
        self.worker_id = worker_process.worker_id
        self._held_lock = instrumented_lock("worker.held_refs")
        self._held: Dict[ObjectId, int] = {}
        from .config import DEFAULT as _cfg

        self._direct = (_WorkerDirectState(self)
                        if int(_cfg.direct_actor_calls) else None)

    # -- worker-held reference accounting (ref: reference_count.h:61 borrower
    # reports; the head aggregates per-holder counts and frees only when all
    # holders have dropped theirs) ------------------------------------------

    def adopt_owned_ref(self, ref: ObjectRef) -> None:
        """A ref whose holder-count the head already established (task
        submission returns, puts): only attach the decrement finalizer."""
        with self._held_lock:
            self._held[ref.id] = self._held.get(ref.id, 0) + 1
        weakref.finalize(ref, self._deref, ref.id)

    def register_borrowed_ref(self, ref: ObjectRef) -> None:
        """A ref deserialized in this worker (task arg or inside a fetched
        value): report the borrow to the head, then track like any ref."""
        with self._held_lock:
            self._held[ref.id] = self._held.get(ref.id, 0) + 1
        try:
            self.channel.notify("add_ref", ref.id)
        except Exception:
            pass
        weakref.finalize(ref, self._deref, ref.id)

    def _deref(self, oid: ObjectId) -> None:
        with self._held_lock:
            c = self._held.get(oid, 0) - 1
            if c <= 0:
                self._held.pop(oid, None)
            else:
                self._held[oid] = c
        try:
            self.channel.notify("remove_ref", oid)
        except Exception:
            pass

    # task context
    def set_current_task(self, spec: TaskSpec):
        return self._current.set(_TaskCtx(spec))

    def clear_current_task(self, token) -> None:
        self._current.reset(token)

    def current_task(self) -> Optional[TaskSpec]:
        ctx = self._current.get()
        return ctx.spec if ctx is not None else None

    # objects
    def next_put_id(self) -> ObjectId:
        # Per-task deterministic put indices: a re-executed task (lineage
        # reconstruction) recreates byte-identical put ObjectIds, making
        # objects put inside tasks reconstructable — stronger than the
        # reference, where ray.put objects are unrecoverable.
        ctx = self._current.get()
        if ctx is not None:
            ctx.put_index += 1
            return ObjectId.for_put(ctx.spec.task_id, ctx.put_index)
        with self._put_lock:
            self._put_counter += 1
            return ObjectId.for_put(TaskId.from_random(), self._put_counter)

    def put(self, value: Any) -> ObjectRef:
        from .config import DEFAULT as cfg

        oid = self.next_put_id()
        sobj = serialization.serialize(value)
        for r in sobj.contained_refs:
            # direct results nested in a put value escape this process
            self.ensure_published(r.id)
        if sobj.total_bytes <= cfg.max_direct_call_object_size:
            self.channel.call("put_inline", {"object_id": oid,
                                             "data": sobj.to_bytes()})
        else:
            name = self.channel.call("create_object",
                                     {"object_id": oid, "size": sobj.total_bytes})
            mv = self.worker.reader.read(name, sobj.total_bytes)
            sobj.write_into(mv)
            del mv  # drop the exported view before unmapping
            self.worker.reader.release(name)
            # is_put: the worker holds the only reference (balanced by
            # adopt_owned_ref below); task RETURNS also seal but their
            # lifetime is owned by the caller's returned refs instead.
            self.channel.call("seal_object", {"object_id": oid,
                                              "is_put": True})
        ref = ObjectRef(oid)
        self.adopt_owned_ref(ref)
        return ref

    def get_many(self, oids: List[ObjectId], timeout: Optional[float] = None):
        t0 = time.perf_counter()
        try:
            if self._direct is not None and self._direct.involves(oids):
                results = self._direct.get_many(oids, timeout)
            else:
                results = self.channel.call("get_objects",
                                            {"ids": oids, "timeout": timeout},
                                            timeout=None)
        finally:
            # worker-local registry: ships to the head node/worker-tagged
            _H_GET_WAIT.observe(time.perf_counter() - t0)
        out = []
        for res in results:
            out.append(self._deserialize(res))
        return out

    def on_direct_result(self, payload: dict) -> None:
        """direct_result frames arriving on the NODE channel (a peer that
        replied through it) route here from WorkerProcess.handle_direct."""
        if self._direct is not None:
            self._direct.on_direct_result(payload)

    def ensure_published(self, oid: ObjectId) -> None:
        """A ref is escaping this process (task arg / nested in a put or
        return): make sure the head owns the object first. No-op for
        anything that isn't a locally-held direct result."""
        if self._direct is not None:
            self._direct.ensure_published(oid)

    def _deserialize(self, res):
        if res[0] == "inline":
            value = serialization.loads(res[1])
        else:
            _, name, size = res
            value = serialization.loads(self.worker.reader.read(name, size))
        if isinstance(value, exc.TaskError):
            cause = value.cause
            if isinstance(cause, exc.RayTpuError):
                raise cause
            raise value
        if isinstance(value, exc.RayTpuError):
            raise value
        return value

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        out = self.get_many([r.id for r in refs], timeout)
        return out[0] if single else out

    def get_async(self, ref: ObjectRef):
        import asyncio

        loop = asyncio.get_event_loop()
        return loop.run_in_executor(None, lambda: self.get(ref))

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        if self._direct is not None \
                and self._direct.involves([r.id for r in refs]):
            return self._direct.wait(refs, num_returns, timeout)
        ready_ids, pending_ids = self.channel.call(
            "wait", {"ids": [r.id for r in refs], "num_returns": num_returns,
                     "timeout": timeout}, timeout=None)
        ready_set = {o for o in ready_ids}
        ready = [r for r in refs if r.id in ready_set]
        pending = [r for r in refs if r.id not in ready_set]
        return ready, pending

    # functions / tasks / actors
    def export_function(self, fn) -> str:
        key = id(fn)
        cached = self._fn_cache.get(key)
        if cached is not None and cached[0] is fn:
            return cached[1]
        blob = cloudpickle.dumps(fn)
        func_id = hashlib.sha1(blob).hexdigest()
        self.channel.call("export_function", {"func_id": func_id, "blob": blob})
        self._fn_cache[key] = (fn, func_id)
        return func_id

    def new_task_id(self) -> TaskId:
        return TaskId.from_random()

    def submit_spec(self, spec: TaskSpec) -> List[ObjectRef]:
        if spec.task_type == TaskType.ACTOR_TASK and self._direct is not None:
            refs = self._direct.try_submit(spec)
            if refs is not None:
                return refs
            # routed actor call (streaming / ref args / not resolvable):
            # the cached direct gate no longer covers it
            self._direct.note_routed(spec.actor_id)
        _C_ROUTED.inc()
        _rec_dispatch("routed", spec)
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        self.channel.call("submit_task", spec)
        # the head counted this worker as holder of each return ref during
        # the submit call; pair each with a GC-driven decrement
        for r in refs:
            self.adopt_owned_ref(r)
        return refs

    def create_actor(self, spec: TaskSpec, name: str = "", detached: bool = False,
                     meta: Optional[dict] = None) -> None:
        self.channel.call("create_actor", {"spec": spec, "name": name,
                                           "detached": detached, "meta": meta})

    def kill_actor(self, actor_id: ActorId, no_restart: bool = True) -> None:
        self.channel.call("kill_actor", {"actor_id": actor_id,
                                         "no_restart": no_restart})

    def actor_state(self, actor_id: ActorId) -> str:
        return self.channel.call("actor_state", actor_id)

    def wait_for_actor(self, actor_id: ActorId, timeout: float = 60.0) -> None:
        self.channel.call("wait_for_actor", {"actor_id": actor_id,
                                             "timeout": timeout}, timeout=None)

    def get_named_actor_info(self, name: str, namespace: str):
        return self.channel.call("get_named_actor", {"name": name,
                                                     "namespace": namespace})

    def cancel(self, ref, force: bool = False) -> None:
        self.channel.call("cancel_task", {"task_id": ref, "force": force})

    def free(self, refs) -> None:
        pass  # centralized GC; workers do not free directly

    # placement groups
    def create_placement_group(self, bundles, strategy, name=""):
        return self.channel.call("create_pg", {"bundles": bundles,
                                               "strategy": strategy, "name": name})

    def pg_ready(self, pg_id, timeout: float = 30.0) -> bool:
        return self.channel.call("pg_ready", {"pg_id": pg_id, "timeout": timeout},
                                 timeout=None)

    def remove_placement_group(self, pg_id) -> None:
        self.channel.call("remove_pg", {"pg_id": pg_id})

    # kv
    def next_generator_item(self, task_id, index: int,
                            timeout: Optional[float] = None):
        kind, val = self.channel.call(
            "generator_next",
            {"task_id": task_id, "index": index, "timeout": timeout})
        if kind == "done":
            return None
        if kind == "error":
            err = serialization.loads(val)
            raise err if isinstance(err, BaseException) else \
                exc.TaskError(cause=RuntimeError(str(err)))
        ref = ObjectRef(val)
        self.adopt_owned_ref(ref)  # head counted this worker as holder
        return ref

    def release_generator(self, task_id) -> None:
        self.channel.notify("release_generator", task_id)

    def prepare_runtime_env(self, renv: Optional[dict]) -> Optional[dict]:
        """Nested submission: no env specified inherits the parent task's
        (already-packaged) env — the worker IS that environment; an explicit
        env is packaged fresh (reference semantics: a task-level env
        replaces, not composes)."""
        if not renv:
            cur = self.current_task()
            return cur.runtime_env if cur is not None else None
        from . import runtime_env as renv_mod

        validated = renv_mod.validate(renv)
        key = renv_mod.cache_key(validated)
        cache = getattr(self, "_renv_cache", None)
        if cache is None:
            cache = self._renv_cache = {}
        cached = cache.get(key)
        if cached is None:
            cached = cache[key] = renv_mod.package(
                validated,
                lambda k, b: self.kv_put(k, b,
                                         namespace=renv_mod.KV_NAMESPACE,
                                         overwrite=False))
        return cached

    def kv_put(self, key, value, namespace="user", overwrite=True):
        return self.channel.call("kv_put", {"key": key, "value": value,
                                            "namespace": namespace,
                                            "overwrite": overwrite})

    def kv_get(self, key, namespace="user"):
        return self.channel.call("kv_get", {"key": key, "namespace": namespace})

    def kv_del(self, key, namespace="user"):
        return self.channel.call("kv_del", {"key": key, "namespace": namespace})

    def kv_keys(self, prefix="", namespace="user"):
        return self.channel.call("kv_keys", {"prefix": prefix,
                                             "namespace": namespace})

    def runtime_context(self) -> RuntimeContext:
        spec = self.current_task()
        info = self.channel.call("node_info", {})
        return RuntimeContext(
            job_id=info["job_id"], node_id=info["node_id"],
            worker_id=self.worker_id,
            task_id=spec.task_id if spec else None,
            actor_id=spec.actor_id if spec else None,
            namespace=info["namespace"])

    def shutdown(self) -> None:
        pass
