"""GCS — global control service (control plane).

Equivalent of the reference's GCS server (ref: src/ray/gcs/gcs_server/
gcs_server.h:79) with its sub-managers: node table + health
(gcs_node_manager.cc, gcs_health_check_manager.h:39), actor directory +
lifecycle FSM (gcs_actor_manager.cc:246,271; src/ray/design_docs/
actor_states.rst), internal KV (gcs_kv_manager.cc), pubsub
(src/ray/pubsub/publisher.h:307), job table (gcs_job_manager.cc), placement
groups with 2-phase bundle commit (gcs_placement_group_manager.cc), and task
events (gcs_task_manager.h:61).

This runs in-process on the head (driver) — the single-controller model a TPU
pod already assumes — with optional directory-backed persistence standing in
for the Redis-backed fault-tolerance store (ref: store_client/
redis_store_client.h). Remote hosts reach it over the RpcChannel control
plane.
"""
from __future__ import annotations

import enum
import os
import pickle
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..devtools.locks import instrumented_lock
from ..util import metrics as _metrics
from .ids import ActorId, JobId, NodeId, PlacementGroupId, TaskId, WorkerId
from .resources import ResourceSet
from .task_spec import TaskSpec

# task-lifecycle phase latencies, derived from the state-transition
# event stream (ref: src/ray/stats/metric_defs.cc task latency metrics;
# gcs_task_manager.h:61). Tagged by task name so one straggling function
# is visible next to its siblings; cardinality = #distinct remote fns.
_H_SUBMIT_TO_SCHED = _metrics.Histogram(
    "ray_tpu_task_submit_to_sched_seconds",
    "submit -> node-picked scheduling latency", tag_keys=("name",))
_H_QUEUE_WAIT = _metrics.Histogram(
    "ray_tpu_task_queue_wait_seconds",
    "node-picked -> RUNNING queue/lease wait", tag_keys=("name",))
_H_EXEC = _metrics.Histogram(
    "ray_tpu_task_exec_seconds",
    "RUNNING -> FINISHED/FAILED execution time", tag_keys=("name",))

# phase marks outlive the bounded event ring but must stay bounded too:
# tasks that never reach a terminal state are evicted oldest-first
_PHASE_MARKS_MAX = 20000


class ActorState(enum.Enum):
    # ref: src/ray/design_docs/actor_states.rst
    DEPENDENCIES_UNREADY = 0
    PENDING_CREATION = 1
    ALIVE = 2
    RESTARTING = 3
    DEAD = 4


@dataclass
class ActorInfo:
    actor_id: ActorId
    name: str  # "" if unnamed
    namespace: str
    job_id: JobId
    state: ActorState
    creation_spec: TaskSpec
    max_restarts: int
    num_restarts: int = 0
    node_id: Optional[NodeId] = None
    worker_id: Optional[WorkerId] = None
    death_cause: str = ""
    detached: bool = False


@dataclass
class NodeInfo:
    node_id: NodeId
    total_resources: ResourceSet
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    # planned capacity loss (docs/FAULT_TOLERANCE.md "Elasticity"): a
    # preemption notice arrived — the node is still ALIVE and serving,
    # but the scheduler stops placing new work on it and workloads that
    # subscribed to the "node" channel drain/resize before the axe
    draining: bool = False
    preempt_deadline: float = 0.0  # monotonic; 0 = no notice


@dataclass
class JobInfo:
    job_id: JobId
    driver_pid: int
    start_time: float = field(default_factory=time.time)
    end_time: float = 0.0


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupId
    bundles: List[ResourceSet]
    strategy: str
    state: str = "PENDING"  # PENDING | CREATED | REMOVED | RESCHEDULING
    bundle_nodes: List[Optional[NodeId]] = field(default_factory=list)
    name: str = ""


class Pubsub:
    """In-process pub/sub with per-channel subscriber callbacks.
    (ref: src/ray/pubsub/publisher.h:307 — long-poll mailboxes; here the
    subscribers are in-process or bridged over RpcChannel notify)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self._lock = instrumented_lock("gcs.pubsub")

    def subscribe(self, channel: str, cb: Callable[[Any], None]) -> Callable[[], None]:
        with self._lock:
            self._subs[channel].append(cb)

        def _unsub():
            with self._lock:
                try:
                    self._subs[channel].remove(cb)
                except ValueError:
                    pass

        return _unsub

    def publish(self, channel: str, msg: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, ()))
        for cb in subs:
            try:
                cb(msg)
            except Exception:
                pass


class _EventShard:
    """One shard of the task-event intake: ring slice + monotonic counts
    + phase-mark table, with its own lock."""

    __slots__ = ("lock", "events", "counts", "phase_marks", "marks_max")

    def __init__(self, index: int, maxlen: int, marks_max: int):
        self.lock = instrumented_lock(f"gcs.events.s{index}")
        self.events: deque = deque(maxlen=maxlen)
        self.counts: Dict[str, int] = {}
        self.phase_marks: Dict[str, tuple] = {}
        self.marks_max = max(64, marks_max)


class Gcs:
    def __init__(self, storage_path: str = "", config=None):
        self._lock = instrumented_lock("gcs.tables", reentrant=True)
        self.pubsub = Pubsub()
        self._nodes: Dict[NodeId, NodeInfo] = {}
        self._jobs: Dict[JobId, JobInfo] = {}
        self._actors: Dict[ActorId, ActorInfo] = {}
        self._named_actors: Dict[tuple, ActorId] = {}  # (namespace, name) -> id
        self._kv: Dict[str, Dict[str, bytes]] = defaultdict(dict)  # namespace -> k -> v
        self._pgs: Dict[PlacementGroupId, PlacementGroupInfo] = {}
        # ring sized from the runtime's config (was hardcoded 10000 and
        # ignored the flag): SUBMITTED/SCHEDULED roughly doubled
        # events-per-task, so the default doubled with it — timeline()
        # slices keep the same effective task history as before
        if config is None:
            from .config import DEFAULT as config

        # event intake is SHARDED by task id (docs/DISPATCH.md): each
        # shard owns a ring slice + phase-mark table + lock, so a flood of
        # completion events from many clients doesn't serialize on one
        # lock; task_events() merges by timestamp on (rare) reads. One
        # task's events always land in one shard, keeping its
        # state-transition chain ordered.
        n_shards = max(1, int(getattr(config, "head_event_shards", 8)))
        per_shard = max(64, int(config.task_events_max_buffered) // n_shards)
        self._event_shards = [
            _EventShard(i, per_shard, _PHASE_MARKS_MAX // n_shards)
            for i in range(n_shards)]
        # attributed worker log records (stdout/stderr/structured),
        # byte-budgeted with long-poll follow — the `ray logs` analog
        # (ref: dashboard/modules/log/log_manager.py; gcs as the index)
        from .log_store import LogStore
        from .trace_store import TraceStore

        self.logs = LogStore(max_bytes=int(config.log_store_max_bytes))
        self.traces = TraceStore(
            max_bytes=int(config.trace_store_max_bytes),
            sample_rate=float(config.trace_sample_rate),
            slow_threshold_s=float(config.trace_slow_threshold_s))
        self._storage_path = storage_path
        # set by the Runtime: asks the scheduler to (re)create an actor
        self.schedule_actor_cb: Optional[Callable[[ActorInfo], None]] = None
        self._dirty = threading.Event()
        self._stop_flusher = threading.Event()
        self._flush_file_lock = instrumented_lock("gcs.flush_file")
        if storage_path:
            os.makedirs(storage_path, exist_ok=True)
            self._load()
            # debounced table snapshots (the Redis-write analog, ref:
            # redis_store_client.h; gcs_table_storage.cc)
            threading.Thread(target=self._flush_loop, daemon=True,
                             name="gcs-flusher").start()

    def _mark_dirty(self) -> None:
        if self._storage_path:
            self._dirty.set()

    def _flush_loop(self) -> None:
        while not self._stop_flusher.is_set():
            if self._dirty.wait(timeout=0.5):
                self._dirty.clear()
                self.flush()
            else:
                continue

    def flush(self) -> None:
        """Write the actor/job/pg tables + named index to disk atomically.
        The pickle happens under the table lock (records are mutated in
        place by the FSM — a copy of the dict alone would tear) and the
        file write is serialized so stop() can't interleave with the
        flusher thread."""
        if not self._storage_path:
            return
        try:
            with self._lock:
                blob = pickle.dumps({
                    "actors": dict(self._actors),
                    "named_actors": dict(self._named_actors),
                    "jobs": dict(self._jobs),
                    "pgs": dict(self._pgs),
                })
            with self._flush_file_lock:
                fname = os.path.join(self._storage_path, "tables.pkl")
                with open(fname + ".tmp", "wb") as f:
                    f.write(blob)
                os.replace(fname + ".tmp", fname)
        except Exception:
            self._dirty.set()  # retry on the next flusher tick

    def stop(self) -> None:
        self._stop_flusher.set()
        self.flush()

    # ---- node table ----------------------------------------------------------

    def register_node(self, info: NodeInfo) -> None:
        # node membership is NOT persisted (rebuilt by re-registration on
        # restart), so no dirty mark
        with self._lock:
            self._nodes[info.node_id] = info
        self.pubsub.publish("node", ("ALIVE", info.node_id))

    def mark_node_preempting(self, node_id: NodeId, grace_s: float,
                             reason: str = "") -> None:
        """Planned-capacity node event, DISTINCT from fencing: the node
        is still alive for ``grace_s`` more seconds. Publishes
        ``("PREEMPTING", node_id, grace_s)`` on the "node" channel so
        live workloads (pipeline engines, the serve control loop) can
        drain/hand off/resize before the kill lands. Idempotent per
        notice window."""
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None or not info.alive:
                return
            if info.draining:
                return  # one notice per axe; re-deliveries are no-ops
            info.draining = True
            info.preempt_deadline = time.monotonic() + max(0.0, grace_s)
        self.pubsub.publish("node", ("PREEMPTING", node_id, grace_s))

    def mark_node_dead(self, node_id: NodeId, reason: str = "") -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None or not info.alive:
                return
            info.alive = False
        self.pubsub.publish("node", ("DEAD", node_id))
        # fail over actors that lived on this node
        for actor in self.actors_on_node(node_id):
            self.on_actor_failure(actor.actor_id,
                                  f"node {node_id.hex()[:8]} died: {reason}")

    def heartbeat(self, node_id: NodeId) -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info:
                info.last_heartbeat = time.monotonic()

    def nodes(self) -> List[NodeInfo]:
        with self._lock:
            return list(self._nodes.values())

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self._nodes.values() if n.alive]

    # ---- job table -----------------------------------------------------------

    def register_job(self, info: JobInfo) -> None:
        with self._lock:
            self._jobs[info.job_id] = info
        self._mark_dirty()

    def finish_job(self, job_id: JobId) -> None:
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id].end_time = time.time()
        self._mark_dirty()

    # ---- actor directory + FSM ----------------------------------------------

    def register_actor(self, info: ActorInfo) -> None:
        with self._lock:
            if info.name:
                key = (info.namespace, info.name)
                if key in self._named_actors:
                    existing = self._actors.get(self._named_actors[key])
                    if existing and existing.state != ActorState.DEAD:
                        # checked before inserting the record so a rejected
                        # registration leaves no orphan actor entry
                        raise ValueError(f"Actor name {info.name!r} already taken")
                self._named_actors[key] = info.actor_id
            self._actors[info.actor_id] = info
        self._mark_dirty()
        self.pubsub.publish("actor", (info.actor_id, info.state))

    def set_actor_state(self, actor_id: ActorId, state: ActorState,
                        node_id: Optional[NodeId] = None,
                        worker_id: Optional[WorkerId] = None,
                        death_cause: str = "") -> None:
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                return
            info.state = state
            if node_id is not None:
                info.node_id = node_id
            if worker_id is not None:
                info.worker_id = worker_id
            if death_cause:
                info.death_cause = death_cause
        self._mark_dirty()
        self.pubsub.publish("actor", (actor_id, state))

    def on_actor_failure(self, actor_id: ActorId, cause: str) -> None:
        """Actor FSM edge: ALIVE/PENDING -> RESTARTING (if budget) or DEAD.
        (ref: gcs_actor_manager.cc OnActorWorkerDead / restart logic)"""
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None or info.state == ActorState.DEAD:
                return
            if info.max_restarts != 0 and (
                info.max_restarts < 0 or info.num_restarts < info.max_restarts
            ):
                info.num_restarts += 1
                info.state = ActorState.RESTARTING
                info.death_cause = cause
                restart = True
            else:
                info.state = ActorState.DEAD
                info.death_cause = cause
                restart = False
        self._mark_dirty()
        self.pubsub.publish("actor", (actor_id, info.state))
        if restart and self.schedule_actor_cb is not None:
            self.schedule_actor_cb(info)

    def get_actor(self, actor_id: ActorId) -> Optional[ActorInfo]:
        with self._lock:
            return self._actors.get(actor_id)

    def get_named_actor(self, name: str, namespace: str) -> Optional[ActorInfo]:
        with self._lock:
            aid = self._named_actors.get((namespace, name))
            return self._actors.get(aid) if aid else None

    def actors_on_node(self, node_id: NodeId) -> List[ActorInfo]:
        with self._lock:
            return [a for a in self._actors.values()
                    if a.node_id == node_id
                    and a.state in (ActorState.ALIVE, ActorState.PENDING_CREATION,
                                    ActorState.RESTARTING)]

    def list_actors(self) -> List[ActorInfo]:
        with self._lock:
            return list(self._actors.values())

    # ---- internal KV (function table, cluster metadata) ----------------------

    def kv_put(self, key: str, value: bytes, namespace: str = "default",
               overwrite: bool = True) -> bool:
        with self._lock:
            ns = self._kv[namespace]
            if not overwrite and key in ns:
                return False
            ns[key] = value
        if self._storage_path:
            self._persist_kv(namespace, key, value)
        return True

    def kv_get(self, key: str, namespace: str = "default") -> Optional[bytes]:
        with self._lock:
            return self._kv[namespace].get(key)

    def kv_del(self, key: str, namespace: str = "default") -> None:
        with self._lock:
            self._kv[namespace].pop(key, None)

    def kv_keys(self, prefix: str = "", namespace: str = "default") -> List[str]:
        with self._lock:
            return [k for k in self._kv[namespace] if k.startswith(prefix)]

    # ---- placement groups ----------------------------------------------------

    def register_pg(self, info: PlacementGroupInfo) -> None:
        with self._lock:
            self._pgs[info.pg_id] = info
        self._mark_dirty()

    def get_pg(self, pg_id: PlacementGroupId) -> Optional[PlacementGroupInfo]:
        with self._lock:
            return self._pgs.get(pg_id)

    def list_pgs(self) -> List[PlacementGroupInfo]:
        with self._lock:
            return list(self._pgs.values())

    # ---- task events (timeline / state API backing store) --------------------

    def _event_shard(self, event: dict) -> _EventShard:
        tid = event.get("task_id") or event.get("trace_id") or ""
        return self._event_shards[hash(tid) % len(self._event_shards)]

    def add_task_event(self, event: dict) -> None:
        shard = self._event_shard(event)
        if event.get("state") == "SPAN" and event.get("trace_id"):
            # spans additionally feed the tail-sampled trace store (the
            # shard ring keeps them too, for timeline() flow arrows)
            self.traces.add_span(event)
        observe = None  # (histogram, seconds, name) — fired outside locks
        with shard.lock:
            shard.events.append(event)
            st = event.get("state", "?")
            shard.counts[st] = shard.counts.get(st, 0) + 1
            tid = event.get("task_id")
            t = event.get("time")
            if tid and isinstance(t, (int, float)):
                observe = self._mark_phase(shard, tid, st, float(t),
                                           event.get("name", ""))
        if observe is not None:
            hist, dt, name = observe
            hist.observe(dt, tags={"name": name})

    @staticmethod
    def _mark_phase(shard: _EventShard, tid: str, state: str, t: float,
                    name: str):
        """SUBMITTED -> SCHEDULED -> RUNNING -> FINISHED/FAILED phase
        durations. Called under the shard lock; returns the observation
        to make (metric locks must not nest inside the table lock)."""
        prev = shard.phase_marks.get(tid)
        out = None
        if state in ("FINISHED", "FAILED"):
            shard.phase_marks.pop(tid, None)
            if prev is not None and prev[0] == "RUNNING":
                out = (_H_EXEC, max(0.0, t - prev[1]), prev[2] or name)
            return out
        if state not in ("SUBMITTED", "SCHEDULED", "RUNNING"):
            return None
        if prev is not None:
            pstate, pt, pname = prev
            name = name or pname
            if state == "SCHEDULED" and pstate == "SUBMITTED":
                out = (_H_SUBMIT_TO_SCHED, max(0.0, t - pt), name)
            elif state == "RUNNING" and pstate in ("SUBMITTED", "SCHEDULED"):
                # actor tasks skip SCHEDULED (direct push): their queue
                # wait spans from submission
                out = (_H_QUEUE_WAIT, max(0.0, t - pt), name)
        elif len(shard.phase_marks) >= shard.marks_max:
            shard.phase_marks.pop(next(iter(shard.phase_marks)))
        shard.phase_marks[tid] = (state, t, name)
        return out

    def add_task_events(self, events: List[dict]) -> None:
        """Batched intake for the direct-dispatch completion stream (one
        message per flush interval instead of per-call traffic)."""
        for ev in events:
            if isinstance(ev, dict):
                self.add_task_event(ev)

    def task_event_counts(self) -> Dict[str, int]:
        """Monotonic per-state totals (unlike the bounded ring buffer,
        these never decrease — safe to export as Prometheus counters)."""
        out: Dict[str, int] = {}
        for shard in self._event_shards:
            with shard.lock:
                for k, v in shard.counts.items():
                    out[k] = out.get(k, 0) + v
        return out

    def task_events(self) -> List[dict]:
        """Merged view over the intake shards, timestamp-ordered (reads
        are rare — dashboards/state API; writes are the hot path)."""
        merged: List[dict] = []
        for shard in self._event_shards:
            with shard.lock:
                merged.extend(shard.events)
        merged.sort(key=lambda e: e.get("time", 0.0))
        return merged

    # ---- persistence (GCS fault-tolerance stand-in) --------------------------

    def _persist_kv(self, namespace: str, key: str, value: bytes) -> None:
        try:
            fname = os.path.join(self._storage_path, "kv.pkl")
            with self._lock:
                snapshot = {ns: dict(kv) for ns, kv in self._kv.items()}
            with open(fname + ".tmp", "wb") as f:
                pickle.dump(snapshot, f)
            os.replace(fname + ".tmp", fname)
        except Exception:
            pass

    def _load(self) -> None:
        fname = os.path.join(self._storage_path, "kv.pkl")
        if os.path.exists(fname):
            try:
                with open(fname, "rb") as f:
                    data = pickle.load(f)
                self._kv = defaultdict(dict, data)
            except Exception:
                pass
        tname = os.path.join(self._storage_path, "tables.pkl")
        if os.path.exists(tname):
            try:
                with open(tname, "rb") as f:
                    tables = pickle.load(f)
            except Exception:
                return
            self._jobs = tables.get("jobs", {})
            self._pgs = tables.get("pgs", {})
            self._actors = tables.get("actors", {})
            self._named_actors = tables.get("named_actors", {})
            # workers died with the old head: every actor that was running
            # is gone. Detached actors keep their creation spec and go to
            # RESTARTING so the new runtime can revive them (ref:
            # gcs_server.cc:521 restart path + actor_states.rst); normal
            # actors die with their job.
            for info in self._actors.values():
                if info.state == ActorState.DEAD:
                    continue
                if info.detached:
                    info.state = ActorState.RESTARTING
                    info.num_restarts = 0
                    info.node_id = None
                    info.worker_id = None
                    info.death_cause = "head restarted"
                else:
                    info.state = ActorState.DEAD
                    info.death_cause = "lost in head restart"
            for pg in self._pgs.values():
                if pg.state not in ("REMOVED",):
                    pg.state = "RESCHEDULING"
                    pg.bundle_nodes = [None] * len(pg.bundles)

    def detached_actors_to_revive(self) -> List[ActorInfo]:
        with self._lock:
            return [a for a in self._actors.values()
                    if a.detached and a.state == ActorState.RESTARTING
                    and a.node_id is None]
