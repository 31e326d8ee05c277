"""Node manager — the per-node data/scheduling plane (raylet equivalent).

Equivalent of the reference's raylet (ref: src/ray/raylet/node_manager.h:119;
worker_pool.h:156 pop-or-start leasing; local_task_manager.cc:57 dispatch;
placement_group_resource_manager.cc for the 2PC bundle ledger). One Node owns:
a shared-memory PlasmaStore, a pool of worker subprocesses reached over a
Unix-socket RpcChannel each, a FIFO lease queue with resource accounting, and
the placement-group bundle reservations.

Multiple Node objects can live in one driver process — the in-process
multi-node cluster used by tests, mirroring the reference's
``ray.cluster_utils.Cluster`` (python/ray/cluster_utils.py:99). A remote host
would run the same Node served over TCP; the channel protocol is
transport-agnostic.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..devtools.locks import instrumented_lock
from ..exceptions import WorkerCrashedError
from .config import Config
from .gcs import NodeInfo
from .ids import ActorId, NodeId, PlacementGroupId, TaskId, WorkerId
from .object_store import make_store
from .resources import ResourceSet, normalize, res_add, res_ge, res_sub
from .rpc import RpcChannel, RpcServer, cluster_token
from .task_spec import TaskSpec, TaskType


@dataclass
class WorkerHandle:
    worker_id: WorkerId
    proc: subprocess.Popen
    channel: Optional[RpcChannel] = None
    state: str = "starting"  # starting | idle | leased | actor | dead
    pid: int = 0
    actor_id: Optional[ActorId] = None
    in_flight: Dict[TaskId, TaskSpec] = field(default_factory=dict)
    lease_resources: ResourceSet = field(default_factory=dict)
    lease_pg: Optional[tuple] = None  # (pg_id, bundle_index)
    # >0 while the worker sits in blocking get/wait calls: its lease
    # resources are returned to the pool so dependent tasks can run (ref:
    # local_task_manager.cc blocked-worker accounting via
    # NotifyDirectCallTaskBlocked/Unblocked). A depth counter, not a bool:
    # threaded actors (max_concurrency>1) can block on several calls at once.
    blocked_depth: int = 0
    # runtime_env dedication (ref: worker_pool.cc keys PopWorker by the
    # env hash): None = fresh/unbound; "" = bound to the plain env;
    # other = bound to that packaged runtime_env for life
    env_hash: Optional[str] = None
    idle_since: float = 0.0  # monotonic timestamp of the last idle entry
    started_at: float = 0.0  # monotonic launch time (launch-strike gate)
    # peer-facing direct-call socket this worker listens on (direct
    # dispatch; resolve_actor hands it to callers — docs/DISPATCH.md)
    direct_addr: Optional[str] = None


@dataclass
class _LeaseRequest:
    spec: TaskSpec
    demand: ResourceSet
    future: Future  # resolves to WorkerHandle
    pg: Optional[tuple] = None  # (pg_id, bundle_index)
    env_hash: str = ""  # runtime_env dedication key ("" = plain)


@dataclass
class _Bundle:
    reserved: ResourceSet
    used: ResourceSet = field(default_factory=dict)
    committed: bool = False


class Node:
    def __init__(self, runtime, node_id: NodeId, resources: ResourceSet,
                 session_dir: str, config: Config,
                 labels: Optional[Dict[str, str]] = None):
        self.runtime = runtime
        self.node_id = node_id
        self.config = config
        self.total_resources = normalize(resources)
        self.available = dict(self.total_resources)
        self.labels = labels or {}
        self.session_dir = session_dir
        self.store = make_store(
            node_id,
            capacity_bytes=int(resources.get("object_store_memory",
                                             config.object_store_memory)),
            spill_dir=(f"{config.object_spilling_dir}/{node_id.hex()[:8]}"
                       if "://" in str(config.object_spilling_dir)
                       else os.path.join(config.object_spilling_dir,
                                         node_id.hex()[:8])),
            min_spilling_size=int(config.min_spilling_size),
        )
        self.total_resources.pop("object_store_memory", None)
        self.available.pop("object_store_memory", None)
        self._lock = instrumented_lock("node", reentrant=True)
        self._workers: Dict[WorkerId, WorkerHandle] = {}
        self._idle: deque = deque()
        # lease backlog bucketed by (demand, pg, env) signature: a burst
        # of identical tasks is ONE bucket, so dispatch is O(#buckets)
        # per event instead of O(backlog) — the 10k-queued envelope's
        # second O(queue^2) cliff after the round-4 early-exit fix
        # (ref: local_task_manager.cc tasks_to_dispatch_ per-class map)
        self._lease_queue: Dict[tuple, deque] = {}
        self._bundles: Dict[tuple, _Bundle] = {}  # (pg_id, idx) -> bundle
        self._starting_count = 0
        self.alive = True
        self.draining = False  # preemption-noticed: no NEW work lands here
        self._sock_path = os.path.join(session_dir, f"node_{node_id.hex()[:12]}.sock")
        self._server = RpcServer(self._sock_path, self._make_handler,
                                 num_handler_threads=int(
                                     self.config.node_server_threads),
                                 family="AF_UNIX")
        self._max_workers = max(int(config.num_workers_soft_limit),
                                int(self.total_resources.get("CPU", 1)))
        self._prefetch_depth = max(1, int(config.worker_task_prefetch))
        # env_hash -> consecutive died-before-register count (reset on a
        # successful register; see _note_launch_failure)
        self._launch_failures: Dict[str, int] = {}
        for _ in range(int(config.worker_prestart_count)):
            self._start_worker()
        # idle-worker reclamation (ref: worker_pool.cc idle worker killing;
        # config.worker_idle_timeout_s existed but was unenforced until r3)
        threading.Thread(target=self._idle_reaper_loop, daemon=True,
                         name="idle-reaper").start()

    def _idle_reaper_loop(self) -> None:
        timeout = float(self.config.worker_idle_timeout_s)
        keep = int(self.config.worker_prestart_count)
        while self.alive:
            time.sleep(min(30.0, max(1.0, timeout / 4)))
            now = time.monotonic()
            victims = []
            with self._lock:
                if not self.alive:
                    return
                idle = [w for w in self._workers.values()
                        if w.state == "idle"]
                reclaimable = sorted(idle, key=lambda w: w.idle_since)
                # oldest first, but always keep the prestart floor warm
                for w in reclaimable[:max(0, len(idle) - keep)]:
                    if now - w.idle_since > timeout:
                        victims.append(w)
                for w in victims:
                    self._terminate_worker(w)
                if victims:
                    self._idle = deque(x for x in self._idle
                                       if x.state == "idle")

    def info(self) -> NodeInfo:
        return NodeInfo(node_id=self.node_id, total_resources=dict(self.total_resources),
                        labels=dict(self.labels), alive=self.alive)

    # ---- leasing (ref: worker_pool.h PopWorker + local_task_manager.cc) ------

    def request_lease(self, spec: TaskSpec) -> Future:
        fut: Future = Future()
        # submitters on the hot path pre-normalize (remote_function);
        # decoded/foreign specs fall through to normalize here
        demand = spec.__dict__.get("_demand")
        if demand is None:
            demand = normalize(spec.resources)
        pg = None
        strat = spec.scheduling_strategy
        if strat.kind == "PLACEMENT_GROUP" and strat.placement_group_id is not None:
            pg = self._pick_bundle(strat.placement_group_id, strat.bundle_index, demand)
            if pg is None:
                fut.set_exception(WorkerCrashedError(
                    f"No bundle with capacity for {demand} in pg "
                    f"{strat.placement_group_id.hex()[:8]} on this node"))
                return fut
        from .runtime_env import env_hash as _env_hash

        req = _LeaseRequest(spec=spec, demand=demand, future=fut, pg=pg,
                            env_hash=_env_hash(spec.runtime_env))
        dkey = spec.__dict__.get("_demand_key")
        if dkey is None:
            dkey = tuple(sorted(demand.items()))
        # task type is part of the signature: lease reuse must never hand
        # a busy task worker to an actor-creation request (push_task
        # would flip it to state="actor" mid-stream)
        sig = (dkey, req.pg, req.env_hash, spec.task_type)
        with self._lock:
            self._lease_queue.setdefault(sig, deque()).append(req)
        self._dispatch()
        return fut

    def steal_queued_leases(self, everything: bool = False) -> list:
        """Remove and return queued (not yet granted) NON-placement-group
        lease requests so the runtime can re-route them — the spillback
        half of elastic capacity (docs/FAULT_TOLERANCE.md "Elasticity").

        Default: steal only buckets this node cannot grant from its
        CURRENT availability (a request parked behind a full node, which
        a freshly joined node could serve right now). ``everything``
        steals every queued non-PG request — the draining path, where
        this node must not start new work at all. PG-bundle leases stay:
        their bundle reservation pins them here by construction.

        A stolen request's future is simply abandoned (nothing holds it
        once it leaves the queue — its grant callback never fires); the
        caller re-enters the TaskSpec through the scheduler."""
        stolen = []
        with self._lock:
            if not self.alive:
                return []
            for sig in list(self._lease_queue.keys()):
                dkey, pg, _env, _ttype = sig
                if pg is not None:
                    continue
                if not everything and res_ge(self.available, dict(dkey)):
                    continue  # grantable here as soon as a worker frees
                bucket = self._lease_queue[sig]
                reqs = [r for r in bucket if not r.future.cancelled()]
                if reqs:
                    stolen.extend(reqs)
                del self._lease_queue[sig]
        return stolen

    def _pick_bundle(self, pg_id: PlacementGroupId, index: int,
                     demand: ResourceSet) -> Optional[tuple]:
        with self._lock:
            if index >= 0:
                key = (pg_id, index)
                b = self._bundles.get(key)
                if b is not None and b.committed:
                    return key
                return None
            for key, b in sorted(self._bundles.items(), key=lambda kv: kv[0][1]):
                if key[0] == pg_id and b.committed and res_ge(
                        res_sub(b.reserved, b.used), demand):
                    return key
        return None

    def _dispatch(self) -> None:
        """Grant queued leases that fit; start workers on demand.

        Per-bucket scan: every request in a bucket shares one (demand,
        pg, env) signature, so the first head that can't be granted ends
        that bucket — no per-request walk of the backlog."""
        grants = []
        failures = []
        with self._lock:
            if not self.alive:
                return
            for sig in list(self._lease_queue.keys()):
                bucket = self._lease_queue[sig]
                while bucket:
                    req = bucket[0]
                    if req.future.cancelled():
                        bucket.popleft()
                        continue
                    if not self._fits(req):
                        break  # same demand behind it: none of it fits
                    cont = ((req.spec.runtime_env or {}).get("container")
                            if req.env_hash else None)
                    # container envs need a worker LAUNCHED inside the
                    # container — a fresh host worker can't be moved in
                    worker = self._pop_idle(req.env_hash,
                                            dedicated_only=cont is not None)
                    if worker is None:
                        # blocked workers don't count toward the cap:
                        # each freed its resources and waits on work that
                        # may only be runnable by a new worker
                        active = (len(self._workers) + self._starting_count
                                  - sum(1 for w in self._workers.values()
                                        if w.blocked_depth > 0))
                        if active >= self._max_workers:
                            # cap reached but an idle worker bound to a
                            # DIFFERENT runtime_env may be the blocker:
                            # evict one to make room (ref: worker_pool.cc
                            # idle-worker kill under pressure). A
                            # container request can't use unbound
                            # workers either — they count as evictable
                            # for it, or it would starve behind a warm
                            # pool of plain idle workers.
                            victim = next(
                                (w for w in self._idle
                                 if w.state == "idle"
                                 and w.env_hash != req.env_hash
                                 and (w.env_hash is not None
                                      or cont is not None)), None)
                            if victim is not None:
                                self._terminate_worker(victim)
                                self._idle = deque(
                                    x for x in self._idle
                                    if x is not victim)
                                active -= 1
                        if active < self._max_workers or not self._workers:
                            try:
                                self._start_worker(
                                    container=cont,
                                    env_hash=req.env_hash if cont else None)
                            except OSError as e:
                                # launcher missing/unexecutable: fail THIS
                                # request with a clear error instead of
                                # tearing down dispatch for everyone
                                # (future resolved outside the lock, like
                                # grants — callbacks may re-enter)
                                bucket.popleft()
                                failures.append((req, WorkerCrashedError(
                                    "container worker launch failed ("
                                    f"{self.config.container_launcher}): "
                                    f"{e}")))
                                continue
                        break  # this bucket needs a worker that isn't
                        # here yet; other buckets (different env) may
                        # still have one
                    bucket.popleft()
                    self._take_resources(req)
                    worker.env_hash = req.env_hash  # dedicate on grant
                    worker.state = "leased"
                    worker.lease_resources = req.demand
                    worker.lease_pg = req.pg
                    grants.append((req, worker))
                if not bucket:
                    del self._lease_queue[sig]
        for req, worker in grants:
            req.future.set_result(worker)
        for req, err in failures:
            if not req.future.done():
                req.future.set_exception(err)

    def _fits(self, req: _LeaseRequest) -> bool:
        if req.pg is not None:
            b = self._bundles.get(req.pg)
            return b is not None and res_ge(res_sub(b.reserved, b.used), req.demand)
        return res_ge(self.available, req.demand)

    def _take_resources(self, req: _LeaseRequest) -> None:
        if req.pg is not None:
            b = self._bundles[req.pg]
            b.used = res_add(b.used, req.demand)
        else:
            self.available = res_sub(self.available, req.demand)

    def release_lease(self, worker: WorkerHandle, terminate: bool = False) -> None:
        with self._lock:
            if worker.blocked_depth > 0:
                worker.blocked_depth = 0  # resources already back in the pool
            elif worker.lease_pg is not None:
                b = self._bundles.get(worker.lease_pg)
                if b is not None:
                    b.used = res_sub(b.used, worker.lease_resources)
            else:
                self.available = res_add(self.available, worker.lease_resources)
            worker.lease_resources = {}
            worker.lease_pg = None
            if worker.state in ("leased", "actor") and not terminate:
                worker.state = "idle"
                worker.idle_since = time.monotonic()
                self._idle.append(worker)
            elif terminate:
                self._terminate_worker(worker)
        self._dispatch()

    def notify_worker_blocked(self, worker: WorkerHandle) -> None:
        """The worker entered a blocking get/wait: return its lease resources
        to the pool so tasks it depends on can be dispatched here. Without
        this, nested task graphs deadlock once every CPU is held by a blocked
        parent (ref: local_task_manager.cc:57 blocked-worker accounting)."""
        with self._lock:
            if not worker.lease_resources \
                    or worker.state not in ("leased", "actor"):
                return
            worker.blocked_depth += 1
            if worker.blocked_depth > 1:
                return  # resources already released by the first blocker
            if worker.lease_pg is not None:
                b = self._bundles.get(worker.lease_pg)
                if b is not None:
                    b.used = res_sub(b.used, worker.lease_resources)
            else:
                self.available = res_add(self.available, worker.lease_resources)
        self._dispatch()

    def notify_worker_unblocked(self, worker: WorkerHandle) -> None:
        """The blocking call returned: re-take the lease resources. May drive
        availability negative (temporary oversubscription) — progress beats
        strictness here, exactly as the reference behaves on unblock."""
        with self._lock:
            if worker.blocked_depth == 0:
                return
            worker.blocked_depth -= 1
            if worker.blocked_depth > 0:
                return  # other calls from this worker still blocked
            if worker.lease_pg is not None:
                b = self._bundles.get(worker.lease_pg)
                if b is not None:
                    b.used = res_add(b.used, worker.lease_resources)
            else:
                self.available = res_sub(self.available, worker.lease_resources)

    def _worker_alive(self, w: WorkerHandle) -> bool:
        return w.channel is not None and not w.channel.closed

    def _pop_idle(self, env_hash: str = "",
                  dedicated_only: bool = False) -> Optional[WorkerHandle]:
        """Pop an idle worker compatible with the request's runtime_env:
        one already dedicated to the same env, or a fresh unbound one (it
        gets dedicated on grant). A worker bound to a DIFFERENT env is
        never reused — its process state (env vars, sys.path, cwd) is that
        environment's (ref: worker_pool.cc runtime-env-keyed pop).
        RemoteNode shares this loop and overrides only _worker_alive
        (remote workers have no head-side channel object)."""
        kept = []
        found = None
        while self._idle:
            w = self._idle.popleft()
            if w.state != "idle" or not self._worker_alive(w):
                continue
            if w.env_hash == env_hash or (w.env_hash is None
                                          and not dedicated_only):
                found = w
                break
            kept.append(w)
        self._idle.extendleft(reversed(kept))
        return found

    # ---- worker lifecycle ----------------------------------------------------

    def _start_worker(self, container: Optional[dict] = None,
                      env_hash: Optional[str] = None) -> WorkerHandle:
        worker_id = WorkerId.from_random()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        # auth token travels via env (RTPU_AUTHKEY), never argv — argv is
        # world-readable through /proc/<pid>/cmdline
        env["RTPU_AUTHKEY"] = cluster_token().hex()
        # -S skips site processing (a sitecustomize importing jax costs ~2s
        # per worker start); the parent's sys.path travels via PYTHONPATH.
        cmd = [
            sys.executable, "-S", "-m", "ray_tpu_torch.core.worker_main",
            "--address", self._sock_path,
            "--worker-id", worker_id.hex(),
            "--node-id", self.node_id.hex(),
        ]
        if container is not None:
            # containerized worker (ref: runtime_env/container.py)
            from .runtime_env import container_command

            cmd = container_command(self.config.container_launcher,
                                    container, cmd)
        proc = subprocess.Popen(cmd, env=env)
        handle = WorkerHandle(worker_id=worker_id, proc=proc, pid=proc.pid,
                              started_at=time.monotonic())
        if env_hash is not None:
            handle.env_hash = env_hash  # container workers: dedicated
            # from birth (the env can't be applied to a host process)
        with self._lock:  # reentrant: callers may already hold it
            self._workers[worker_id] = handle
            self._starting_count += 1
        # watchdog: a worker that dies before registering must not strand the
        # lease queue (ref: worker_pool.cc PopWorker failure callbacks)
        threading.Thread(target=self._reap_worker, args=(handle,), daemon=True,
                         name="worker-reaper").start()
        return handle

    def _reap_worker(self, handle: WorkerHandle) -> None:
        try:
            handle.proc.wait()
        except Exception:
            return
        with self._lock:
            if handle.state == "starting":
                self._starting_count = max(0, self._starting_count - 1)
        self._on_worker_exit(handle)

    def _on_register(self, channel: RpcChannel, payload: dict) -> None:
        worker_id: WorkerId = payload["worker_id"]
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is None:
                handle = WorkerHandle(worker_id=worker_id, proc=None,  # type: ignore
                                      pid=payload.get("pid", 0))
                self._workers[worker_id] = handle
            handle.channel = channel
            handle.pid = payload.get("pid", handle.pid)
            handle.direct_addr = payload.get("direct_addr")
            handle.state = "idle"
            self._launch_failures.pop(handle.env_hash or "", None)
            handle.idle_since = time.monotonic()
            self._starting_count = max(0, self._starting_count - 1)
            self._idle.append(handle)
        channel.on_close(lambda: self._on_worker_exit(handle))
        self._dispatch()

    def _on_worker_exit(self, worker: WorkerHandle) -> None:
        with self._lock:
            if worker.state == "dead":
                return
            was_starting = worker.state == "starting"
            worker.state = "dead"
            self._workers.pop(worker.worker_id, None)
            if worker.blocked_depth > 0:
                worker.blocked_depth = 0  # resources already back in the pool
            elif worker.lease_resources:
                if worker.lease_pg is not None:
                    b = self._bundles.get(worker.lease_pg)
                    if b is not None:
                        b.used = res_sub(b.used, worker.lease_resources)
                else:
                    self.available = res_add(self.available, worker.lease_resources)
            in_flight = list(worker.in_flight.values())
            actor_id = worker.actor_id
        for spec in in_flight:
            self.runtime.on_worker_crashed(spec, self.node_id)
        # drop every object reference the dead worker held
        self.runtime.refcount.release_holder(worker.worker_id)
        if actor_id is not None and self.alive:
            self.runtime.gcs.on_actor_failure(
                actor_id, f"worker {worker.worker_id.hex()[:8]} died")
        if was_starting and self.alive:
            # died before registering: a broken launch recipe (bad
            # container launcher, image pull failure) would otherwise
            # loop start->die->restart forever. Quick deaths (<30s) trip
            # the breaker at 3 consecutive strikes; slow deaths (a
            # loaded box can stall registration) still count but only
            # trip at 6 — slow-but-broken recipes (registry timeouts)
            # must fail eventually too, just with more patience.
            fast = bool(worker.started_at) and \
                time.monotonic() - worker.started_at < 30.0
            self._note_launch_failure(worker.env_hash or "", fast)
        self._dispatch()

    _LAUNCH_STRIKES = 3
    _LAUNCH_STRIKES_SLOW = 6

    def _note_launch_failure(self, env_hash: str,
                             fast: bool = True) -> None:
        to_fail: list = []
        with self._lock:
            n = self._launch_failures.get(env_hash, 0) + 1
            self._launch_failures[env_hash] = n
            limit = (self._LAUNCH_STRIKES if fast
                     else self._LAUNCH_STRIKES_SLOW)
            if n < limit:
                return
            self._launch_failures[env_hash] = 0
            for sig in list(self._lease_queue.keys()):
                if sig[2] == env_hash:
                    to_fail.extend(self._lease_queue.pop(sig))
        for req in to_fail:
            if not req.future.done():
                req.future.set_exception(WorkerCrashedError(
                    f"workers for runtime_env {env_hash or '<plain>'} "
                    f"exited before registering {self._LAUNCH_STRIKES} "
                    f"times in a row on node {self.node_id.hex()[:8]} — "
                    f"check the worker launch recipe (container "
                    f"launcher / image) and worker logs"))

    def _terminate_worker(self, worker: WorkerHandle) -> None:
        # kill_worker/shutdown call in unlocked: the pop must not race a
        # dispatch pass iterating _workers under the (reentrant) lock
        with self._lock:
            worker.state = "dead"
            self._workers.pop(worker.worker_id, None)
        self.runtime.refcount.release_holder(worker.worker_id)
        if worker.channel is not None:
            worker.channel.notify("shutdown")
            worker.channel.close()
        if worker.proc is not None:
            try:
                worker.proc.terminate()
            except Exception:
                pass

    # ---- task push (direct transport) ----------------------------------------

    def push_task(self, worker: WorkerHandle, spec: TaskSpec) -> None:
        """Push a task to a leased worker (ref: direct_task_transport.h:211
        PushNormalTask — the raylet is off the data path)."""
        with self._lock:
            worker.in_flight[spec.task_id] = spec
            if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                worker.state = "actor"
                worker.actor_id = spec.actor_id
        if worker.channel is None or worker.channel.closed:
            self._on_worker_exit(worker)
            return
        worker.channel.notify("push_task", spec)

    def on_task_done(self, worker: WorkerHandle, payload: dict) -> None:
        task_id: TaskId = payload["task_id"]
        with self._lock:
            spec = worker.in_flight.pop(task_id, None)
        if spec is None:
            return
        self.runtime.on_task_done(spec, payload, self.node_id, worker)
        if spec.task_type == TaskType.NORMAL_TASK:
            nxt = self._reuse_lease(worker)
            if nxt:
                # lease reuse (ref: direct_task_transport lease caching /
                # local_task_manager same-scheduling-class dispatch): the
                # next queued requests have the identical (demand, pg,
                # env) signature, so the worker flows straight to them —
                # no resource return, no dispatch scan, no new grant.
                # Up to `prefetch` tasks ride one lease (executed
                # sequentially by the worker; only the lease's own
                # resources are held), which keeps the worker fed and
                # lets both channel directions coalesce frames.
                for req in nxt:
                    req.future.set_result(worker)
            elif not worker.in_flight:
                self.release_lease(worker)

    def _reuse_lease(self, worker: WorkerHandle) -> list:
        out: list = []
        with self._lock:
            if not self.alive or worker.state != "leased" \
                    or worker.channel is None or worker.channel.closed:
                return out
            want = self._prefetch_depth - len(worker.in_flight)
            if want <= 0:
                return out
            sig = (tuple(sorted(worker.lease_resources.items())),
                   worker.lease_pg, worker.env_hash or "",
                   TaskType.NORMAL_TASK)  # reuse serves normal tasks only
            bucket = self._lease_queue.get(sig)
            while bucket and len(out) < want:
                req = bucket.popleft()
                if not bucket:
                    del self._lease_queue[sig]
                    bucket = None
                if not req.future.cancelled():
                    out.append(req)
        return out

    # ---- placement group bundles: 2PC ----------------------------------------
    # (ref: node_manager.proto:380-384 PrepareBundleResources/CommitBundleResources)

    def prepare_bundle(self, pg_id: PlacementGroupId, index: int,
                       resources: ResourceSet) -> bool:
        with self._lock:
            demand = normalize(resources)
            if not res_ge(self.available, demand):
                return False
            self.available = res_sub(self.available, demand)
            self._bundles[(pg_id, index)] = _Bundle(reserved=demand)
            return True

    def commit_bundle(self, pg_id: PlacementGroupId, index: int) -> None:
        with self._lock:
            b = self._bundles.get((pg_id, index))
            if b is not None:
                b.committed = True
        self._dispatch()

    def return_bundle(self, pg_id: PlacementGroupId, index: int) -> None:
        with self._lock:
            b = self._bundles.pop((pg_id, index), None)
            if b is not None:
                self.available = res_add(self.available, b.reserved)
        self._dispatch()

    # ---- worker RPC handler --------------------------------------------------

    def _make_handler(self, channel: RpcChannel):
        state = {"worker": None}

        def handler(method: str, payload):
            if method == "register":
                self._on_register(channel, payload)
                with self._lock:
                    state["worker"] = self._workers.get(payload["worker_id"])
                # local workers tee stdout/stderr too when the head keeps
                # a log store (dashboard log view); lines still reach the
                # console through the tee's original stream
                return {"forward_logs":
                        bool(int(self.config.capture_worker_logs))}
            worker: Optional[WorkerHandle] = state["worker"]
            if method == "task_done":
                if worker is not None:
                    self.on_task_done(worker, payload)
                return None
            if method == "direct_result":
                # a worker finished one of the DRIVER's direct calls
                # (submitted over this same channel); hot path — handled
                # before the generic worker-call chain
                self.runtime.on_direct_result(payload)
                return None
            if method == "create_object":
                return self.store.create(payload["object_id"], payload["size"])
            if method == "seal_object":
                self.store.seal(payload["object_id"])
                self.store.pin(payload["object_id"])
                self.runtime.on_object_sealed(
                    payload["object_id"], self.node_id,
                    size=self.store.object_size(payload["object_id"]))
                if worker is not None and payload.get("is_put"):
                    # a worker ray_tpu_torch.put: the worker holds the only ref
                    # (its adopt_owned_ref finalizer sends the balancing
                    # remove). Task returns sealed via _report_success get
                    # their lifetime from the caller's returned refs.
                    self.runtime.refcount.add_holder_ref(
                        payload["object_id"], worker.worker_id)
                return True
            # everything else is the shared core-worker API, served by the runtime
            return self.runtime.handle_worker_call(self, worker, method, payload)

        return handler

    # ---- queries & lifecycle -------------------------------------------------

    def get_worker(self, worker_id: WorkerId) -> Optional[WorkerHandle]:
        with self._lock:
            return self._workers.get(worker_id)

    def list_workers(self) -> List[WorkerHandle]:
        with self._lock:
            return list(self._workers.values())

    # ---- on-demand introspection (ref: `ray stack` per-node fan-out) ---------

    def worker_stack(self, worker: WorkerHandle,
                     timeout: float = 5.0) -> dict:
        """One worker's thread stacks, served by its dump_stacks RPC
        (answered from the worker's handler pool — works while the
        executor thread is blocked in user code or get())."""
        if worker.channel is None or worker.channel.closed:
            raise RuntimeError("worker has no live channel")
        return worker.channel.call("dump_stacks", None, timeout=timeout)

    def worker_profile(self, worker: WorkerHandle, duration_s: float = 5.0,
                       interval_s: float = 0.01) -> dict:
        """On-demand sampling profile of one worker (start/stop happens
        worker-side; the call returns the aggregated result)."""
        if worker.channel is None or worker.channel.closed:
            raise RuntimeError("worker has no live channel")
        return worker.channel.call(
            "profile", {"duration_s": float(duration_s),
                        "interval_s": float(interval_s)},
            timeout=float(duration_s) + 30.0)

    # ---- compiled-graph control plane (ray_tpu_torch/cgraph) -----------------------

    def worker_notify(self, worker: WorkerHandle, method: str,
                      payload) -> None:
        """Fire-and-forget message to one worker (cgraph envelope
        delivery); RemoteNode overrides with the agent relay. Raises
        when the channel is provably gone — a silently-dropped envelope
        would strand the consumer waiting on a seq that never arrives,
        while raising lets the sender's retraction/abort paths run."""
        if worker.channel is None or worker.channel.closed:
            raise RuntimeError(
                f"worker {worker.worker_id.hex()[:8]} has no live channel")
        worker.channel.notify(method, payload)

    def worker_cgraph_call(self, worker: WorkerHandle, method: str,
                           payload, timeout: float = 30.0):
        """Request/response to one worker (cgraph_load / cgraph_stop)."""
        if worker.channel is None or worker.channel.closed:
            raise RuntimeError("worker has no live channel")
        return worker.channel.call(method, payload, timeout=timeout)

    def num_workers(self) -> int:
        with self._lock:
            return len(self._workers)

    def queue_len(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._lease_queue.values())

    def kill_worker(self, worker: WorkerHandle, force: bool = True) -> None:
        try:
            if force and worker.proc is not None:
                worker.proc.kill()
            else:
                self._terminate_worker(worker)
        except Exception:
            pass

    def shutdown(self, kill: bool = False) -> None:
        """Graceful stop, or simulated node failure when kill=True."""
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            workers = list(self._workers.values())
            queued = [r for b in self._lease_queue.values() for r in b]
            self._lease_queue.clear()
        for req in queued:
            if not req.future.done():
                req.future.set_exception(
                    WorkerCrashedError(f"node {self.node_id.hex()[:8]} shut down"))
        for w in workers:
            try:
                if kill:
                    if w.proc is not None:
                        w.proc.kill()
                else:
                    self._terminate_worker(w)
            except Exception:
                pass
        if kill:
            self.store.destroy()
        self._server.close()
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=5)
                except Exception:
                    pass
        if not kill:
            self.store.destroy()
