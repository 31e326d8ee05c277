"""Worker process entrypoint.

Equivalent of the reference's worker side of CoreWorker
(ref: src/ray/core_worker/core_worker.cc:2523 ExecuteTask;
python/ray/_raylet.pyx:1253 execute_task;
transport/actor_scheduling_queue.cc for ordered actor execution;
concurrency_group_manager.cc for threaded/async actors).

A worker connects back to its node over a Unix socket RpcChannel, registers,
then serves pushed tasks. Normal tasks run one-at-a-time on the main executor
thread; actor tasks run on the actor's scheduling queue (FIFO by client
sequence number, with max_concurrency threads, or an asyncio loop for async
actors). Blocking runtime calls (get/put/submit) are proxied back over the
channel to the node — the worker never blocks its RPC reader.
"""
from __future__ import annotations

import argparse
import asyncio
import inspect
import os
import queue
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from .._vendor import cloudpickle

from . import serialization
from .ids import ActorId, WorkerId
from .object_ref import ObjectRef
from .object_store import SegmentReader
from .rpc import RpcChannel, connect
from .task_spec import (ARG_REF, ARG_VALUE, STREAMING_RETURNS, TaskSpec,
                        TaskType)


# line-buffered stdout/stderr capture now lives in util/logs.py
# (StreamTee -> LogBatcher): lines are stamped with {stream, seq, ts,
# job/task/actor} from the current-task contextvar, batched, and
# rate-limited before riding the channel — see that module's docstring.
from ..util.logs import LogBatcher, StreamTee as _StreamTee  # noqa: E402


def _aiter_to_iter(agen):
    """Drain an async generator synchronously (streaming async-actor
    methods; the channel call between items blocks anyway)."""
    loop = asyncio.new_event_loop()
    try:
        while True:
            try:
                yield loop.run_until_complete(agen.__anext__())
            except StopAsyncIteration:
                break
    finally:
        loop.close()


class _ActorLane:
    """Per-caller sequencing lane (ref: the reference's client-side actor
    task sequencing — each submitter numbers its own calls). The head's
    routed lane is key b""; direct callers get their own lane keyed by
    caller worker id. A direct lane carries a GATE: the number of
    head-lane tasks that must have dispatched before the lane may run,
    which pins the caller's routed->direct transition to per-caller FIFO
    (its earlier routed calls all carry head seqs below the gate).

    ``era`` is the caller's connection-era token: bumped by the caller
    each time it (re)establishes the peer connection, at which point the
    caller also restarts its seq numbering at 0. A higher era resets the
    lane (frames lost in the dead connection would otherwise leave
    ``expected`` behind forever); a lower era marks a straggler frame
    from a connection whose unanswered calls the caller has already
    recovered through the routed path — dropped, never a lost result."""

    __slots__ = ("expected", "buffer", "gate", "era")

    def __init__(self, gate: int = 0, era: int = 0):
        self.expected = 0
        self.buffer: Dict[int, TaskSpec] = {}
        self.gate = gate
        self.era = era


class ActorQueue:
    """Ordered execution queue for one actor instance.
    (ref: transport/actor_scheduling_queue.cc — enforce seq order;
    out_of_order_actor_submit_queue.cc for max_concurrency > 1).

    Tasks arrive on per-caller lanes (see _ActorLane); within a lane,
    execution is dispatched in seq order. Lanes are independent — two
    callers' calls interleave arbitrarily, exactly as they did racing
    through the head."""

    def __init__(self, worker: "WorkerProcess", instance: Any, spec: TaskSpec):
        self.worker = worker
        self.instance = instance
        self.max_concurrency = max(1, spec.max_concurrency)
        self.is_async = spec.is_async_actor
        self._lanes: Dict[bytes, _ActorLane] = {}
        self._head_dispatched = 0
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=self.max_concurrency,
                                        thread_name_prefix="actor")
        # named concurrency groups: each an independent execution lane with
        # its own parallelism cap; calls within a group keep submission
        # order relative to each other (FIFO into a bounded pool) while
        # groups never block one another (ref:
        # transport/concurrency_group_manager.cc)
        self._group_pools: Dict[str, ThreadPoolExecutor] = {}
        for gname, size in (spec.concurrency_groups or {}).items():
            self._group_pools[gname] = ThreadPoolExecutor(
                max_workers=max(1, int(size)),
                thread_name_prefix=f"actor-{gname}")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        if self.is_async:
            self._loop = asyncio.new_event_loop()
            threading.Thread(target=self._loop.run_forever, daemon=True,
                             name="actor-asyncio").start()

    def _pool_for(self, spec: TaskSpec) -> ThreadPoolExecutor:
        return self._group_pools.get(spec.concurrency_group, self._pool)

    def push(self, spec: TaskSpec, gate: int = 0, era: int = 0) -> None:
        # Dispatch under the lock: push_task messages are handled by a pool
        # of RPC threads, so releasing the lock before pool.submit would let
        # two threads invert the sequence order.
        lane_key = spec.owner_id.binary() if spec.owner_id is not None else b""
        with self._lock:
            lane = self._lanes.get(lane_key)
            if lane is None:
                lane = self._lanes[lane_key] = _ActorLane(gate, era)
            elif era > lane.era:
                # new connection era: the caller restarted seq numbering
                # at 0 and has recovered everything unanswered from the
                # old connection through the routed path — buffered old-
                # era frames are covered by that recovery, and keeping
                # the old `expected` would strand the lane forever if any
                # old-era frame died in the dropped socket
                lane.era = era
                lane.expected = 0
                lane.buffer.clear()
                lane.gate = gate
            elif era < lane.era:
                return  # straggler from a recovered (dead) era
            elif gate > lane.gate:
                lane.gate = gate
            lane.buffer[spec.seq_no] = spec
            self._drain_locked()

    def _drain_locked(self) -> None:
        """Dispatch every runnable task: head lane first (its progress
        opens direct-lane gates), then gated direct lanes; loop until a
        full pass makes no progress."""
        progress = True
        while progress:
            progress = False
            head = self._lanes.get(b"")
            if head is not None:
                while head.expected in head.buffer:
                    s = head.buffer.pop(head.expected)
                    head.expected += 1
                    self._head_dispatched += 1
                    self._dispatch(s)
                    progress = True
            for key, lane in self._lanes.items():
                if key == b"" or self._head_dispatched < lane.gate:
                    continue
                while lane.expected in lane.buffer:
                    s = lane.buffer.pop(lane.expected)
                    lane.expected += 1
                    self._dispatch(s)
                    progress = True

    def _dispatch(self, s: TaskSpec) -> None:
        if s.concurrency_group \
                and s.concurrency_group not in self._group_pools:
            self._pool.submit(
                self.worker._report_error, s,
                ValueError(
                    f"concurrency group {s.concurrency_group!r} was "
                    f"not declared in concurrency_groups="
                    f"{sorted(self._group_pools)}"))
            return
        if self.is_async:
            asyncio.run_coroutine_threadsafe(self._run_async(s), self._loop)
        else:
            self._pool_for(s).submit(self.worker.execute_task, s,
                                     self.instance)

    async def _run_async(self, spec: TaskSpec) -> None:
        if self._is_coroutine(spec):
            await self.worker.execute_task_async(spec, self.instance)
        else:
            loop = asyncio.get_event_loop()
            await loop.run_in_executor(None, self.worker.execute_task, spec,
                                       self.instance)

    def _is_coroutine(self, spec: TaskSpec) -> bool:
        try:
            method = getattr(self.instance, spec.method_name)
            return inspect.iscoroutinefunction(method)
        except Exception:
            return False


class WorkerProcess:
    def __init__(self, channel: RpcChannel, worker_id: WorkerId, node_id_hex: str):
        self.channel = channel
        self.worker_id = worker_id
        self.node_id_hex = node_id_hex
        self.reader = SegmentReader()
        self._fn_cache: Dict[str, Any] = {}
        self._task_queue: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self._actor: Optional[ActorQueue] = None
        self._actor_id: Optional[ActorId] = None
        self._cancelled: set = set()
        self._renv_applied = False  # runtime_env applied once, first task
        self._stop = threading.Event()
        # register the worker-mode runtime so `ray_tpu_torch.get/put/remote` work in tasks
        from . import runtime as runtime_mod

        self.runtime = runtime_mod.WorkerRuntime(self)
        runtime_mod.set_runtime(self.runtime)
        # every ObjectRef deserialized in this process is a borrow the head
        # must count (ref: reference_count.h:61 borrower protocol)
        from .object_ref import _set_borrow_hook

        _set_borrow_hook(self.runtime.register_borrowed_ref)
        # metrics export: this process's registry (user metrics observed
        # inside tasks + the built-in rpc/store/get instruments) ships
        # deltas to the head — throttled after each task, plus a periodic
        # sweep so idle-period observations still surface (the
        # metrics-agent analog; ref: python/ray/_private/metrics_agent.py)
        self._metrics_last_flush = 0.0
        self._metrics_flush_lock = threading.Lock()
        self._metrics_backlog: list = []  # deltas that failed to ship
        from .config import DEFAULT as _cfg

        self._metrics_interval = max(
            0.1, float(_cfg.metrics_export_interval_s))
        # direct-dispatch state must exist before the metrics loop starts
        # (it flushes the batched direct-event stream on the same thread)
        self._direct_reply = {}
        self._direct_lock = threading.Lock()
        self._devents: list = []
        self._devents_interval = max(0.05, float(_cfg.direct_event_flush_s))
        self._devents_batch = max(1, int(_cfg.direct_event_batch))
        threading.Thread(target=self._metrics_loop, daemon=True,
                         name="worker-metrics").start()
        # outbound log plane: stdout/stderr tees and the structured
        # logger emit into this batcher; attribution is read from the
        # current-task contextvar at write time (async-actor lines on
        # one loop thread attribute to their own asyncio.Task context)
        self.log_batcher = LogBatcher(
            send=lambda p: self.channel.notify("worker_log", p),
            task_ids=self._current_task_ids,
            batch_lines=int(_cfg.log_batch_lines),
            flush_interval_s=float(_cfg.log_flush_interval_s),
            rate_lines_per_s=float(_cfg.log_rate_limit_lines_per_s))
        self._profiling = threading.Lock()  # one profile run at a time
        # compiled-graph executor (ray_tpu_torch/cgraph): created lazily on the
        # first cgraph_load so plain task workers never pay the import
        self._cgraph = None
        # direct dispatch (docs/DISPATCH.md): tasks submitted straight to
        # this worker by a peer (another worker, or the driver over this
        # node channel) reply on the channel they arrived on, not via the
        # head's task_done intake; the reply map / batched-event state is
        # initialized above, before the metrics thread starts
        self._direct_server = None
        self.direct_addr: Optional[str] = None

    def start_direct_server(self, sock_dir: str) -> None:
        """Listen for peer direct-call connections (worker-to-worker and
        driver-to-remote-worker submissions). Unix socket next to the
        node's: same-host peers connect directly; cross-host callers fall
        back to head routing when the connect fails."""
        from .rpc import RpcServer

        path = os.path.join(sock_dir, f"dw_{self.worker_id.hex()[:12]}.sock")

        def factory(channel: RpcChannel):
            return lambda method, payload: self.handle_direct(
                channel, method, payload)

        try:
            self._direct_server = RpcServer(path, factory, family="AF_UNIX",
                                            num_handler_threads=4)
            self.direct_addr = path
        except Exception:
            self.direct_addr = None

    def handle_direct(self, channel: RpcChannel, method: str, payload):
        """Handler for peer direct-call channels (and the direct_submit /
        direct_result frames that ride the node channel when the driver is
        the caller)."""
        if method == "direct_submit":
            spec: TaskSpec = payload["spec"]
            if self._actor is None or self._actor_id != spec.actor_id:
                # stale placement (this process hosts no/another actor —
                # e.g. an OS-recycled address): tell the caller to
                # invalidate its cache and re-resolve via the head
                channel.notify("direct_result",
                               {"task_id": spec.task_id,
                                "actor_id": spec.actor_id, "stale": True})
                return None
            with self._direct_lock:
                self._direct_reply[spec.task_id] = channel
            self._actor.push(spec, gate=int(payload.get("gate", 0)),
                             era=int(payload.get("lane", 0)))
            return None
        if method == "direct_result":
            # this worker is the CALLER: a peer finished our direct task
            self.runtime.on_direct_result(payload)
            return None
        if method == "ping":
            return "pong"
        raise ValueError(f"unknown direct message {method}")

    def _direct_event(self, spec: TaskSpec, t_start: float, t_end: float,
                      error: bool) -> None:
        """Record one direct task's lifecycle for the batched event
        stream; flushes by size here and by time in the metrics loop."""
        tid = spec.task_id.hex()
        aid = spec.actor_id.hex() if spec.actor_id else ""
        flush = None
        with self._direct_lock:
            self._devents.append(
                {"task_id": tid, "name": spec.description,
                 "state": "RUNNING", "time": t_start, "actor_id": aid})
            self._devents.append(
                {"task_id": tid, "name": spec.description,
                 "state": "FAILED" if error else "FINISHED",
                 "time": t_end, "actor_id": aid})
            if len(self._devents) >= self._devents_batch:
                flush, self._devents = self._devents, []
        if flush:
            self._send_devents(flush)

    def _flush_devents(self) -> None:
        with self._direct_lock:
            flush, self._devents = self._devents, []
        if flush:
            self._send_devents(flush)

    def _send_devents(self, events: list) -> None:
        try:
            self.channel.notify("task_events_batch", events)
        except Exception:
            pass

    def _current_task_ids(self):
        spec = self.runtime.current_task()
        if spec is None:
            # actor workers between calls: background threads still
            # attribute to the resident actor
            aid = self._actor_id.hex() if self._actor_id else ""
            return ("", "", aid)
        aid = spec.actor_id.hex() if spec.actor_id else ""
        return (spec.job_id.hex(), spec.task_id.hex(), aid)

    def _flush_metrics(self, min_interval: Optional[float] = None) -> None:
        now = time.monotonic()
        with self._metrics_flush_lock:
            if min_interval is not None \
                    and now - self._metrics_last_flush < min_interval:
                return
            self._metrics_last_flush = now
            from ..util import metrics as metrics_mod

            try:
                deltas = metrics_mod.carry_backlog(self._metrics_backlog)
            except Exception:
                return
            if not deltas:
                return
            if self.channel.closed:
                self._metrics_backlog = deltas
                return
            self._metrics_backlog = []
            # notify inside the lock (it only enqueues to the writer
            # thread): a later gauge snapshot shipping before an earlier
            # one would roll the head's last-write-wins value backwards
            try:
                self.channel.notify("metrics_push", {"deltas": deltas})
            except Exception:
                self._metrics_backlog = deltas

    def _metrics_loop(self) -> None:
        last_dev = 0.0
        while not self._stop.is_set() and not self.channel.closed:
            self._stop.wait(min(self._metrics_interval,
                                self._devents_interval))
            now = time.monotonic()
            if now - last_dev >= self._devents_interval:
                last_dev = now
                self._flush_devents()
            self._flush_metrics(min_interval=self._metrics_interval)

    # -- incoming RPC ----------------------------------------------------------

    def handle(self, method: str, payload: Any) -> Any:
        if method == "push_task":
            spec: TaskSpec = payload
            if spec.task_type == TaskType.ACTOR_TASK and self._actor is not None:
                self._actor.push(spec)
            else:
                self._task_queue.put(spec)
            return None
        if method in ("direct_submit", "direct_result"):
            # the driver submits direct calls over this node channel (it
            # already connects straight to this process); replies ride it
            # back as direct_result frames
            return self.handle_direct(self.channel, method, payload)
        if method == "ping":
            return "pong"
        if method == "dump_stacks":
            # answered from the RPC handler pool — works while the main
            # executor thread is wedged in user code or a blocking get()
            # (ref: `ray stack`; the SIGUSR1 faulthandler hook remains
            # the signal-safe fallback when even RPC is unresponsive)
            from ..util.introspect import dump_stacks

            return dump_stacks()
        if method == "profile":
            from ..util.introspect import SamplingProfiler

            if not self._profiling.acquire(blocking=False):
                raise RuntimeError("a profile run is already active "
                                   "on this worker")
            try:
                prof = SamplingProfiler(
                    interval_s=float((payload or {}).get("interval_s",
                                                         0.01)))
                res = prof.run(float((payload or {}).get("duration_s",
                                                         5.0)))
            finally:
                self._profiling.release()
            res["pid"] = os.getpid()
            return res
        if method == "cancel_task":
            self._cancelled.add(payload)
            return None
        if method == "cgraph_load":
            # resident-loop execution mode: build channel endpoints + the
            # method dispatch table once, then run the static plan beside
            # normal task dispatch (ray_tpu_torch/cgraph/executor.py)
            if self._cgraph is None:
                from ..cgraph.executor import CGraphExecutor

                self._cgraph = CGraphExecutor(self)
            return self._cgraph.load(payload)
        if method == "cgraph_push":
            if self._cgraph is not None:
                self._cgraph.push(payload)
            return None
        if method == "cgraph_stop":
            if self._cgraph is not None:
                return self._cgraph.stop(payload["graph_id"])
            return True
        if method == "flightrec_snapshot":
            from ..perf.recorder import get_recorder
            return get_recorder().snapshot(
                clear=bool((payload or {}).get("clear")))
        if method == "flightrec_set_enabled":
            from ..perf.recorder import set_enabled
            set_enabled(bool((payload or {}).get("on", True)))
            return True
        if method == "kill_actor":
            os._exit(0)
        if method == "shutdown":
            self._stop.set()
            if self._cgraph is not None:
                self._cgraph.stop_all()
            self._task_queue.put(None)
            return None
        raise ValueError(f"unknown method {method}")

    # -- task execution --------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set() and not self.channel.closed:
            try:
                spec = self._task_queue.get(timeout=0.25)
            except queue.Empty:
                continue
            if spec is None:
                break
            self.execute_task(spec, self._actor.instance if self._actor else None)

    def _get_function(self, func_id: str):
        fn = self._fn_cache.get(func_id)
        if fn is None:
            blob = self.channel.call("get_function", func_id, timeout=60)
            fn = cloudpickle.loads(blob)
            self._fn_cache[func_id] = fn
        return fn

    def resolve_args(self, spec: TaskSpec):
        ref_ids = [a[1].id for a in spec.args if a[0] == ARG_REF]
        ref_ids += [a[1].id for a in spec.kwargs.values() if a[0] == ARG_REF]
        values = {}
        if ref_ids:
            fetched = self.runtime.get_many(ref_ids)
            values = dict(zip([r.hex() for r in ref_ids], fetched))
        args = [
            values[a[1].id.hex()] if a[0] == ARG_REF else serialization.loads(a[1])
            for a in spec.args
        ]
        kwargs = {
            k: (values[a[1].id.hex()] if a[0] == ARG_REF else serialization.loads(a[1]))
            for k, a in spec.kwargs.items()
        }
        return args, kwargs

    def execute_task(self, spec: TaskSpec, instance: Any = None) -> None:
        if spec.task_id in self._cancelled:
            self._report_error(spec, _make_cancelled_error(spec))
            return
        if spec.task_id in self._direct_reply:
            spec.__dict__["_t_exec0"] = time.time()  # direct event stream
        if spec.runtime_env and not self._renv_applied:
            # the node's lease dispatch guarantees this worker is either
            # fresh or already dedicated to exactly this env, so a single
            # application covers the worker's whole life
            from . import runtime_env as renv_mod

            try:
                renv_mod.apply(
                    spec.runtime_env,
                    lambda key: self.channel.call(
                        "kv_get",
                        {"key": key, "namespace": renv_mod.KV_NAMESPACE},
                        timeout=120))
            except BaseException as e:
                from ..exceptions import RuntimeEnvSetupError

                self._report_error(spec, RuntimeEnvSetupError(
                    f"runtime_env setup failed: {e!r}"))
                return
            self._renv_applied = True
        token = self.runtime.set_current_task(spec)
        # tracing: the submitter's span context re-activates around the
        # execution and resets afterwards (tracing.task_span handles the
        # token; a leak would misattribute later tasks on this thread)
        from ..util.tracing import task_span

        with task_span(spec):
            self._execute_task_inner(spec, instance, token)
        # ship metric deltas promptly after each task (throttled) so a
        # head scrape right after ray_tpu_torch.get() sees them
        self._flush_metrics(min_interval=0.25)

    def _execute_task_inner(self, spec: TaskSpec, instance: Any,
                            token) -> None:
        try:
            args, kwargs = self.resolve_args(spec)
            if spec.task_type == TaskType.NORMAL_TASK:
                fn = self._get_function(spec.func_id)
                result = fn(*args, **kwargs)
            elif spec.task_type == TaskType.ACTOR_CREATION_TASK:
                cls = self._get_function(spec.func_id)
                inst = cls(*args, **kwargs)
                self._actor = ActorQueue(self, inst, spec)
                self._actor_id = spec.actor_id
                result = None
            else:  # ACTOR_TASK
                method = getattr(instance, spec.method_name)
                if inspect.iscoroutinefunction(method):
                    result = asyncio.run(method(*args, **kwargs))
                else:
                    result = method(*args, **kwargs)
            self._report_success(spec, result)
        except BaseException as e:  # noqa: BLE001 — remote errors must be shipped back
            self._report_error(spec, e)
        finally:
            self.runtime.clear_current_task(token)

    async def execute_task_async(self, spec: TaskSpec, instance: Any) -> None:
        from ..util.tracing import task_span

        token = self.runtime.set_current_task(spec)
        with task_span(spec):
            try:
                args, kwargs = self.resolve_args(spec)
                method = getattr(instance, spec.method_name)
                result = await method(*args, **kwargs)
                self._report_success(spec, result)
            except BaseException as e:  # noqa: BLE001
                self._report_error(spec, e)
            finally:
                self.runtime.clear_current_task(token)
        self._flush_metrics(min_interval=0.25)

    # -- result reporting ------------------------------------------------------

    def _pop_direct_reply(self, task_id) -> Optional[RpcChannel]:
        with self._direct_lock:
            return self._direct_reply.pop(task_id, None)

    def _report_direct_success(self, spec: TaskSpec, result: Any,
                               reply: RpcChannel) -> None:
        """Ship a direct task's results straight back to the caller.

        Small ref-free results travel inline on the peer channel — zero
        head traffic. Results that are large OR contain ObjectRefs go
        through the head's store instead (("stored") markers): nested
        refs need the head's borrower pins (_nested_refs) so the
        producer's own reference dropping at function exit can't free
        them before the caller deserializes."""
        from .config import DEFAULT as cfg

        if spec.num_returns == 0:
            outs = []
        elif spec.num_returns == 1:
            outs = [result]
        else:
            outs = list(result)
            if len(outs) != spec.num_returns:
                self._report_direct_error(spec, ValueError(
                    f"Task returned {len(outs)} values, expected "
                    f"{spec.num_returns}"), reply)
                return
        results = []
        for oid, value in zip(spec.return_ids(), outs):
            sobj = serialization.serialize(value)
            if sobj.contained_refs:
                for r in sobj.contained_refs:
                    self.runtime.ensure_published(r.id)
                data = sobj.to_bytes()
                self.channel.call("direct_result_stored", {
                    "object_id": oid, "data": data,
                    "borrowed": [r.id for r in sobj.contained_refs]})
                results.append(("stored", None))
            elif sobj.total_bytes <= cfg.max_direct_call_object_size:
                results.append(("inline", sobj.to_bytes()))
            else:
                name = self.channel.call(
                    "create_object",
                    {"object_id": oid, "size": sobj.total_bytes})
                mv = self.reader.read(name, sobj.total_bytes)
                sobj.write_into(mv)
                del mv
                self.reader.release(name)
                self.channel.call("seal_object", {"object_id": oid})
                results.append(("stored", None))
        t_end = time.time()
        self._direct_event(spec, spec.__dict__.get("_t_exec0", t_end),
                           t_end, error=False)
        reply.notify("direct_result", {
            "task_id": spec.task_id, "actor_id": spec.actor_id,
            "results": results, "error": None})

    def _report_direct_error(self, spec: TaskSpec, exc: BaseException,
                             reply: RpcChannel) -> None:
        from ..exceptions import TaskError

        if isinstance(exc, TaskError):
            err = exc
        else:
            err = TaskError(cause=exc,
                            remote_traceback=traceback.format_exc(),
                            task_desc=spec.description)
        try:
            blob = serialization.dumps(err)
        except Exception:
            blob = serialization.dumps(
                TaskError(remote_traceback=traceback.format_exc(),
                          task_desc=spec.description))
        t_end = time.time()
        self._direct_event(spec, spec.__dict__.get("_t_exec0", t_end),
                           t_end, error=True)
        reply.notify("direct_result", {
            "task_id": spec.task_id, "actor_id": spec.actor_id,
            "results": None, "error": blob})

    def _report_success(self, spec: TaskSpec, result: Any) -> None:
        from .config import DEFAULT as cfg

        if spec.num_returns == STREAMING_RETURNS:
            self._stream_generator(spec, result)
            return
        reply = self._pop_direct_reply(spec.task_id)
        if reply is not None:
            try:
                self._report_direct_success(spec, result, reply)
            except Exception as e:  # e.g. head channel died mid-store
                # the reply entry is already popped — report on the direct
                # channel we hold, NOT _report_error (whose routed
                # task_done the head would drop: direct tasks are never
                # in worker.in_flight, so the caller would hang)
                try:
                    self._report_direct_error(spec, e, reply)
                except Exception:
                    pass  # reply channel dead too: the caller's
                    # on_close recovery resubmits through the head
            return
        if spec.num_returns == 0:
            outs = []
        elif spec.num_returns == 1:
            outs = [result]
        else:
            outs = list(result)
            if len(outs) != spec.num_returns:
                self._report_error(
                    spec,
                    ValueError(
                        f"Task returned {len(outs)} values, expected {spec.num_returns}"),
                )
                return
        results = []
        borrowed = []  # aligned with results: [[oids], ...] per return
        return_ids = spec.return_ids()
        for oid, value in zip(return_ids, outs):
            sobj = serialization.serialize(value)
            for r in sobj.contained_refs:
                # direct-result refs nested in a routed return escape this
                # process: the head must own them before it pins them
                self.runtime.ensure_published(r.id)
            # refs nested inside EACH return value: the head pins them
            # until THAT return object dies, or this worker's own ref
            # dropping (function exit) can free them before the caller
            # deserializes — the borrower-protocol gap a GC cycle used
            # to mask (see on_task_done's nested-ref pin)
            borrowed.append([r.id for r in sobj.contained_refs])
            if sobj.total_bytes <= cfg.max_direct_call_object_size:
                results.append(("inline", sobj.to_bytes()))
            else:
                name = self.channel.call("create_object",
                                         {"object_id": oid, "size": sobj.total_bytes})
                mv = self.reader.read(name, sobj.total_bytes)
                sobj.write_into(mv)
                del mv  # drop the exported view before unmapping
                self.reader.release(name)
                self.channel.call("seal_object", {"object_id": oid})
                results.append(("stored", None))
        msg = {"task_id": spec.task_id, "results": results, "error": None}
        if any(borrowed):
            msg["borrowed"] = borrowed
        self.channel.notify("task_done", msg)

    def _stream_generator(self, spec: TaskSpec, result: Any) -> None:
        """Iterate the task's generator, reporting each item as it is
        produced (ref: _raylet.pyx execute_streaming_generator:868;
        ReportGeneratorItemReturns). The per-item call doubles as
        backpressure: the worker can't run ahead of the head's intake."""
        from .config import DEFAULT as cfg
        from .ids import ObjectId

        if hasattr(result, "__aiter__") and not hasattr(result, "__iter__"):
            result = _aiter_to_iter(result)  # async-generator methods
        n = 0
        try:
            for item in result:
                oid = ObjectId.for_task_return(spec.task_id, n)
                sobj = serialization.serialize(item)
                for r in sobj.contained_refs:
                    self.runtime.ensure_published(r.id)
                if sobj.total_bytes <= cfg.max_direct_call_object_size:
                    ok = self.channel.call("generator_item", {
                        "task_id": spec.task_id, "index": n,
                        "object_id": oid, "data": sobj.to_bytes()})
                    if ok is False:
                        break  # consumer dropped the generator
                else:
                    name = self.channel.call(
                        "create_object", {"object_id": oid,
                                          "size": sobj.total_bytes})
                    mv = self.reader.read(name, sobj.total_bytes)
                    sobj.write_into(mv)
                    del mv
                    self.reader.release(name)
                    self.channel.call("seal_object", {"object_id": oid})
                    ok = self.channel.call("generator_item", {
                        "task_id": spec.task_id, "index": n,
                        "object_id": oid})
                    if ok is False:
                        break  # consumer dropped the generator
                n += 1
        except BaseException as e:  # noqa: BLE001 — mid-stream failure
            self._report_error(spec, e)
            return
        finally:
            close = getattr(result, "close", None)
            if callable(close):
                try:
                    close()  # run the generator's finally blocks
                except Exception:
                    pass
        self.channel.notify("task_done", {
            "task_id": spec.task_id,
            "results": [],
            "streaming_count": n,
            "error": None,
        })

    def _report_error(self, spec: TaskSpec, exc: BaseException) -> None:
        from ..exceptions import TaskError

        reply = self._pop_direct_reply(spec.task_id)
        if reply is not None:
            self._report_direct_error(spec, exc, reply)
            return
        if isinstance(exc, TaskError):
            err = exc
        else:
            err = TaskError(cause=exc, remote_traceback=traceback.format_exc(),
                            task_desc=spec.description)
        try:
            blob = serialization.dumps(err)
        except Exception:
            blob = serialization.dumps(
                TaskError(remote_traceback=traceback.format_exc(),
                          task_desc=spec.description))
        self.channel.notify("task_done", {
            "task_id": spec.task_id,
            "results": None,
            "error": blob,
        })


def _make_cancelled_error(spec: TaskSpec):
    from ..exceptions import TaskCancelledError

    return TaskCancelledError(f"Task {spec.description} was cancelled")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--node-id", required=True)
    args = parser.parse_args()

    # SIGUSR1 dumps all thread stacks to stderr — the debugging hook for
    # "worker looks wedged" (ref: the reference's ray stack CLI).
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)

    # deterministic fault injection (env inherited from the node): frame
    # chaos applies to this worker's node channel and direct peer sockets
    from .. import chaos as _chaos_mod

    _chaos_mod.maybe_enable_from_env()

    worker_id = WorkerId.from_hex(args.worker_id)
    try:
        # auth token arrives via RTPU_AUTHKEY in the environment (connect's
        # default cluster_token() reads it), never on the command line
        channel = connect(args.address, name=f"worker-{args.worker_id[:8]}")
    except OSError:
        return  # node shut down while we were starting; exit quietly
    wp = WorkerProcess(channel, worker_id, args.node_id)
    channel.set_handler(wp.handle)
    from .config import DEFAULT as _cfg

    if int(_cfg.direct_worker_server):
        # peer-facing direct-call socket, advertised through register so
        # the head's resolve_actor can hand it to callers
        wp.start_direct_server(os.path.dirname(args.address))
    if os.environ.get("RTPU_WORKER_PROFILE"):
        # perf debugging: dump this worker's cProfile stats on exit
        import atexit
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()

        def _dump(pid=os.getpid()):
            prof.disable()
            pstats.Stats(prof).dump_stats(
                os.environ["RTPU_WORKER_PROFILE"] + f".{pid}")
        atexit.register(_dump)
        channel.on_close(lambda: (_dump(), os._exit(0)))
    else:
        channel.on_close(lambda: os._exit(0))
    resp = channel.call("register", {"worker_id": worker_id,
                                     "pid": os.getpid(),
                                     "direct_addr": wp.direct_addr},
                        timeout=30)
    if isinstance(resp, dict) and resp.get("forward_logs"):
        # tee prints into the attributed log plane (and still to the
        # local console); remote nodes additionally get driver mirroring
        sys.stdout = _StreamTee(wp.log_batcher, "stdout", sys.stdout)
        sys.stderr = _StreamTee(wp.log_batcher, "stderr", sys.stderr)
    try:
        wp.run()
    finally:
        try:
            wp._flush_devents()  # late direct completions still reach GCS
        except Exception:
            pass
        try:
            wp.log_batcher.stop()  # final flush before the channel drops
        except Exception:
            pass
        channel.close()


if __name__ == "__main__":
    main()
