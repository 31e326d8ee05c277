"""Worker-side compiled-graph execution: the resident loop.

The worker half of `ray_tpu_torch.cgraph` (ref: the reference's accelerated-DAG
executor — python/ray/_private/worker.py exec_compiled_dag loop): at
``cgraph_load`` the worker builds its channel endpoints and method
dispatch table ONCE, then a resident thread runs the static plan forever
— read input slots, call the bound actor methods, write output slots —
with zero per-call scheduling, leasing, or task-spec traffic. Normal
``.remote()`` dispatch on the actor keeps working alongside the loop.

Error semantics: a stage exception becomes an error envelope forwarded
through the SAME channels (downstream stages skip execution and
propagate), so the driver's ``execute()`` ref raises the original
``TaskError``. An unexpected loop death poisons the node's channels so
peers (and ultimately the driver) fail fast instead of wedging.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from ..core import serialization
from ..exceptions import (ChannelFullError, CompiledGraphClosedError,
                          TaskError)
from ..perf import oplog as _oplog
from ..perf.recorder import get_recorder
from ..util import metrics as _metrics
from ..util.logs import get_logger
from .channel import (FLAG_ERROR, QueueChannel, RpcSender, ShmChannel,
                      pack_envelope, unpack_envelope)
from .codec import decode_value, encode_value

_H_NODE_EXEC = _metrics.Histogram(
    "ray_tpu_cgraph_node_exec_seconds",
    "compiled-graph per-node method execution time",
    boundaries=_metrics.FAST_BOUNDARIES, tag_keys=("method",))
_H_STAGE_EXEC = _metrics.Histogram(
    "ray_tpu_pipeline_stage_exec_seconds",
    "pipeline-engine per-op compute time on a stage actor",
    boundaries=_metrics.FAST_BOUNDARIES, tag_keys=("stage",))
_H_BUBBLE_WAIT = _metrics.Histogram(
    "ray_tpu_pipeline_bubble_wait_seconds",
    "pipeline-engine time a stage spent blocked on channel input "
    "before an op (the 1F1B bubble as observed from inside the stage)",
    boundaries=_metrics.FAST_BOUNDARIES, tag_keys=("stage",))

_log = get_logger("ray_tpu_torch.cgraph")

# flight recorder (perf/recorder.py): one enabled-flag test per record,
# chaos-style module handle so the A/B off leg costs one attribute load
_FLREC = get_recorder()


class _NodePlan:
    __slots__ = ("key", "method", "fn", "num_returns", "concurrency_group",
                 "args", "kwargs", "outs", "codec", "n_chan_args")


class _GraphRun:
    """One loaded graph on one actor worker."""

    def __init__(self, graph_id: bytes):
        self.graph_id = graph_id
        self.stop = threading.Event()
        self.readers: Dict[str, Any] = {}  # cid hex -> channel endpoint
        self.writers: List[Any] = []
        self.writer_cache: Dict[str, Any] = {}  # cid/shm name -> endpoint
        self.nodes: List[_NodePlan] = []
        self.thread: Optional[threading.Thread] = None
        # iterative (pipeline) mode: the node list is a per-STEP op
        # schedule — the same channel is read once per op, never cached
        # across ops, and pipeline stage metrics are recorded
        self.iterative = False
        self.stage_tag = ""


class CGraphExecutor:
    """Per-worker registry of loaded graphs + their resident threads."""

    def __init__(self, worker):
        self.worker = worker  # WorkerProcess
        self._lock = threading.Lock()
        self._graphs: Dict[bytes, _GraphRun] = {}
        # dedicated segment reader: channel attachments must not collide
        # with the task-result reader's cache lifecycle
        from ..core.object_store import SegmentReader

        self._segreader = SegmentReader()

    # -- control-plane entry points (worker_main.handle) -----------------

    def load(self, plan: dict) -> bool:
        actor = self.worker._actor
        if actor is None:
            raise RuntimeError(
                "cgraph_load sent to a worker that hosts no actor")
        gid = plan["graph_id"]
        with self._lock:
            if self._graphs:
                raise RuntimeError(
                    "actor already participates in a live compiled graph; "
                    "teardown() it before compiling another")
            run = _GraphRun(gid)
            self._graphs[gid] = run
        try:
            self._build(run, plan, actor)
        except BaseException:
            with self._lock:
                self._graphs.pop(gid, None)
            raise
        run.thread = threading.Thread(
            target=self._loop, args=(run,), daemon=True,
            name=f"cgraph-{gid.hex()[:8]}")
        run.thread.start()
        return True

    def push(self, payload: dict) -> None:
        """A cross-node envelope routed to one of our queue channels."""
        with self._lock:
            run = self._graphs.get(payload["graph_id"])
        if run is None:
            return  # late delivery after stop: drop
        ch = run.readers.get(payload["cid"])
        if isinstance(ch, QueueChannel):
            ch.deliver(payload["seq"], payload["data"])

    def stop(self, graph_id: bytes) -> bool:
        with self._lock:
            run = self._graphs.pop(graph_id, None)
        if run is None:
            return True
        run.stop.set()
        for ch in list(run.readers.values()) + run.writers:
            try:
                ch.mark_closed()
            except Exception:
                pass
        if run.thread is not None:
            run.thread.join(timeout=3.0)
        for ch in list(run.readers.values()) + run.writers:
            try:
                ch.close()
            except Exception:
                pass
        # ship this run's metric deltas NOW: a short-lived graph (a fast
        # pipeline engine torn down within the export interval) would
        # otherwise lose its stage_exec/bubble_wait samples when the
        # driver kills the actor right after this stop returns
        try:
            self.worker._flush_metrics()
        except Exception:
            pass
        return True

    def stop_all(self) -> None:
        with self._lock:
            gids = list(self._graphs)
        for gid in gids:
            self.stop(gid)

    # -- plan materialization --------------------------------------------

    def _make_reader(self, spec: dict, run: _GraphRun):
        if spec["kind"] == "shm":
            return ShmChannel(self._segreader, spec["name"], spec["size"],
                              edge=spec.get("edge", ""), interrupt=run.stop,
                              slots=spec.get("slots", 1))
        return QueueChannel(spec["cid"], edge=spec.get("edge", ""),
                            interrupt=run.stop)

    def _make_writer(self, spec: dict, run: _GraphRun):
        # one endpoint per channel per run: several ops write the same
        # edge in iterative (pipeline) plans — e.g. every microbatch's
        # fwd shares the activation edge — and a fresh RpcSender per op
        # would restart its seq stamp at 0 for each (shm endpoints share
        # the segment ledger, which masked this on single-host graphs)
        key = spec["name"] if spec["kind"] == "shm" else spec["cid"]
        cached = run.writer_cache.get(key)
        if cached is not None:
            return cached
        if spec["kind"] == "shm":
            ch = ShmChannel(self._segreader, spec["name"], spec["size"],
                            edge=spec.get("edge", ""), interrupt=run.stop,
                            slots=spec.get("slots", 1))
        else:
            gid = run.graph_id

            def send(cid, seq, data):
                self.worker.channel.call(
                    "cgraph_send", {"graph_id": gid, "cid": cid,
                                    "seq": seq, "data": data}, timeout=120)

            ch = RpcSender(send, spec["cid"], edge=spec.get("edge", ""))
        run.writer_cache[key] = ch
        run.writers.append(ch)
        return ch

    def _build(self, run: _GraphRun, plan: dict, actor) -> None:
        run.iterative = bool(plan.get("iterative"))
        run.stage_tag = str(plan.get("stage", ""))
        for spec in plan["in_channels"]:
            run.readers[spec["cid"]] = self._make_reader(spec, run)
        groups = getattr(actor, "_group_pools", {}) or {}
        for nspec in plan["nodes"]:
            np = _NodePlan()
            np.key = nspec["key"]
            np.method = nspec["method"]
            np.fn = getattr(actor.instance, nspec["method"])
            np.num_returns = int(nspec.get("num_returns", 1))
            np.concurrency_group = nspec.get("concurrency_group", "")
            if np.concurrency_group and np.concurrency_group not in groups:
                raise ValueError(
                    f"concurrency group {np.concurrency_group!r} bound via "
                    f".options() was not declared in concurrency_groups="
                    f"{sorted(groups)}")
            np.args = [self._load_argspec(a) for a in nspec["args"]]
            np.kwargs = {k: self._load_argspec(a)
                         for k, a in nspec["kwargs"].items()}
            np.n_chan_args = sum(
                1 for a in list(np.args) + list(np.kwargs.values())
                if a[0] == "chan")
            np.outs = [self._make_writer(w, run) for w in nspec["outs"]]
            # wire codec negotiated at compile time for this node's
            # output envelopes (cgraph/codec.py); readers are stateless
            # — the codec id rides in each envelope's flag byte
            np.codec = nspec.get("codec")
            run.nodes.append(np)

    @staticmethod
    def _load_argspec(spec):
        kind = spec[0]
        if kind == "const":
            return ("const", serialization.loads(spec[1]))
        return tuple(spec)  # ("chan", cid) | ("local", key)

    # -- the resident loop -----------------------------------------------

    def _loop(self, run: _GraphRun) -> None:
        try:
            while not run.stop.is_set():
                self._iteration(run)
        except CompiledGraphClosedError:
            pass  # clean stop/teardown
        except BaseException:
            # unexpected loop death: poison every endpoint so producers,
            # consumers, and ultimately the driver unblock with a typed
            # error instead of wedging on a silent half-dead pipeline
            _log.error("compiled-graph loop died:\n%s",
                       traceback.format_exc())
            _FLREC.record("cgraph.loop.death",
                          run.stage_tag or run.graph_id.hex()[:8],
                          {"error": traceback.format_exc(limit=3)})
            for ch in list(run.readers.values()) + run.writers:
                try:
                    ch.mark_closed()
                except Exception:
                    pass
            # worker-side half of the post-mortem: the driver's merged
            # bundle RPC can only reach us while we're alive, so dump
            # this process's ring locally too (throttled)
            try:
                from ..perf.postmortem import dump_bundle

                dump_bundle("cgraph loop death",
                            origin=f"worker:{run.stage_tag or 'dag'}",
                            meta={"graph_id": run.graph_id.hex()})
            except Exception:
                pass

    def _iteration(self, run: _GraphRun) -> None:
        local: Dict[str, tuple] = {}  # node key -> ("val", v)|("err", bytes)
        # DAG mode caches one envelope per cid per iteration so diamond
        # fan-outs share a single slot read; iterative (pipeline) plans
        # read the SAME channel once per op (M microbatches stream
        # through one edge per step), so caching would replay stale data
        chan_cache: Optional[Dict[str, tuple]] = (
            None if run.iterative else {})
        # iterative mode: errors can reach ops with NO outs (chunk 0's
        # backward, tied_add) where the envelope would otherwise die —
        # the step would then report clean losses over corrupted grads.
        # Latch the first error and ship it from the final op (the
        # update, whose out is the driver's report channel) instead of
        # applying an update over a broken accumulation.
        iter_err: Optional[bytes] = None
        last = run.nodes[-1] if run.nodes else None
        tag = run.stage_tag or run.graph_id.hex()[:8]
        for np in run.nodes:
            err_bytes = None
            parent_trace = ""
            t_waited = 0.0
            n_chan = 0
            args: List[Any] = []
            kwargs: Dict[str, Any] = {}

            def resolve(spec):
                nonlocal err_bytes, parent_trace, t_waited, n_chan
                kind = spec[0]
                if kind == "const":
                    return spec[1]
                if kind == "chan":
                    n_chan += 1
                    cid = spec[1]
                    env = None if chan_cache is None \
                        else chan_cache.get(cid)
                    if env is None:
                        # time ONLY the blocking recv — deserialization
                        # below is compute, not 1F1B bubble
                        t0 = time.perf_counter()
                        data = run.readers[cid].recv()
                        t_waited += time.perf_counter() - t0
                        env = unpack_envelope(data)
                        if chan_cache is not None:
                            chan_cache[cid] = env
                    flags, trace, body = env
                    if trace:
                        parent_trace = trace
                    if flags & FLAG_ERROR:
                        err_bytes = body
                        return None
                    return decode_value(flags, body)
                # ("local", key): same-actor edge, no channel round trip
                state, val = local[spec[1]]
                if state == "err":
                    err_bytes = val
                    return None
                return val

            # recv begin/end bracket the whole arg-resolve phase: a stage
            # blocked on a dead/stalled peer leaves a dangling begin the
            # post-mortem renderer flags as in-flight at death
            rec_on = _FLREC.enabled and np.n_chan_args
            if rec_on:
                _FLREC.record("cgraph.recv.begin", f"{tag}:{np.key}")
            for spec in np.args:
                args.append(resolve(spec))
            for k, spec in np.kwargs.items():
                kwargs[k] = resolve(spec)
            if rec_on:
                _FLREC.record("cgraph.recv.end", f"{tag}:{np.key}",
                              {"waited_ms": round(t_waited * 1e3, 3)}
                              if t_waited > 1e-4 else None)
            if run.iterative and n_chan:
                # ops with no channel inputs (update, tied_grad) would
                # pad the bubble histogram with guaranteed-zero samples
                _H_BUBBLE_WAIT.observe(t_waited,
                                       tags={"stage": run.stage_tag})
                _oplog.bubble_record(run.stage_tag, t_waited)
            if run.stop.is_set():
                raise CompiledGraphClosedError("graph stopping")

            if err_bytes is None and run.iterative and np is last \
                    and iter_err is not None:
                err_bytes = iter_err  # poison the report, skip the update
            trace_out = ""
            if err_bytes is None:
                if _FLREC.enabled:
                    _FLREC.record("cgraph.op.begin", f"{tag}:{np.key}",
                                  {"method": np.method})
                t_wall0 = time.time()
                t_exec0 = time.perf_counter()
                value, err_bytes, trace_out = self._exec_node(
                    np, args, kwargs, parent_trace)
                dt = time.perf_counter() - t_exec0
                if _FLREC.enabled:
                    _FLREC.record("cgraph.op.end", f"{tag}:{np.key}",
                                  {"error": True} if err_bytes else None)
                if run.iterative:
                    _H_STAGE_EXEC.observe(dt,
                                          tags={"stage": run.stage_tag})
                    _oplog.op_record(run.stage_tag, np.key, np.method,
                                     t_wall0, t_wall0 + dt)
            t_send0 = time.perf_counter() \
                if run.iterative and np.outs else 0.0
            if err_bytes is not None:
                if run.iterative:
                    iter_err = iter_err or err_bytes
                else:
                    local[np.key] = ("err", err_bytes)
                env = pack_envelope(FLAG_ERROR, trace_out or parent_trace,
                                    err_bytes)
            else:
                # iterative (pipeline) plans wire everything through
                # channels and never use ("local", key) args — retaining
                # every op's output here would hold all M activations/
                # cotangents live per step, breaking the bounded 1F1B
                # in-flight-memory property
                if not run.iterative:
                    local[np.key] = ("val", value)
                if np.outs:
                    cbits, body = encode_value(value, np.codec)
                else:
                    cbits, body = 0, b""
                env = pack_envelope(cbits, trace_out, body)
            sent = 0
            try:
                for w in np.outs:
                    w.send(env)
                    sent += 1
            except ChannelFullError as e:
                # a value over the channel's capacity fails this
                # execution, not the loop: the error envelope fits, so
                # it goes downstream and the driver raises it (in the
                # JAX package the loop dies here and the driver's get
                # waits out its timeout)
                err_bytes = serialization.dumps(e)
                if run.iterative:
                    iter_err = iter_err or err_bytes
                else:
                    local[np.key] = ("err", err_bytes)
                env = pack_envelope(FLAG_ERROR, trace_out or parent_trace,
                                    err_bytes)
                for w in np.outs[sent:]:
                    w.send(env)
            if t_send0:
                # encode + channel writes, backpressure block included —
                # the step profiler's third measured phase
                _oplog.send_record(run.stage_tag,
                                   time.perf_counter() - t_send0)

    def _exec_node(self, np: _NodePlan, args, kwargs, parent_trace: str):
        """-> (value, error_bytes, downstream_trace)."""
        from ..util import tracing

        span_ctx = None
        token = None
        if parent_trace:
            tid, _, sid = parent_trace.partition(":")
            token = tracing.activate((tid, sid))
            span_ctx = tracing.trace(f"cgraph:{np.key}.{np.method}",
                                     method=np.method,
                                     concurrency_group=np.concurrency_group)
            span = span_ctx.__enter__()
        t0 = time.perf_counter()
        try:
            value = np.fn(*args, **kwargs)
            if np.num_returns > 1:
                if not isinstance(value, (tuple, list)) \
                        or len(value) != np.num_returns:
                    raise ValueError(
                        f"{np.method} bound with num_returns="
                        f"{np.num_returns} returned "
                        f"{type(value).__name__} instead of a "
                        f"{np.num_returns}-tuple")
            err = None
        except BaseException as e:  # noqa: BLE001 — shipped downstream
            err = serialization.dumps(TaskError(
                cause=e, remote_traceback=traceback.format_exc(),
                task_desc=f"cgraph:{np.key}.{np.method}"))
            value = None
        finally:
            _H_NODE_EXEC.observe(time.perf_counter() - t0,
                                 tags={"method": np.method})
            trace_out = ""
            if span_ctx is not None:
                try:
                    span_ctx.__exit__(None, None, None)
                    trace_out = f"{span.trace_id}:{span.span_id}"
                finally:
                    tracing.deactivate(token)
        return value, err, trace_out
