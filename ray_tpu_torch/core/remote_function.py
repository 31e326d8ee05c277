"""@remote for plain functions.

Equivalent of the reference's RemoteFunction machinery
(ref: python/ray/remote_function.py:245 _remote — options resolution per
python/ray/_private/ray_option_utils.py; function pickled once per job and
exported through the GCS KV function table)."""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

from . import runtime as runtime_mod
from . import serialization
from .config import DEFAULT as cfg
from .object_ref import ObjectRef
from ..util.tracing import current_context as _trace_ctx
from .task_spec import (ARG_REF, ARG_VALUE, STREAMING_RETURNS,
                        SchedulingStrategy, TaskSpec,
                        TaskType)

_VALID_OPTIONS = {
    "num_cpus", "num_tpus", "resources", "num_returns", "max_retries",
    "retry_exceptions", "scheduling_strategy", "name", "memory",
    "placement_group", "placement_group_bundle_index", "runtime_env",
}


def resolve_resources(options: Dict[str, Any], default_cpus: float = 1.0) -> Dict[str, float]:
    res = dict(options.get("resources") or {})
    res["CPU"] = float(options.get("num_cpus", default_cpus))
    if options.get("num_tpus"):
        res["TPU"] = float(options["num_tpus"])
    if options.get("memory"):
        res["memory"] = float(options["memory"])
    return {k: v for k, v in res.items() if v}


def resolve_strategy(options: Dict[str, Any]) -> SchedulingStrategy:
    strat = options.get("scheduling_strategy")
    if strat is None:
        pg = options.get("placement_group")
        if pg is not None:
            return SchedulingStrategy(
                kind="PLACEMENT_GROUP", placement_group_id=pg.id,
                bundle_index=options.get("placement_group_bundle_index", -1))
        return SchedulingStrategy()
    if isinstance(strat, SchedulingStrategy):
        return strat
    if isinstance(strat, str):
        if strat == "SPREAD":
            return SchedulingStrategy(kind="SPREAD")
        if strat == "DEFAULT":
            return SchedulingStrategy()
        raise ValueError(f"Unknown scheduling strategy {strat!r}")
    # duck-typed strategy objects from util.scheduling_strategies
    return strat.to_spec()


def prepare_args(rt, args, kwargs):
    """Top-level ObjectRefs pass by reference; small plain values inline in
    the spec; large values are promoted to the object store first
    (ref: transport/dependency_resolver.cc + ray_config_def.h:516)."""
    publish = getattr(rt, "ensure_published", None)

    def one(v):
        if isinstance(v, ObjectRef):
            if publish is not None:
                # a locally-held direct result escaping into a task arg
                # must reach the head first (docs/DISPATCH.md)
                publish(v.id)
            return (ARG_REF, v)
        sobj = serialization.serialize(v)
        if sobj.total_bytes <= cfg.max_direct_call_object_size:
            if publish is not None:
                # refs NESTED in an inlined container arg escape this
                # process just like top-level ones: the executing worker
                # will deserialize and fetch them through the head
                for r in sobj.contained_refs:
                    publish(r.id)
            return (ARG_VALUE, sobj.to_bytes())
        ref = rt.put(v)
        return (ARG_REF, ref)

    return [one(a) for a in args], {k: one(v) for k, v in kwargs.items()}


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        for k in self._options:
            if k not in _VALID_OPTIONS:
                raise ValueError(f"Invalid @remote option {k!r}")
        self._func_ids: Dict[str, str] = {}  # runtime worker_id.hex -> func_id
        # per-runtime wire template + normalized demand: every spec this
        # function submits shares its constant fields, so they encode once
        self._wire_tmpls: Dict[str, tuple] = {}
        self._consts: Dict[str, dict] = {}
        self._norm_demand: Optional[Dict[str, float]] = None
        self._demand_key: Optional[tuple] = None
        functools.update_wrapper(self, fn)

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(overrides)
        rf = RemoteFunction(self._fn, merged)
        return rf

    def remote(self, *args, **kwargs):
        rt = runtime_mod.get_runtime()
        # keyed by the runtime's unique worker id, not id(rt): a new runtime
        # allocated at a recycled address must re-export into its own GCS
        rt_key = rt.worker_id.hex()
        func_id = self._func_ids.get(rt_key)
        if func_id is None:
            func_id = rt.export_function(self._fn)
            self._func_ids[rt_key] = func_id
        sargs, skwargs = prepare_args(rt, args, kwargs)
        # constants of this (function, options, runtime) resolved once —
        # the submit loop is the head-throughput envelope's hot path
        consts = self._consts.get(rt_key)
        if consts is None:
            num_returns = self._options.get("num_returns", 1)
            if num_returns == "streaming":
                num_returns = STREAMING_RETURNS
            consts = {
                "job_id": getattr(rt, "job_id", None) or _job_of(rt),
                "description": (self._options.get("name")
                                or getattr(self._fn, "__name__", "fn")),
                "num_returns": int(num_returns),
                "resources": resolve_resources(self._options),
                "max_retries": int(self._options.get(
                    "max_retries", cfg.task_max_retries)),
                "retry_exceptions": bool(self._options.get(
                    "retry_exceptions", False)),
                "scheduling_strategy": resolve_strategy(self._options),
                "runtime_env": rt.prepare_runtime_env(
                    self._options.get("runtime_env")),
            }
            self._consts[rt_key] = consts
        spec = TaskSpec(
            task_id=rt.new_task_id(),
            task_type=TaskType.NORMAL_TASK,
            func_id=func_id,
            args=sargs,
            kwargs=skwargs,
            trace_ctx=_trace_ctx(),
            **consts,
        )
        tmpl = self._wire_tmpls.get(rt_key)
        if tmpl is None:
            from . import wire

            tmpl = wire.make_struct_template(
                spec, ("task_id", "args", "kwargs", "trace_ctx"))
            self._wire_tmpls[rt_key] = tmpl
        spec._wire_tmpl = tmpl
        if self._norm_demand is None:
            from .resources import normalize

            # publish _demand_key FIRST: a racing second submission
            # branches on _norm_demand and then reads _demand_key
            nd = normalize(spec.resources)
            self._demand_key = tuple(sorted(nd.items()))
            self._norm_demand = nd
        spec._demand = self._norm_demand
        spec._demand_key = self._demand_key
        refs = rt.submit_spec(spec)
        num_returns = consts["num_returns"]
        if num_returns == STREAMING_RETURNS:
            from .object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, rt)
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{getattr(self._fn, '__name__', 'fn')}' cannot be "
            "called directly; use .remote().")


def _job_of(rt):
    from .ids import JobId

    return JobId.nil()
