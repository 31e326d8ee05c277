"""Actor classes, handles, and method invocation.

Equivalent of the reference's actor machinery
(ref: python/ray/actor.py — ActorClass/_remote, ActorHandle with method
wrappers; creation registers with the GCS actor manager
src/ray/gcs/gcs_server/gcs_actor_manager.cc:246; calls go direct to the
actor's worker with client-side sequencing,
src/ray/core_worker/transport/direct_actor_task_submitter.h:67)."""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

from . import runtime as runtime_mod
from .config import DEFAULT as cfg
from .ids import ActorId
from .object_ref import ObjectRef
from .remote_function import (prepare_args, resolve_resources, resolve_strategy)
from ..util.tracing import current_context as _trace_ctx
from .task_spec import STREAMING_RETURNS, TaskSpec, TaskType

_VALID_ACTOR_OPTIONS = {
    "num_cpus", "num_tpus", "resources", "max_restarts", "max_task_retries",
    "max_concurrency", "concurrency_groups", "name", "namespace", "lifetime",
    "scheduling_strategy", "memory", "placement_group",
    "placement_group_bundle_index", "runtime_env", "get_if_exists",
}


def _method_meta_of(cls) -> Dict[str, dict]:
    """Per-method defaults set by the @ray_tpu_torch.method decorator."""
    meta: Dict[str, dict] = {}
    for name, m in inspect.getmembers(cls, callable):
        nr = getattr(m, "_rtpu_num_returns", None)
        cg = getattr(m, "_rtpu_concurrency_group", None)
        if nr is not None or cg is not None:
            meta[name] = {"num_returns": nr if nr is not None else 1,
                          "concurrency_group": cg or ""}
    return meta


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns=1, concurrency_group: str = ""):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, num_returns=None,
                concurrency_group: Optional[str] = None) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._name,
            self._num_returns if num_returns is None else num_returns,
            self._concurrency_group if concurrency_group is None
            else concurrency_group)

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs,
                                    self._num_returns,
                                    self._concurrency_group)

    def bind(self, *args, **kwargs):
        """Declare this method as a node in a static compiled graph
        (ray_tpu_torch.cgraph). Args may be other DAG nodes (dataflow edges)
        or plain values (compile-time constants). Options set via
        ``.options(num_returns=, concurrency_group=)`` carry through
        exactly as they do for ``.remote()``."""
        from ..cgraph.dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs,
                               num_returns=self._num_returns,
                               concurrency_group=self._concurrency_group)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._name}' cannot be called directly; "
            "use .remote() for a dynamic task, or .bind() to build a "
            "compiled graph (ray_tpu_torch.cgraph).")


class ActorHandle:
    def __init__(self, actor_id: ActorId, max_task_retries: int = 0,
                 description: str = "Actor",
                 method_meta: Optional[Dict[str, dict]] = None):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries
        self._description = description
        self._method_meta = method_meta or {}
        self._ready_ref: Optional[ObjectRef] = None

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self.__dict__.get("_method_meta", {}).get(name, {})
        return ActorMethod(self, name,
                           num_returns=meta.get("num_returns", 1),
                           concurrency_group=meta.get("concurrency_group",
                                                      ""))

    def _invoke(self, method_name: str, args, kwargs, num_returns,
                concurrency_group: str = ""):
        rt = runtime_mod.get_runtime()
        if num_returns == "streaming":
            num_returns = STREAMING_RETURNS
        num_returns = int(num_returns)
        sargs, skwargs = prepare_args(rt, args, kwargs)
        spec = TaskSpec(
            task_id=rt.new_task_id(),
            job_id=getattr(rt, "job_id", None) or _nil_job(),
            task_type=TaskType.ACTOR_TASK,
            func_id="",
            description=f"{self._description}.{method_name}",
            args=sargs,
            kwargs=skwargs,
            num_returns=num_returns,
            resources={},
            max_retries=self._max_task_retries,
            actor_id=self._actor_id,
            method_name=method_name,
            concurrency_group=concurrency_group,
            trace_ctx=_trace_ctx(),
        )
        # wire template: the constant fields of this (actor, method,
        # options) encode once; each call walks only task_id/args/kwargs/
        # seq_no/owner_id/trace_ctx — the actor-call analog of
        # RemoteFunction's template (the submit hot path)
        cache = self.__dict__.setdefault("_tmpl_cache", {})
        key = (method_name, num_returns, concurrency_group)
        tmpl = cache.get(key)
        if tmpl is None:
            from . import wire

            tmpl = cache[key] = wire.make_struct_template(
                spec, ("task_id", "args", "kwargs", "seq_no", "owner_id",
                       "trace_ctx"))
        spec._wire_tmpl = tmpl
        refs = rt.submit_spec(spec)
        if num_returns == STREAMING_RETURNS:
            from .object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, rt)
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._max_task_retries,
                              self._description, self._method_meta))

    def __repr__(self):
        return f"ActorHandle({self._description}, {self._actor_id.hex()[:12]})"


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        for k in self._options:
            if k not in _VALID_ACTOR_OPTIONS:
                raise ValueError(f"Invalid actor option {k!r}")
        self._func_ids: Dict[str, str] = {}  # runtime worker_id.hex -> func_id

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._options)
        merged.update(overrides)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = runtime_mod.get_runtime()
        opts = self._options
        name = opts.get("name", "")
        if name and opts.get("get_if_exists"):
            existing = _try_get_actor(rt, name, opts.get("namespace"))
            if existing is not None:
                return existing
        rt_key = rt.worker_id.hex()
        func_id = self._func_ids.get(rt_key)
        if func_id is None:
            func_id = rt.export_function(self._cls)
            self._func_ids[rt_key] = func_id
        sargs, skwargs = prepare_args(rt, args, kwargs)
        actor_id = ActorId.from_random()
        is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(self._cls, inspect.isfunction))
        if is_async and opts.get("concurrency_groups"):
            raise ValueError(
                "concurrency_groups are not supported on async actors yet; "
                "use max_concurrency for asyncio concurrency")
        spec = TaskSpec(
            task_id=rt.new_task_id(),
            job_id=getattr(rt, "job_id", None) or _nil_job(),
            task_type=TaskType.ACTOR_CREATION_TASK,
            func_id=func_id,
            description=f"{self._cls.__name__}.__init__",
            args=sargs,
            kwargs=skwargs,
            num_returns=1,
            resources=resolve_resources(opts, default_cpus=1.0),
            max_retries=0,
            scheduling_strategy=resolve_strategy(opts),
            actor_id=actor_id,
            max_restarts=int(opts.get("max_restarts", cfg.actor_max_restarts)),
            max_concurrency=int(opts.get("max_concurrency", 1)),
            concurrency_groups=opts.get("concurrency_groups"),
            is_async_actor=is_async,
            runtime_env=rt.prepare_runtime_env(opts.get("runtime_env")),
            trace_ctx=_trace_ctx(),
        )
        max_task_retries = int(opts.get("max_task_retries", 0))
        method_meta = _method_meta_of(self._cls)
        meta = {"class_name": self._cls.__name__,
                "max_task_retries": max_task_retries,
                "method_meta": method_meta}
        import time as _time

        deadline = _time.monotonic() + 30.0
        while True:
            try:
                rt.create_actor(spec, name=name,
                                detached=(opts.get("lifetime") == "detached"),
                                meta=meta)
                break
            except Exception as e:
                # get_if_exists creation race: another process registered the
                # name between our lookup and create (the GCS rejects
                # duplicates, ref: gcs_actor_manager.cc name registry). Adopt
                # the winner — or, if the winner died, retry the create (the
                # GCS frees names held by DEAD actors).
                if not (name and opts.get("get_if_exists")
                        and "already taken" in str(e)
                        and _time.monotonic() < deadline):
                    raise
                existing = _try_get_actor(rt, name, opts.get("namespace"))
                if existing is not None:
                    return existing
                _time.sleep(0.01)
        handle = ActorHandle(actor_id, max_task_retries=max_task_retries,
                             description=self._cls.__name__,
                             method_meta=method_meta)
        handle._ready_ref = ObjectRef(spec.return_ids()[0])
        return handle

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            "directly; use .remote().")


def _try_get_actor(rt, name: str, namespace: Optional[str]) -> Optional[ActorHandle]:
    try:
        return get_actor(name, namespace)
    except ValueError:
        return None


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    rt = runtime_mod.get_runtime()
    ns = namespace or getattr(rt, "namespace", "default")
    if hasattr(rt, "gcs"):  # driver
        info = rt.gcs.get_named_actor(name, ns)
        from .gcs import ActorState

        if info is None or info.state == ActorState.DEAD:
            raise ValueError(f"Failed to look up actor {name!r} in namespace {ns!r}")
        from .._vendor import cloudpickle

        meta_blob = rt.gcs.kv_get("actor_meta:" + info.actor_id.hex(),
                                  namespace="actor")
        meta = cloudpickle.loads(meta_blob) if meta_blob else {}
        return ActorHandle(info.actor_id,
                           max_task_retries=meta.get("max_task_retries", 0),
                           description=meta.get("class_name", "Actor"),
                           method_meta=meta.get("method_meta"))
    res = rt.get_named_actor_info(name, ns)
    if res is None:
        raise ValueError(f"Failed to look up actor {name!r} in namespace {ns!r}")
    from .._vendor import cloudpickle

    meta = cloudpickle.loads(res["meta"]) if res.get("meta") else {}
    return ActorHandle(res["actor_id"],
                       max_task_retries=meta.get("max_task_retries", 0),
                       description=meta.get("class_name", "Actor"),
                       method_meta=meta.get("method_meta"))


def _nil_job():
    from .ids import JobId

    return JobId.nil()
