"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for one NVIDIA H100.

The JAX package ``ray_tpu`` stays beside this one as the reference; this
package keeps its module layout and names so each counterpart is easy to
find, and imports nothing of it (nor of JAX). What the port covers so far:

- the host runtime: ``init``/``remote``/``get``/``put``/``wait``, actors,
  placement groups, the object store (``core``), and compiled graphs
  (``cgraph``, ``InputNode``) with their wire codecs (``parallel.quant``),
  copied from the JAX package with its host semantics. Workers are started
  as ``python -S -m ray_tpu_torch.core.worker_main`` and import torch only
  when a task needs it;
- ``ops``: the numeric layers, ``mha_reference``, the paged KV-cache
  primitives, ``flash_attention`` whose forward and backward are CUDA
  kernels written for Hopper (``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu``), and the fused ``ln_matmul`` and
  ``matmul_residual`` (``csrc/ln_matmul.cu``, ``csrc/mm_res.cu``);
- ``models``: the six families of the JAX package's ``models`` (GPT,
  Llama, MoE, ViT, ResNet, MLP), with loaders of its parameters;
- ``serve.llm``: the block pool, the continuous-batching engine, the
  ``LLMServer`` callable and disaggregated prefill/decode (``DisaggLLM``)
  over a compiled graph.

Entry points (``build_model``, ``LLMServer``, ``DisaggLLM``) run on the
CUDA card unless the caller passes ``device="cpu"``; without a card they
raise.
"""
from __future__ import annotations

import os
import time as _time
from typing import Any, Dict, List, Optional, Sequence

from ._version import __version__
from . import exceptions
from . import cgraph
from .cgraph import InputNode, MultiOutputNode
from .core import runtime as _runtime_mod
from .core.actor import ActorClass, ActorHandle, get_actor
from .core.config import Config
from .core.ids import ActorId, JobId, NodeId, ObjectId, TaskId, WorkerId
from .core.object_ref import ObjectRef, ObjectRefGenerator
from .core.placement_group import (PlacementGroup, placement_group,
                                   placement_group_table,
                                   remove_placement_group)
from .core.remote_function import RemoteFunction
from .core.runtime import DriverRuntime, RuntimeContext

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "nodes", "cluster_resources",
    "available_resources", "get_runtime_context", "ObjectRef",
    "ObjectRefGenerator",
    "placement_group", "remove_placement_group", "placement_group_table",
    "PlacementGroup", "exceptions", "method", "__version__",
    "cgraph", "InputNode", "MultiOutputNode", "resolve_device",
]


def __getattr__(name: str):
    # resolve_device lives in a torch module; loading it lazily keeps
    # torch out of every plain task worker (they start with -S for the
    # same reason)
    if name == "resolve_device":
        from ._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def init(num_cpus: Optional[float] = None,
         num_tpus: Optional[float] = None,
         num_nodes: int = 1,
         resources: Optional[Dict[str, float]] = None,
         address: Optional[str] = None,
         authkey: Optional[str] = None,
         namespace: str = "default",
         system_config: Optional[Dict[str, Any]] = None,
         ignore_reinit_error: bool = False,
         object_store_memory: Optional[int] = None,
         runtime_env: Optional[Dict[str, Any]] = None,
         **_ignored) -> DriverRuntime:
    """Start (or connect to) the runtime. Inside a worker this is a no-op
    returning the ambient WorkerRuntime, matching the reference's behavior."""
    if address:
        # remote-driver mode (the Ray Client equivalent): attach to a
        # running head instead of starting a local cluster
        from .client import ClientRuntime

        existing = _runtime_mod.maybe_runtime()
        if existing is not None:
            # silently handing back a DIFFERENT cluster's runtime would
            # run the caller's work on the wrong cluster
            if getattr(existing, "_address", None) == address:
                return existing
            raise RuntimeError(
                f"ray_tpu_torch.init(address={address!r}) called but this "
                f"process already has a runtime "
                f"({type(existing).__name__}); call ray_tpu_torch.shutdown() "
                f"first")
        client = ClientRuntime(address, authkey=authkey)
        client._address = address
        _runtime_mod.set_runtime(client)
        return client
    existing = _runtime_mod.maybe_runtime()
    if existing is not None:
        if isinstance(existing, DriverRuntime) and not ignore_reinit_error:
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
        if runtime_env and isinstance(existing, DriverRuntime):
            # re-init with a job env must not silently drop it: it becomes
            # the new job-level default for subsequent submissions
            from .core import runtime_env as _renv_mod

            existing.default_runtime_env = _renv_mod.validate(runtime_env)
        return existing
    res: Dict[str, float] = dict(resources or {})
    res.setdefault("CPU", float(num_cpus if num_cpus is not None
                                else (os.cpu_count() or 1)))
    if num_tpus is not None:
        res["TPU"] = float(num_tpus)
    if object_store_memory is not None:
        res["object_store_memory"] = float(object_store_memory)
    rt = DriverRuntime(resources=res, num_nodes=num_nodes,
                       config=Config(system_config), namespace=namespace)
    if int(rt.config.metrics_export_port):
        # opt-in Prometheus exposition at a fixed port (config/env
        # RTPU_METRICS_EXPORT_PORT); ephemeral-port serving remains
        # available any time via metrics.start_metrics_server()
        from .util import metrics as _metrics_mod

        global _metrics_server_from_init
        was_running = _metrics_mod._server is not None
        try:
            _metrics_mod.start_metrics_server(
                port=int(rt.config.metrics_export_port))
            # only own the lifecycle when init() actually bound it — a
            # user-started server must survive ray_tpu_torch.shutdown()
            _metrics_server_from_init = not was_running
        except OSError:
            pass  # port taken: init must not fail over observability
    if runtime_env:
        # job-level default: merged under every task/actor env (ref:
        # job_config.py runtime_env; validated now so errors hit at init)
        from .core import runtime_env as _renv_mod

        rt.default_runtime_env = _renv_mod.validate(runtime_env)
    _runtime_mod.set_runtime(rt)
    return rt


_metrics_server_from_init = False


def shutdown() -> None:
    global _metrics_server_from_init
    rt = _runtime_mod.maybe_runtime()
    if rt is not None:
        rt.shutdown()
        _runtime_mod.set_runtime(None)
        if isinstance(rt, DriverRuntime):
            # the shipped worker/agent series died with the cluster; a
            # re-init must not serve them merged into the new cluster's
            from .util import metrics as _metrics_mod

            _metrics_mod.reset_remote_metrics()
            if _metrics_server_from_init:
                # init() bound it, so init() owns its lifecycle — a
                # re-init with a different port must actually rebind
                _metrics_server_from_init = False
                _metrics_mod.stop_metrics_server()


def is_initialized() -> bool:
    return _runtime_mod.maybe_runtime() is not None


def remote(*args, **options):
    """Decorator turning a function into a RemoteFunction or a class into an
    ActorClass. Usable bare (@remote) or with options (@remote(num_cpus=2))."""
    if len(args) == 1 and not options and (callable(args[0]) or isinstance(args[0], type)):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only")

    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    return wrap


def method(num_returns=None, concurrency_group: Optional[str] = None):
    """Per-method defaults on actor classes: num_returns (int or
    "streaming") and concurrency_group (ref: python/ray/actor.py method
    decorator; concurrency groups per
    transport/concurrency_group_manager.cc)."""

    def wrap(m):
        if num_returns is not None:
            m._rtpu_num_returns = num_returns
        if concurrency_group is not None:
            m._rtpu_concurrency_group = concurrency_group
        return m

    return wrap


def get(refs, timeout: Optional[float] = None):
    # future-like objects (e.g. serve.DeploymentResponse) resolve through
    # the __rtpu_result__ protocol
    if hasattr(refs, "__rtpu_result__"):
        return refs.__rtpu_result__(timeout)
    rt = _runtime_mod.get_runtime()
    if isinstance(refs, ObjectRef):
        return rt.get(refs, timeout)
    if isinstance(refs, (list, tuple)):
        if all(hasattr(r, "__rtpu_result__") for r in refs) and refs:
            deadline = None if timeout is None else _time.monotonic() + timeout
            return [r.__rtpu_result__(
                None if deadline is None
                else max(0.0, deadline - _time.monotonic()))
                for r in refs]
        if not all(isinstance(r, ObjectRef) for r in refs):
            raise TypeError("ray_tpu_torch.get accepts an ObjectRef or a list of them")
        return rt.get(list(refs), timeout)
    raise TypeError(f"Cannot get {type(refs)}")


def put(value: Any) -> ObjectRef:
    rt = _runtime_mod.get_runtime()
    return rt.put(value)


def wait(refs: Sequence[ObjectRef], num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    rt = _runtime_mod.get_runtime()
    return rt.wait(list(refs), num_returns=num_returns, timeout=timeout,
                   fetch_local=fetch_local)


def kill(actor: ActorHandle, no_restart: bool = True) -> None:
    rt = _runtime_mod.get_runtime()
    rt.kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, force: bool = False, recursive: bool = True) -> None:
    rt = _runtime_mod.get_runtime()
    rt.cancel(ref, force=force)


def free(refs: Sequence[ObjectRef]) -> None:
    rt = _runtime_mod.get_runtime()
    rt.free(list(refs))


def nodes() -> List[dict]:
    rt = _runtime_mod.get_runtime()
    return [
        {"NodeID": n.node_id.hex(), "Alive": n.alive,
         "Resources": dict(n.total_resources.items()),
         "Labels": dict(n.labels)}
        for n in rt.gcs.nodes()
    ]


def cluster_resources() -> Dict[str, float]:
    return _runtime_mod.get_runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _runtime_mod.get_runtime().available_resources()


def get_runtime_context() -> RuntimeContext:
    return _runtime_mod.get_runtime().runtime_context()
