"""Typed, env-overridable flag registry.

Equivalent of the reference's RAY_CONFIG macro registry
(ref: src/ray/common/ray_config_def.h — 205 typed flags overridable via
RAY_<name> env vars and a cluster-wide system-config dict). Here: a plain
dataclass-like registry; override with RTPU_<NAME> env vars or
``init(system_config={...})``.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict


_DEFS: Dict[str, Any] = {}
_DESCRIPTIONS: Dict[str, str] = {}


def _define(name: str, default: Any, description: str = "") -> None:
    _DEFS[name] = default
    _DESCRIPTIONS[name] = description


def describe() -> Dict[str, Dict[str, Any]]:
    """Flag catalog: {name: {default, type, description, env}} — the
    analog of reading ray_config_def.h."""
    return {
        name: {"default": default,
               "type": type(default).__name__,
               "description": _DESCRIPTIONS.get(name, ""),
               "env": "RTPU_" + name.upper()}
        for name, default in _DEFS.items()
    }


# --- object store / serialization ---
_define("max_direct_call_object_size", 100 * 1024,
        "values at or under this inline into specs/results instead of the "
        "shared-memory store (ref: ray_config_def.h:213)")
_define("task_args_inline_bytes_limit", 10 * 1024 * 1024,
        "total inline-arg budget per task (ref: ray_config_def.h:516)")
_define("object_store_memory", 2 * 1024**3,
        "per-node shared-memory store capacity in bytes")
_define("object_spilling_dir",
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill"),
        "disk spill directory; empty disables spilling")
_define("min_spilling_size", 1 * 1024 * 1024,
        "objects smaller than this are evicted rather than spilled")
_define("object_transfer_chunk_bytes", 5 * 1024 * 1024,
        "chunk size for inter-node object pulls/pushes "
        "(ref: ray_config_def.h:348)")
# --- scheduling ---
_define("scheduler_spread_threshold", 0.5,
        "hybrid policy: pack onto a node until this utilization, then "
        "spread (ref: ray_config_def.h:193)")
_define("scheduler_top_k_fraction", 0.2,
        "fraction of best-scoring nodes randomized over per decision "
        "(ref: ray_config_def.h:199)")
_define("worker_lease_timeout_s", 30.0,
        "how long a lease request waits for capacity before erroring")
_define("num_workers_soft_limit", 8,
        "per-node worker-pool size target; the idle reaper trims to it")
_define("worker_prestart_count", 0,
        "workers started eagerly at node bring-up")
_define("worker_startup_timeout_s", 60.0,
        "a worker that hasn't registered by then is declared failed")
_define("worker_idle_timeout_s", 300.0,
        "idle workers above the soft limit are reaped after this")
# --- runtime / rpc ---
_define("driver_pool_threads", 8,
        "DriverRuntime's shared thread pool (lease grants, await-ref "
        "futures, function export)")
_define("rpc_handler_threads", 4,
        "request-handler threads per RpcChannel (worker/agent channels)")
_define("node_server_threads", 16,
        "handler threads for a node's worker-facing RPC server")
_define("container_launcher",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "scripts", "container_worker_launcher.sh"),
        "executable that launches a containerized worker: invoked as "
        "<launcher> <image> [run_options...] -- <worker cmd...>. The "
        "default is the repo's docker reference script; point it at a "
        "podman/k8s wrapper for other runtimes")
_define("capture_worker_logs", 1,
        "tee every worker's stdout/stderr over its node channel into the "
        "head's bounded log store (dashboard log view / state API); "
        "0 = only remote workers forward, for console display")
_define("log_store_max_bytes", 16 * 1024 * 1024,
        "byte budget for the head's attributed log store; oldest records "
        "evict first (ref: dashboard log retention)")
_define("trace_store_max_bytes", 8 * 1024 * 1024,
        "byte budget for the head's request-trace store; oldest traces "
        "evict first (counted in ray_tpu_traces_dropped_total)")
_define("trace_sample_rate", 1.0,
        "tail-sampling keep probability for ordinary completed traces; "
        "errors, failovers, preemptions and slow requests are ALWAYS "
        "kept regardless of this rate")
_define("trace_slow_threshold_s", 1.0,
        "completed traces slower than this are always tail-kept when the "
        "root span carries no per-deployment slo_target attribute")
_define("log_batch_lines", 200,
        "worker-side log forwarder flushes when this many lines are "
        "pending (or on the flush interval, whichever first)")
_define("log_flush_interval_s", 0.2,
        "worker-side log forwarder flush cadence")
_define("log_rate_limit_lines_per_s", 2000.0,
        "per-worker log forwarding budget; lines over it are DROPPED "
        "(counted in ray_tpu_logs_dropped_total) — capture must never "
        "block or OOM the task")
_define("agent_log_ring_lines", 2000,
        "per-worker log ring retained on each node agent (local triage "
        "when the head evicted or the link dropped batches)")
_define("log_to_driver", 1,
        "mirror remote workers' stdout/stderr onto the driver console "
        "with a colored (worker pid=, node=) prefix; 0 silences the "
        "mirror (records still reach the head store)")
_define("worker_task_prefetch", 16,
        "max same-signature tasks pushed onto one leased worker's queue "
        "(executed sequentially; only the lease's resources are held). "
        "Keeps workers fed under burst and lets RPC frames coalesce — "
        "set 1 to restore strict one-task-per-lease dispatch")
_define("agent_server_threads", 32,
        "handler threads for the head's agent-facing TCP server (blocking "
        "fetches must not starve worker_call relays)")
# --- decentralized dispatch (docs/DISPATCH.md) ---
_define("direct_actor_calls", 1,
        "steady-state actor calls bypass the head: the caller resolves "
        "placement once, then submits straight to the owning worker over "
        "a cached peer connection (0 = route everything through the head)")
_define("direct_worker_server", 1,
        "each worker listens on a direct-call socket so peers (other "
        "workers, the driver) can submit actor tasks without a head hop")
_define("direct_event_batch", 200,
        "direct-path task completions are batched into one "
        "task_events_batch message at this size (or the flush interval)")
_define("direct_event_flush_s", 0.5,
        "flush cadence for the batched direct-path task-event stream")
_define("head_event_shards", 8,
        "GCS task-event intake shards (per-shard ring + phase table + "
        "lock, keyed by task id) so event floods don't serialize on one "
        "lock; merged on read")
_define("refcount_shards", 16,
        "reference-counter shards keyed by object id")
_define("pg_placer_tick_s", 0.5,
        "parked placement groups re-check capacity at this cadence when "
        "no cluster event fires")
# --- fault tolerance ---
_define("task_max_retries", 3,
        "default automatic retries for worker-crash task failures")
_define("actor_max_restarts", 0,
        "default actor restart budget (0 = actors die with their worker)")
_define("health_check_period_s", 1.0,
        "head -> remote-agent heartbeat check cadence "
        "(ref: gcs_health_check_manager)")
_define("health_check_timeout_s", 10.0,
        "an agent silent for this long is declared dead and fenced")
_define("heartbeat_miss_threshold", 0,
        "declare a node dead only after this many consecutive missed "
        "heartbeat periods, when stricter than health_check_timeout_s "
        "(0 = timeout alone governs); every silent period counts in "
        "ray_tpu_heartbeat_misses_total{node}")
_define("lineage_max_bytes", 256 * 1024 * 1024,
        "lineage (resubmittable task specs) memory budget")
# --- gcs ---
_define("gcs_storage_path", "",
        "non-empty => persist KV/tables to this dir (head restart FT)")
_define("task_events_max_buffered", 20000,
        "task-event ring size backing the state API / timeline (a task "
        "now emits SUBMITTED/SCHEDULED/RUNNING/FINISHED, ~4 events)")
# --- misc ---
_define("log_dir", os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "logs"),
        "worker/agent log directory")
_define("metrics_export_port", 0,
        "non-zero => Prometheus exposition server on this port")
_define("metrics_export_interval_s", 1.0,
        "cadence at which worker processes ship metric deltas to the "
        "head's /metrics exposition (agents piggyback on heartbeat). "
        "Workers read this from their own environment, so set it via "
        "RTPU_METRICS_EXPORT_INTERVAL_S — init(system_config=...) only "
        "reaches the head process")


class Config:
    """Snapshot of config values; env vars RTPU_<NAME> override defaults,
    then an explicit system_config dict overrides both."""

    def __init__(self, system_config: Dict[str, Any] | None = None):
        self._values: Dict[str, Any] = {}
        for name, default in _DEFS.items():
            val = default
            env = os.environ.get("RTPU_" + name.upper())
            if env is not None:
                val = _parse(env, default)
            self._values[name] = val
        if system_config:
            for k, v in system_config.items():
                if k not in _DEFS:
                    raise ValueError(f"Unknown config key: {k}")
                self._values[k] = v

    def __getattr__(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)


def _parse(env: str, default: Any) -> Any:
    if isinstance(default, bool):
        return env.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(env)
    if isinstance(default, float):
        return float(env)
    if isinstance(default, (dict, list)):
        return json.loads(env)
    return env


DEFAULT = Config()
