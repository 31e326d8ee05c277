"""State API — programmatic cluster introspection.

Equivalent of the reference's `ray.util.state` (ref:
python/ray/util/state/api.py list_tasks/list_actors/list_objects/
list_nodes; dashboard/state_aggregator.py). Backed by the head's GCS
tables, the task-event log, the reference counter, and per-node store
stats. Chrome-trace export mirrors `ray timeline`
(ref: scripts.py timeline command; task_event_buffer.h state events).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..core import runtime as runtime_mod


def _rt():
    rt = runtime_mod.get_runtime()
    if not hasattr(rt, "gcs"):
        raise RuntimeError("state API must run on the driver (head) process")
    return rt


def list_nodes() -> List[Dict[str, Any]]:
    rt = _rt()
    out = []
    for info in rt.gcs.nodes():
        node = rt.nodes.get(info.node_id)
        out.append({
            "node_id": info.node_id.hex(),
            "alive": info.alive,
            # preemption-notice drain state (docs/FAULT_TOLERANCE.md
            # "Elasticity"): alive but taking no new work
            "draining": bool(info.draining),
            "resources_total": dict(info.total_resources),
            "resources_available": (dict(node.available)
                                    if node is not None else {}),
            "labels": dict(info.labels),
            "is_remote": bool(getattr(node, "is_remote", False)),
            "num_workers": node.num_workers() if node is not None else 0,
            "lease_queue_len": node.queue_len() if node is not None else 0,
        })
    return out


def recent_logs(worker_id: Optional[str] = None,
                node_id: Optional[str] = None, pid: Optional[int] = None,
                limit: int = 500) -> List[Dict[str, Any]]:
    """Legacy tail of worker stdout/stderr captured on the head; see
    :func:`logs` for the attributed/filterable surface."""
    return _rt().recent_logs(worker_id=worker_id, node_id=node_id,
                             pid=pid, limit=limit)


def logs(job_id: Optional[str] = None, task_id: Optional[str] = None,
         actor_id: Optional[str] = None, worker_id: Optional[str] = None,
         node_id: Optional[str] = None, stream: Optional[str] = None,
         errors_only: bool = False, since: Optional[int] = None,
         limit: int = 500,
         follow_timeout: Optional[float] = None) -> Dict[str, Any]:
    """Attributed cluster log query (the `ray logs` analog): records
    carry {ts, node_id, worker_id, pid, job_id, task_id, actor_id,
    stream, level, seq, line}; id filters match hex prefixes. Returns
    {"records": [...], "cursor": n} — pass `since=cursor` (optionally
    with `follow_timeout`) to stream new lines."""
    return _rt().query_logs(job_id=job_id, task_id=task_id,
                            actor_id=actor_id, worker_id=worker_id,
                            node_id=node_id, stream=stream,
                            errors_only=errors_only, since=since,
                            limit=limit, follow_timeout=follow_timeout)


def stack_report(timeout: float = 5.0) -> Dict[str, Any]:
    """Merged thread stacks from the driver and every live worker
    (`ray stack` analog): {"driver": {...}, "workers": [{node_id,
    worker_id, pid, state, actor_id, threads|error}]}."""
    return _rt().stack_report(timeout_s=timeout)


def profile_worker(worker_id_prefix: str, duration_s: float = 5.0,
                   interval_s: float = 0.01) -> Dict[str, Any]:
    """On-demand sampling profile of one live worker; the result feeds
    introspect.profile_to_text / collapsed_to_text."""
    return _rt().profile_worker(worker_id_prefix, duration_s=duration_s,
                                interval_s=interval_s)


def log_store_stats() -> Dict[str, int]:
    """Retention counters of the head's log store (lines, bytes,
    evicted; the byte budget is config `log_store_max_bytes`)."""
    return _rt().gcs.logs.stats()


def traces(request_id: Optional[str] = None,
           session: Optional[str] = None,
           deployment: Optional[str] = None,
           slowest: Optional[int] = None, since: Optional[int] = None,
           limit: int = 50,
           follow_timeout: Optional[float] = None) -> Dict[str, Any]:
    """Completed request traces kept by the head's tail-sampler
    (docs/OBSERVABILITY.md "Distributed tracing"). Returns {"traces":
    [summaries], "cursor": n}; pass `since=cursor` (optionally with
    `follow_timeout`) to stream newly kept traces, or `slowest=N` for
    the N slowest retained."""
    return _rt().gcs.traces.query(request_id=request_id, session=session,
                                  deployment=deployment, slowest=slowest,
                                  since=since, limit=limit,
                                  follow_timeout=follow_timeout)


def trace_detail(trace_id_prefix: str) -> Optional[Dict[str, Any]]:
    """One trace's summary + full span list (`spans_detail`, time-
    ordered); the id may be a unique hex prefix — e.g. straight off a
    /metrics exemplar."""
    return _rt().gcs.traces.get(trace_id_prefix)


def trace_store_stats() -> Dict[str, Any]:
    """Retention counters of the head's trace store (kept, dropped by
    reason, bytes; the budget is config `trace_store_max_bytes`)."""
    return _rt().gcs.traces.stats()


def trace_chrome(trace_id_prefix: str,
                 output_path: Optional[str] = None) -> List[dict]:
    """One stored trace as chrome://tracing / Perfetto events — the
    same span-slice + cross-process flow-arrow shape as timeline()."""
    tr = _rt().gcs.traces.get(trace_id_prefix)
    if tr is None:
        return []
    trace = _span_trace_events(list(tr.get("spans_detail", ())))
    if output_path:
        with open(output_path, "w") as f:
            json.dump(trace, f)
    return trace


def actor_detail(actor_id_prefix: str) -> Optional[Dict[str, Any]]:
    """One actor's full picture: info + its recent task events + the
    log tail of its worker (dashboard drill-down)."""
    rt = _rt()
    for a in rt.gcs.list_actors():
        if a.actor_id.hex().startswith(actor_id_prefix):
            wid = a.worker_id.hex() if a.worker_id else None
            # exact actor_id match only: class-name substrings would pull
            # in sibling actors' events
            events = [e for e in rt.gcs.task_events()
                      if e.get("actor_id") == a.actor_id.hex()]
            return {
                "actor_id": a.actor_id.hex(), "name": a.name,
                "namespace": a.namespace, "state": a.state.name,
                "class_name": a.creation_spec.description.split(".")[0],
                "node_id": a.node_id.hex() if a.node_id else None,
                "worker_id": wid,
                "num_restarts": a.num_restarts,
                "death_cause": a.death_cause,
                "detached": a.detached,
                "recent_events": events[-50:],
                # attributed store: actor-stamped lines first (survives
                # worker restarts), worker tail as the fallback
                "logs": (rt.query_logs(actor_id=a.actor_id.hex(),
                                       limit=200)["records"]
                         or (rt.recent_logs(worker_id=wid, limit=200)
                             if wid else [])),
            }
    return None


def task_detail(task_id_prefix: str) -> Optional[Dict[str, Any]]:
    """One task's state transitions + lineage summary (dashboard
    drill-down)."""
    rt = _rt()
    events = [e for e in rt.gcs.task_events()
              if str(e.get("task_id", "")).startswith(task_id_prefix)]
    if not events:
        return None
    pend = None
    for tid, pt in list(rt.task_manager._pending.items()):
        if tid.hex().startswith(task_id_prefix):
            pend = {"state": pt.state, "retries_left": pt.retries_left}
            break
    return {"task_id": events[-1].get("task_id"),
            "name": events[-1].get("name"),
            "pending": pend, "events": events[-100:]}


def list_actors(state: Optional[str] = None) -> List[Dict[str, Any]]:
    rt = _rt()
    out = []
    for a in rt.gcs.list_actors():
        row = {
            "actor_id": a.actor_id.hex(),
            "name": a.name,
            "namespace": a.namespace,
            "state": a.state.name,
            "node_id": a.node_id.hex() if a.node_id else None,
            "num_restarts": a.num_restarts,
            "detached": a.detached,
            "death_cause": a.death_cause,
            "class_name": a.creation_spec.description.split(".")[0],
        }
        if state is None or row["state"] == state:
            out.append(row)
    return out


def list_tasks(limit: int = 1000) -> List[Dict[str, Any]]:
    """Most-recent task state transitions (RUNNING/FINISHED/FAILED)."""
    rt = _rt()
    return rt.gcs.task_events()[-limit:]


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    rt = _rt()
    out = []
    directory, inline = rt.object_table_snapshot()
    for oid in list(inline)[:limit]:
        local, pins, holders = rt.refcount.counts(oid)
        out.append({"object_id": oid.hex(), "where": "inline",
                    "local_refs": local, "task_pins": pins,
                    "worker_refs": holders})
    for oid, nids in list(directory.items())[:max(0, limit - len(out))]:
        local, pins, holders = rt.refcount.counts(oid)
        out.append({"object_id": oid.hex(),
                    "where": [n.hex()[:12] for n in nids],
                    "local_refs": local, "task_pins": pins,
                    "worker_refs": holders})
    return out


def list_placement_groups() -> List[Dict[str, Any]]:
    rt = _rt()
    return [{
        "pg_id": pg.pg_id.hex(),
        "state": pg.state,
        "strategy": pg.strategy,
        "bundles": [dict(b) for b in pg.bundles],
        "nodes": [n.hex()[:12] if n else None for n in pg.bundle_nodes],
        "name": pg.name,
    } for pg in rt.gcs.list_pgs()]


def object_store_stats() -> Dict[str, Dict[str, Any]]:
    rt = _rt()
    out = {}
    for nid, node in rt.nodes.items():
        try:
            out[nid.hex()[:12]] = node.store.stats()
        except Exception:
            out[nid.hex()[:12]] = {}
    return out


def rpc_method_stats() -> Dict[str, dict]:
    """Per-RPC-method call/error/latency stats served by THIS process
    (ref: the reference's grpc_server_req_* metrics)."""
    from ..core.rpc import rpc_stats

    return rpc_stats()


def latency_summary() -> Dict[str, dict]:
    """p50/p95/p99 per latency histogram — task lifecycle phases, get(),
    store ops, RPC methods, serve — aggregated cluster-wide (worker- and
    agent-shipped series included). Backs /api/latency and
    `ray_tpu_torch list latency`."""
    from . import metrics as metrics_mod

    return metrics_mod.latency_summary()


def summary() -> Dict[str, Any]:
    rt = _rt()
    events = rt.gcs.task_events()
    by_state: Dict[str, int] = {}
    for e in events:
        by_state[e.get("state", "?")] = by_state.get(e.get("state", "?"), 0) + 1
    return {
        "nodes_alive": sum(1 for n in rt.gcs.nodes() if n.alive),
        "nodes_total": len(rt.gcs.nodes()),
        "actors_by_state": _count_by(list_actors(), "state"),
        "task_events_by_state": by_state,
        "placement_groups": _count_by(list_placement_groups(), "state"),
        "object_store": object_store_stats(),
    }


def _count_by(rows: List[dict], key: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in rows:
        out[r[key]] = out.get(r[key], 0) + 1
    return out


def timeline(output_path: Optional[str] = None) -> List[dict]:
    """Chrome-trace (catapult) events from the task log; load the result
    in chrome://tracing or Perfetto (ref: `ray timeline`)."""
    rt = _rt()
    events = rt.gcs.task_events()
    starts: Dict[str, dict] = {}
    phases: Dict[str, Dict[str, float]] = {}  # tid -> {state: wall time}
    trace: List[dict] = []
    spans: List[dict] = []
    for e in events:
        tid = e.get("task_id", "")
        state = e.get("state")
        if state == "SPAN":
            spans.append(e)
        elif state in ("SUBMITTED", "SCHEDULED"):
            phases.setdefault(tid, {})[state] = e.get("time", 0.0)
        elif state == "RUNNING":
            starts[tid] = e
        elif state in ("FINISHED", "FAILED"):
            begin = starts.pop(tid, None)
            t_end = e.get("time", 0.0)
            t_begin = begin.get("time", t_end) if begin else t_end
            # phase breakdown joins the lifecycle events into the trace
            # slice: how long scheduling and the queue wait took before
            # this exec span started (straggler-phase triage args)
            args: Dict[str, Any] = {"state": state}
            marks = phases.pop(tid, {})
            t_sub = marks.get("SUBMITTED")
            t_sched = marks.get("SCHEDULED")
            if t_sub is not None and t_sched is not None:
                args["submit_to_sched_ms"] = round(
                    max(0.0, (t_sched - t_sub)) * 1e3, 3)
            queued_from = t_sched if t_sched is not None else t_sub
            if queued_from is not None and begin is not None:
                args["queue_wait_ms"] = round(
                    max(0.0, (t_begin - queued_from)) * 1e3, 3)
            args["exec_ms"] = round(max(0.0, (t_end - t_begin)) * 1e3, 3)
            trace.append({
                "name": e.get("name", tid[:8]),
                "cat": "task",
                "ph": "X",  # complete event
                "ts": t_begin * 1e6,
                "dur": max(1.0, (t_end - t_begin) * 1e6),
                "pid": e.get("node_id", "head")[:12],
                "tid": tid[:12],
                "args": args,
            })
    trace.extend(_span_trace_events(spans))
    if output_path:
        with open(output_path, "w") as f:
            json.dump(trace, f)
    return trace


def _span_trace_events(spans: List[dict]) -> List[dict]:
    """SPAN events -> chrome-trace slices + flow arrows.

    Spans from one OS process share a `spans pid=N` lane on their node's
    row, so sibling/child spans nest naturally by time containment;
    parent -> child edges that CROSS processes (submitter's span -> the
    task's span in a worker) are drawn as flow events (`ph: s/f`, bound
    by span_id), which Perfetto renders as arrows — the cross-worker
    call tree (satellite; ref: `ray timeline` + OTel span trees)."""
    out: List[dict] = []
    by_id = {s.get("span_id"): s for s in spans}

    def lane(s: dict) -> tuple:
        node = str(s.get("node_id") or "head")[:12]
        return node, f"spans pid={s.get('pid', '?')}"

    def bounds(s: dict) -> tuple:
        t0 = float(s.get("time") or 0.0)
        return t0, float(s.get("end_time") or t0)

    for s in spans:
        t0, t1 = bounds(s)
        pid, tid = lane(s)
        args = dict(s.get("attributes") or {})
        args["trace_id"] = s.get("trace_id")
        args["span_id"] = s.get("span_id")
        out.append({"name": s.get("name", "span"), "cat": "span",
                    "ph": "X", "ts": t0 * 1e6,
                    "dur": max(1.0, (t1 - t0) * 1e6),
                    "pid": pid, "tid": tid, "args": args})
        parent = by_id.get(s.get("parent_span_id"))
        if parent is None:
            continue
        p0, p1 = bounds(parent)
        ppid, ptid = lane(parent)
        # the flow start must land INSIDE the parent slice to attach
        anchor = min(max(t0, p0), p1)
        flow_id = str(s.get("span_id"))
        out.append({"name": "span-link", "cat": "span", "ph": "s",
                    "id": flow_id, "pid": ppid, "tid": ptid,
                    "ts": anchor * 1e6})
        out.append({"name": "span-link", "cat": "span", "ph": "f",
                    "bp": "e", "id": flow_id, "pid": pid, "tid": tid,
                    "ts": t0 * 1e6})
    return out
