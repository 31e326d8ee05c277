"""One head snapshot RPC feeding ``ray_tpu_torch top``.

``head_snapshot(runtime)`` flattens the head's merged metric registry
(local + every worker/agent-shipped delta) into a wire-safe dict: node
rows, scalar series (counters + gauges, tag-qualified), and histogram
summaries. The CLI polls it and computes rates client-side by diffing
counter values between refreshes — the head does no rate bookkeeping.
Served to unregistered channels as the ``perf_snapshot`` agent-handler
method, beside ``list_nodes``/``logs_query``.
"""
from __future__ import annotations

import time
from typing import Dict

from ..util import metrics as _metrics

__all__ = ["head_snapshot"]


def _fmt_tags(tags: Dict[str, str]) -> str:
    items = sorted((k, v) for k, v in tags.items() if v)
    return ",".join(f"{k}={v}" for k, v in items)


def head_snapshot(runtime) -> dict:
    """Everything ``ray_tpu_torch top`` renders, in one reply."""
    nodes = []
    try:
        for n in runtime.gcs.nodes():
            nodes.append({"node_id": n.node_id.hex(), "alive": n.alive,
                          "resources": dict(n.total_resources)})
    except Exception:
        pass
    scalars: Dict[str, Dict[str, float]] = {}
    hists: Dict[str, dict] = {}
    for fam in _metrics._collect_families():
        if not fam.name.startswith("ray_tpu_"):
            continue
        if fam.kind == "histogram":
            continue  # summarized below with percentiles
        series = scalars.setdefault(fam.name, {})
        for suffix, tags, value, _ex in fam.samples:
            if suffix:
                continue
            key = _fmt_tags(tags)
            # multiple worker-shipped series can share a tag set after
            # node/worker qualifiers are dropped: sum counters, keep the
            # freshest gauge write
            if fam.kind == "counter":
                series[key] = series.get(key, 0.0) + value
            else:
                series[key] = value
    for name, summ in _metrics.latency_summary().items():
        if not name.startswith("ray_tpu_"):
            continue
        hists[name] = {k: summ.get(k) for k in
                       ("count", "mean", "p50", "p95", "p99")}
    traces = None
    try:
        ts = runtime.gcs.traces
        st = ts.stats()
        if st.get("total_traces", 0):  # tracing actually on: show it
            traces = dict(st)
            traces["slowest_active"] = ts.slowest_active()
    except Exception:
        pass
    return {"time": time.time(), "nodes": nodes, "scalars": scalars,
            "histograms": hists, "traces": traces}
