"""Prometheus metrics exposition + cluster-wide aggregation.

Equivalent of the reference's metrics pipeline (ref:
src/ray/stats/metric_defs.cc:44 native metric definitions;
python/ray/_private/metrics_agent.py Prometheus exposition). Gauges are
computed from live runtime state at scrape time — no sampling loop to
drift — and exposed on a stdlib HTTP endpoint at /metrics.

Also the app-metric API: Counter/Gauge/Histogram
(ref: python/ray/util/metrics.py) registered into the same exposition.

Histograms are fully bucketed: `boundaries` (seconds, ascending) define
cumulative `_bucket{le="..."}` series (with the mandatory `+Inf`
terminal) next to `_sum`/`_count`, and `percentile(p)` interpolates
p50/p95/p99-style estimates straight from the bucket counts.

Cluster aggregation (the metrics-agent analog, ref:
python/ray/_private/metrics_agent.py): metrics registered in worker or
remote-agent processes never share this process's registry, so those
processes periodically ship *deltas* (`snapshot_deltas`) over their
existing RPC channel — workers after each task / on a 1 s cadence,
agents piggybacked on the heartbeat — and the head merges them
(`merge_remote`) into the single `/metrics` exposition with `node` /
`worker` tags. One scrape of the head sees the whole cluster.
"""
from __future__ import annotations

import threading
import time
import warnings
from bisect import bisect_left
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

# RLock: __init__ runs its whole body (including the super().__init__
# chain) inside one critical section, so concurrent first-constructions
# of the same name can't double-register or reset each other's state
_user_metrics_lock = threading.RLock()
_user_metrics: List["Metric"] = []
# name -> instance: re-constructing a metric with a name this process
# already registered returns the SAME object (state intact), so the
# blessed pattern of creating a Counter inside a task body neither
# leaks one Metric per call nor makes every flush scan an ever-growing
# registry. Keyed by name alone — one exposition family has one kind,
# so a Counter/Gauge/Histogram collision on a name is an error.
_metric_index: Dict[str, "Metric"] = {}

# general-purpose request/task latency buckets (seconds)
DEFAULT_BOUNDARIES: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
# sub-millisecond-heavy paths: RPC handlers, shared-memory store ops
FAST_BOUNDARIES: Tuple[float, ...] = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 1.0, 2.5)


class Metric:
    def __new__(cls, name: str, *args, **kwargs):
        with _user_metrics_lock:
            existing = _metric_index.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}; one exposition "
                        f"family cannot carry two kinds")
                return existing  # __init__ no-ops via _registered
            obj = super().__new__(cls)
            _metric_index[name] = obj
            return obj

    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        with _user_metrics_lock:
            if getattr(self, "_registered", False):
                return  # registry reuse: keep the existing series state
            self.name = name
            self.description = description
            self.tag_keys = tuple(tag_keys)
            self._values: Dict[tuple, float] = {}
            self._shipped: Dict[tuple, Any] = {}  # delta watermarks
            self._lock = threading.Lock()
            self._registered = True
            _user_metrics.append(self)

    def _key(self, tags: Optional[Dict[str, str]]) -> tuple:
        tags = tags or {}
        return tuple(tags.get(k, "") for k in self.tag_keys)

    def _delta(self) -> Optional[dict]:
        """Changes since the last snapshot, as a wire-safe dict (lists +
        primitives only); None when nothing changed. Used by worker/agent
        processes to ship their registry to the head."""
        series = []
        with self._lock:
            for k, v in self._values.items():
                last = self._shipped.get(k, 0.0)
                if self.kind == "gauge":
                    if k in self._shipped and last == v:
                        continue
                    self._shipped[k] = v
                    series.append([list(k), v])
                else:  # counter: ship the increment
                    if v == last:
                        continue
                    self._shipped[k] = v
                    series.append([list(k), v - last])
        if not series:
            return None
        return {"name": self.name, "kind": self.kind,
                "help": self.description, "tag_keys": list(self.tag_keys),
                "series": series}

    kind = "gauge"


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def total(self) -> float:
        """Sum across every tag combination, as counted in this process."""
        with self._lock:
            return sum(self._values.values())


class Gauge(Metric):
    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    """Bucketed histogram: cumulative `_bucket{le=...}` series (with
    `+Inf`) plus `_sum`/`_count`. `boundaries` are inclusive upper
    bounds in ascending order; observations above the last boundary land
    in the `+Inf` overflow bucket."""
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        with _user_metrics_lock:
            bounds = tuple(float(b)
                           for b in (boundaries or DEFAULT_BOUNDARIES))
            if getattr(self, "_registered", False):
                # registry reuse: don't reset buckets/counts — but a
                # caller asking for different bucketing must not
                # silently get the old one
                if boundaries is not None and bounds != self.boundaries:
                    warnings.warn(
                        f"histogram {name!r} already registered with "
                        f"boundaries {self.boundaries}; ignoring "
                        f"{bounds}", RuntimeWarning, stacklevel=2)
                return
            if not bounds or list(bounds) != sorted(set(bounds)):
                # a failed construction must not leave the name mapped
                # to a half-built instance
                _metric_index.pop(name, None)
                raise ValueError(
                    f"histogram {name!r}: boundaries must be strictly "
                    f"ascending and non-empty, got {boundaries!r}")
            super().__init__(name, description, tag_keys)
            self.boundaries = bounds
            self._counts: Dict[tuple, int] = {}
            # per-series NON-cumulative bucket counts: len(bounds)+1
            # (last = overflow); cumulated only at render time
            self._buckets: Dict[tuple, List[int]] = {}
            # OpenMetrics exemplars: per series, per bucket index, the
            # LATEST (trace_id, value, ts) observed with one — a p99
            # bucket on the scrape links straight to a stored trace
            self._exemplars: Dict[tuple, Dict[int, tuple]] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None,
                exemplar: Optional[str] = None) -> None:
        """``exemplar`` is a trace id to pin to the bucket this sample
        lands in (rendered as `# {trace_id="..."} value ts`)."""
        k = self._key(tags)
        idx = bisect_left(self.boundaries, value)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1
            b = self._buckets.get(k)
            if b is None:
                b = self._buckets[k] = [0] * (len(self.boundaries) + 1)
            b[idx] += 1
            if exemplar:
                self._exemplars.setdefault(k, {})[idx] = (
                    str(exemplar), float(value), time.time())

    def percentile(self, p: float,
                   tags: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Estimate the p-th percentile (p in (0, 100]) by linear
        interpolation inside the bracketing bucket. tags=None aggregates
        across every tagged series; None when nothing was observed."""
        with self._lock:
            if tags is None:
                rows = list(self._buckets.values())
            else:
                b = self._buckets.get(self._key(tags))
                rows = [b] if b else []
            agg = [sum(col) for col in zip(*rows)] if rows else []
        return percentile_from_buckets(self.boundaries, agg, p)

    def _delta(self) -> Optional[dict]:
        series = []
        with self._lock:
            for k, b in self._buckets.items():
                s = self._values.get(k, 0.0)
                c = self._counts.get(k, 0)
                last = self._shipped.get(k)
                if last is None:
                    ds, dc, db = s, c, list(b)
                else:
                    ls, lc, lb = last
                    if c == lc:
                        continue
                    ds, dc = s - ls, c - lc
                    db = [x - y for x, y in zip(b, lb)]
                self._shipped[k] = (s, c, list(b))
                # exemplars ride as an OPTIONAL 4th element so heads
                # that predate them still unpack the delta; pop = each
                # exemplar ships once (the head keeps the latest seen).
                # str keys survive JSON/msgpack map round-trips intact.
                ex = self._exemplars.pop(k, None)
                if ex:
                    series.append([list(k), [ds, dc, db, {
                        str(i): list(v) for i, v in ex.items()}]])
                else:
                    series.append([list(k), [ds, dc, db]])
        if not series:
            return None
        return {"name": self.name, "kind": "histogram",
                "help": self.description, "tag_keys": list(self.tag_keys),
                "boundaries": list(self.boundaries), "series": series}


def percentile_from_buckets(boundaries: Sequence[float],
                            bucket_counts: Sequence[int],
                            p: float) -> Optional[float]:
    """p-th percentile (p in (0, 100]) from NON-cumulative bucket counts
    (len(boundaries)+1, last = +Inf overflow), linearly interpolated
    within the bracketing bucket. Observations in the overflow bucket
    clamp to the last finite boundary (their true magnitude is unknown)."""
    total = sum(bucket_counts)
    if total == 0 or not boundaries:
        return None
    target = max(1e-12, p / 100.0) * total
    cum = 0.0
    for i, c in enumerate(bucket_counts[:len(boundaries)]):
        if c == 0:
            continue
        if cum + c >= target:
            lo = boundaries[i - 1] if i > 0 else 0.0
            hi = boundaries[i]
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return float(boundaries[-1])


# ---- Prometheus text-format escaping (satellite: label values holding
# `"`, `\` or newlines previously produced an unparseable exposition) ----

def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_tags(tags: Dict[str, str]) -> str:
    # empty label values are spec-equivalent to the label being absent —
    # skip them so merged cluster series stay tidy
    items = [(k, v) for k, v in tags.items() if v not in ("", None)]
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + inner + "}"


def _fmt_val(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


# ---- cluster-wide aggregation (head side) ---------------------------------

_remote_lock = threading.Lock()
# name -> {"kind","help","tag_keys","boundaries","series":{tagvals: val}}
# histogram series value: [sum, count, [bucket_counts]]
_remote_metrics: Dict[str, dict] = {}
# per-family series cap: worker churn (container dedication, crash
# restarts, serve autoscaling) mints fresh worker ids forever; without a
# bound the head's scrape body and memory grow monotonically. Series are
# kept in last-update order and the stalest evicted past the cap.
REMOTE_SERIES_MAX = 2000


def merge_remote(deltas: List[dict], node: str = "",
                 worker: str = "") -> None:
    """Fold metric deltas shipped from a worker/agent process into the
    head's exposition, tagged with their origin node (and worker, when
    the origin is a worker process)."""
    if not deltas:
        return
    with _remote_lock:
        for d in deltas:
            try:
                name = d["name"]
                kind = d.get("kind", "gauge")
                fam = _remote_metrics.get(name)
                if fam is None:
                    fam = _remote_metrics[name] = {
                        "kind": kind, "help": d.get("help", ""),
                        "tag_keys": tuple(d.get("tag_keys", ())) +
                        ("node", "worker"),
                        "boundaries": tuple(d.get("boundaries", ()) or ()),
                        "series": {},
                    }
                if kind == "histogram" and fam["boundaries"] != tuple(
                        d.get("boundaries", ())):
                    continue  # incompatible bucketing: drop, don't corrupt
                for tagvals, val in d.get("series", ()):
                    key = tuple(tagvals) + (node, worker)
                    cur = fam["series"].pop(key, None)  # re-insert at
                    # the tail below: dict order doubles as recency, so
                    # the cap evicts the longest-untouched series first
                    if cur is None \
                            and len(fam["series"]) >= REMOTE_SERIES_MAX:
                        fam["series"].pop(next(iter(fam["series"])))
                    if kind == "gauge":
                        fam["series"][key] = float(val)
                    elif kind == "histogram":
                        ds, dc, db = val[0], val[1], val[2]
                        ex = val[3] if len(val) > 3 else None
                        if cur is None:
                            cur = [0.0, 0, [0] * len(db), {}]
                        elif len(cur) == 3:  # pre-exemplar shape
                            cur.append({})
                        cur[0] += ds
                        cur[1] += dc
                        if len(cur[2]) == len(db):
                            cur[2] = [x + y for x, y in zip(cur[2], db)]
                        if ex:
                            cur[3].update(ex)
                        fam["series"][key] = cur  # re-insert (recency)
                    else:  # counter
                        fam["series"][key] = (cur or 0.0) + float(val)
            except Exception:
                continue  # one malformed delta must not poison the rest


def carry_backlog(backlog: List[dict], cap: int = 100) -> List[dict]:
    """Shared ship-retry policy for delta exporters (worker post-task
    flush, agent heartbeat): append this snapshot to whatever failed to
    ship earlier, keeping only the newest `cap` deltas. snapshot_deltas
    advances watermarks, so deltas that don't ship must ride a bounded
    backlog or their observations silently vanish from the head."""
    return (backlog + snapshot_deltas())[-cap:]


def reset_remote_metrics() -> None:
    """Drop every worker/agent-shipped series. Called by
    ray_tpu_torch.shutdown(): the origin processes are dead, and a re-init in
    the same process must not blend the old cluster's node/worker-tagged
    numbers into the new cluster's scrape."""
    with _remote_lock:
        _remote_metrics.clear()


def snapshot_deltas() -> List[dict]:
    """Collect every registered metric's changes since the last call —
    what a worker/agent process ships to the head."""
    with _user_metrics_lock:
        metrics = list(_user_metrics)
    out = []
    for m in metrics:
        try:
            d = m._delta()
        except Exception:
            d = None
        if d:
            out.append(d)
    return out


# ---- exposition ------------------------------------------------------------

class _Family:
    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help_: str):
        self.name = name
        self.kind = kind
        self.help = help_
        # (suffix, tags, value, exemplar-or-None); exemplar is
        # (trace_id, value, ts) attached only to histogram _bucket rows
        self.samples: List[Tuple[str, Dict[str, str], Any, Any]] = []

    def add(self, suffix: str, tags: Dict[str, str], value,
            exemplar=None) -> None:
        self.samples.append((suffix, tags, value, exemplar))


def _hist_samples(fam: _Family, tags: Dict[str, str],
                  boundaries: Sequence[float], buckets: Sequence[int],
                  total: float, count: int, exemplars=None) -> None:
    def _ex(i):
        if not exemplars:
            return None
        return exemplars.get(i) or exemplars.get(str(i))

    cum = 0
    for i, (b, c) in enumerate(zip(boundaries, buckets)):
        cum += c
        fam.add("_bucket", {**tags, "le": _fmt_val(float(b))}, cum, _ex(i))
    fam.add("_bucket", {**tags, "le": "+Inf"}, count, _ex(len(boundaries)))
    fam.add("_sum", tags, total)
    fam.add("_count", tags, count)


def _runtime_families(fams: "OrderedFams") -> None:
    from ..core import runtime as runtime_mod

    rt = runtime_mod.maybe_runtime()
    if rt is None or not hasattr(rt, "gcs"):
        return
    nodes = rt.gcs.nodes()
    fams.get("ray_tpu_nodes_total", "gauge", "cluster nodes").add(
        "", {}, len(nodes))
    fams.get("ray_tpu_nodes_alive", "gauge", "live cluster nodes").add(
        "", {}, sum(1 for n in nodes if n.alive))
    actors = fams.get("ray_tpu_actors", "gauge", "actors by state")
    by_state: Dict[str, int] = {}
    for a in rt.gcs.list_actors():
        by_state[a.state.name] = by_state.get(a.state.name, 0) + 1
    for state, n in sorted(by_state.items()):
        actors.add("", {"state": state}, n)
    evs = fams.get("ray_tpu_task_events_total", "counter",
                   "task state transitions since head start")
    for state, n in sorted(rt.gcs.task_event_counts().items()):
        evs.add("", {"state": state}, n)
    store_fams = [
        fams.get("ray_tpu_object_store_bytes_used", "gauge",
                 "shared-memory store bytes in use"),
        fams.get("ray_tpu_object_store_capacity_bytes", "gauge",
                 "shared-memory store capacity"),
        fams.get("ray_tpu_object_store_objects", "gauge",
                 "sealed objects resident per store"),
        fams.get("ray_tpu_object_store_evictions_total", "counter",
                 "LRU evictions per store"),
        fams.get("ray_tpu_object_store_spills_total", "counter",
                 "disk/remote spills per store"),
    ]
    keys = ("used", "capacity", "num_objects", "num_evictions", "num_spills")
    for nid, node in list(rt.nodes.items()):
        try:
            st = node.store.stats()
        except Exception:
            continue
        tags = {"node": nid.hex()[:12]}
        for fam, key in zip(store_fams, keys):
            fam.add("", tags, st.get(key, 0))


def _torch_families(fams: "OrderedFams") -> None:
    """Device count and per-device CUDA memory gauges — only when the
    application already imported torch (a scrape must not pay the torch
    import). The JAX package's XLA compile counter has no counterpart in
    eager torch and is left out."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return
    try:
        if not torch.cuda.is_available():
            return
        n = torch.cuda.device_count()
    except Exception:
        return
    fams.get("ray_tpu_cuda_device_count", "gauge",
             "torch.cuda.device_count() visible to the head").add("", {}, n)
    mem = fams.get("ray_tpu_cuda_memory_bytes", "gauge",
                   "per-device torch.cuda memory_allocated/memory_reserved")
    for d in range(n):
        for kind, fn in (("allocated", torch.cuda.memory_allocated),
                         ("reserved", torch.cuda.memory_reserved)):
            try:
                mem.add("", {"device": str(d), "kind": kind}, fn(d))
            except Exception:
                pass


class OrderedFams:
    def __init__(self):
        self._fams: "Dict[str, _Family]" = {}

    def get(self, name: str, kind: str, help_: str = "") -> _Family:
        fam = self._fams.get(name)
        if fam is None:
            fam = self._fams[name] = _Family(name, kind, help_)
        return fam

    def families(self) -> List[_Family]:
        return list(self._fams.values())


def _collect_families() -> List[_Family]:
    fams = OrderedFams()
    try:
        _runtime_families(fams)
    except Exception:
        pass
    try:
        _torch_families(fams)
    except Exception:
        pass
    with _user_metrics_lock:
        metrics = list(_user_metrics)
    for m in metrics:
        fam = fams.get(m.name, m.kind, m.description)
        with m._lock:
            items = list(m._values.items())
            counts = dict(getattr(m, "_counts", {}))
            buckets = {k: list(v)
                       for k, v in getattr(m, "_buckets", {}).items()}
            exemplars = {k: dict(v)
                         for k, v in getattr(m, "_exemplars", {}).items()}
        for k, value in items:
            tags = dict(zip(m.tag_keys, k))
            if isinstance(m, Histogram):
                _hist_samples(fam, tags, m.boundaries,
                              buckets.get(k, ()), value, counts.get(k, 0),
                              exemplars.get(k))
            else:
                fam.add("", tags, value)
    with _remote_lock:
        # histogram values are [sum, count, buckets] lists merge_remote
        # mutates in place — copy them INSIDE the lock or a concurrent
        # push can tear the render into a non-monotonic exposition
        remote = {name: {"kind": f["kind"], "help": f["help"],
                         "tag_keys": f["tag_keys"],
                         "boundaries": f["boundaries"],
                         "series": {
                             k: ([v[0], v[1], list(v[2]),
                                  dict(v[3]) if len(v) > 3 else {}]
                                 if f["kind"] == "histogram" else v)
                             for k, v in f["series"].items()}}
                  for name, f in _remote_metrics.items()}
    for name, f in remote.items():
        fam = fams.get(name, f["kind"], f["help"])
        for key, val in f["series"].items():
            tags = dict(zip(f["tag_keys"], key))
            if f["kind"] == "histogram":
                total, count, bks = val[0], val[1], val[2]
                _hist_samples(fam, tags, f["boundaries"], bks, total, count,
                              val[3] if len(val) > 3 else None)
            else:
                fam.add("", tags, val)
    return fams.families()


def _render() -> str:
    lines: List[str] = []
    for fam in _collect_families():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for suffix, tags, value, ex in fam.samples:
            line = f"{fam.name}{suffix}{_fmt_tags(tags)} {_fmt_val(value)}"
            if ex:
                # OpenMetrics exemplar: `# {trace_id="..."} value ts` —
                # the landing bucket links straight to the stored trace
                tid, ev, ets = ex[0], ex[1], ex[2]
                line += (f' # {{trace_id="{_escape_label_value(tid)}"}}'
                         f" {_fmt_val(float(ev))} {ets:.3f}")
            lines.append(line)
    return "\n".join(lines) + "\n"


def latency_summary() -> Dict[str, dict]:
    """p50/p95/p99 (+count/mean) per histogram family, aggregated across
    every series — local AND worker/agent-shipped — plus a per-series
    breakdown. Backs `/api/latency` and `ray_tpu_torch list latency`."""
    acc: Dict[str, dict] = {}

    def fold(name, boundaries, tag_keys, key, total, count, bks):
        if not boundaries or count == 0:
            return
        f = acc.get(name)
        if f is None or len(f["boundaries"]) != len(boundaries):
            if f is not None:
                return
            f = acc[name] = {"boundaries": tuple(boundaries),
                             "agg": [0] * (len(boundaries) + 1),
                             "sum": 0.0, "count": 0, "series": []}
        f["agg"] = [x + y for x, y in zip(f["agg"], bks)]
        f["sum"] += total
        f["count"] += count
        tags = {k: v for k, v in zip(tag_keys, key) if v}
        f["series"].append((tags, total, count, list(bks)))

    with _user_metrics_lock:
        metrics = [m for m in _user_metrics if isinstance(m, Histogram)]
    for m in metrics:
        with m._lock:
            rows = [(k, m._values.get(k, 0.0), m._counts.get(k, 0),
                     list(b)) for k, b in m._buckets.items()]
        for k, total, count, bks in rows:
            fold(m.name, m.boundaries, m.tag_keys, k, total, count, bks)
    with _remote_lock:
        for name, f in _remote_metrics.items():
            if f["kind"] != "histogram":
                continue
            for key, val in f["series"].items():
                fold(name, f["boundaries"], f["tag_keys"], key,
                     val[0], val[1], list(val[2]))

    out: Dict[str, dict] = {}
    for name, f in acc.items():
        bounds = f["boundaries"]

        def pct(bks, p):
            v = percentile_from_buckets(bounds, bks, p)
            return None if v is None else round(v, 6)

        out[name] = {
            "count": f["count"],
            "mean": round(f["sum"] / f["count"], 6) if f["count"] else None,
            "p50": pct(f["agg"], 50), "p95": pct(f["agg"], 95),
            "p99": pct(f["agg"], 99),
            "series": [
                {"tags": tags, "count": count,
                 "mean": round(total / count, 6) if count else None,
                 "p50": pct(bks, 50), "p95": pct(bks, 95),
                 "p99": pct(bks, 99)}
                for tags, total, count, bks in f["series"]],
        }
    return out


_server_lock = threading.Lock()
_server: Optional[ThreadingHTTPServer] = None
_server_requested: Optional[Tuple[str, int]] = None


def start_metrics_server(host: str = "127.0.0.1",
                         port: int = 0) -> Tuple[str, int]:
    """Start the /metrics endpoint; -> (host, port).

    Singleton per process: the first call binds, every later call
    returns the existing server's address. A later call naming a
    *different* host or explicit port is almost certainly a config
    error (the caller would silently scrape the wrong address), so it
    warns and keeps the original binding; call stop_metrics_server()
    first to rebind."""
    global _server, _server_requested
    with _server_lock:  # two first-calls racing must not double-bind
        if _server is not None:
            bound = _server.server_address[:2]
            if (host != _server_requested[0]
                    or (port != 0 and port != bound[1])):
                warnings.warn(
                    f"metrics server already bound to "
                    f"{bound[0]}:{bound[1]}; ignoring request for "
                    f"{host}:{port} (stop_metrics_server() first to "
                    f"rebind)", RuntimeWarning, stacklevel=2)
            return bound

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") in ("", "/metrics", "/-/healthy"):
                    body = _render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

        _server = ThreadingHTTPServer((host, port), Handler)
        _server_requested = (host, port)
        threading.Thread(target=_server.serve_forever, daemon=True,
                         name="metrics-http").start()
        return _server.server_address[:2]


def stop_metrics_server() -> None:
    global _server, _server_requested
    with _server_lock:
        if _server is not None:
            _server.shutdown()
            _server = None
            _server_requested = None
