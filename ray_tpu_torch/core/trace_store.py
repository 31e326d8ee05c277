"""Head-side request-trace store — tail-sampled span aggregation.

Equivalent of the reference's task-event aggregation for request
timelines (ref: GCS task-event stream feeding the dashboard's request
view), crossed with an OTel tail-sampling collector: workers ship every
span decision-free over the existing delta channel; the head groups
spans by ``trace_id`` and decides at *trace completion* (root span end)
whether to keep it. Always kept: errors, failover hops, preemptions,
and requests slower than the deployment's SLO target (or the global
``trace_slow_threshold_s``). The rest keep with probability
``trace_sample_rate`` under a seedable RNG (deterministic tests).

Storage discipline mirrors ``core/log_store.py``: a byte budget with
oldest-trace eviction, monotonic cursor paging over completed traces,
and condition-variable long-poll follow. Dropped traces leave a
tombstone so late-arriving worker spans are counted
(``ray_tpu_traces_dropped_total{reason="late"}``), not resurrected.
"""
from __future__ import annotations

import random
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

# accounting overhead per span beyond name/attribute text
_SPAN_OVERHEAD = 240
# tombstones remembered for dropped/evicted traces (late-span dedup)
_TOMBSTONES_MAX = 4096

_KEEP_ALWAYS_NAMES = {"serve.failover": "failover", "llm.preempt": "preempt"}


def _span_bytes(span: Dict[str, Any]) -> int:
    n = len(str(span.get("name", "")))
    for k, v in (span.get("attributes") or {}).items():
        n += len(str(k)) + len(str(v))
    return n + _SPAN_OVERHEAD


class TraceStore:
    def __init__(self, max_bytes: Optional[int] = None,
                 sample_rate: Optional[float] = None,
                 slow_threshold_s: Optional[float] = None,
                 seed: Optional[int] = None):
        if max_bytes is None or sample_rate is None \
                or slow_threshold_s is None:
            from .config import DEFAULT as config
            if max_bytes is None:
                max_bytes = config.trace_store_max_bytes
            if sample_rate is None:
                sample_rate = config.trace_sample_rate
            if slow_threshold_s is None:
                slow_threshold_s = config.trace_slow_threshold_s
        self._max_bytes = int(max_bytes)
        self._sample_rate = float(sample_rate)
        self._slow_s = float(slow_threshold_s)
        self._rng = random.Random(seed)
        self._cv = threading.Condition()
        # trace_id -> {spans, bytes, start, end, root, done, keep_reason}
        self._traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._completed: deque = deque()   # kept trace_ids, completion order
        self._base = 0                     # cursor of _completed[0]
        self._bytes = 0
        self._dropped: "OrderedDict[str, None]" = OrderedDict()
        self.total_traces = 0
        self.kept_traces = 0
        self.dropped_sampled = 0
        self.dropped_evicted = 0

    # ---- ingest --------------------------------------------------------------

    def add_span(self, event: Dict[str, Any]) -> None:
        tid = event.get("trace_id")
        if not tid:
            return
        with self._cv:
            if tid in self._dropped:
                self._count_drop("late")
                return
            tr = self._traces.get(tid)
            if tr is None:
                tr = {"spans": [], "bytes": 0,
                      "start": event.get("time", 0.0), "end": None,
                      "root": None, "done": False, "keep_reason": None}
                self._traces[tid] = tr
                self.total_traces += 1
            b = _span_bytes(event)
            tr["spans"].append(event)
            tr["bytes"] += b
            self._bytes += b
            t0 = event.get("time")
            if t0 is not None and t0 < tr["start"]:
                tr["start"] = t0
            # root = parentless span, or the proxy's ingress span (its
            # parent is a REMOTE span from the client's traceparent that
            # will never arrive here)
            if not event.get("parent_span_id") \
                    or (event.get("attributes") or {}).get("ingress"):
                tr["root"] = event
            root = tr["root"]
            if not tr["done"] and root is not None \
                    and root.get("end_time") is not None:
                self._complete(tid, tr)
            self._evict()
            self._cv.notify_all()

    def _complete(self, tid: str, tr: Dict[str, Any]) -> None:
        tr["done"] = True
        root = tr["root"]
        tr["end"] = root.get("end_time")
        reason = self._decide(tr)
        if reason is None:
            self._drop(tid, "sampled")
            return
        tr["keep_reason"] = reason
        self.kept_traces += 1
        self._completed.append(tid)

    def _decide(self, tr: Dict[str, Any]) -> Optional[str]:
        """Tail-sampling policy -> keep reason, or None to drop."""
        recovered = None
        for span in tr["spans"]:
            hit = _KEEP_ALWAYS_NAMES.get(span.get("name"))
            if hit:
                # a failover/preempt span's own error attribute is the
                # RECOVERED cause (the stream went on) — the trace only
                # classifies "error" when some other span failed
                recovered = recovered or hit
                continue
            attrs = span.get("attributes") or {}
            if attrs.get("error"):
                return "error"
        if recovered:
            return recovered
        root = tr["root"]
        dur = (root.get("end_time") or 0.0) - (root.get("time") or 0.0)
        attrs = root.get("attributes") or {}
        slow_s = attrs.get("slo_target")
        if not slow_s:
            # the per-deployment SLO rides the route span, not the root
            for span in tr["spans"]:
                slow_s = (span.get("attributes") or {}).get("slo_target")
                if slow_s:
                    break
        slow_s = slow_s or self._slow_s
        try:
            if dur > float(slow_s):
                return "slow"
        except (TypeError, ValueError):
            if dur > self._slow_s:
                return "slow"
        if self._rng.random() < self._sample_rate:
            return "sampled"
        return None

    def _drop(self, tid: str, reason: str) -> None:
        tr = self._traces.pop(tid, None)
        if tr is not None:
            self._bytes -= tr["bytes"]
        self._dropped[tid] = None
        while len(self._dropped) > _TOMBSTONES_MAX:
            self._dropped.popitem(last=False)
        self._count_drop(reason)

    def _count_drop(self, reason: str) -> None:
        if reason == "sampled":
            self.dropped_sampled += 1
        elif reason == "evicted":
            self.dropped_evicted += 1
        try:
            from ..util.tracing import TRACES_DROPPED
            TRACES_DROPPED.inc(tags={"reason": reason})
        except Exception:  # noqa: BLE001 — metrics must not break intake
            pass

    def _evict(self) -> None:
        # completed traces go first (oldest kept), then oldest active —
        # an in-flight trace is only sacrificed when nothing else remains
        while self._bytes > self._max_bytes and self._traces:
            if self._completed:
                tid = self._completed.popleft()
                self._base += 1
                if tid not in self._traces:
                    continue
            else:
                tid = next(iter(self._traces))
            self._drop(tid, "evicted")

    # ---- queries -------------------------------------------------------------

    def _summary(self, tid: str, tr: Dict[str, Any]) -> Dict[str, Any]:
        root = tr["root"] or (tr["spans"][0] if tr["spans"] else {})
        attrs = root.get("attributes") or {}
        deployment = attrs.get("deployment", "")
        session = attrs.get("session", "")
        request_id = attrs.get("request_id", "")
        for span in tr["spans"]:
            a = span.get("attributes") or {}
            deployment = deployment or a.get("deployment", "")
            session = session or a.get("session", "")
            request_id = request_id or a.get("request_id", "")
        end = tr["end"]
        return {"trace_id": tid, "name": root.get("name", ""),
                "start": tr["start"], "end": end,
                "duration_s": (end - (root.get("time") or tr["start"]))
                if end is not None else None,
                "spans": len(tr["spans"]),
                "procs": len({s.get("pid") for s in tr["spans"]}),
                "nodes": len({s.get("node_id") for s in tr["spans"]}),
                "done": tr["done"], "keep_reason": tr["keep_reason"],
                "deployment": deployment, "session": session,
                "request_id": request_id}

    @staticmethod
    def _matches(summ: Dict[str, Any], request_id: Optional[str],
                 session: Optional[str],
                 deployment: Optional[str]) -> bool:
        if request_id and not str(summ.get("request_id", "")).startswith(
                request_id):
            return False
        if session and summ.get("session") != session:
            return False
        if deployment and summ.get("deployment") != deployment:
            return False
        return True

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Full trace (summary + spans sorted by start) by exact id or
        unique hex prefix — CLI ergonomics like the state API."""
        with self._cv:
            tr = self._traces.get(trace_id)
            tid = trace_id
            if tr is None:
                hits = [t for t in self._traces if t.startswith(trace_id)]
                if len(hits) != 1:
                    return None
                tid = hits[0]
                tr = self._traces[tid]
            out = self._summary(tid, tr)
            out["spans_detail"] = sorted(
                (dict(s) for s in tr["spans"]),
                key=lambda s: s.get("time", 0.0))
        return out

    def query(self, request_id: Optional[str] = None,
              session: Optional[str] = None,
              deployment: Optional[str] = None,
              slowest: Optional[int] = None,
              since: Optional[int] = None,
              limit: int = 50,
              follow_timeout: Optional[float] = None) -> Dict[str, Any]:
        """-> {"traces": [summaries], "cursor": next_since}.

        Pages over *completed kept* traces in completion order (LogStore
        cursor semantics); without ``since``, the newest ``limit``
        matches (tail). ``slowest`` instead returns the N slowest kept
        traces by root duration. ``follow_timeout`` long-polls for the
        next matching completion."""
        import time as _time

        limit = max(1, int(limit))
        deadline = (None if not follow_timeout
                    else _time.monotonic() + float(follow_timeout))
        while True:
            with self._cv:
                base = self._base
                order = list(self._completed)
                tail = base + len(order)
                if since is None:
                    start = base
                    scan = order
                else:
                    start = max(base, int(since))
                    scan = order[start - base:]
                summs = {tid: self._summary(tid, self._traces[tid])
                         for tid in scan if tid in self._traces}
            out: List[Dict[str, Any]] = []
            if slowest is not None:
                cands = [s for s in summs.values()
                         if self._matches(s, request_id, session,
                                          deployment)
                         and s.get("duration_s") is not None]
                cands.sort(key=lambda s: -s["duration_s"])
                return {"traces": cands[:max(1, int(slowest))],
                        "cursor": tail}
            if since is None:
                cursor = tail
                for tid in reversed(scan):
                    s = summs.get(tid)
                    if s and self._matches(s, request_id, session,
                                           deployment):
                        out.append(s)
                        if len(out) >= limit:
                            break
                out.reverse()
            else:
                cursor = tail
                for i, tid in enumerate(scan):
                    s = summs.get(tid)
                    if s and self._matches(s, request_id, session,
                                           deployment):
                        out.append(s)
                        if len(out) >= limit:
                            cursor = start + i + 1
                            break
            if out or deadline is None:
                return {"traces": out, "cursor": cursor}
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return {"traces": out, "cursor": cursor}
            since = tail
            with self._cv:
                if self._base + len(self._completed) == tail:
                    self._cv.wait(remaining)

    def slowest_active(self) -> Optional[Dict[str, Any]]:
        """Oldest still-open trace (root span not yet ended) — surfaced
        in `ray_tpu_torch top` as the live tail-latency suspect."""
        import time as _time

        with self._cv:
            best = None
            for tid, tr in self._traces.items():
                if tr["done"]:
                    continue
                if best is None or tr["start"] < best[1]["start"]:
                    best = (tid, tr)
            if best is None:
                return None
            return {"trace_id": best[0], "name":
                    (best[1]["root"] or {}).get("name", "")
                    or (best[1]["spans"][0].get("name", "")
                        if best[1]["spans"] else ""),
                    "age_s": _time.time() - best[1]["start"]}

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            active = sum(1 for tr in self._traces.values()
                         if not tr["done"])
            return {"traces": len(self._traces), "active": active,
                    "bytes": self._bytes,
                    "total_traces": self.total_traces,
                    "kept_traces": self.kept_traces,
                    "dropped_sampled": self.dropped_sampled,
                    "dropped_evicted": self.dropped_evicted,
                    "cursor": self._base + len(self._completed)}
