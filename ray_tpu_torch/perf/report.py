"""StepReport: the structured result of a profiling run.

One class serves both hot paths — ``kind="pipeline"`` reports carry a
per-stage exec/bubble/recv/sync breakdown plus per-op spans;
``kind="llm"`` reports carry the per-step admit/prefill/decode/retire
phase split, batch-occupancy and KV-pressure series. Both carry
throughput (tokens/s), MFU when a flops estimate is available, a
chrome-trace export (perfetto-loadable, same event shapes as
``state.timeline()``) and ``suggest()`` tuning hints.

Analytic anchors (validated in tests/test_perf.py against synthetic
schedules):

- 1F1B bubble fraction: with P stages and M microbatches of equal cost,
  ``bubble_frac == (P - 1) / (M + P - 1)``.
- MFU: ``tokens_per_s * flops_per_token / peak_flops``.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["StepReport", "compute_mfu", "analytic_bubble_frac"]


def compute_mfu(tokens_per_s: float, flops_per_token: float,
                peak_flops: float) -> Optional[float]:
    """Model-flops utilization in [0, 1]; None when any input is
    missing/non-positive."""
    if not tokens_per_s or not flops_per_token or not peak_flops:
        return None
    if tokens_per_s <= 0 or flops_per_token <= 0 or peak_flops <= 0:
        return None
    return tokens_per_s * flops_per_token / peak_flops


def analytic_bubble_frac(num_stages: int, num_microbatches: int) -> float:
    """Ideal 1F1B pipeline bubble fraction: (P-1)/(M+P-1)."""
    p, m = int(num_stages), int(num_microbatches)
    if p < 1 or m < 1:
        raise ValueError(f"need P >= 1 and M >= 1, got P={p} M={m}")
    return (p - 1) / (m + p - 1)


@dataclass
class StepReport:
    """Everything ``profile(steps=N)`` measured, in one picklable bag.

    Times are milliseconds unless the field name says otherwise. Stage
    dicts: ``{"stage", "exec_ms", "bubble_ms", "recv_ms", "sync_ms",
    "update_ms", "ops": [{"key", "method", "t0", "t1"}, ...]}``.
    ``phases`` maps phase name -> total ms across the profiled steps
    (llm: admit/prefill/decode/retire; pipeline: compute/bubble/update).
    """

    kind: str = "pipeline"            # "pipeline" | "llm"
    engine: str = ""                  # gtag / engine id
    steps: int = 0
    wall_s: float = 0.0               # profiled window wall time
    step_ms: List[float] = field(default_factory=list)
    stages: List[dict] = field(default_factory=list)
    phases: Dict[str, float] = field(default_factory=dict)
    tokens: float = 0.0
    tokens_per_s: float = 0.0
    flops_per_token: float = 0.0
    peak_flops: float = 0.0
    num_stages: int = 0               # P
    num_microbatches: int = 0         # M
    occupancy: List[float] = field(default_factory=list)   # llm, per step
    kv_pressure: List[float] = field(default_factory=list)  # llm, per step
    events: List[dict] = field(default_factory=list)  # recorder drain
    extra: Dict[str, Any] = field(default_factory=dict)

    # -- derived -----------------------------------------------------------

    @property
    def mean_step_ms(self) -> float:
        return sum(self.step_ms) / len(self.step_ms) if self.step_ms \
            else 0.0

    @property
    def mfu(self) -> Optional[float]:
        return compute_mfu(self.tokens_per_s, self.flops_per_token,
                           self.peak_flops)

    @property
    def bubble_frac(self) -> Optional[float]:
        """Measured bubble fraction: summed recv-blocked time over
        summed busy+blocked time across stages. On the ideal 1F1B
        schedule this equals (P-1)/(M+P-1)."""
        ex = sum(s.get("exec_ms", 0.0) for s in self.stages)
        bub = sum(s.get("bubble_ms", 0.0) for s in self.stages)
        if ex + bub <= 0:
            return None
        return bub / (ex + bub)

    def phase_total_ms(self) -> float:
        return sum(self.phases.values())

    def phase_wall_ratio(self) -> Optional[float]:
        """phase-sum over measured step wall — the live-smoke acceptance
        gate asserts this lands within 10% of 1.0."""
        wall = sum(self.step_ms)
        if wall <= 0:
            return None
        return self.phase_total_ms() / wall

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "engine": self.engine, "steps": self.steps,
            "wall_s": self.wall_s, "step_ms": list(self.step_ms),
            "stages": self.stages, "phases": dict(self.phases),
            "tokens": self.tokens, "tokens_per_s": self.tokens_per_s,
            "flops_per_token": self.flops_per_token,
            "peak_flops": self.peak_flops, "mfu": self.mfu,
            "num_stages": self.num_stages,
            "num_microbatches": self.num_microbatches,
            "bubble_frac": self.bubble_frac,
            "mean_step_ms": self.mean_step_ms,
            "occupancy": list(self.occupancy),
            "kv_pressure": list(self.kv_pressure),
            "events": self.events, "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StepReport":
        keep = {k: d[k] for k in (
            "kind", "engine", "steps", "wall_s", "step_ms", "stages",
            "phases", "tokens", "tokens_per_s", "flops_per_token",
            "peak_flops", "num_stages", "num_microbatches", "occupancy",
            "kv_pressure", "events", "extra") if k in d}
        return cls(**keep)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        return path

    # -- chrome trace ------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Perfetto/chrome://tracing-loadable timeline: the same
        complete-slice shape ``state.timeline()`` emits (``ph:"X"``,
        ``ts``/``dur`` in microseconds), one pid per stage/engine, one
        tid lane per event source."""
        out: List[dict] = []
        t0 = math.inf
        for st in self.stages:
            for op in st.get("ops", ()):
                t0 = min(t0, op.get("t0", math.inf))
        for ev in self.events:
            t0 = min(t0, ev.get("ts", math.inf))
        if not math.isfinite(t0):
            t0 = 0.0

        def us(t: float) -> float:
            return round((t - t0) * 1e6, 1)

        pid = self.engine or self.kind
        for st in self.stages:
            tid = f"stage {st.get('stage', '?')}"
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": tid}})
            for op in st.get("ops", ()):
                if "t0" not in op or "t1" not in op:
                    continue
                out.append({
                    "name": op.get("key") or op.get("method", "op"),
                    "cat": "cgraph", "ph": "X", "ts": us(op["t0"]),
                    "dur": max(0.1, round((op["t1"] - op["t0"]) * 1e6, 1)),
                    "pid": pid, "tid": tid,
                    "args": {"method": op.get("method", "")}})
        for ev in self.events:
            # recorder begin/end pairs were already folded into ops by
            # the profiler; whatever remains renders as instants
            out.append({
                "name": f"{ev.get('kind', 'event')} {ev.get('label', '')}"
                        .strip(),
                "cat": "flightrec", "ph": "i", "s": "p",
                "ts": us(ev.get("ts", t0)), "pid": pid,
                "tid": "events", "args": ev.get("data") or {}})
        # per-step phase lanes (llm) / aggregate lanes (pipeline)
        cursor = 0.0
        for name, ms in sorted(self.phases.items()):
            out.append({
                "name": name, "cat": "phase", "ph": "X", "ts": cursor,
                "dur": max(0.1, round(ms * 1e3, 1)), "pid": pid,
                "tid": "phases (total ms)", "args": {"total_ms": ms}})
            cursor += max(0.1, ms * 1e3)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"engine": self.engine, "kind": self.kind,
                              "steps": self.steps}}

    # -- tuning hints ------------------------------------------------------

    def suggest(self) -> List[str]:
        """Microbatch/interleave tuning hints — the profile-driven
        tuning prerequisite for the overlap-scheduling arc."""
        hints: List[str] = []
        b = self.bubble_frac
        p, m = self.num_stages, self.num_microbatches
        if self.kind == "pipeline":
            if b is not None and p > 1 and m >= 1:
                ideal = analytic_bubble_frac(p, m)
                if b > 0.20:
                    target = 0.10
                    m_new = max(m + 1,
                                math.ceil((p - 1) * (1 - target) / target))
                    hints.append(
                        f"bubble fraction {b:.2f} (ideal {ideal:.2f} at "
                        f"P={p}, M={m}): raise microbatches to M={m_new} "
                        f"to push the 1F1B bubble under {target:.0%}")
                elif b < 0.05 and m > 2 * p:
                    hints.append(
                        f"bubble fraction {b:.2f} is already small at "
                        f"M={m}: reduce M toward {2 * p} to cut "
                        f"per-step latency and activation memory")
                if b > 1.5 * ideal + 0.05:
                    hints.append(
                        f"measured bubble {b:.2f} exceeds the analytic "
                        f"1F1B floor {ideal:.2f}: stages are imbalanced "
                        f"or recv-starved — rebalance layers_per_stage "
                        f"or interleave")
            sync = sum(s.get("sync_ms", 0.0) for s in self.stages)
            ex = sum(s.get("exec_ms", 0.0) for s in self.stages)
            if ex > 0 and sync > 0.15 * ex:
                hints.append(
                    f"collective sync-exposed time is "
                    f"{sync / ex:.0%} of compute: overlap the ZeRO "
                    f"reduce-scatter/all-gather legs with backward")
        else:
            occ = (sum(self.occupancy) / len(self.occupancy)
                   if self.occupancy else None)
            cap = float(self.extra.get("max_batch") or 0)
            if occ is not None and cap and occ < 0.5 * cap:
                hints.append(
                    f"mean batch occupancy {occ:.1f} of {cap:.0f}: the "
                    f"engine is admission-starved — raise arrival "
                    f"concurrency or shrink max_batch")
            if self.kv_pressure and max(self.kv_pressure) > 0.9:
                hints.append(
                    f"KV pressure peaked at "
                    f"{max(self.kv_pressure):.0%}: provision more KV "
                    f"blocks or expect preemptions")
            pre = self.phases.get("prefill", 0.0)
            tot = self.phase_total_ms()
            if tot > 0 and pre > 0.5 * tot:
                hints.append(
                    f"prefill is {pre / tot:.0%} of engine step time: "
                    f"chunked prefill would cap decode stalls")
        if not hints:
            hints.append("no obvious tuning headroom at this schedule")
        return hints
