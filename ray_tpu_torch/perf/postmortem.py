"""Post-mortem bundles: every abort path drains the flight-recorder
rings (driver + whatever workers are still reachable) into one merged
JSON bundle on disk, rendered by ``ray_tpu_torch postmortem <bundle>``.

A bundle is ``{"reason", "origin", "time", "rings": {proc: [events]},
"meta": {...}}`` where each event is the recorder's wire shape
(``{"ts", "kind", "label", "data"}``). Rendering merges rings on the
wall-clock axis and flags ``*.begin`` events with no matching ``*.end``
— on a mid-step stage kill, the killed op surfaces as exactly such a
dangling begin (asserted in tests/test_perf.py).

Dumps are throttled per ``(origin, reason)`` so a poison that fans out
through step()/teardown/abort produces one bundle, not three.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from ..util import metrics as _metrics
from .recorder import get_recorder

__all__ = ["bundle_dir", "dump_bundle", "load_bundle", "render_bundle",
           "last_bundle_path", "find_dangling"]

_C_BUNDLES = _metrics.Counter(
    "ray_tpu_postmortem_bundles_total",
    "post-mortem flight-recorder bundles dumped", tag_keys=("origin",))

_THROTTLE_S = 10.0
_lock = threading.Lock()
_recent: Dict[tuple, float] = {}
_last_path: Optional[str] = None
_seq = 0  # disambiguates same-millisecond dumps from one process


def bundle_dir() -> str:
    d = os.environ.get("RAY_TPU_POSTMORTEM_DIR")
    if not d:
        d = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_postmortem")
    os.makedirs(d, exist_ok=True)
    return d


def dump_bundle(reason: str, origin: str = "driver",
                extra_rings: Optional[Dict[str, List[dict]]] = None,
                ring_fetchers: Optional[
                    Dict[str, Callable[[], List[dict]]]] = None,
                meta: Optional[dict] = None,
                throttle: bool = True) -> Optional[str]:
    """Write one merged bundle and return its path (None when
    throttled). ``extra_rings`` are pre-drained event lists keyed by
    process label; ``ring_fetchers`` are best-effort callables (worker
    RPCs) — a fetcher that raises contributes an error marker instead of
    killing the dump, because the abort being recorded may be the very
    thing that made the worker unreachable."""
    global _last_path, _seq
    key = (origin, reason.split(":", 1)[0])
    now = time.monotonic()
    if throttle:
        with _lock:
            last = _recent.get(key, -1e18)
            if now - last < _THROTTLE_S:
                return None
            _recent[key] = now
    rings: Dict[str, List[dict]] = {
        origin: get_recorder().snapshot(clear=False)}
    for proc, events in (extra_rings or {}).items():
        rings[proc] = list(events or ())
    for proc, fetch in (ring_fetchers or {}).items():
        try:
            rings[proc] = list(fetch() or ())
        except Exception as e:
            rings[proc] = [{"ts": time.time(), "kind": "postmortem.fetch_error",
                            "label": proc, "data": {"error": repr(e)}}]
    bundle = {"reason": reason, "origin": origin, "time": time.time(),
              "rings": rings, "meta": meta or {}}
    with _lock:
        _seq += 1
        seq = _seq
    fname = (f"postmortem-{int(time.time() * 1000)}"
             f"-{os.getpid()}-{seq}.json")
    path = os.path.join(bundle_dir(), fname)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    with _lock:
        _last_path = path
    _C_BUNDLES.inc(tags={"origin": origin})
    return path


def last_bundle_path() -> Optional[str]:
    with _lock:
        return _last_path


def load_bundle(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_dangling(bundle: dict) -> List[dict]:
    """``*.begin`` events with no later matching ``*.end`` for the same
    (process, event family, label) — in-flight work at the moment of
    death."""
    dangling: List[dict] = []
    for proc, events in sorted(bundle.get("rings", {}).items()):
        open_ops: Dict[tuple, dict] = {}
        for ev in events:
            kind = ev.get("kind", "")
            if kind.endswith(".begin"):
                open_ops[(kind[:-6], ev.get("label", ""))] = ev
            elif kind.endswith(".end"):
                open_ops.pop((kind[:-4], ev.get("label", "")), None)
        for (fam, label), ev in open_ops.items():
            dangling.append({"proc": proc, "family": fam, "label": label,
                             "ts": ev.get("ts", 0.0),
                             "data": ev.get("data")})
    dangling.sort(key=lambda d: (d["ts"], d["proc"], d["label"]))
    return dangling


def render_bundle(bundle: dict, tail: int = 40) -> str:
    """Human-readable post-mortem: header, dangling ops, then the last
    ``tail`` merged events. Deterministic for a fixed bundle (golden
    tested) — timestamps render relative to the earliest event."""
    rings = bundle.get("rings", {})
    merged = [dict(ev, proc=proc) for proc, events in sorted(rings.items())
              for ev in events]
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("proc", "")))
    t0 = merged[0].get("ts", 0.0) if merged else 0.0
    lines = []
    lines.append("== post-mortem bundle ==")
    lines.append(f"reason : {bundle.get('reason', '?')}")
    lines.append(f"origin : {bundle.get('origin', '?')}")
    lines.append(f"rings  : " + ", ".join(
        f"{proc}({len(events)})" for proc, events in sorted(rings.items()))
        if rings else "rings  : (none)")
    for k, v in sorted((bundle.get("meta") or {}).items()):
        lines.append(f"meta   : {k} = {v}")
    dangling = find_dangling(bundle)
    lines.append("")
    if dangling:
        lines.append(f"-- in-flight at death ({len(dangling)}) --")
        for d in dangling:
            lines.append(f"  ! {d['proc']:<12} {d['family']:<18} "
                         f"{d['label']} (began +{d['ts'] - t0:.3f}s)")
    else:
        lines.append("-- in-flight at death: none --")
    lines.append("")
    shown = merged[-tail:]
    lines.append(f"-- last {len(shown)} of {len(merged)} events --")
    for ev in shown:
        data = ev.get("data")
        suffix = f"  {data}" if data else ""
        lines.append(f"  +{ev.get('ts', 0.0) - t0:9.3f}s "
                     f"{ev.get('proc', '?'):<12} "
                     f"{ev.get('kind', '?'):<22} "
                     f"{ev.get('label', '')}{suffix}")
    return "\n".join(lines)
