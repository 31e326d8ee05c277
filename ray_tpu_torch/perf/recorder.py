"""Flight recorder: an always-on, bounded, lock-light per-process ring
of structured runtime events.

Design constraints (ISSUE 17 tentpole b):

- **Always on, bounded.** The ring is a ``collections.deque(maxlen=N)``
  — append is O(1), thread-safe under the GIL, and the oldest event is
  dropped implicitly on overflow. Capacity defaults to
  ``RAY_TPU_FLIGHTREC_CAP`` (4096 events); at ~120 bytes/event the
  steady-state footprint is sub-megabyte per process.
- **Lock-light.** ``record()`` takes no lock: one enabled-flag test, a
  tuple build, a deque append, and a non-atomic length check for the
  drop counter. The drop count is reconciled exactly in ``snapshot()``
  (appended minus retained), so the occasional racy fast-path
  undercount never survives a drain; the reconciled total feeds
  ``ray_tpu_flightrec_dropped_total``.
- **Structured.** Events are ``(ts, kind, label, data)`` tuples —
  ``ts`` is ``time.time()`` (wall clock, so driver+worker rings merge
  on one axis), ``kind`` is a short dotted string from the table in
  docs/OBSERVABILITY.md (``cgraph.op.begin``, ``chan.send``,
  ``llm.admit``, ...), ``label`` identifies the instance (op key,
  channel id, request id) and ``data`` is a small dict or None.

Host modules (cgraph executor, channels, engines) hold a module-level
``_FLREC`` pointing at the process singleton — the chaos-layer hook
pattern — and guard every record with ``if _FLREC.enabled`` so the
disabled A/B leg pays one attribute load.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..util import metrics as _metrics

__all__ = ["FlightRecorder", "get_recorder", "record",
           "recorder_enabled", "set_enabled", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = int(os.environ.get("RAY_TPU_FLIGHTREC_CAP", "4096"))

_C_DROPPED = _metrics.Counter(
    "ray_tpu_flightrec_dropped_total",
    "flight-recorder ring events dropped (oldest-first) on overflow")


class FlightRecorder:
    """One process's event ring. ``record()`` is the hot path; all
    bookkeeping that needs exactness happens in ``snapshot()``."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: Optional[bool] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._appended = 0          # racy-fast increments; see snapshot()
        self._dropped_flushed = 0   # drops already shipped to the metric
        self._snap_lock = threading.Lock()
        if enabled is None:
            enabled = os.environ.get("RAY_TPU_FLIGHTREC", "1") != "0"
        self.enabled = bool(enabled)

    # -- hot path ----------------------------------------------------------

    def record(self, kind: str, label: str = "",
               data: Optional[Dict[str, Any]] = None) -> None:
        """Append one event. No lock: deque.append is GIL-atomic, and the
        ``_appended`` increment may rarely lose a tick under contention —
        acceptable, because ``snapshot()`` recomputes the drop total from
        retained length and never reports fewer drops than really
        happened after a drain."""
        if not self.enabled:
            return
        self._ring.append((time.time(), kind, label, data))
        self._appended += 1

    # -- drain / accounting ------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events lost to overflow so far (monotone, reconciled)."""
        return max(0, self._appended - len(self._ring))

    def snapshot(self, clear: bool = False) -> List[dict]:
        """Drain the ring into a list of wire-safe dicts (oldest first)
        and flush the drop delta into
        ``ray_tpu_flightrec_dropped_total``."""
        with self._snap_lock:
            events = list(self._ring)
            dropped = self.dropped  # BEFORE clear: drained events are
            if clear:               # delivered, not dropped
                self._ring.clear()
                # keep the drop ledger: with the ring empty, appended
                # minus retained must still equal the historic total
                self._appended = dropped
            delta = dropped - self._dropped_flushed
            if delta > 0:
                _C_DROPPED.inc(delta)
                self._dropped_flushed += delta
        return [{"ts": ts, "kind": kind, "label": label,
                 "data": data} for ts, kind, label, data in events]

    def stats(self) -> dict:
        return {"capacity": self.capacity, "size": len(self._ring),
                "appended": self._appended, "dropped": self.dropped,
                "enabled": self.enabled}


# ---------------------------------------------------------------------------
# process singleton
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_GLOBAL: Optional[FlightRecorder] = None


def get_recorder() -> FlightRecorder:
    global _GLOBAL
    rec = _GLOBAL
    if rec is None:
        with _LOCK:
            rec = _GLOBAL
            if rec is None:
                rec = _GLOBAL = FlightRecorder()
    return rec


def record(kind: str, label: str = "",
           data: Optional[Dict[str, Any]] = None) -> None:
    """Module-level convenience for cold paths (admissions, placements,
    aborts). Hot loops should cache ``get_recorder()`` in a module
    global instead."""
    get_recorder().record(kind, label, data)


def recorder_enabled() -> bool:
    return get_recorder().enabled


def set_enabled(on: bool) -> None:
    """Flip the process recorder (the bench A/B switch). Events already
    in the ring stay; only future records are gated."""
    get_recorder().enabled = bool(on)
