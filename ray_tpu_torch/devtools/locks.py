"""Debug-mode lock instrumentation for the multi-threaded core runtime.

The reference ships whole C++ subsystems for this hazard class (TSAN
wiring, ABSL lock annotations, ``debug/lock_debug.h``); a pure-Python
runtime gets no compiler help, so this module provides the runtime half
of graftcheck: an ``instrumented_lock()`` factory the core's hot locks
are built from.

With ``RAY_TPU_DEBUG_LOCKS`` unset (the default) the factory returns a
plain ``threading.Lock``/``RLock`` — zero overhead on the hot path. With
``RAY_TPU_DEBUG_LOCKS=1`` it returns an :class:`InstrumentedLock` that

- records, per thread, the stack of currently-held instrumented locks
  and the call site of each acquisition;
- maintains a global acquired-while-holding order graph between lock
  *roles* (the names passed to ``instrumented_lock``) and reports a
  **lock-order inversion** the first time an acquisition closes a cycle
  in that graph (the classic AB/BA deadlock precondition — reported with
  both acquisition stacks, without needing the deadlock to strike);
- reports **long holds**: a lock held longer than
  ``RAY_TPU_LOCK_HOLD_WARN_S`` seconds (default 1.0) — a latency smell in
  a runtime whose scheduler and object directory sit behind these locks.

Reports flow through the existing observability path: they are appended
to a bounded in-process buffer (``get_lock_reports()``), logged via the
``ray_tpu_torch.devtools.locks`` logger, and — when a runtime is up — pushed
into the GCS task-event stream, where they surface in the dashboard
timeline and as ``ray_tpu_task_events_total{state="LOCK_..."}`` in
/metrics.
"""
from __future__ import annotations

import atexit
import collections
import logging
import os
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple

logger = logging.getLogger("ray_tpu_torch.devtools.locks")

_TRUTHY = ("1", "true", "on", "yes")


def debug_locks_enabled() -> bool:
    return os.environ.get("RAY_TPU_DEBUG_LOCKS", "").lower() in _TRUTHY


def _hold_warn_threshold() -> float:
    try:
        return float(os.environ.get("RAY_TPU_LOCK_HOLD_WARN_S", "1.0"))
    except ValueError:
        return 1.0


@dataclass
class LockReport:
    """One detected hazard (inversion or long hold)."""

    kind: str  # "lock-order-inversion" | "long-hold"
    message: str
    thread: str
    locks: Tuple[str, ...]
    stacks: Dict[str, str] = field(default_factory=dict)
    time: float = field(default_factory=time.time)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "message": self.message,
                "thread": self.thread, "locks": list(self.locks),
                "stacks": dict(self.stacks), "time": self.time}


class _Registry:
    """Process-global detector state (order graph + report buffer).

    A single plain Lock guards everything; instrumented locks never call
    back into the registry while holding it, so the registry lock cannot
    itself participate in an inversion.
    """

    def __init__(self):
        self._mu = threading.Lock()
        # role -> roles acquired while holding it (order graph edges)
        self._edges: Dict[str, Set[str]] = collections.defaultdict(set)
        # (held_role, acquired_role) -> acquisition stack that created it
        self._edge_sites: Dict[Tuple[str, str], str] = {}
        self._reported_cycles: Set[frozenset] = set()
        self.reports: Deque[LockReport] = collections.deque(maxlen=256)
        # GCS publications deferred while the reporting thread still holds
        # instrumented locks (publishing acquires the instrumented GCS
        # lock — doing that from inside a critical section would extend
        # the hold being diagnosed and inject instrumentation edges into
        # the order graph)
        self._pending_gcs: Deque[LockReport] = collections.deque(maxlen=256)
        self._tls = threading.local()

    # ---- per-thread held-lock stack -------------------------------------

    def held_stack(self) -> List[dict]:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    # ---- order graph ----------------------------------------------------

    def _path_exists(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS: a src -> ... -> dst chain in the order graph, if any."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            cur, path = stack.pop()
            for nxt in self._edges.get(cur, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_acquisition(self, role: str, stack_str: str,
                         held: List[dict]) -> None:
        """Record edges held-role -> role; report on closing a cycle."""
        report: Optional[LockReport] = None
        with self._mu:
            for h in held:
                hrole = h["role"]
                if hrole == role:
                    continue  # same role (reentrant or sibling instance)
                cycle = self._path_exists(role, hrole)
                new_edge = role not in self._edges[hrole]
                if new_edge:
                    self._edges[hrole].add(role)
                    self._edge_sites[(hrole, role)] = stack_str
                if cycle is not None:
                    key = frozenset(cycle) | {role}
                    if key in self._reported_cycles:
                        continue
                    self._reported_cycles.add(key)
                    chain = " -> ".join(cycle + [role])
                    prior = self._edge_sites.get((cycle[0], cycle[1])
                                                 if len(cycle) > 1 else
                                                 (hrole, role), "")
                    report = LockReport(
                        kind="lock-order-inversion",
                        message=(f"lock-order inversion: acquiring '{role}' "
                                 f"while holding '{hrole}' closes the cycle "
                                 f"{chain} (opposite order seen earlier)"),
                        thread=threading.current_thread().name,
                        locks=tuple(cycle + [role]),
                        stacks={"this_acquisition": stack_str,
                                "holding_site": h.get("stack", ""),
                                "prior_order_site": prior},
                    )
        if report is not None:
            self._emit(report)

    def note_long_hold(self, role: str, held_for: float,
                       stack_str: str) -> None:
        report = LockReport(
            kind="long-hold",
            message=(f"lock '{role}' held for {held_for:.3f}s "
                     f"(threshold {_hold_warn_threshold():.3f}s)"),
            thread=threading.current_thread().name,
            locks=(role,),
            stacks={"acquisition": stack_str},
        )
        self._emit(report)

    # ---- reporting ------------------------------------------------------

    def _emit(self, report: LockReport) -> None:
        with self._mu:
            self.reports.append(report)
        logger.warning("%s [thread=%s]", report.message, report.thread)
        if self.held_stack():
            # inside a critical section: defer the GCS write (it acquires
            # the instrumented GCS lock) until this thread drops its last
            # instrumented lock
            with self._mu:
                self._pending_gcs.append(report)
        else:
            self._publish_gcs(report)

    def flush_pending_gcs(self) -> None:
        """Publish reports deferred while their thread held locks."""
        while True:
            with self._mu:
                if not self._pending_gcs:
                    return
                report = self._pending_gcs.popleft()
            self._publish_gcs(report)

    def _publish_gcs(self, report: LockReport) -> None:
        # observability path: ride the GCS task-event stream so the hazard
        # shows up in the dashboard timeline and /metrics event counters
        try:
            from ..core import runtime as _runtime_mod

            rt = _runtime_mod.maybe_runtime()
            gcs = getattr(rt, "gcs", None)
            if gcs is not None:
                gcs.add_task_event({
                    "task_id": "",
                    "name": report.message,
                    "state": ("LOCK_INVERSION"
                              if report.kind == "lock-order-inversion"
                              else "LOCK_LONG_HOLD"),
                    "time": report.time,
                })
        except Exception:
            pass

    def snapshot(self) -> List[LockReport]:
        with self._mu:
            return list(self.reports)

    def order_edges(self) -> List[Tuple[str, str]]:
        with self._mu:
            return sorted((held, acq)
                          for held, acqs in self._edges.items()
                          for acq in acqs)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._edge_sites.clear()
            self._reported_cycles.clear()
            self.reports.clear()
            self._pending_gcs.clear()
        self._tls = threading.local()


_registry = _Registry()


def get_lock_reports() -> List[LockReport]:
    """All hazards detected so far in this process (bounded buffer)."""
    return _registry.snapshot()


def reset_lock_state() -> None:
    """Clear the order graph and report buffer (test isolation)."""
    _registry.reset()


def get_order_edges() -> List[Tuple[str, str]]:
    """The observed role-level order graph as (held, acquired) edges.

    This is the dynamic twin of graftcheck's static lock-order graph
    (``graftcheck locks``); ``scripts/locks_gate.py`` asserts every edge
    observed here is predicted by the static graph.
    """
    return _registry.order_edges()


def _dump_order_edges() -> None:
    """atexit hook: append observed edges to RAY_TPU_LOCK_ORDER_DUMP.

    Runs in every process (workers included — they import this module
    when building their locks), so the gate sees the union of edges
    across the whole process tree. O_APPEND keeps concurrent writers
    from interleaving mid-line.
    """
    path = os.environ.get("RAY_TPU_LOCK_ORDER_DUMP", "")
    if not path:
        return
    edges = _registry.order_edges()
    if not edges:
        return
    payload = "".join(f"{held} -> {acq}\n" for held, acq in edges)
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, payload.encode())
        finally:
            os.close(fd)
    except OSError:
        pass


if os.environ.get("RAY_TPU_LOCK_ORDER_DUMP"):
    atexit.register(_dump_order_edges)


def _capture_stack(skip: int = 2, limit: int = 8) -> str:
    frames = traceback.extract_stack(limit=limit + skip)[:-skip]
    return "".join(traceback.format_list(frames))


class InstrumentedLock:
    """Drop-in Lock/RLock replacement that feeds the hazard detectors.

    Only constructed when ``RAY_TPU_DEBUG_LOCKS`` is set; the factory
    below hands back raw ``threading`` locks otherwise.
    """

    __slots__ = ("_role", "_lock", "_reentrant")

    def __init__(self, role: str, reentrant: bool = False):
        self._role = role
        self._reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    @property
    def role(self) -> str:
        return self._role

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # the wrapper IS the lock: release flows through self.release()
        # graftcheck: disable=GC006,GC030
        got = self._lock.acquire(blocking, timeout)
        if not got:
            return False
        held = _registry.held_stack()
        me = id(self)
        for h in held:
            if h["instance"] == me:
                h["count"] += 1  # reentrant re-acquire: no new edges
                return True
        stack_str = _capture_stack()
        _registry.note_acquisition(self._role, stack_str, held)
        held.append({"role": self._role, "instance": me, "count": 1,
                     "t0": time.monotonic(), "stack": stack_str})
        return True

    def release(self) -> None:
        held = _registry.held_stack()
        me = id(self)
        entry = None
        for i in range(len(held) - 1, -1, -1):
            if held[i]["instance"] == me:
                held[i]["count"] -= 1
                if held[i]["count"] == 0:
                    entry = held.pop(i)
                break
        # release FIRST: the report path must not run inside (and extend)
        # the critical section it is diagnosing
        self._lock.release()
        if entry is not None:
            dur = time.monotonic() - entry["t0"]
            if dur > _hold_warn_threshold():
                _registry.note_long_hold(self._role, dur, entry["stack"])
        if not held:
            _registry.flush_pending_gcs()

    def locked(self) -> bool:
        if self._reentrant:
            # RLock has no locked(); try-acquire probe
            if self._lock.acquire(blocking=False):
                self._lock.release()
                return False
            return True
        return self._lock.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "RLock" if self._reentrant else "Lock"
        return f"<InstrumentedLock {kind} role={self._role!r}>"


def instrumented_lock(role: str, reentrant: bool = False):
    """Factory for the core runtime's hot locks.

    ``role`` names the lock's job (e.g. ``"runtime.driver"``) — the
    order graph is built between roles, so every instance of a role
    shares one node. Returns a plain ``threading.Lock``/``RLock`` unless
    ``RAY_TPU_DEBUG_LOCKS=1``.
    """
    if not debug_locks_enabled():
        return threading.RLock() if reentrant else threading.Lock()
    return InstrumentedLock(role, reentrant=reentrant)
