"""Per-process, per-stage op-timing sink for the step profiler.

The cgraph executor records every iterative op's wall-clock span and
cumulative exec/bubble seconds here; ``_CGStage.update()`` — which runs
as the LAST op of each step on the SAME executor thread — drains the
stage's slice into its per-step report dict, so per-op timestamps reach
the driver over the existing report channel with no new RPC surface.

Single-threaded by construction (one executor thread per loaded graph,
and the drain happens inside an op of that very schedule), but guarded
by a lock anyway: two pipeline replicas on one worker process would
otherwise race the dict.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

__all__ = ["op_record", "bubble_record", "sync_record", "send_record",
           "stage_perf", "reset"]

_OPS_KEPT = 512  # per stage; a 4-microbatch step is ~10 ops


class _StageSink:
    __slots__ = ("exec_s", "bubble_s", "sync_s", "send_s", "ops")

    def __init__(self):
        self.exec_s = 0.0
        self.bubble_s = 0.0
        self.sync_s = 0.0   # collective sync-exposed (ZeRO legs, fsdp)
        self.send_s = 0.0   # encode + channel write (incl. backpressure)
        self.ops: deque = deque(maxlen=_OPS_KEPT)


_lock = threading.Lock()
_sinks: Dict[str, _StageSink] = {}


def _sink(stage: str) -> _StageSink:
    s = _sinks.get(stage)
    if s is None:
        with _lock:
            s = _sinks.setdefault(stage, _StageSink())
    return s


def op_record(stage: str, key: str, method: str,
              t0: float, t1: float) -> None:
    s = _sink(stage)
    s.exec_s += t1 - t0
    s.ops.append({"key": key, "method": method, "t0": t0, "t1": t1})


def bubble_record(stage: str, seconds: float) -> None:
    _sink(stage).bubble_s += seconds


def sync_record(stage: str, seconds: float) -> None:
    _sink(stage).sync_s += seconds


def send_record(stage: str, seconds: float) -> None:
    _sink(stage).send_s += seconds


def stage_perf(stage: str, drain_ops: bool = True) -> dict:
    """Cumulative totals (driver diffs across steps) + the op spans
    recorded since the last drain."""
    s = _sink(stage)
    with _lock:
        ops: List[dict] = list(s.ops)
        if drain_ops:
            s.ops.clear()
    return {"exec_s": s.exec_s, "bubble_s": s.bubble_s,
            "sync_s": s.sync_s, "send_s": s.send_s, "ops": ops}


def reset(stage: Optional[str] = None) -> None:
    with _lock:
        if stage is None:
            _sinks.clear()
        else:
            _sinks.pop(stage, None)
