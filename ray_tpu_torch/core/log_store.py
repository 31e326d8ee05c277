"""Head-side attributed log store — the GCS log plane.

Equivalent of the reference's log aggregation surface (ref:
dashboard/modules/log/log_manager.py + the `ray logs` state API): every
worker's stdout/stderr/structured-log lines arrive as attributed records
and land here, indexed by job/task/actor/worker/node, under a byte
budget (oldest-first eviction, counted). Readers page with a monotonic
``cursor`` and can *follow*: a query with ``follow_timeout`` long-polls
on a condition variable until matching records arrive — the primitive
under ``ray_tpu_torch logs --follow`` and the dashboard's live log tab.

Record schema (all values wire-primitive)::

    {ts, node_id, worker_id, pid, job_id, task_id, actor_id,
     stream, level, seq, line}
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

# accounting overhead per record beyond the line text (dict + id hexes)
_REC_OVERHEAD = 160

_ERROR_LEVELS = ("WARNING", "ERROR", "CRITICAL", "FATAL")


class LogStore:
    def __init__(self, max_bytes: int = 16 * 1024 * 1024):
        self._max_bytes = int(max_bytes)
        self._cv = threading.Condition()
        self._recs: deque = deque()
        self._base = 0          # cursor of _recs[0]
        self._bytes = 0
        self.total_lines = 0
        self.evicted_lines = 0

    # ---- ingest --------------------------------------------------------------

    def append(self, records: List[Dict[str, Any]]) -> None:
        if not records:
            return
        with self._cv:
            for rec in records:
                self._recs.append(rec)
                self._bytes += len(rec.get("line", "")) + _REC_OVERHEAD
                self.total_lines += 1
            while self._bytes > self._max_bytes and self._recs:
                old = self._recs.popleft()
                self._base += 1
                self._bytes -= len(old.get("line", "")) + _REC_OVERHEAD
                self.evicted_lines += 1
            self._cv.notify_all()

    # ---- queries -------------------------------------------------------------

    @staticmethod
    def _matches(rec: Dict[str, Any],
                 job_id: Optional[str], task_id: Optional[str],
                 actor_id: Optional[str], worker_id: Optional[str],
                 node_id: Optional[str], stream: Optional[str],
                 errors_only: bool) -> bool:
        # id filters match on hex prefixes (CLI ergonomics, like the
        # reference's state API)
        if job_id and not str(rec.get("job_id", "")).startswith(job_id):
            return False
        if task_id and not str(rec.get("task_id", "")).startswith(task_id):
            return False
        if actor_id and not str(rec.get("actor_id", "")).startswith(actor_id):
            return False
        if worker_id and not str(rec.get("worker_id", "")).startswith(
                worker_id):
            return False
        if node_id and not str(rec.get("node_id", "")).startswith(node_id):
            return False
        if stream and rec.get("stream") != stream:
            return False
        if errors_only and rec.get("stream") != "stderr" \
                and rec.get("level", "") not in _ERROR_LEVELS:
            return False
        return True

    def query(self, job_id: Optional[str] = None,
              task_id: Optional[str] = None,
              actor_id: Optional[str] = None,
              worker_id: Optional[str] = None,
              node_id: Optional[str] = None,
              stream: Optional[str] = None,
              errors_only: bool = False,
              since: Optional[int] = None,
              limit: int = 500,
              follow_timeout: Optional[float] = None) -> Dict[str, Any]:
        """-> {"records": [...], "cursor": next_since}.

        ``since`` is the cursor returned by the previous call (records at
        positions >= since are scanned); with ``follow_timeout`` the call
        long-polls until a matching record lands past ``since`` or the
        timeout expires. Without ``since``, the newest ``limit`` matches
        are returned (tail semantics)."""
        import itertools as _it
        import time as _time

        limit = max(1, int(limit))
        deadline = (None if not follow_timeout
                    else _time.monotonic() + float(follow_timeout))
        while True:
            # snapshot under the lock, FILTER OUTSIDE it: a sparse filter
            # over a full store must not stall every ingest for its scan
            with self._cv:
                base = self._base
                if since is None:
                    recs = list(self._recs)
                    start = base
                else:
                    start = max(base, int(since))
                    recs = list(_it.islice(self._recs, start - base,
                                           None))
                tail = base + len(self._recs)
            out: List[Dict[str, Any]] = []
            if since is None:
                # tail semantics: newest matches first, restore order
                cursor = tail
                for rec in reversed(recs):
                    if self._matches(rec, job_id, task_id, actor_id,
                                     worker_id, node_id, stream,
                                     errors_only):
                        out.append(rec)
                        if len(out) >= limit:
                            break
                out.reverse()
            else:
                # paging: when the limit cuts the scan short, the cursor
                # points at the NEXT unscanned record — a follower never
                # skips the remainder of a burst
                cursor = tail
                for i, rec in enumerate(recs):
                    if self._matches(rec, job_id, task_id, actor_id,
                                     worker_id, node_id, stream,
                                     errors_only):
                        out.append(rec)
                        if len(out) >= limit:
                            cursor = start + i + 1
                            break
            if out or deadline is None:
                return {"records": out, "cursor": cursor}
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return {"records": out, "cursor": cursor}
            # everything up to `tail` was judged non-matching; sleep
            # until new records land (re-check under the lock so a
            # record that arrived after the snapshot is not missed)
            since = tail
            with self._cv:
                if self._base + len(self._recs) == tail:
                    self._cv.wait(remaining)

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"lines": len(self._recs), "bytes": self._bytes,
                    "total_lines": self.total_lines,
                    "evicted_lines": self.evicted_lines,
                    "cursor": self._base + len(self._recs)}
