"""Worker/driver log plane — capture, attribution, batching, mirroring.

Equivalent of the reference's log pipeline (ref:
python/ray/_private/log_monitor.py tails worker log files to the driver;
python/ray/_private/ray_logging.py structured worker logging). Here the
lines never touch disk: every worker process funnels stdout/stderr plus
the ``ray_tpu_torch.logger`` structured channel through a :class:`LogBatcher`
that stamps each line with ``{stream, seq, ts, job_id, task_id,
actor_id, level}`` — attribution read from the worker's current-task
contextvar at *write* time, so interleaved async-actor lines never
mis-attribute — and ships bounded batches over the existing RPC channel.
Shipping is strictly non-blocking and rate-limited: past the budget,
lines are dropped and counted (``ray_tpu_logs_dropped_total``), never
buffered unboundedly and never allowed to stall the task.

The head ingests batches into the GCS :class:`~ray_tpu_torch.core.log_store.
LogStore` and mirrors remote workers' lines onto the driver console with
a per-worker colored ``(worker pid=..., node=...)`` prefix and
repeated-line dedup (:class:`DriverMirror` — the ``log_to_driver``
analog of the reference's log_monitor -> driver mirroring).
"""
from __future__ import annotations

import logging as _pylogging
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import metrics as _metrics

# stream names a record can carry; "log" is the structured logger channel
STREAMS = ("stdout", "stderr", "log")

LINES_TOTAL = _metrics.Counter(
    "ray_tpu_logs_lines_total",
    "log lines ingested into the head's attributed log store",
    tag_keys=("stream",))
DROPPED_TOTAL = _metrics.Counter(
    "ray_tpu_logs_dropped_total",
    "log lines dropped before reaching the head (rate limit, channel "
    "loss, store eviction)", tag_keys=("reason",))

# wire shape of one line inside a worker_log batch (a list, not a dict:
# a batch of hundreds of lines should not re-ship the key strings)
# [stream, seq, ts, job_id, task_id, actor_id, level, line]
REC_STREAM, REC_SEQ, REC_TS, REC_JOB, REC_TASK, REC_ACTOR, REC_LEVEL, \
    REC_LINE = range(8)


class LogBatcher:
    """Per-process accumulator for outbound log lines.

    ``emit()`` is called from arbitrary task/user threads (via the
    stdout/stderr tees and the structured logger handler); it stamps
    attribution + a per-stream monotonic ``seq`` and buffers. A flush —
    triggered by size, by the background timer, or explicitly — hands
    one wire payload to ``send`` (a channel ``notify``: enqueue-only,
    never blocking). A token-bucket rate limiter drops (and counts)
    lines over budget instead of ever blocking the writer.
    """

    def __init__(self, send: Callable[[dict], None],
                 task_ids: Optional[Callable[[], Tuple[str, str, str]]] = None,
                 batch_lines: int = 200,
                 flush_interval_s: float = 0.2,
                 rate_lines_per_s: float = 2000.0,
                 start_thread: bool = True):
        self._send = send
        self._task_ids = task_ids or (lambda: ("", "", ""))
        self._batch_lines = max(1, int(batch_lines))
        self._interval = max(0.01, float(flush_interval_s))
        self._rate = float(rate_lines_per_s)
        self._lock = threading.Lock()
        self._buf: List[list] = []
        self._seq: Dict[str, int] = {}
        self._dropped_pending = 0  # drops not yet reported in a payload
        self.dropped_total = 0
        # token bucket: capacity = 1s of budget (burst headroom)
        self._tokens = self._rate
        self._last_refill = time.monotonic()
        self._stop = threading.Event()
        if start_thread:
            threading.Thread(target=self._flush_loop, daemon=True,
                             name="log-flush").start()

    def emit(self, stream: str, lines: List[str], level: str = "") -> None:
        if not lines:
            return
        try:
            job, task, actor = self._task_ids()
        except Exception:
            job = task = actor = ""
        ts = time.time()
        flush_now = False
        with self._lock:
            dropped = 0
            if self._rate > 0:
                now = time.monotonic()
                self._tokens = min(
                    self._rate,
                    self._tokens + (now - self._last_refill) * self._rate)
                self._last_refill = now
                allowed = int(self._tokens)
                if allowed < len(lines):
                    dropped = len(lines) - allowed
                    self._dropped_pending += dropped
                    self.dropped_total += dropped
                    DROPPED_TOTAL.inc(dropped, tags={"reason": "rate"})
                    lines = lines[:allowed]
                self._tokens -= len(lines)
            seq = self._seq.get(stream, 0)
            for line in lines:
                self._buf.append(
                    [stream, seq, ts, job, task, actor, level, line])
                seq += 1
            # dropped lines still consume sequence numbers: a seq GAP in
            # the stored stream is the auditable drop signal
            self._seq[stream] = seq + dropped
            if len(self._buf) >= self._batch_lines:
                flush_now = True
        if flush_now:
            self.flush()

    def flush(self) -> None:
        # swap AND send under the lock: send only enqueues to the
        # channel's writer thread (never blocks), and two racing flushes
        # (size-triggered vs the timer) must not ship batches out of
        # order — the head relies on seq order within a stream
        failed = 0
        with self._lock:
            if not self._buf and not self._dropped_pending:
                return
            batch, self._buf = self._buf, []
            dropped, self._dropped_pending = self._dropped_pending, 0
            payload = {"pid": os.getpid(), "recs": batch}
            if dropped:
                payload["dropped"] = dropped
            try:
                self._send(payload)
            except Exception:
                # channel down: the local console still has the lines
                failed = len(batch)
                self.dropped_total += failed
        if failed:
            DROPPED_TOTAL.inc(failed, tags={"reason": "channel"})

    def _flush_loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.flush()

    def stop(self) -> None:
        self._stop.set()
        self.flush()


class StreamTee:
    """Line-buffered tee of a process's stdout/stderr into a LogBatcher —
    the log plane's capture edge (ref: python/ray/_private/log_monitor.py
    tails worker log files; here lines ride the existing RPC channel).
    Local writes still reach the original stream (the parent console)."""

    def __init__(self, batcher: LogBatcher, stream: str, orig):
        self._batcher = batcher
        self._stream = stream
        self._orig = orig
        # per-thread partial-line buffers: print() writes the text and
        # the trailing "\n" as SEPARATE calls, so one shared buffer
        # would shear concurrent writers' fragments into each other —
        # each thread's line assembles privately and ships whole.
        # threading.local (not an ident-keyed dict): idents are REUSED
        # after a thread dies, which would splice a dead thread's
        # unterminated fragment into an unrelated thread's first line —
        # and the storage dies with its thread, so nothing leaks
        self._local = threading.local()
        # file-object surface libraries probe before writing
        self.encoding = getattr(orig, "encoding", "utf-8")
        self.errors = getattr(orig, "errors", "strict")

    def writelines(self, lines) -> None:
        for line in lines:
            self.write(line)

    @property
    def buffer(self):
        return getattr(self._orig, "buffer", self._orig)

    def write(self, s: str) -> int:
        self._orig.write(s)
        lines = None
        buf = getattr(self._local, "buf", "") + s
        if "\n" in buf:
            done, buf = buf.rsplit("\n", 1)
            lines = done.split("\n")
        self._local.buf = buf
        if lines:
            self._batcher.emit(self._stream, lines)
        return len(s)

    def flush(self) -> None:
        self._orig.flush()

    def isatty(self) -> bool:
        return False

    def fileno(self):
        return self._orig.fileno()


# ---------------------------------------------------------------------------
# driver-side mirroring (log_to_driver)

# the reference's worker-prefix palette (ray_constants: cyan family
# avoided so error text stays distinct); cycled per (node, pid)
_COLORS = (36, 35, 33, 32, 34, 96, 95, 94, 92, 93)


class DriverMirror:
    """Print remote workers' lines on the driver console with a colored
    ``(worker pid=..., node=...)`` prefix and consecutive-duplicate
    dedup ("repeated Nx") — the log_to_driver surface."""

    # worker churn (restarts, autoscaling) mints fresh pids forever; the
    # per-worker state tables evict oldest past this cap (the same
    # discipline as the agent log rings / REMOTE_SERIES_MAX)
    _STATE_MAX = 256

    def __init__(self, enabled: bool = True, color: Optional[bool] = None):
        self.enabled = enabled
        self._color = (sys.stdout.isatty() if color is None else color)
        self._color_idx: Dict[tuple, int] = {}
        self._color_next = 0
        self._lock = threading.Lock()
        # (node, pid, stream) -> [last_line, repeat_count, first_ts]
        self._last: Dict[tuple, list] = {}

    def _prefix(self, node: str, pid, stream: str) -> str:
        text = f"(worker pid={pid}, node={node[:8]}) "
        if not self._color:
            return text
        key = (node, pid)
        idx = self._color_idx.get(key)
        if idx is None:
            if len(self._color_idx) >= self._STATE_MAX:
                self._color_idx.pop(next(iter(self._color_idx)))
            idx = self._color_idx[key] = self._color_next % len(_COLORS)
            self._color_next += 1
        return f"\x1b[{_COLORS[idx]}m{text}\x1b[0m"

    # a run of identical lines reports its count when a different line
    # arrives, or at this cadence while the run is still going (a
    # forever-repeating heartbeat must not look like one silent line)
    _REPEAT_FLUSH_S = 2.0

    def emit(self, node: str, pid, stream: str, lines: List[str]) -> None:
        if not self.enabled or not lines:
            return
        # structured-logger lines surface on stderr like the reference's
        # worker-log mirroring (the rpdb banner rides this path)
        out = sys.stderr if stream in ("stderr", "log") else sys.stdout
        key = (node, pid, stream)
        to_print: List[str] = []
        now = time.monotonic()
        with self._lock:
            state = self._last.get(key)
            if state is None:
                if len(self._last) >= self._STATE_MAX:
                    self._last.pop(next(iter(self._last)))
                # [last_line, repeat_count, first_repeat_ts]
                state = self._last[key] = [None, 0, now]
            for line in lines:
                if line == state[0]:
                    if not state[1]:
                        state[2] = now
                    state[1] += 1
                    if now - state[2] >= self._REPEAT_FLUSH_S:
                        to_print.append(
                            f"... last line repeated {state[1]}x "
                            f"(ongoing)")
                        state[1] = 0
                    continue
                if state[1]:
                    to_print.append(
                        f"... last line repeated {state[1]}x")
                    state[1] = 0
                state[0] = line
                to_print.append(line)
        prefix = self._prefix(node, pid, stream)
        for line in to_print:
            print(prefix + line, file=out)  # graftcheck: disable=GC007


# ---------------------------------------------------------------------------
# the ray_tpu_torch.logger structured channel

_logger_lock = threading.Lock()
_handler_installed = False


class _StructuredHandler(_pylogging.Handler):
    """Routes stdlib-logging records into the log plane: in a worker,
    through its LogBatcher (stream="log", level attached); on the
    driver, straight into the head's LogStore. Console output rides the
    stderr tee/stream either way, so nothing prints twice."""

    def emit(self, record: _pylogging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:
            return
        err = sys.stderr
        # console copy bypasses a tee: the structured record below is the
        # shipped one (stream="log" + level), not a second stderr line
        console = err._orig if isinstance(err, StreamTee) else err
        try:
            console.write(line + "\n")
        except Exception:
            pass
        try:
            from ..core import runtime as runtime_mod

            rt = runtime_mod.maybe_runtime()
            if rt is None:
                return
            batcher = getattr(getattr(rt, "worker", None),
                              "log_batcher", None)
            if batcher is not None:
                batcher.emit("log", [record.getMessage()],
                             level=record.levelname)
            elif hasattr(rt, "gcs") and getattr(rt.gcs, "logs", None) \
                    is not None:
                rt.gcs.logs.append([{
                    "ts": record.created,
                    "node_id": "driver", "worker_id": rt.worker_id.hex(),
                    "pid": os.getpid(), "job_id": rt.job_id.hex(),
                    "task_id": "", "actor_id": "", "stream": "log",
                    "level": record.levelname, "seq": -1,
                    "line": record.getMessage()}])
        except Exception:
            pass


def get_logger(name: str = "ray_tpu_torch") -> _pylogging.Logger:
    """The structured log channel: a stdlib logger whose records land in
    the cluster log store with level + task attribution (and on the
    local console). Use inside tasks/actors exactly like logging."""
    global _handler_installed
    logger = _pylogging.getLogger(name)
    with _logger_lock:
        if not _handler_installed:
            root = _pylogging.getLogger("ray_tpu_torch")
            handler = _StructuredHandler()
            handler.setFormatter(_pylogging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
            root.addHandler(handler)
            root.setLevel(_pylogging.INFO)
            root.propagate = False
            _handler_installed = True
    return logger
