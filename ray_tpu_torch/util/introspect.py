"""On-demand process introspection: thread stacks + sampling profiles.

Equivalent of the reference's ``ray stack`` (py-spy dump over every
worker on a node) and ``ray timeline``-adjacent profiling hooks. Workers
answer a ``dump_stacks`` RPC from :func:`dump_stacks` — a pure
``sys._current_frames()`` walk, safe to run while the main thread is
blocked in a ``get()`` — and a ``profile`` RPC from
:class:`SamplingProfiler`, a py-spy-style wall-clock sampler that
aggregates collapsed stacks (flamegraph text: ``frame;frame;frame N``)
plus a pstats-like self/cumulative table. Sampling, unlike cProfile's
tracing, needs no cooperation from the profiled threads and has
near-zero overhead between samples — the right trade for live
production workers (the exit-time cProfile dump behind
``RTPU_WORKER_PROFILE`` remains for offline runs).
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional


def dump_stacks() -> Dict[str, Any]:
    """Every thread's current stack in this process.

    -> {"pid", "threads": [{"thread_id", "name", "daemon", "frames":
    ["file:line in fn", ...] outermost-first}]}.
    """
    import os

    names = {t.ident: t for t in threading.enumerate()}
    threads = []
    for tid, frame in sys._current_frames().items():
        t = names.get(tid)
        frames = []
        for fs in traceback.extract_stack(frame):
            frames.append(f"{fs.filename}:{fs.lineno} in {fs.name}")
        threads.append({
            "thread_id": tid,
            "name": t.name if t is not None else f"thread-{tid}",
            "daemon": bool(t.daemon) if t is not None else False,
            "frames": frames,
        })
    threads.sort(key=lambda r: (r["daemon"], r["name"]))
    return {"pid": os.getpid(), "threads": threads}


def format_stacks(report: Dict[str, Any], header: str = "") -> str:
    """Render a dump_stacks() report like faulthandler / `ray stack`."""
    out = []
    if header:
        out.append(header)
    for th in report.get("threads", ()):
        out.append(f"  Thread {th['thread_id']} ({th['name']}"
                   f"{', daemon' if th['daemon'] else ''}):")
        for fr in th["frames"]:
            out.append(f"    {fr}")
    return "\n".join(out)


class SamplingProfiler:
    """Wall-clock sampler over every thread in this process."""

    def __init__(self, interval_s: float = 0.01):
        self.interval_s = max(0.001, float(interval_s))

    def run(self, duration_s: float,
            exclude_threads: Optional[set] = None) -> Dict[str, Any]:
        """Sample for ``duration_s``; -> {"samples", "duration_s",
        "interval_s", "collapsed": {stack_key: count},
        "functions": {frame_key: [self, cum]}}.

        ``stack_key`` is ``outer;...;inner`` (flamegraph collapsed
        format); ``frame_key`` is ``fn (file:line-of-def)``.
        """
        me = threading.get_ident()
        skip = {me} | set(exclude_threads or ())
        collapsed: Dict[str, int] = {}
        functions: Dict[str, List[int]] = {}
        samples = 0
        t0 = time.monotonic()
        deadline = t0 + max(0.0, float(duration_s))
        while True:
            for tid, frame in sys._current_frames().items():
                if tid in skip:
                    continue
                keys = []
                f = frame
                while f is not None:
                    code = f.f_code
                    keys.append(f"{code.co_name} "
                                f"({code.co_filename}:"
                                f"{code.co_firstlineno})")
                    f = f.f_back
                keys.reverse()  # outermost first
                stack_key = ";".join(k.split(" ")[0] for k in keys)
                collapsed[stack_key] = collapsed.get(stack_key, 0) + 1
                seen = set()
                for i, k in enumerate(keys):
                    row = functions.setdefault(k, [0, 0])
                    if i == len(keys) - 1:
                        row[0] += 1  # self: innermost frame
                    if k not in seen:
                        row[1] += 1  # cumulative: once per stack
                        seen.add(k)
            samples += 1
            now = time.monotonic()
            if now >= deadline:
                break
            time.sleep(min(self.interval_s, deadline - now))
        return {"samples": samples,
                "duration_s": round(time.monotonic() - t0, 4),
                "interval_s": self.interval_s,
                "collapsed": collapsed,
                "functions": functions}


def profile_to_text(result: Dict[str, Any], top: int = 25) -> str:
    """pstats-style table from a SamplingProfiler result: self/cum
    sample counts per function, heaviest self-time first."""
    samples = max(1, int(result.get("samples", 0)))
    rows = sorted(result.get("functions", {}).items(),
                  key=lambda kv: (-kv[1][0], -kv[1][1], kv[0]))
    out = [f"{result.get('samples', 0)} samples over "
           f"{result.get('duration_s', 0)}s "
           f"(interval {result.get('interval_s', 0)}s)",
           f"{'self%':>7} {'cum%':>7} {'self':>6} {'cum':>6}  function"]
    for key, (self_n, cum_n) in rows[:top]:
        out.append(f"{self_n / samples * 100:6.1f}% "
                   f"{cum_n / samples * 100:6.1f}% "
                   f"{self_n:6d} {cum_n:6d}  {key}")
    return "\n".join(out)


def collapsed_to_text(result: Dict[str, Any]) -> str:
    """Flamegraph collapsed-stack text (`flamegraph.pl` / speedscope
    input): one `frame;frame;frame count` line per distinct stack."""
    rows = sorted(result.get("collapsed", {}).items(),
                  key=lambda kv: -kv[1])
    return "\n".join(f"{stack} {n}" for stack, n in rows)
