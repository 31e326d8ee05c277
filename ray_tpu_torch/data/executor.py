"""Streaming executor for ray_tpu_torch.data.

Equivalent of the reference's StreamingExecutor driving a PhysicalOperator
DAG over tasks/actor pools with bounded in-flight blocks (ref:
python/ray/data/_internal/execution/streaming_executor.py:49, loop in
streaming_executor_state.py; actor pools:
_internal/execution/operators/actor_pool_map_operator.py:34).

Design here: the logical plan is fused into *segments* — a source (read
tasks or materialized block refs) followed by a chain of block→block
transforms — separated by all-to-all barriers (repartition / shuffle).
Each segment streams: inputs are submitted as remote tasks with a bounded
in-flight window (backpressure); outputs yield in plan order by default
(DataContext.preserve_order) or completion order, and flow into the next
segment without a barrier.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Iterator, List, Optional

from .._vendor import cloudpickle
import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core import runtime as _rt
from ray_tpu_torch.util import metrics as _metrics

from .block import (Block, block_concat, block_num_rows, block_select,
                    block_slice)

# byte-budget backpressure instruments (docs/DATA.md). Worker-process
# executions register these in the worker's registry and their values
# ship to the head on the standard metrics_push delta path.
_G_BYTES_INFLIGHT = _metrics.Gauge(
    "ray_tpu_data_bytes_inflight",
    "bytes held by live streaming data segments in this process: "
    "completed-but-unemitted blocks at store-reported size plus "
    "in-flight tasks at the segment's running average")
_C_BLOCKS_EMITTED = _metrics.Counter(
    "ray_tpu_data_blocks_emitted_total",
    "blocks emitted downstream by streaming data segments")

# process-wide ledger behind the gauge: every live segment window posts
# its outstanding-bytes delta here, so one scrape sees the sum over
# concurrent executions without the windows sharing any other state
_LEDGER_LOCK = threading.Lock()
_LEDGER_BYTES = 0


def _ledger_post(delta: int) -> None:
    global _LEDGER_BYTES
    if delta == 0:
        return
    with _LEDGER_LOCK:
        _LEDGER_BYTES = max(0, _LEDGER_BYTES + delta)
        _G_BYTES_INFLIGHT.set(float(_LEDGER_BYTES))


def _ref_size_hint(ref) -> Optional[int]:
    """Store-reported serialized size of a completed block ref, when the
    process can see the object table (driver); None -> estimate."""
    rt = _rt.maybe_runtime()
    hint = getattr(rt, "object_size_hint", None)
    if hint is None:
        return None
    try:
        return hint(ref.id)
    except Exception:
        return None


class _ByteWindow:
    """Per-segment byte accounting for admit-against-budget
    backpressure (DataContext.target_max_bytes_inflight; the way
    serve/llm's BlockPool admits KV blocks — all-or-nothing against a
    fixed budget, the admitter blocks rather than overshoots).

    Completed-but-unemitted blocks count at their store-reported size —
    including the ordered-mode head-of-line buffer, which the block
    window already throttles but whose BYTES were previously invisible.
    In-flight tasks count at the segment's running-average block size
    (their real size is unknowable until the store seals them)."""

    # in-flight estimate before the first completion is measured
    _BOOTSTRAP_EST = 1 << 16

    def __init__(self, stats: "ExecStats", budget: int):
        self.budget = max(0, int(budget))
        self.stats = stats
        self._sizes: dict = {}     # emit index -> measured bytes
        self._buffered = 0         # completed-but-unemitted bytes
        self._avg = 0.0
        self._seen = 0
        self._posted = 0           # this window's share of the ledger

    def outstanding(self, n_in_flight: int) -> int:
        est = self._avg if self._seen else float(self._BOOTSTRAP_EST)
        return self._buffered + int(est * n_in_flight)

    def admit(self, n_in_flight: int) -> bool:
        """May one more task be submitted? Always true with the budget
        off; with everything drained (nothing in flight or buffered)
        always true, so one oversized block can never wedge a stream."""
        if self.budget <= 0:
            return True
        if n_in_flight == 0 and self._buffered == 0:
            return True
        return self.outstanding(n_in_flight) < self.budget

    def on_complete(self, ref, idx: int) -> None:
        size = _ref_size_hint(ref)
        if size is None:
            size = int(self._avg) if self._seen else self._BOOTSTRAP_EST
        self._sizes[idx] = size
        self._seen += 1
        self._avg += (size - self._avg) / self._seen
        self._buffered += size

    def on_emit(self, idx: int) -> None:
        self._buffered -= self._sizes.pop(idx, 0)
        self.stats.on_emit()
        _C_BLOCKS_EMITTED.inc()

    def publish(self, n_in_flight: int) -> None:
        now = self.outstanding(n_in_flight)
        self.stats.on_bytes(now)
        _ledger_post(now - self._posted)
        self._posted = now

    def close(self) -> None:
        _ledger_post(-self._posted)
        self._posted = 0

# ---------------------------------------------------------------------------
# remote helpers (module-level so the function blob is exported once)
# ---------------------------------------------------------------------------


def _apply_chain(chain_blob: bytes, block: Block) -> Block:
    fns: List[Callable[[Block], Block]] = cloudpickle.loads(chain_blob)
    for fn in fns:
        block = fn(block)
    return block


def _read_and_apply(read_blob: bytes, chain_blob: bytes) -> Block:
    read_fn = cloudpickle.loads(read_blob)
    return _apply_chain(chain_blob, read_fn())


def _count_rows(block: Block) -> int:
    return block_num_rows(block)


def _slice_concat(plan: List[tuple], *blocks: Block) -> Block:
    """plan: [(input_index, start, stop), ...] into *blocks."""
    parts = [block_slice(blocks[i], a, b) for (i, a, b) in plan]
    return block_concat(parts)


def _shuffle_map(block: Block, n: int, seed: int):
    rng = np.random.default_rng(seed)
    n_rows = block_num_rows(block)
    assign = rng.integers(0, n, size=n_rows)
    outs = [block_select(block, np.nonzero(assign == j)[0]) for j in range(n)]
    return tuple(outs) if n > 1 else outs[0]


def _shuffle_reduce(seed: int, *parts: Block) -> Block:
    merged = block_concat(parts)
    n_rows = block_num_rows(merged)
    perm = np.random.default_rng(seed).permutation(n_rows)
    return block_select(merged, perm)


def _merge_parts(*parts: Block) -> Block:
    """Intermediate merge of one reducer's parts from one map wave
    (push-based shuffle's merge stage)."""
    return block_concat(parts)


# -- sort (range partition; ref: planner/exchange/sort_task_spec.py) --------


def _sort_sample(block: Block, key: str, k: int) -> np.ndarray:
    col = block[key]
    if len(col) <= k:
        return np.asarray(col)
    idx = np.linspace(0, len(col) - 1, k).astype(np.int64)
    return np.asarray(col)[idx]


def _sort_map(block: Block, key: str, boundaries: np.ndarray):
    """Range-partition one block by the sampled boundaries."""
    col = np.asarray(block[key])
    assign = np.searchsorted(boundaries, col, side="right")
    n = len(boundaries) + 1
    outs = [block_select(block, np.nonzero(assign == j)[0])
            for j in range(n)]
    return tuple(outs) if n > 1 else outs[0]


def _sort_reduce(key: str, descending: bool, *parts: Block) -> Block:
    merged = block_concat(parts)
    if not merged:
        # every map task routed zero rows into this range partition
        # (skewed/constant keys): an empty block sorts to itself
        return merged
    order = np.argsort(np.asarray(merged[key]), kind="stable")
    if descending:
        order = order[::-1]
    return block_select(merged, order)


# -- groupby/aggregate (hash partition of per-block partial states;
#    ref: _internal/planner/exchange + push_based_shuffle reduce stage) ----


def _bucket_of(values: np.ndarray, n: int) -> np.ndarray:
    """Deterministic cross-process bucket assignment per key value."""
    import zlib

    v = np.asarray(values)
    if v.dtype.kind in "iub":
        # Fibonacci multiplicative hash spreads adjacent ints
        return ((v.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
                >> np.uint64(40)).astype(np.int64) % n
    if v.dtype.kind == "f":
        v = v.astype(np.float64) + 0.0  # -0.0 -> 0.0: equal keys, one bucket
        return _bucket_of(v.view(np.uint64), n)
    return np.asarray([zlib.crc32(repr(x).encode()) % n for x in v],
                      np.int64)


def _partial_agg(block: Block, key: str, specs: List[tuple]) -> Block:
    """-> partial-state block: unique keys + accumulator columns."""
    keys = np.asarray(block[key])
    uniq, inv = np.unique(keys, return_inverse=True)
    out: Block = {key: uniq}
    for i, (op, col) in enumerate(specs):
        if op == "count":
            out[f"__a{i}_c"] = np.bincount(inv, minlength=len(uniq))
            continue
        vals = np.asarray(block[col], np.float64)
        if op in ("sum", "mean"):
            out[f"__a{i}_s"] = np.bincount(inv, weights=vals,
                                           minlength=len(uniq))
            if op == "mean":
                out[f"__a{i}_c"] = np.bincount(inv, minlength=len(uniq))
        elif op in ("min", "max"):
            fill = np.inf if op == "min" else -np.inf
            acc = np.full(len(uniq), fill)
            fn = np.minimum if op == "min" else np.maximum
            fn.at(acc, inv, vals)
            out[f"__a{i}_m"] = acc
        else:
            raise ValueError(f"unknown aggregate {op!r}")
    return out


def _groupby_map(block: Block, key: str, specs: List[tuple], n: int):
    partial = _partial_agg(block, key, specs)
    assign = _bucket_of(partial[key], n)
    outs = [block_select(partial, np.nonzero(assign == j)[0])
            for j in range(n)]
    return tuple(outs) if n > 1 else outs[0]


def _groupby_reduce(key: str, specs: List[tuple], *parts: Block) -> Block:
    merged = block_concat([p for p in parts if block_num_rows(p)])
    if not merged:
        return {key: np.asarray([])}
    keys = np.asarray(merged[key])
    uniq, inv = np.unique(keys, return_inverse=True)
    out: Block = {key: uniq}
    for i, (op, col) in enumerate(specs):
        name = f"{op}()" if col is None else f"{op}({col})"
        if op == "count":
            out[name] = np.bincount(
                inv, weights=merged[f"__a{i}_c"],
                minlength=len(uniq)).astype(np.int64)
        elif op == "sum":
            out[name] = np.bincount(inv, weights=merged[f"__a{i}_s"],
                                    minlength=len(uniq))
        elif op == "mean":
            s = np.bincount(inv, weights=merged[f"__a{i}_s"],
                            minlength=len(uniq))
            c = np.bincount(inv, weights=merged[f"__a{i}_c"],
                            minlength=len(uniq))
            out[name] = s / np.maximum(c, 1)
        else:  # min / max
            fill = np.inf if op == "min" else -np.inf
            acc = np.full(len(uniq), fill)
            fn = np.minimum if op == "min" else np.maximum
            fn.at(acc, inv, np.asarray(merged[f"__a{i}_m"]))
            out[name] = acc
    return out


class _BlockWorker:
    """Actor-pool worker for map_batches(compute=ActorPoolStrategy(...)).
    Holds the deserialized chain so per-block calls skip unpickling; a
    class-based UDF's constructor runs once here (ref:
    actor_pool_map_operator.py _MapWorker)."""

    def __init__(self, chain_blob: bytes):
        self._fns = cloudpickle.loads(chain_blob)

    def apply(self, block: Block) -> Block:
        for fn in self._fns:
            block = fn(block)
        return block

    def ping(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


class ExecStats:
    def __init__(self):
        self.lock = threading.Lock()
        self.tasks_submitted = 0
        self.blocks_produced = 0
        self.blocks_emitted = 0
        self.peak_in_flight = 0
        self.bytes_inflight = 0
        self.peak_bytes_inflight = 0

    def on_submit(self, in_flight: int) -> None:
        with self.lock:
            self.tasks_submitted += 1
            self.peak_in_flight = max(self.peak_in_flight, in_flight)

    def on_emit(self) -> None:
        with self.lock:
            self.blocks_emitted += 1

    def on_bytes(self, outstanding: int) -> None:
        with self.lock:
            self.bytes_inflight = outstanding
            self.peak_bytes_inflight = max(self.peak_bytes_inflight,
                                           outstanding)

    def summary(self) -> dict:
        return {"tasks_submitted": self.tasks_submitted,
                "blocks_produced": self.blocks_produced,
                "blocks_emitted": self.blocks_emitted,
                "peak_in_flight": self.peak_in_flight,
                "bytes_inflight": self.bytes_inflight,
                "peak_bytes_inflight": self.peak_bytes_inflight}


class StreamingExecutor:
    """Drives one dataset execution; yields output block refs."""

    def __init__(self, context, epoch: int = 0):
        self.ctx = context
        # epoch index threaded into windowed-shuffle seeds: Dataset
        # .iter_epochs() re-executes the plan with epoch=e so every
        # windowed_shuffle stage reshuffles deterministically per epoch
        self.epoch = int(epoch)
        self.stats = ExecStats()
        self._apply_remote = ray_tpu_torch.remote(_apply_chain)
        self._read_remote = ray_tpu_torch.remote(_read_and_apply)

    # -- segment drivers -----------------------------------------------------

    def _stream_tasks(self, inputs: Iterator[Any], chain_blob: bytes,
                      reads: bool) -> Iterator[Any]:
        """Submit one task per input with a bounded in-flight window.
        With ctx.preserve_order (default), blocks emit in PLAN order —
        completed-out-of-order refs buffer until their turn. Admission
        is gated by the block-count window AND (when set) the byte
        budget: ctx.target_max_bytes_inflight against this segment's
        outstanding bytes."""
        cap = max(1, int(self.ctx.max_in_flight_blocks))
        ordered = bool(self.ctx.preserve_order)
        bw = _ByteWindow(self.stats,
                         getattr(self.ctx, "target_max_bytes_inflight", 0))
        in_flight: dict = {}   # ref -> submission index
        ready: dict = {}       # submission index -> ref (ordered mode)
        submitted = 0
        next_emit = 0
        inputs = iter(inputs)
        exhausted = False
        try:
            while True:
                # buffered-but-unemitted refs count against the window: one
                # stalled head-of-line block must throttle submission, not
                # let the whole dataset materialize behind it
                while not exhausted and len(in_flight) + len(ready) < cap \
                        and bw.admit(len(in_flight)):
                    try:
                        item = next(inputs)
                    except StopIteration:
                        exhausted = True
                        break
                    if reads:
                        ref = self._read_remote.remote(item, chain_blob)
                    else:
                        ref = self._apply_remote.remote(chain_blob, item)
                    in_flight[ref] = submitted
                    submitted += 1
                    self.stats.on_submit(len(in_flight))
                    bw.publish(len(in_flight))
                if not in_flight:
                    if exhausted:
                        for idx in sorted(ready):
                            ref = ready.pop(idx)
                            bw.on_emit(idx)
                            bw.publish(0)
                            yield ref
                        return
                    continue
                done, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                       timeout=None, fetch_local=False)
                for ref in done:
                    idx = in_flight.pop(ref)
                    self.stats.blocks_produced += 1
                    bw.on_complete(ref, idx)
                    if not ordered:
                        bw.on_emit(idx)
                        bw.publish(len(in_flight))
                        yield ref
                        continue
                    ready[idx] = ref
                    while next_emit in ready:
                        out = ready.pop(next_emit)
                        bw.on_emit(next_emit)
                        next_emit += 1
                        bw.publish(len(in_flight))
                        yield out
                bw.publish(len(in_flight))
        finally:
            bw.close()

    def _stream_actor_pool(self, inputs: Iterator[Any], chain_blob: bytes,
                           pool_size: int,
                           resources: Optional[dict]) -> Iterator[Any]:
        cls = ray_tpu_torch.remote(_BlockWorker)
        opts = {}
        if resources:
            opts["num_cpus"] = resources.get("CPU", 1.0)
            extra = {k: v for k, v in resources.items() if k != "CPU"}
            if extra:
                opts["resources"] = extra
        actors = [cls.options(**opts).remote(chain_blob) if opts
                  else cls.remote(chain_blob) for _ in range(pool_size)]
        bw = _ByteWindow(self.stats,
                         getattr(self.ctx, "target_max_bytes_inflight", 0))
        try:
            ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=60)
            per_actor_cap = max(
                1, int(self.ctx.max_in_flight_blocks) // pool_size) + 1
            ordered = bool(self.ctx.preserve_order)
            in_flight: dict = {}   # ref -> (actor index, submission index)
            ready: dict = {}
            submitted = 0
            next_emit = 0
            load = {i: 0 for i in range(pool_size)}
            inputs = iter(inputs)
            exhausted = False
            while True:
                while not exhausted:
                    i = min(load, key=lambda k: load[k])
                    if load[i] >= per_actor_cap or len(ready) >= len(actors) \
                            * per_actor_cap or not bw.admit(len(in_flight)):
                        break  # window full (incl. head-of-line buffer)
                    try:
                        item = next(inputs)
                    except StopIteration:
                        exhausted = True
                        break
                    ref = actors[i].apply.remote(item)
                    in_flight[ref] = (i, submitted)
                    submitted += 1
                    load[i] += 1
                    self.stats.on_submit(len(in_flight))
                    bw.publish(len(in_flight))
                if not in_flight:
                    if exhausted:
                        for idx in sorted(ready):
                            ref = ready.pop(idx)
                            bw.on_emit(idx)
                            bw.publish(0)
                            yield ref
                        return
                    continue
                done, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                       timeout=None, fetch_local=False)
                for ref in done:
                    i, idx = in_flight.pop(ref)
                    load[i] -= 1
                    self.stats.blocks_produced += 1
                    bw.on_complete(ref, idx)
                    if not ordered:
                        bw.on_emit(idx)
                        bw.publish(len(in_flight))
                        yield ref
                        continue
                    ready[idx] = ref
                    while next_emit in ready:
                        out = ready.pop(next_emit)
                        bw.on_emit(next_emit)
                        next_emit += 1
                        bw.publish(len(in_flight))
                        yield out
                bw.publish(len(in_flight))
        finally:
            bw.close()
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass

    # -- barriers ------------------------------------------------------------

    def _repartition(self, refs: List[Any], n: int) -> List[Any]:
        counts = ray_tpu_torch.get(
            [ray_tpu_torch.remote(_count_rows).remote(r) for r in refs], timeout=300)
        total = sum(counts)
        slice_remote = ray_tpu_torch.remote(_slice_concat)
        offsets = [0]
        for c in counts:
            offsets.append(offsets[-1] + c)
        outs = []
        for j in range(n):
            lo = total * j // n
            hi = total * (j + 1) // n
            plan, args = [], []
            for i, c in enumerate(counts):
                a, b = max(lo, offsets[i]), min(hi, offsets[i + 1])
                if a < b:
                    plan.append((len(args), a - offsets[i], b - offsets[i]))
                    args.append(refs[i])
            outs.append(slice_remote.remote(plan, *args))
        return outs

    # maps per merge wave for the push-based path (ref:
    # push_based_shuffle.py _MergeTaskScheduler merge_factor)
    _SHUFFLE_MERGE_FACTOR = 8

    def _random_shuffle(self, refs: List[Any], seed: Optional[int]) -> List[Any]:
        n = len(refs)
        if n == 0:
            return refs
        base = seed if seed is not None else 0x5EED
        map_remote = ray_tpu_torch.remote(_shuffle_map)
        reduce_remote = ray_tpu_torch.remote(_shuffle_reduce)
        M = self._SHUFFLE_MERGE_FACTOR
        if n <= M:
            # small: simple pull shuffle, every reducer takes N parts
            parts = [map_remote.options(num_returns=n).remote(r, n, base + i)
                     for i, r in enumerate(refs)]
            if n == 1:
                cols = [[p] for p in parts]
            else:
                cols = [[parts[i][j] for i in range(n)] for j in range(n)]
            return [reduce_remote.remote(base ^ (j * 2654435761), *col)
                    for j, col in enumerate(cols)]
        # Push-based two-stage shuffle (ref: _internal/push_based_shuffle.py):
        # maps run in waves of M; each wave's per-reducer parts merge
        # IMMEDIATELY into one block per (wave, reducer), so the N x N
        # intermediate object matrix never exists at once — per-wave parts
        # become garbage as soon as their merge lands, in-flight objects
        # stay O(M*N), and wave w+1's maps overlap wave w's merges through
        # ordinary async scheduling.
        merge_remote = ray_tpu_torch.remote(_merge_parts)
        merged_cols: List[List[Any]] = [[] for _ in range(n)]
        for w0 in range(0, n, M):
            wave = refs[w0:w0 + M]
            parts = [map_remote.options(num_returns=n).remote(
                r, n, base + w0 + i) for i, r in enumerate(wave)]
            for j in range(n):
                # n > M >= 8 here, so num_returns is always a list
                col = [parts[i][j] for i in range(len(wave))]
                merged_cols[j].append(merge_remote.remote(*col))
        return [reduce_remote.remote(base ^ (j * 2654435761),
                                     *merged_cols[j])
                for j in range(n)]

    # -- windowed shuffle (streaming, not a barrier) -------------------------

    def _windowed_shuffle(self, stream: Iterator[Any], window: int,
                          seed: Optional[int]) -> Iterator[Any]:
        """Buffer up to `window` upstream block refs, emit their rows
        globally permuted within the window, repeat. Replaces the
        all-to-all random_shuffle barrier for training loops: the first
        shuffled block is available after W upstream blocks land, and
        peak held refs stay O(W) instead of O(dataset).

        Every RNG in the stage is seeded by the tuple (base seed, epoch,
        window index, task index) via np SeedSequence, so the emitted
        row order is a pure function of (seed, epoch) — same seed+epoch
        replays bit-identically, the next epoch reshuffles."""
        window = max(1, int(window))
        base = seed if seed is not None else 0x5EED
        map_remote = ray_tpu_torch.remote(_shuffle_map)
        reduce_remote = ray_tpu_torch.remote(_shuffle_reduce)

        def shuffle_one(refs: List[Any], widx: int) -> List[Any]:
            w = len(refs)
            parts = [map_remote.options(num_returns=w).remote(
                r, w, [base, self.epoch, widx, i])
                for i, r in enumerate(refs)]
            if w == 1:
                cols = [[parts[0]]]
            else:
                cols = [[parts[i][j] for i in range(w)] for j in range(w)]
            return [reduce_remote.remote([base, self.epoch, widx, w + j],
                                         *col)
                    for j, col in enumerate(cols)]

        buf: List[Any] = []
        widx = 0
        for ref in stream:
            buf.append(ref)
            if len(buf) >= window:
                # emit refs (futures) immediately: downstream pulls
                # overlap this window's shuffle tasks and the upstream
                # segment's production of the next window
                for out in shuffle_one(buf, widx):
                    yield out
                buf = []
                widx += 1
        if buf:
            for out in shuffle_one(buf, widx):
                yield out

    def _sort(self, refs: List[Any], key: str, descending: bool) -> List[Any]:
        """Distributed sort: sample -> range partition -> per-partition
        sort (ref: planner/exchange/sort_task_spec.py SortTaskSpec)."""
        n = len(refs)
        if n == 0:
            return refs
        sample_remote = ray_tpu_torch.remote(_sort_sample)
        samples = ray_tpu_torch.get(
            [sample_remote.remote(r, key, 64) for r in refs], timeout=300)
        vals = np.concatenate([s for s in samples if len(s)]) \
            if any(len(s) for s in samples) else np.asarray([])
        if len(vals) == 0 or n == 1:
            reduce_remote = ray_tpu_torch.remote(_sort_reduce)
            return [reduce_remote.remote(key, descending, r) for r in refs]
        boundaries = np.quantile(np.sort(vals),
                                 [j / n for j in range(1, n)]) \
            if vals.dtype.kind == "f" else np.sort(vals)[
                [min(len(vals) - 1, len(vals) * j // n)
                 for j in range(1, n)]]
        map_remote = ray_tpu_torch.remote(_sort_map)
        reduce_remote = ray_tpu_torch.remote(_sort_reduce)
        parts = [map_remote.options(num_returns=n).remote(r, key, boundaries)
                 for r in refs]
        # n > 1 here: the single-partition case early-returned above
        cols = [[parts[i][j] for i in range(n)] for j in range(n)]
        out = [reduce_remote.remote(key, descending, *col) for col in cols]
        # ascending partitions ordered low->high; descending reverses
        return out[::-1] if descending else out

    def _groupby(self, refs: List[Any], key: str,
                 specs: List[tuple]) -> List[Any]:
        n = len(refs)
        if n == 0:
            return refs
        map_remote = ray_tpu_torch.remote(_groupby_map)
        reduce_remote = ray_tpu_torch.remote(_groupby_reduce)
        parts = [map_remote.options(num_returns=n).remote(r, key, specs, n)
                 for r in refs]
        cols = ([[p] for p in parts] if n == 1
                else [[parts[i][j] for i in range(n)] for j in range(n)])
        return [reduce_remote.remote(key, specs, *col) for col in cols]

    # -- plan driver ---------------------------------------------------------

    def execute(self, segments: List[dict]) -> Iterator[Any]:
        """segments: produced by plan.build_segments(). Each is a dict:
        {source: ('reads', [blobs]) | ('refs', [refs]) | ('barrier', op),
         chain: bytes, compute: None | (pool_size, resources)}"""
        stream: Optional[Iterator[Any]] = None
        for seg in segments:
            kind, payload = seg["source"]
            if kind == "reads":
                # the map chain is fused into the read task itself
                stream = self._stream_tasks(iter(payload), seg["chain"],
                                            reads=True)
                continue
            if kind == "refs":
                inputs: Iterator[Any] = iter(payload)
            elif kind == "thunk":
                # deferred source (union/split views): the upstream
                # dataset plans execute now, on the driver
                inputs = iter(payload())
            elif kind == "chained":
                assert stream is not None
                inputs = stream
            elif kind == "wshuffle":
                # streaming stage: window-buffered shuffle over the
                # previous segment's stream — no materialization
                assert stream is not None
                inputs = self._windowed_shuffle(stream, payload[0],
                                                payload[1])
            elif kind == "barrier":
                op, arg = payload
                upstream = list(stream) if stream is not None else []
                if op == "repartition":
                    refs = self._repartition(upstream, arg)
                elif op == "random_shuffle":
                    refs = self._random_shuffle(upstream, arg)
                elif op == "sort":
                    refs = self._sort(upstream, arg[0], arg[1])
                elif op == "groupby":
                    refs = self._groupby(upstream, arg[0], arg[1])
                else:
                    raise ValueError(f"unknown barrier {op}")
                inputs = iter(refs)
            else:  # pragma: no cover
                raise ValueError(kind)
            if seg["identity"]:
                stream = inputs
            elif seg["compute"] is not None:
                size, res = seg["compute"]
                stream = self._stream_actor_pool(inputs, seg["chain"],
                                                 size, res)
            else:
                stream = self._stream_tasks(inputs, seg["chain"], reads=False)
        assert stream is not None
        return stream
