"""Logical plan + fusion for ray_tpu_torch.data.

Mirrors the reference's logical-plan → physical-plan split (ref:
python/ray/data/_internal/logical/, planner/plan_udf_map_op.py fusion):
consecutive block→block transforms fuse into one task per block; all-to-all
ops (repartition / random_shuffle) are barriers; an actor-pool compute
strategy cuts the fusion so the chain runs on the pool.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

from .._vendor import cloudpickle


@dataclass
class SourceOp:
    """Produces blocks: read-task callables, already-materialized refs,
    or a deferred thunk () -> [refs] (union / split views over other
    datasets: the upstream plans execute when THIS plan executes)."""
    read_fns: Optional[List[bytes]] = None   # cloudpickled () -> Block
    refs: Optional[List[Any]] = None
    thunk: Optional[Callable[[], List[Any]]] = None
    name: str = "source"
    # column-aware sources (parquet) accept a projection: called with the
    # selected column names, returns replacement read_fns that fetch only
    # those columns (optimizer.py projection pushdown)
    project: Optional[Callable[[List[str]], List[bytes]]] = None


@dataclass
class MapOp:
    """A block -> block transform, optionally on an actor pool."""
    fn: Callable  # Block -> Block
    name: str = "map"
    compute: Optional[Tuple[int, Optional[dict]]] = None  # (pool, resources)
    # row-wise content-preserving ops commute with order-only all-to-all
    # barriers (optimizer.py reordering); batch-boundary-dependent ops
    # (map_batches) must keep False
    commutes: bool = False
    # set by select_columns: the column list, for projection pushdown
    projection: Optional[List[str]] = None


@dataclass
class AllToAllOp:
    kind: str  # "repartition" | "random_shuffle"
    arg: Any = None
    name: str = "all_to_all"


@dataclass
class WindowedShuffleOp:
    """Streaming windowed shuffle (Dataset.windowed_shuffle): buffers
    `window` upstream blocks, emits their rows globally permuted by a
    seeded RNG, then moves to the next window — NOT a barrier, so the
    consumer starts pulling shuffled blocks after the first W blocks
    land instead of after the whole dataset materializes. The executor
    derives each window's RNG stream from (seed, epoch, window index),
    so iter_epochs() reshuffles deterministically per epoch."""
    window: int
    seed: Optional[int] = None
    name: str = "windowed_shuffle"


def build_segments(ops: List[Any]) -> List[dict]:
    """Fuse the op list into executor segments (see StreamingExecutor.execute)."""
    if not ops or not isinstance(ops[0], SourceOp):
        raise ValueError("plan must start with a SourceOp")
    segments: List[dict] = []
    src = ops[0]
    if src.read_fns is not None:
        pending_source = ("reads", list(src.read_fns))
    elif src.thunk is not None:
        pending_source = ("thunk", src.thunk)
    else:
        pending_source = ("refs", list(src.refs or []))
    chain: List[Callable] = []
    compute: Optional[Tuple[int, Optional[dict]]] = None

    def flush():
        nonlocal pending_source, chain, compute
        segments.append({
            "source": pending_source,
            "chain": cloudpickle.dumps(list(chain)),
            "identity": not chain,
            "compute": compute,
        })
        chain = []
        compute = None

    for op in ops[1:]:
        if isinstance(op, MapOp):
            if op.compute is not None:
                # actor-pool op: cut fusion before and run the pool segment
                if chain or pending_source[0] == "reads":
                    flush()
                    pending_source = ("chained", None)
                chain.append(op.fn)
                compute = op.compute
                flush()
                pending_source = ("chained", None)
            else:
                if compute is not None:
                    flush()
                    pending_source = ("chained", None)
                chain.append(op.fn)
        elif isinstance(op, AllToAllOp):
            flush()
            pending_source = ("barrier", (op.kind, op.arg))
        elif isinstance(op, WindowedShuffleOp):
            # streaming stage: consumes the previous segment's stream
            # window-by-window (no materialization barrier)
            flush()
            pending_source = ("wshuffle", (op.window, op.seed))
        else:
            raise TypeError(f"unknown op {op!r}")
    flush()

    # resolve "chained" placeholders: those segments consume the previous
    # segment's stream — the executor handles this by treating them as
    # ("refs", <upstream stream>) at run time.
    return segments
