"""Rule-based logical-plan optimization for ray_tpu_torch.data.

The analog of the reference's logical optimizer (ref:
python/ray/data/_internal/logical/optimizers.py LogicalOptimizer +
rules/: operator fusion, limit/projection pushdown). Fusion of adjacent
block transforms already lives in plan.build_segments; this pass runs
BEFORE it and applies plan-shape rules:

- **Projection pushdown**: a `select_columns` op directly downstream of
  a column-aware source (parquet) rewrites the read tasks to fetch only
  those columns — IO and memory drop at the reader, not after it.
- **Commute reordering**: row-wise content-preserving ops (filter,
  select/drop_columns, row map) commute with content-preserving
  all-to-all ops — random_shuffle and repartition only. `sort` needs
  its key column (a later drop/select may remove it) and `groupby`
  changes the row set entirely, so nothing moves across those. Ops
  that depend on block/batch boundaries (map_batches) are never moved
  either.

`optimize` is pure: it returns a new op list plus the list of rule
applications (surfaced via Dataset.stats()["optimizer_rules"]).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, List, Tuple

from .plan import AllToAllOp, MapOp, SourceOp

_MAX_PASSES = 10
# only content-preserving barriers commute with row-wise ops: sort
# consumes its key column, groupby replaces the row set
_COMMUTABLE_BARRIERS = ("repartition", "random_shuffle")


def optimize(ops: List[Any]) -> Tuple[List[Any], List[str]]:
    applied: List[str] = []
    ops = list(ops)
    ops = _push_projection_into_source(ops, applied)
    for _ in range(_MAX_PASSES):
        changed = False
        for i in range(1, len(ops) - 1):
            a, b = ops[i], ops[i + 1]
            if (isinstance(a, AllToAllOp)
                    and a.kind in _COMMUTABLE_BARRIERS
                    and isinstance(b, MapOp)
                    and getattr(b, "commutes", False)
                    and b.compute is None):
                ops[i], ops[i + 1] = b, a
                applied.append(f"commute[{b.name} <-> {a.name}]")
                changed = True
                break
        if not changed:
            break
    return ops, applied


def _push_projection_into_source(ops: List[Any],
                                 applied: List[str]) -> List[Any]:
    if len(ops) < 2:
        return ops
    src = ops[0]
    if not isinstance(src, SourceOp) or src.project is None:
        return ops
    op1 = ops[1]
    cols = getattr(op1, "projection", None)
    if not isinstance(op1, MapOp) or not cols:
        return ops
    try:
        new_fns = src.project(list(cols))
    except Exception:
        return ops  # source declined (e.g. unknown columns) — run as-is
    applied.append(f"projection_pushdown[{','.join(cols)}]")
    new_src = replace(src, read_fns=new_fns,
                      name=f"{src.name}[{','.join(cols)}]")
    new_src.project = None  # already applied
    # the reader now returns exactly the selected columns; the
    # projection op is identity — drop it
    return [new_src] + ops[2:]
