"""Lowering helpers — the two ways a program enters a MeshOwner's mesh
(counterpart of ray_tpu/parallel/sharding/lower.py, with its names).

- :func:`lower_jit` — the partitioned plane, with DTensor semantics:
  the inputs are this rank's shards laid out by ``in_specs`` (what
  ``MeshOwner.place`` returns), the body runs on ``DTensor`` s, torch's
  sharding propagation decides each op's layout and inserts its
  collectives, and the outputs are redistributed to ``out_specs`` and
  returned as this rank's shards.
- :func:`lower_shard_map` — the manual plane: the body runs on this
  rank's shards and its collectives (:func:`psum`, :func:`all_gather`,
  :func:`axis_index`) name axes the owner's mesh binds; an axis the call
  does not bind raises.
- :func:`sharded_init` — each rank materializes its shards from a seeded
  full init, one tensor at a time, so no rank holds the whole tree.

Where the port's semantics differ from GSPMD's:
- Nothing is compiled: every helper returns an eager callable, and
  ``donate_argnums`` and ``jit`` are accepted and ignored.
- A rank holds only its shard: arguments and results are this rank's
  local tensors, not global arrays, and a caller that wants the whole
  value gathers it.
- GSPMD pads a dimension that does not tile the mesh; here ``place`` and
  ``sharded_init`` require exact tiling and raise, and DTensor's uneven
  shards follow ``torch.chunk``.
- Operators choose their layouts by torch's DTensor propagation rules,
  not XLA's: the results are the same values, the collectives on the way
  may differ.
- The explicit tensor-parallel forward of the serving models
  (``tensor_parallel.py``) does not go through either helper: it is
  written per rank, with its own all-reduces.
"""
from __future__ import annotations

import contextvars
from typing import Callable, Optional, Sequence, Union

from ..mesh import PartitionSpec
from .owner import MeshOwner, _tree_map

# (owner, bound axes) of the lower_shard_map body running on this thread
_BOUND: "contextvars.ContextVar" = contextvars.ContextVar(
    "ray_tpu_torch_shard_map_axes", default=None)


def _placements(owner: MeshOwner, spec):
    return owner.sharding(spec).placements()


def _from_local(owner: MeshOwner, x, spec):
    import torch
    from torch.distributed.tensor import DTensor

    if not isinstance(x, torch.Tensor):
        return x
    return DTensor.from_local(x, owner.mesh, _placements(owner, spec),
                              run_check=False)


def _to_local(owner: MeshOwner, x, spec):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(owner.mesh, _placements(owner, spec)).to_local()


def _norm_argnums(argnums: Union[int, Sequence[int]]) -> set:
    return {argnums} if isinstance(argnums, int) else set(argnums)


def lower_jit(fn: Callable, owner: MeshOwner, *,
              in_specs=None, out_specs=None,
              donate_argnums: Union[int, Sequence[int]] = (),
              static_argnums: Union[int, Sequence[int]] = ()) -> Callable:
    """``fn`` over the owner's mesh with PartitionSpec-annotated inputs
    and outputs, DTensor semantics (module docstring).

    ``in_specs`` is a tree matching the non-static arguments (a None leaf
    or ``in_specs=None`` means replicated); ``out_specs`` a tree matching
    the result, whose leaves are redistributed to it and returned as
    local shards (``out_specs=None``: returned as DTensors).
    """
    static = _norm_argnums(static_argnums)

    def run(*args):
        dyn = [a for i, a in enumerate(args) if i not in static]
        specs = in_specs if in_specs is not None else [None] * len(dyn)
        if isinstance(specs, PartitionSpec):
            specs = [specs]
        placed = iter(_tree_map(lambda x, s: _from_local(owner, x, s),
                                list(dyn), list(specs)))
        full = [a if i in static else next(placed)
                for i, a in enumerate(args)]
        out = fn(*full)
        if out_specs is None:
            return out
        if isinstance(out_specs, PartitionSpec):
            return _to_local(owner, out, out_specs)
        return _tree_map(lambda x, s: _to_local(owner, x, s), out,
                         out_specs)

    return run


def lower_shard_map(fn: Callable, owner: MeshOwner, *,
                    in_specs, out_specs,
                    axis_names: Optional[frozenset] = None,
                    jit: bool = True) -> Callable:
    """``fn`` run per shard over the owner's mesh, manual over
    ``axis_names`` (default: every axis the mesh carries). The body sees
    this rank's shards (laid out by ``in_specs``), returns its shards of
    the results (laid out by ``out_specs``), and may call the collectives
    of this module over the bound axes only."""
    bound = frozenset(owner.mesh.mesh_dim_names if axis_names is None
                      else axis_names)
    unknown = bound - set(owner.mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"axis_names {sorted(unknown)} are not axes of "
                         f"mesh {owner.name!r} "
                         f"({list(owner.mesh.mesh_dim_names)})")
    n_in = len(in_specs) if isinstance(in_specs, (tuple, list)) and \
        not isinstance(in_specs, PartitionSpec) else 1

    def run(*args):
        if len(args) != n_in:
            raise TypeError(f"shard_map body takes {n_in} sharded "
                            f"arguments (in_specs), got {len(args)}")
        token = _BOUND.set((owner, bound))
        try:
            return fn(*args)
        finally:
            _BOUND.reset(token)

    return run


def _group(axis_name: str):
    ctx = _BOUND.get()
    if ctx is None:
        raise RuntimeError(f"collective over {axis_name!r} outside a "
                           "lower_shard_map body")
    owner, bound = ctx
    if axis_name not in bound:
        raise ValueError(
            f"collective over axis {axis_name!r}, which this shard_map "
            f"does not bind (bound: {sorted(bound)}; mesh "
            f"{owner.name!r} axes {list(owner.mesh.mesh_dim_names)})")
    return owner.mesh.get_group(axis_name)


def psum(x, axis_name: str):
    """Sum of ``x`` over the ranks of ``axis_name`` (jax.lax.psum)."""
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, group=_group(axis_name))
    return out


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = False):
    """Every rank's ``x`` along ``axis_name``: stacked on a new ``axis``
    (or concatenated along it when ``tiled``), as jax.lax.all_gather."""
    import torch
    import torch.distributed as dist

    group = _group(axis_name)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)


def axis_index(axis_name: str) -> int:
    """This rank's index along ``axis_name``."""
    import torch.distributed as dist

    return dist.get_group_rank(_group(axis_name), dist.get_rank())


def sharded_init(init_fn: Callable, owner: MeshOwner,
                 out_specs) -> Callable:
    """An init whose outputs come back as this rank's shards.
    ``init_fn(*args)`` returns a dict of full tensors or yields (name,
    full tensor) pairs; with the latter each full tensor is sliced as it
    comes and freed, so a rank holds its shards and at most one full
    tensor. ``out_specs`` is a dict of specs by name or one spec for
    all."""
    def run(*args, **kwargs):
        out = init_fn(*args, **kwargs)
        items = out.items() if isinstance(out, dict) else out
        specs = out_specs
        return {name: owner.local_shard(
                    x, specs if isinstance(specs, PartitionSpec) or specs
                    is None else specs[name])
                for name, x in items}

    return run
