"""Lowering helpers — the two ways a program enters a MeshOwner's mesh
(counterpart of ray_tpu/parallel/sharding/lower.py, with its names).

- :func:`lower_jit` — the partitioned plane, with DTensor semantics:
  the inputs are this rank's shards laid out by ``in_specs`` (what
  ``MeshOwner.place`` returns), the body runs on ``DTensor`` s, torch's
  sharding propagation decides each op's layout and inserts its
  collectives, and the outputs are redistributed to ``out_specs`` and
  returned as this rank's shards.
- :func:`lower_shard_map` — the manual plane: the body runs on this
  rank's shards and its collectives (:func:`psum`, :func:`ppermute`,
  :func:`pvary`, :func:`all_gather`, :func:`psum_scatter`,
  :func:`all_to_all`, :func:`axis_index`, and the one-rank
  :func:`gather`, :func:`scatter` and object collectives that JAX has no
  use for) name axes the owner's mesh binds; an axis the call does not
  bind raises. The collectives run over gloo: a CUDA tensor goes through
  the host and its result comes back to its device.
- :func:`psum`, :func:`ppermute` and :func:`pvary` are differentiable,
  with the transposes JAX gives them inside a shard_map: a sum into an
  output replicated over the axis transposes to the identity, a
  permutation to the inverse permutation, and a replicated input entering
  the manual region (``pvary``) to the sum of every rank's cotangent. The
  backward captures the axis's group at the forward, so it runs after
  the body has returned, as ``loss.backward()`` runs it. Every rank must
  run the same autograd graph, so that the ranks' backwards reach the
  collectives in the same order; :func:`collective_stats` keeps their
  seconds and bytes. :func:`group_all_reduce` and :func:`group_pvary` are
  the same pair over a process group that the caller holds (the
  tensor-parallel split's). :func:`psum` and :func:`pvary` take a tuple
  of axes too, one collective over each in turn. The all-reduce and the
  permutation are the dispatcher ops ``ray_tpu_torch::all_reduce`` and
  ``ray_tpu_torch::ppermute``, so a selective checkpoint (``ops.remat``)
  keeps their outputs and never runs them again in a recompute.
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
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

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


def _host(x):
    """``x`` on the CPU, where gloo runs every collective."""
    return x.detach().cpu() if x.device.type != "cpu" else x


# {name: {"calls", "seconds", "bytes"}} of the differentiable collectives
_STATS: Dict[str, Dict[str, float]] = {}
_STATS_LOCK = threading.Lock()


def collective_stats(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """Calls, wall seconds and bytes of :func:`psum`, :func:`ppermute`
    and :func:`pvary` in this process since the last reset, by name: the
    forward under its ``name`` (the op's name by default), its transpose
    under ``name + ".T"``. A call's seconds start once the device has
    finished the work queued before it (the copy to the host waits for
    that anyway) and include the copies through the host. ``reset``
    empties the record after reading it."""
    with _STATS_LOCK:
        out = {k: dict(v) for k, v in _STATS.items()}
        if reset:
            _STATS.clear()
    return out


def _timed(name: str, x, fn):
    """``fn()``, its wall time and ``x``'s bytes recorded under ``name``."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = fn()
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    seconds = time.perf_counter() - t0
    with _STATS_LOCK:
        rec = _STATS.setdefault(name, {"calls": 0, "seconds": 0.0,
                                       "bytes": 0})
        rec["calls"] += 1
        rec["seconds"] += seconds
        rec["bytes"] += x.numel() * x.element_size()
    return out


def _grad_needed(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x, group, op: str = "sum"):
    import torch.distributed as dist

    out = _host(x).clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out.to(x.device)


# The collective as a dispatcher op, so that a selective checkpoint can
# keep its output (ops/remat.py). Defined through torch.library.Library:
# the first call of a torch.library.custom_op imports torch._dynamo,
# seconds in every process. Its arguments are tensors and scalars, so a
# process group is named by an id; the groups are held here, so no id is
# reused.
_GROUPS: Dict[int, object] = {}
_LIB = torch.library.Library("ray_tpu_torch", "FRAGMENT")
_LIB.define("all_reduce(Tensor x, int group, str name, str op) -> Tensor")


def _all_reduce_op(x, group: int, name: str, op: str):
    """The ``op`` ("sum" or "max") of ``x`` over the process group of id
    ``group``, recorded under ``name`` (:func:`collective_stats`)."""
    return _timed(name, x, lambda: _all_reduce(x, _GROUPS[group], op))


_LIB.impl("all_reduce", _all_reduce_op, "CompositeExplicitAutograd")


class _PSum(torch.autograd.Function):
    """psum into an output replicated over the axis: its transpose is the
    identity on each rank (JAX's)."""

    @staticmethod
    def forward(ctx, x, group, name):
        return torch.ops.ray_tpu_torch.all_reduce(x, group, name, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def group_all_reduce(x, group, *, name: str = "psum", op: str = "sum"):
    """The sum (or, with ``op="max"``, the max, which has no gradient) of
    ``x`` over the ranks of process group ``group``, through the host.
    Differentiable: the sum is replicated over the group, so the
    cotangent passes through unchanged."""
    _GROUPS[id(group)] = group
    if op == "sum" and _grad_needed(x):
        return _PSum.apply(x, id(group), name)
    return torch.ops.ray_tpu_torch.all_reduce(x, id(group), name, op)


def _axes(axis_name) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def psum(x, axis_name, *, name: Optional[str] = None):
    """Sum of ``x`` over the ranks of ``axis_name`` (jax.lax.psum; a tuple
    of axes sums over each in turn). Differentiable: the result is
    replicated over the axes, so the cotangent passes through
    unchanged."""
    for axis in _axes(axis_name):
        x = group_all_reduce(x, _group(axis), name=name or "psum")
    return x


def _perm_peers(perm: Sequence[Tuple[int, int]], me: int, n: int):
    """(the index this rank sends to, the index it receives from) under
    ``perm``, a list of (source, target) pairs over ``n`` ranks; None
    where it has none."""
    pairs = [(int(s), int(d)) for s, d in perm]
    sources, targets = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(sources)) != len(sources) or \
            len(set(targets)) != len(targets) or \
            not all(0 <= i < n for i in sources + targets):
        raise ValueError(f"ppermute: {list(perm)} is not a permutation "
                         f"of the {n} ranks of the axis")
    to = next((d for s, d in pairs if s == me), None)
    frm = next((s for s, d in pairs if d == me), None)
    return to, frm


def _exchange(x, to: Optional[int], frm: Optional[int], me: int, group):
    """Send ``x`` to the rank of index ``to`` and receive a tensor like it
    from the rank of index ``frm`` (zeros where ``frm`` is None), both in
    flight together, over gloo through the host."""
    import torch.distributed as dist

    if to == me:                           # a rank that keeps its own
        return x.clone()
    h = _host(x).contiguous()
    buf = torch.zeros_like(h) if frm is None else torch.empty_like(h)
    works = []
    if frm is not None:
        works.append(dist.irecv(buf, src=dist.get_global_rank(group, frm),
                                group=group))
    if to is not None:
        works.append(dist.isend(h, dst=dist.get_global_rank(group, to),
                                group=group))
    for w in works:
        w.wait()
    return buf.to(x.device)


_LIB.define("ppermute(Tensor x, int group, int to, int frm, int me, "
            "str name) -> Tensor")


def _ppermute_op(x, group: int, to: int, frm: int, me: int, name: str):
    """``x`` sent to the rank of index ``to`` of the process group of id
    ``group`` and what the rank of index ``frm`` sent returned (-1: none),
    recorded under ``name``."""
    return _timed(name, x, lambda: _exchange(
        x, None if to < 0 else to, None if frm < 0 else frm, me,
        _GROUPS[group]))


_LIB.impl("ppermute", _ppermute_op, "CompositeExplicitAutograd")


def _ppermute_call(x, group, to, frm, me, name):
    _GROUPS[id(group)] = group
    return torch.ops.ray_tpu_torch.ppermute(
        x, id(group), -1 if to is None else to, -1 if frm is None else frm,
        me, name)


class _PPermute(torch.autograd.Function):
    """ppermute; its transpose is the inverse permutation (JAX's)."""

    @staticmethod
    def forward(ctx, x, group, to, frm, me, name):
        ctx.peers = (group, to, frm, me, name)
        return _ppermute_call(x, group, to, frm, me, name)

    @staticmethod
    def backward(ctx, g):
        group, to, frm, me, name = ctx.peers
        return (_timed(name + ".T", g,
                       lambda: _exchange(g, frm, to, me, group)),
                None, None, None, None, None)


def ppermute(x, axis_name: str, perm: Sequence[Tuple[int, int]], *,
             name: Optional[str] = None):
    """jax.lax.ppermute: each rank of ``axis_name`` sends ``x`` to the
    index ``perm`` pairs it with as source, and returns what the rank
    pairing it as target sent (zeros where no pair names it as target).
    Differentiable: the cotangent travels the inverse permutation."""
    import torch.distributed as dist

    group = _group(axis_name)
    me = axis_index(axis_name)
    to, frm = _perm_peers(perm, me, dist.get_world_size(group))
    name = name or "ppermute"
    if _grad_needed(x):
        return _PPermute.apply(x, group, to, frm, me, name)
    return _ppermute_call(x, group, to, frm, me, name)


def _sum_over(xs: List, group, name: str) -> List:
    """The sum over the group of each tensor of ``xs``: one all-reduce per
    dtype and device, of the tensors flattened into one buffer."""
    out: List = [None] * len(xs)
    by_kind: Dict[tuple, List[int]] = {}
    for i, x in enumerate(xs):
        by_kind.setdefault((x.dtype, x.device), []).append(i)
    for idx in by_kind.values():
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        summed = _timed(name, flat, lambda: _all_reduce(flat, group))
        for i, part in zip(idx, summed.split([xs[i].numel()
                                              for i in idx])):
            out[i] = part.view(xs[i].shape)
    return out


class _PVary(torch.autograd.Function):
    """A replicated input entering the manual region: the identity, whose
    transpose sums every rank's cotangent over the axis."""

    @staticmethod
    def forward(ctx, group, name, *xs):
        ctx.group, ctx.name = group, name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_sum_over(list(gs), ctx.group,
                                       ctx.name + ".T"))


def pvary(x, axis_name, *, name: Optional[str] = None):
    """Mark ``x`` (a tensor, or a dict, list or tuple tree of them) as
    varying over ``axis_name`` (or a tuple of axes): the values are
    unchanged, and in the backward each differentiable leaf's cotangent
    is summed over the ranks of the axis, of each axis in turn (JAX's
    ``pvary``, the transpose of a replicated input entering the manual
    region). The summed leaves share one all-reduce per dtype and axis."""
    for axis in _axes(axis_name):
        x = group_pvary(x, _group(axis), name=name or "pvary")
    return x


def group_pvary(x, group, *, name: str = "pvary"):
    """:func:`pvary` over the ranks of process group ``group``."""
    def summed(t):
        return isinstance(t, torch.Tensor) and t.is_floating_point() \
            and _grad_needed(t)

    leaves = []
    _tree_map(leaves.append, x)
    picked = [t for t in leaves if summed(t)]
    if not picked:
        return x
    marked = iter(_PVary.apply(group, name, *picked))
    return _tree_map(lambda t: next(marked) if summed(t) else t, x)


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = False):
    """Every rank's ``x`` along ``axis_name``: stacked on a new ``axis``
    (or concatenated along it when ``tiled``), as jax.lax.all_gather."""
    import torch
    import torch.distributed as dist

    group = _group(axis_name)
    h = _host(x).contiguous()
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, h, group=group)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
    return out.to(x.device)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int,
               tiled: bool = False):
    """jax.lax.all_to_all: ``x`` split along ``split_axis`` into one piece
    per rank of ``axis_name``, piece j sent to rank j, and the pieces this
    rank receives joined in rank order along ``concat_axis``. Untiled,
    ``split_axis`` must have the axis size and is dropped, and the pieces
    are stacked on a new ``concat_axis``; tiled, they are concatenated."""
    import torch
    import torch.distributed as dist

    group = _group(axis_name)
    n = dist.get_world_size(group)
    h = _host(x)
    if tiled:
        if h.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of size "
                             f"{h.shape[split_axis]} does not split over "
                             f"{n} ranks of {axis_name!r}")
        pieces = list(h.chunk(n, dim=split_axis))
    else:
        if h.shape[split_axis] != n:
            raise ValueError(f"all_to_all: untiled dimension {split_axis} "
                             f"has size {h.shape[split_axis]}, not the "
                             f"{n} ranks of {axis_name!r}")
        pieces = list(h.unbind(split_axis))
    pieces = [p.contiguous() for p in pieces]
    got = [torch.empty_like(p) for p in pieces]
    dist.all_to_all(got, pieces, group=group)
    out = torch.cat(got, dim=concat_axis) if tiled \
        else torch.stack(got, concat_axis)
    return out.to(x.device)


def psum_scatter(x, axis_name: str, scatter_dimension: int = 0,
                 tiled: bool = False):
    """jax.lax.psum_scatter: the sum of ``x`` over the ranks of
    ``axis_name``, of which this rank keeps piece #index along
    ``scatter_dimension`` (tiled: a chunk of the dimension; untiled: the
    dimension has the axis size and is dropped). Gloo would sum in
    transit in its own order, so this is an :func:`all_to_all` and then
    a sum in rank order, in f32 at least: every rank's result is the
    sequential sum, and deterministic."""
    import torch
    import torch.distributed as dist

    if tiled:
        n = dist.get_world_size(_group(axis_name))
        if x.shape[scatter_dimension] % n:
            raise ValueError(f"psum_scatter: dimension {scatter_dimension} "
                             f"of size {x.shape[scatter_dimension]} does "
                             f"not split over {n} ranks of {axis_name!r}")
        x_split = x.unflatten(scatter_dimension, (n, -1))
    else:
        x_split = x
    # got[i]: rank i's piece for this rank
    got = all_to_all(x_split, axis_name, scatter_dimension, 0, tiled=False)
    acc_dtype = torch.promote_types(got.dtype, torch.float32) \
        if got.is_floating_point() else got.dtype
    acc = got[0].to(acc_dtype, copy=True)
    for part in got[1:]:
        acc += part
    return acc.to(x.dtype)


def gather(x, axis_name: str, dst: int, axis: int = 0, tiled: bool = False):
    """Every rank's ``x`` along ``axis_name`` onto the rank of index
    ``dst`` only (stacked on ``axis``, or concatenated when ``tiled``, as
    :func:`all_gather`); the other ranks get None."""
    import torch
    import torch.distributed as dist

    group = _group(axis_name)
    h = _host(x).contiguous()
    me = axis_index(axis_name) == dst
    parts = [torch.empty_like(h) for _ in range(
        dist.get_world_size(group))] if me else None
    dist.gather(h, parts, dst=dist.get_global_rank(group, dst), group=group)
    if not me:
        return None
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
    return out.to(x.device)


def scatter(x, axis_name: str, src: int, shape, dtype, device=None):
    """The rank of index ``src`` splits ``x`` into equal chunks along
    dimension 0, one per rank of ``axis_name``, and each rank gets its
    own (of ``shape`` and ``dtype``, on ``device``; the default is the
    CPU). ``x`` is read on ``src`` only."""
    import torch
    import torch.distributed as dist

    group = _group(axis_name)
    n = dist.get_world_size(group)
    out = torch.empty(shape, dtype=dtype)
    pieces = None
    if axis_index(axis_name) == src:
        pieces = [p.contiguous() for p in _host(x).chunk(n)]
        if len(pieces) != n or any(p.shape != out.shape for p in pieces):
            raise ValueError(f"scatter: {tuple(x.shape)} does not split "
                             f"into {n} chunks of {tuple(shape)}")
    dist.scatter(out, pieces, src=dist.get_global_rank(group, src),
                 group=group)
    return out if device is None else out.to(device)


def broadcast_object(obj, axis_name: str, src: int):
    """The picklable ``obj`` of the rank of index ``src``, on every rank
    of ``axis_name``."""
    import torch.distributed as dist

    group = _group(axis_name)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    return box[0]


def gather_objects(obj, axis_name: str, dst: Optional[int] = None):
    """Every rank's picklable ``obj``, in rank order: on every rank
    (``dst`` None) or on the rank of index ``dst`` only (None elsewhere)."""
    import torch.distributed as dist

    group = _group(axis_name)
    n = dist.get_world_size(group)
    if dst is None:
        out = [None] * n
        dist.all_gather_object(out, obj, group=group)
        return out
    me = axis_index(axis_name) == dst
    out = [None] * n if me else None
    dist.gather_object(obj, out, dst=dist.get_global_rank(group, dst),
                       group=group)
    return out


def scatter_objects(objs, axis_name: str, src: int):
    """Rank ``src``'s list of picklable objects, one per rank of
    ``axis_name`` in rank order: each rank gets its own."""
    import torch.distributed as dist

    group = _group(axis_name)
    box = [None]
    dist.scatter_object_list(
        box, objs if axis_index(axis_name) == src else None,
        src=dist.get_global_rank(group, src), group=group)
    return box[0]


def axis_index(axis_name: str) -> int:
    """This rank's index along ``axis_name``."""
    import torch.distributed as dist

    return dist.get_group_rank(_group(axis_name), dist.get_rank())


def axis_size(axis_name: str) -> int:
    """The number of ranks along ``axis_name`` (JAX's ``psum(1, axis)``)."""
    import torch.distributed as dist

    return dist.get_world_size(_group(axis_name))


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
