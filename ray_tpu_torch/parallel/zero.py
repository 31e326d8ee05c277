"""ZeRO-style cross-replica sharding of the weight update (counterpart of
the host plane of ray_tpu/parallel/zero.py), over torch tensors.

"Automatic Cross-Replica Sharding of Weight Update in Data-Parallel
Training" (PAPERS.md): in plain data parallelism every replica holds the
FULL optimizer state and applies the FULL update — O(N) redundant memory
and compute per replica. Sharding the update makes both scale with the
dp axis: each replica reduce-scatters gradients (so it receives only its
1/dp shard, already summed), applies the optimizer to that shard with
1/dp of the optimizer state, and all-gathers the fresh parameters.
Elementwise optimizers (SGD, Adam, AdamW) commute with the flat-vector
sharding, so the sharded update is numerically the replicated update.

:class:`ZeroUpdater` runs across actor processes over the host collective
(``parallel/collective.py``): the compiled-graph pipeline engine
(``train/pipeline_cgraph.py``) uses it between the dp replicas of one
stage. :func:`make_zero_update_spmd` is the same update over a mesh axis
of gang ranks (``parallel/mesh_group.py``), where the JAX package runs it
inside one jitted program over the chips of a mesh.

Both work on the FLAT parameter vector: parameter trees (nested dicts,
lists and tuples of tensors; dict keys in sorted order, as JAX orders
them) are raveled into one 1-D tensor (uniform dtype enforced), sharded
in contiguous chunks that match ``np.array_split`` boundaries (what
``collective.reducescatter`` emits), and unraveled after the gather.

The optimizer. Where the JAX package takes an optax transformation, the
port takes ``tx``: a picklable factory that builds a
``torch.optim.Optimizer`` over a list of tensors, for example
``functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1)``.
``ZeroUpdater`` builds one over its single flat shard; an update sets the
shard's ``.grad`` and calls ``step()``. Optimizer state is the
optimizer's ``state_dict()``: its state tensors are what checkpoints
hold and what :func:`tree_bytes` counts.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "TreeSpec", "tree_flatten", "tree_unflatten", "tree_map",
    "flatten_tree", "unflatten_tree", "pad_flat", "shard_bounds",
    "tree_bytes",
    "ZeroUpdater", "make_zero_update_spmd", "merge_opt_shards",
    "split_opt_state", "flatten_opt_state", "unflatten_opt_state",
]


# ---------------------------------------------------------------------------
# trees: nested dicts / lists / tuples; everything else is a leaf
# ---------------------------------------------------------------------------


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """-> (leaves, treedef). Dicts are walked in sorted key order (as
    ``jax.tree.flatten`` walks them), lists and tuples in order; any other
    value, None included, is a leaf."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, None, [walk(x) for x in node])
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves: List[Any]):
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, keys, children = node
        vals = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, vals))
        return vals if kind == "list" else tuple(vals)

    return build(treedef)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), rebuilt in ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


# ---------------------------------------------------------------------------
# the flat vector
# ---------------------------------------------------------------------------


class TreeSpec:
    """Shapes/dtype/treedef needed to unflatten a flat vector."""

    __slots__ = ("treedef", "shapes", "dtype", "size")

    def __init__(self, treedef, shapes, dtype, size):
        self.treedef = treedef
        self.shapes = shapes
        self.dtype = dtype
        self.size = size


def flatten_tree(tree) -> Tuple[torch.Tensor, TreeSpec]:
    """Tree -> (flat 1-D tensor, spec), on the leaves' device. Leaves must
    share one dtype — the flat shard boundary would otherwise cut through
    a dtype change and reinterpret bytes."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot flatten an empty tree")
    leaves = [torch.as_tensor(l) for l in leaves]
    dtypes = {l.dtype for l in leaves}
    if len(dtypes) > 1:
        raise ValueError(
            f"ZeRO flat sharding needs a uniform leaf dtype, got "
            f"{sorted(str(d) for d in dtypes)}")
    shapes = [tuple(l.shape) for l in leaves]
    flat = torch.cat([l.detach().reshape(-1) for l in leaves])
    return flat, TreeSpec(treedef, shapes, flat.dtype, int(flat.numel()))


def unflatten_tree(flat: torch.Tensor, spec: TreeSpec):
    leaves = []
    off = 0
    for shape in spec.shapes:
        n = int(np.prod(shape)) if shape else 1
        leaves.append(flat[off:off + n].reshape(shape))
        off += n
    return tree_unflatten(spec.treedef, leaves)


def pad_flat(flat: torch.Tensor, n: int) -> torch.Tensor:
    """``flat`` zero-padded at the end to ``n`` elements (the sharded
    planes pad the flat vector so its chunks tile the axis exactly)."""
    if flat.numel() == n:
        return flat
    return torch.cat([flat, flat.new_zeros(n - flat.numel())])


def shard_bounds(n: int, world: int) -> List[Tuple[int, int]]:
    """Contiguous (lo, hi) per rank, matching np.array_split: the first
    n % world shards get one extra element."""
    base, extra = divmod(n, world)
    bounds = []
    lo = 0
    for r in range(world):
        hi = lo + base + (1 if r < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensor and array leaves (optimizer-state
    footprint accounting: the hyperparameters of a ``state_dict()`` are
    plain numbers and count nothing)."""
    total = 0
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += int(leaf.nbytes)
    return total


# ---------------------------------------------------------------------------
# opt-state resharding: ZeRO shards saved at one dp width re-split
# exactly across another, and the flat plane converts to and from the
# replicated tree plane, so cross-width checkpoint restores
# (train/pipeline_cgraph.reshard_checkpoint) are pure byte movement
# ---------------------------------------------------------------------------


def merge_opt_shards(shards: List[Any]):
    """Per-rank ZeRO opt-state shards (rank order) -> one flat-vector
    opt state over the FULL parameter vector. Tensor leaves of one or
    more dimensions are shard-sized (optimizer moments) and concatenate
    in rank order — matching the ``shard_bounds`` contiguous layout they
    were split under; scalar leaves (Adam's step count) and
    hyperparameters are collectively identical and come from rank 0."""
    if not shards:
        raise ValueError("merge_opt_shards needs at least one shard")

    def _merge(*leaves):
        if _is_array(leaves[0]) and leaves[0].ndim >= 1:
            if isinstance(leaves[0], torch.Tensor):
                return torch.cat([torch.as_tensor(l) for l in leaves])
            return np.concatenate([np.asarray(l) for l in leaves])
        return leaves[0]

    return tree_map(_merge, *shards)


def split_opt_state(full, world: int, size: int) -> List[Any]:
    """Inverse of :func:`merge_opt_shards`: a flat-vector opt state over
    ``size`` parameters -> ``world`` per-rank shards on the
    ``shard_bounds`` layout. 1-D leaves of length ``size`` are sliced
    (copied); everything else (scalars, hyperparameters) replicates."""
    def _slice(lo, hi):
        def f(leaf):
            if _is_array(leaf) and leaf.ndim == 1 and leaf.shape[0] == size:
                piece = leaf[lo:hi]
                return piece.clone() if isinstance(piece, torch.Tensor) \
                    else piece.copy()
            return leaf
        return f

    return [tree_map(_slice(lo, hi), full)
            for lo, hi in shard_bounds(size, world)]


def _param_shapes(params) -> List[Tuple[int, ...]]:
    return [tuple(torch.as_tensor(l).shape)
            for l in tree_flatten(params)[0]]


def flatten_opt_state(state, params):
    """Replicated TREE-plane opt state (the ``state_dict()`` of an
    optimizer over ``params``' leaves in :func:`tree_flatten` order) ->
    the flat-vector plane (the ``state_dict()`` of the same optimizer
    over one flat parameter): each per-parameter state tensor shaped like
    its parameter (Adam's moments, SGD's momentum) is raveled and
    concatenated on the :func:`flatten_tree` layout; other per-parameter
    entries (Adam's step) come from parameter 0. This is the grow path —
    a dp=1 engine's full opt state becomes ZeRO shards for dp>1."""
    shapes = _param_shapes(params)
    per = state["state"]
    flat_entry = {}
    if per:
        for key, v0 in per[0].items():
            vals = [per[i][key] for i in range(len(shapes))]
            if all(isinstance(v, torch.Tensor) and tuple(v.shape) == s
                   for v, s in zip(vals, shapes)) and v0.ndim >= 1:
                flat_entry[key] = torch.cat([v.reshape(-1) for v in vals])
            else:
                flat_entry[key] = v0
    groups = [dict(g, params=[0]) for g in state["param_groups"]]
    return {"state": {0: flat_entry} if per else {}, "param_groups": groups}


def unflatten_opt_state(flat_state, spec: TreeSpec):
    """Flat-vector-plane opt state -> the replicated TREE plane: 1-D
    state tensors of length ``spec.size`` split back into
    parameter-shaped pieces, one state entry per parameter (the
    shrink-to-dp=1 path)."""
    entry = flat_state["state"].get(0)
    per = {}
    if entry:
        off = 0
        for i, shape in enumerate(spec.shapes):
            n = int(np.prod(shape)) if shape else 1
            per[i] = {
                k: (v[off:off + n].reshape(shape).clone()
                    if isinstance(v, torch.Tensor) and v.ndim == 1
                    and v.shape[0] == spec.size else v)
                for k, v in entry.items()}
            off += n
    groups = [dict(g, params=list(range(len(spec.shapes))))
              for g in flat_state["param_groups"]]
    return {"state": per, "param_groups": groups}


def host_state_dict(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with every state tensor copied to the CPU (a
    checkpoint must not alias tensors the next step updates in place,
    nor pin device memory)."""
    return tree_map(
        lambda t: t.detach().to("cpu", copy=True)
        if isinstance(t, torch.Tensor) else t, opt.state_dict())


def optimizer_state_bytes(opt: torch.optim.Optimizer) -> int:
    """Bytes of the optimizer's state tensors."""
    return sum(t.numel() * t.element_size()
               for st in opt.state.values() for t in st.values()
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# cross-actor dp groups over parallel/collective.py
# ---------------------------------------------------------------------------


class ZeroUpdater:
    """Rank-local view of a ZeRO-sharded optimizer over a host collective
    group.

    Each dp replica constructs one with its rank, builds the optimizer
    for ITS shard only (the ~1/dp memory win), and calls :meth:`update`
    once per optimizer step. The gradient mean, shard update, and
    parameter gather all ride the named collective group — every rank
    must call update() collectively. The shard lives on the parameters'
    device; the collectives carry CPU copies.

    ``grad_codec`` (``"int8"``/``"e4m3"``) compresses BOTH wire legs of
    the dp sync with the block-scaled codec: the gradient reduce-scatter
    ships quantized grads (summed in fp32 after dequantize) and the
    parameter all-gather ships quantized fresh shards. So the
    wire-precision params don't become the optimization state itself
    (sub-quantization-step updates would round away and training would
    stall on the int8 grid), each rank keeps a persistent fp32 MASTER
    copy of its own shard: the optimizer updates the master, the wire
    carries its quantized image, and compute everywhere runs on the
    wire-precision params. ``grad_codec=None`` re-reads the shard from
    the incoming params every update, as the JAX package does.
    """

    def __init__(self, tx, world: int, rank: int,
                 group_name: str = "default",
                 grad_codec: Optional[str] = None):
        from . import quant as _quant

        self.tx = tx
        self.world = int(world)
        self.rank = int(rank)
        self.group_name = group_name
        self.grad_codec = _quant.check_codec(grad_codec)
        self._spec: Optional[TreeSpec] = None
        self._shard: Optional[torch.Tensor] = None  # the optimizer's leaf
        self._opt: Optional[torch.optim.Optimizer] = None
        # codec path: whether _shard holds the fp32 master (False after a
        # restore without one: re-seeded from the next update's params)
        self._have_master = False
        # collective sync-exposed wall time: the two wire legs of the last
        # update() and the running total
        self.last_rs_s = 0.0   # gradient reduce-scatter leg
        self.last_ag_s = 0.0   # parameter all-gather leg
        self.sync_s = 0.0      # cumulative rs+ag over this updater's life

    def init(self, params) -> "ZeroUpdater":
        flat, spec = flatten_tree(params)
        self._spec = spec
        lo, hi = shard_bounds(spec.size, self.world)[self.rank]
        self._shard = flat[lo:hi].clone()
        self._opt = self.tx([self._shard])
        self._have_master = True
        return self

    def opt_state_bytes(self) -> int:
        """Bytes of optimizer state THIS replica holds (~ full/dp)."""
        return optimizer_state_bytes(self._opt)

    def opt_state(self):
        """This rank's optimizer-state SHARD (checkpointing surface — the
        pipeline engine persists one shard per dp rank and hands it back
        through :meth:`set_opt_state` on restore). With a ``grad_codec``
        the fp32 master shard rides along as a shard-sized leaf
        (``{"tx": ..., "master": ...}``) so the reshard vocabulary
        (merge/split over shard-sized leaves) moves it across dp widths
        like any other moment."""
        state = host_state_dict(self._opt)
        if self.grad_codec is not None:
            return {"tx": state, "master": self._shard.detach().cpu()}
        return state

    def set_opt_state(self, state) -> None:
        """Restore this rank's shard (must come from the same (rank,
        world, param-tree) layout it was saved under). Accepts both the
        bare optimizer state and the codec's ``{"tx", "master"}``
        wrapper; a bare state under a codec updater re-seeds the master
        from the next update's incoming params."""
        if self._spec is None:
            raise RuntimeError("ZeroUpdater.set_opt_state() before init()")
        if isinstance(state, dict) and set(state) == {"tx", "master"}:
            self._opt.load_state_dict(state["tx"])
            with torch.no_grad():
                self._shard.copy_(torch.as_tensor(state["master"]))
            self._have_master = True
        else:
            self._opt.load_state_dict(state)
            if self.grad_codec is not None:
                self._have_master = False

    def update(self, params, grads):
        """Collective optimizer step: reduce-scatter the gradient mean,
        update this rank's shard, all-gather fresh parameters. Returns
        the full updated parameter tree. With ``grad_codec`` both
        collectives ship block-scaled quantized payloads and the
        optimizer runs on this rank's fp32 master shard."""
        from . import collective

        if self._spec is None:
            raise RuntimeError("ZeroUpdater.update() before init()")
        flat_g, gspec = flatten_tree(grads)
        if gspec.size != self._spec.size:
            raise ValueError(
                f"grad tree size {gspec.size} != param tree size "
                f"{self._spec.size}")
        codec = self.grad_codec
        dev, dtype = self._shard.device, self._spec.dtype
        # reducescatter SUMS then slices; divide for the dp mean
        # (codec: rows dequantize to fp32 BEFORE the sum, so gradient
        # accumulation precision is full — only the wire is narrow)
        t0 = time.perf_counter()
        g_shard = collective.reducescatter(
            flat_g.cpu(), self.group_name, codec=codec) / self.world
        self.last_rs_s = time.perf_counter() - t0
        lo, hi = shard_bounds(self._spec.size, self.world)[self.rank]
        if codec is None or not self._have_master:
            flat_p, _ = flatten_tree(params)
            with torch.no_grad():
                self._shard.copy_(flat_p[lo:hi])
            self._have_master = True
        self._shard.grad = g_shard.to(device=dev, dtype=dtype)
        self._opt.step()
        self._shard.grad = None
        t1 = time.perf_counter()
        parts = collective.allgather(self._shard.detach().cpu(),
                                     self.group_name, codec=codec)
        self.last_ag_s = time.perf_counter() - t1
        self.sync_s += self.last_rs_s + self.last_ag_s
        full = torch.cat(parts).to(device=dev, dtype=dtype)
        return unflatten_tree(full, self._spec)


# ---------------------------------------------------------------------------
# over a mesh axis of gang ranks: psum_scatter / all_gather in a
# shard_map body (parallel/sharding/lower.py)
# ---------------------------------------------------------------------------


def make_zero_update_spmd(tx, mesh, axis: str = "dp",
                          grad_codec: Optional[str] = None,
                          codec_block: int = 256
                          ) -> Tuple[Callable, Callable]:
    """Build the sharded update over a mesh axis: ``(init_fn, update_fn)``.
    ``mesh`` is a ``MeshOwner`` (or a torch ``DeviceMesh``) over gang
    ranks, every one of which calls both functions collectively.

    ``grad_codec`` ("int8"/"e4m3") swaps the gradient ``psum_scatter``
    for the quantized scatter (``parallel/sharding/codec.py``,
    ``quantized_scatter_mean``): per-block absmax quantize -> all_to_all ->
    dequantize -> f32 sum, so the wire carries about a quarter of the
    gradient bytes; the parameter all-gather stays full precision.
    ``grad_codec=None`` is the exact update.

    - ``init_fn(params)`` -> this rank's optimizer state: ``tx`` built over
      its 1/world chunk of the flat parameter vector only.
    - ``update_fn(params, grads, opt_state)`` -> ``(new_params,
      opt_state)``. Where the JAX package passes ``grads_stacked``, a
      leading axis of per-replica gradients sharded over ``axis``, each
      rank of the port passes its OWN gradient tree. ``psum_scatter``
      hands each rank its chunk of the cross-replica sum (a sequential
      sum in rank order), the optimizer steps that chunk of ``params``
      (re-read every update), and a tiled ``all_gather`` rebuilds the full
      parameter vector: no rank holds the full optimizer state. The state
      steps in place and is returned.

    The flat vector is zero-padded to a multiple of the axis size so the
    chunks tile exactly.
    """
    from . import quant as _quant
    from .sharding import lower
    from .sharding.owner import MeshOwner

    _quant.check_codec(grad_codec)
    owner = mesh if isinstance(mesh, MeshOwner) else MeshOwner.from_mesh(mesh)
    world = owner.axis_size(axis)

    def _pad(flat):
        return pad_flat(flat, flat.numel() + (-flat.numel()) % world)

    def _shard_map(fn, *args):
        return lower.lower_shard_map(
            fn, owner, in_specs=tuple(None for _ in args), out_specs=None,
            axis_names=frozenset({axis}))(*args)

    def init_fn(params):
        flat = _pad(flatten_tree(params)[0])
        chunk = flat.numel() // world

        def _init_local(p_local):
            lo = lower.axis_index(axis) * chunk
            return tx([p_local[lo:lo + chunk].clone()])

        return _shard_map(_init_local, flat)

    def update_fn(params, grads, opt_state):
        flat_p, spec = flatten_tree(params)
        flat_p = _pad(flat_p)
        chunk = flat_p.numel() // world
        flat_g, gspec = flatten_tree(grads)
        if gspec.size != spec.size:
            raise ValueError(f"grad tree size {gspec.size} != param tree "
                             f"size {spec.size}")
        flat_g = _pad(flat_g)
        p_shard = opt_state.param_groups[0]["params"][0]

        def _upd_local(p_local, g_local):
            # psum_scatter hands back chunk #idx of the cross-replica SUM;
            # with a codec the quantized body decomposes it so only narrow
            # payloads cross the wire (f32 sum after dequantize)
            if grad_codec is None:
                g_shard = lower.psum_scatter(g_local, axis, tiled=True) \
                    / world
            else:
                from .sharding.codec import quantized_scatter_mean

                g_shard = quantized_scatter_mean(
                    g_local, axis, world, codec=grad_codec,
                    block=codec_block)
            lo = lower.axis_index(axis) * chunk
            with torch.no_grad():
                p_shard.copy_(p_local[lo:lo + chunk])
            p_shard.grad = g_shard.to(device=p_shard.device,
                                      dtype=p_shard.dtype)
            opt_state.step()
            p_shard.grad = None
            return lower.all_gather(p_shard.detach(), axis, tiled=True)

        new_flat = _shard_map(_upd_local, flat_p, flat_g)
        return (unflatten_tree(new_flat[:spec.size].to(flat_p.device),
                               spec), opt_state)

    return init_fn, update_fn
