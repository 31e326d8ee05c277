"""The fsdp plane — sharded parameter and optimizer storage for the
pipeline stages (counterpart of ray_tpu/parallel/sharding/fsdp.py, with
its names).

ZeRO-3-style storage over a mesh ``fsdp`` axis: between steps each rank
holds only its contiguous 1/fsdp chunk of the FLAT parameter vector and
the optimizer moments of that chunk; the forward gathers the exact full
vector once a step (a tiled all-gather is a pure concatenation, bit
exact), and the update is shard-local (each rank takes its chunk of the
gradient and steps the optimizer over its shard only).

Because the gather is exact and elementwise optimizers commute with
contiguous sharding, a stage trained on this plane has a loss trajectory
**bit-identical** to the replicated stage's.

Where the port differs from the JAX package. A JAX plane is one program
over the chips of one process; a rank of the port is a process with one
device, so the plane is SPMD: every rank of the fsdp axis (a gang, see
``parallel/mesh_group.py``) builds a plane over the same ``MeshOwner``
and calls each method collectively, in the same order.
- ``FsdpParams.flat`` is this rank's shard, not a global array.
- The optimizer state is a ``torch.optim.Optimizer`` (the port's ``tx``
  is a factory over a list of tensors, as for ``ZeroUpdater``) built over
  the shard itself: ``update`` steps it in place and returns the same
  objects.
- A rank may stand for the whole tree where the others have none: with
  ``src`` / ``dst`` set, :meth:`shard` and :meth:`update` scatter from
  that rank (the others pass None), and :meth:`gather` and :meth:`to_host`
  gather onto it. The pipeline stage, whose rank alone runs the forward
  and backward, uses them so that its peers hold shards and moments only.
- The collectives run over gloo, through the host
  (``lower.py``); the shards and moments stay on each rank's device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..zero import (TreeSpec, flatten_tree, host_state_dict, merge_opt_shards,
                    optimizer_state_bytes, pad_flat, split_opt_state,
                    tree_map, unflatten_tree)
from . import lower
from .owner import MeshOwner

__all__ = ["FsdpPlane", "FsdpParams"]


class FsdpParams:
    """One tree's sharded residence on one rank: this rank's chunk of the
    padded flat vector, the spec to unflatten it, and the padding."""

    __slots__ = ("flat", "spec", "pad")

    def __init__(self, flat, spec: TreeSpec, pad: int):
        self.flat = flat
        self.spec = spec
        self.pad = pad

    def nbytes_per_device(self) -> Dict[int, int]:
        """{this rank: bytes of its shard} (each rank reports its own, as
        ``MeshOwner.per_device_bytes`` does)."""
        import torch.distributed as dist

        return {dist.get_rank(): self.flat.numel() * self.flat.element_size()}


class FsdpPlane:
    """Sharded param/opt-state storage and its three operations (gather,
    opt-init, update) over one MeshOwner's fsdp axis. Every method is
    called by every rank of the axis (module docstring)."""

    def __init__(self, owner: MeshOwner, tx=None):
        import torch

        self.owner = owner
        self.axis = owner.layout.fsdp_axis
        self.world = owner.axis_size(self.axis)
        if self.world < 2:
            raise ValueError(
                f"FsdpPlane needs a mesh {self.axis!r} axis of size "
                f">= 2, got {self.world}")
        self.tx = tx
        # this rank's device: the mesh's type, on the card the rank chose
        self.device = torch.device(owner.mesh.device_type)

    # -- the axis ------------------------------------------------------------

    def _run(self, fn, *args):
        """``fn(*args)`` as a shard_map body bound to the fsdp axis (its
        collectives name that axis only)."""
        return lower.lower_shard_map(
            fn, self.owner, in_specs=tuple(None for _ in args),
            out_specs=None, axis_names=frozenset({self.axis}))(*args)

    # -- placement ----------------------------------------------------------

    def shard(self, tree, src: Optional[int] = None) -> FsdpParams:
        """Tree -> this rank's sharded residence (1/fsdp of the padded flat
        vector, on this rank's device). Every rank passes the full tree,
        or (``src`` set) the rank of index ``src`` does and scatters the
        chunks while the others pass None."""
        def body():
            flat = spec = None
            if src is None or lower.axis_index(self.axis) == src:
                flat, spec = flatten_tree(tree)
            if src is not None:
                spec = lower.broadcast_object(spec, self.axis, src)
            pad = (-spec.size) % self.world
            chunk = (spec.size + pad) // self.world
            if flat is not None:
                flat = pad_flat(flat, spec.size + pad)
            if src is None:
                lo = lower.axis_index(self.axis) * chunk
                mine = flat[lo:lo + chunk]
            else:
                mine = lower.scatter(flat, self.axis, src, (chunk,),
                                     spec.dtype)
            return FsdpParams(mine.to(self.device, copy=True), spec, pad)

        return self._run(body)

    def gather(self, fp: FsdpParams, dst: Optional[int] = None):
        """Sharded residence -> the full tree (an exact reassembly; the
        per-step transient the forward consumes), on every rank, or
        (``dst`` set) on the rank of index ``dst`` only (None elsewhere).
        Each leaf is a tensor of its own on this rank's device, as the
        replicated stage's are (a view into one flat buffer would hand the
        matmuls other alignments, and cuBLAS may pick other kernels)."""
        def body(shard):
            if dst is None:
                full = lower.all_gather(shard, self.axis, tiled=True)
            else:
                full = lower.gather(shard, self.axis, dst, tiled=True)
                if full is None:
                    return None
            return tree_map(lambda t: t.to(self.device, copy=True),
                            unflatten_tree(full[:fp.spec.size], fp.spec))

        # gathered on the host, where gloo runs, and moved leaf by leaf
        return self._run(body, fp.flat.detach().cpu())

    # -- optimizer ----------------------------------------------------------

    def init_opt(self, fp: FsdpParams):
        """Optimizer state for the LOCAL shard only: ``tx`` built over this
        rank's shard, so each rank materializes 1/fsdp of the moments."""
        if self.tx is None:
            raise ValueError("FsdpPlane built without an optimizer")
        return self.tx([fp.flat])

    def update(self, fp: FsdpParams, grads, opt_state,
               src: Optional[int] = None) -> Tuple[FsdpParams, Any]:
        """One sharded optimizer step. ``grads`` is the FULL gradient tree
        (already dp-synced by the caller when dp > 1) on every rank, each
        of which takes its chunk with no collective — or (``src`` set) on
        the rank of index ``src`` only, which scatters the chunks (one
        scatter a step; the others pass None). The shard and its moments
        step in place, bit-identical to the replicated update; returns
        ``(fp, opt_state)``."""
        if self.tx is None:
            raise ValueError("FsdpPlane built without an optimizer")
        chunk = fp.flat.numel()

        def body():
            flat_g = None
            if src is None or lower.axis_index(self.axis) == src:
                flat_g, gspec = flatten_tree(grads)
                if gspec.size != fp.spec.size:
                    raise ValueError(
                        f"grad tree size {gspec.size} != param tree size "
                        f"{fp.spec.size}")
                flat_g = pad_flat(flat_g, chunk * self.world)
            if src is None:
                lo = lower.axis_index(self.axis) * chunk
                return flat_g[lo:lo + chunk]
            return lower.scatter(flat_g, self.axis, src, (chunk,),
                                 fp.spec.dtype)

        g_shard = self._run(body)
        fp.flat.grad = g_shard.to(device=fp.flat.device,
                                  dtype=fp.flat.dtype)
        opt_state.step()
        fp.flat.grad = None
        return fp, opt_state

    # -- accounting / checkpointing -----------------------------------------

    def opt_state_bytes(self, opt_state) -> int:
        """Bytes of the optimizer state over the whole axis (every rank's
        moments: the reference counts its global arrays)."""
        return sum(self._run(lambda: lower.gather_objects(
            optimizer_state_bytes(opt_state), self.axis)))

    def per_device_bytes(self, fp: FsdpParams, opt_state=None
                         ) -> Dict[int, int]:
        """{rank: resident bytes (shard + moments)} for every rank of the
        axis — the ~1/fsdp acceptance number."""
        mine = fp.flat.numel() * fp.flat.element_size()
        if opt_state is not None:
            mine += optimizer_state_bytes(opt_state)

        def body():
            import torch.distributed as dist

            return lower.gather_objects((dist.get_rank(), mine), self.axis)

        return dict(self._run(body))

    def to_host(self, fp: FsdpParams, opt_state=None,
                dst: Optional[int] = None):
        """Checkpoint payload: the full params tree and the optimizer state
        as CPU tensors, on every rank or (``dst`` set) on that rank only
        (None, None elsewhere). The state is the ``state_dict`` of the
        optimizer over the whole padded flat vector (each rank's moments
        concatenated in rank order), so it carries this width's padding
        and restores onto the SAME fsdp width only (the pipeline engine's
        geometry check enforces it). Params restore onto any geometry."""
        full = self.gather(fp, dst)
        params = None if full is None else tree_map(
            lambda t: t.detach().to("cpu", copy=True), full)
        if opt_state is None:
            return params, None
        shards = self._run(lambda: lower.gather_objects(
            host_state_dict(opt_state), self.axis, dst))
        return params, None if shards is None else merge_opt_shards(shards)

    def from_host(self, params, opt, src: Optional[int] = None
                  ) -> Tuple[FsdpParams, Any]:
        """Restore a :meth:`to_host` payload (the same fsdp width for the
        optimizer state, which was saved in sharded-flat layout): on every
        rank, or (``src`` set) from that rank, the others passing None."""
        fp = self.shard(params, src)
        has_opt = opt is not None
        if src is not None:
            has_opt = self._run(lambda: lower.broadcast_object(
                has_opt, self.axis, src))
        if not has_opt:
            return fp, None
        return fp, self.place_opt(fp, opt, src)

    def place_opt(self, fp: FsdpParams, opt_host, src: Optional[int] = None):
        """Re-shard a host optimizer state (the merged ``state_dict`` of
        :meth:`to_host`) onto the ranks: an optimizer over this rank's
        shard, loaded with its chunk of every moment. Every rank passes
        the state, or (``src`` set) that rank does and scatters it."""
        size = fp.flat.numel() * self.world

        def body():
            if src is None:
                return split_opt_state(opt_host, self.world, size)[
                    lower.axis_index(self.axis)]
            pieces = None
            if lower.axis_index(self.axis) == src:
                pieces = split_opt_state(opt_host, self.world, size)
            return lower.scatter_objects(pieces, self.axis, src)

        opt = self.init_opt(fp)
        opt.load_state_dict(self._run(body))
        return opt

