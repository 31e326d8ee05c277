"""Device-mesh construction and sharding rules (counterpart of
ray_tpu/parallel/mesh.py, with its names).

The JAX package's unit of parallelism is a ``jax.sharding.Mesh`` over
devices; the port's is a ``torch.distributed.device_mesh.DeviceMesh`` over
ranks of the world process group (one rank per process, formed by
``init_process_group``; ``parallel/mesh_group.py`` forms a gang of such
ranks). This module owns:

- ``MeshSpec``: declarative parallelism degrees (dp/fsdp/tp/sp/ep/pp).
- ``build_mesh``: ranks -> DeviceMesh, axes outermost (dp, pp) to
  innermost (tp), as the JAX package lays devices out.
- ``PartitionSpec`` / ``NamedSharding``: the port's own small spec tuple
  (the JAX package's canonical form: a one-name tuple entry is the name)
  and a (mesh, spec) pair that also gives its DTensor placements.
- logical axis rules: model code annotates parameters with logical axes
  ("batch", "embed", "heads", ...) which map to mesh axes here.

Mesh ownership (who builds a mesh and hands out shardings) lives in
``parallel.sharding.MeshOwner``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

# Canonical mesh axis names, outermost first: the JAX package's order
# (data outermost, model innermost).
MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

Axes = Union[str, Tuple[str, ...], None]


def _canonical(entry: Any) -> Axes:
    """One spec entry in canonical form: a tuple of one axis is that axis,
    an empty tuple is None (as ``jax.sharding.PartitionSpec`` keeps them)."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """How each dimension of a tensor is split over mesh axes: per
    dimension None (whole), an axis name, or a tuple of axis names (the
    first the most major). Equal to the JAX package's PartitionSpec
    spelled the same way, and to a plain tuple of the same entries."""

    def __new__(cls, *partitions):
        return super().__new__(cls, tuple(_canonical(p) for p in partitions))

    def __eq__(self, other):
        if isinstance(other, tuple):
            return tuple.__eq__(self, tuple(_canonical(o) for o in other))
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


@dataclass(frozen=True)
class MeshSpec:
    """Parallelism degrees. -1 on exactly one axis means "fill with all
    remaining ranks" (like torch DeviceMesh / t5x partitioning).

    ``slices`` > 1 declares a multi-slice job: ranks span that many groups
    with no fast interconnect between them; the mesh gains an outermost
    "slice" axis."""
    dp: int = -1      # pure data parallel (replicated params)
    fsdp: int = 1     # data parallel with sharded params (zero-3 style)
    tp: int = 1       # tensor (megatron) parallel
    sp: int = 1       # sequence/context parallel (ring attention axis)
    ep: int = 1       # expert parallel (MoE)
    pp: int = 1       # pipeline parallel
    slices: int = 1   # slices (outermost axis when > 1)

    def degrees(self) -> Dict[str, int]:
        return {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                "ep": self.ep, "sp": self.sp, "tp": self.tp}

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Fill the single -1 axis so the per-slice product equals
        n_devices / slices."""
        if self.slices < 1:
            raise ValueError(f"slices must be >= 1, got {self.slices}")
        if n_devices % self.slices:
            raise ValueError(
                f"{n_devices} devices not divisible into {self.slices} slices")
        per_slice = n_devices // self.slices
        d = self.degrees()
        wild = [k for k, v in d.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"At most one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in d.values() if v != -1)
        if wild:
            if per_slice % fixed:
                raise ValueError(
                    f"{per_slice} per-slice devices not divisible by fixed "
                    f"axes product {fixed}")
            d[wild[0]] = per_slice // fixed
        elif fixed != per_slice:
            raise ValueError(
                f"Mesh {d} wants {fixed} devices/slice but {per_slice} "
                f"are available")
        return d


def world_ranks() -> List[int]:
    """Every rank of the default process group, which must exist."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: a mesh spans the ranks of "
            "one (MeshGroup forms it, or call init_process_group)")
    return list(range(dist.get_world_size()))


def default_device_type() -> str:
    """"cuda", the port's default, or an error where there is none: a
    mesh on the CPU is asked for by name (``device_type="cpu"``)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh is on the CUDA card by default and none is available "
            "here; pass device_type='cpu' for a mesh of CPU ranks")
    return "cuda"


def _device_mesh(ranks, shape: Tuple[int, ...], axis_names: Sequence[str],
                 device_type: Optional[str]):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type or default_device_type(),
                      torch.tensor(list(ranks), dtype=torch.int64
                                   ).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def build_mesh(spec: Union[MeshSpec, Dict[str, int], None] = None,
               devices: Optional[Sequence[int]] = None,
               axis_names: Sequence[str] = MESH_AXES,
               device_type: Optional[str] = None):
    """Build a DeviceMesh from a spec over the given ranks (default: every
    rank of the world group). A MeshSpec with slices > 1 produces an
    outermost "slice" axis over per-slice meshes. Every rank of the world
    group must call it (the mesh's process groups are formed
    collectively)."""
    ranks = list(devices if devices is not None else world_ranks())
    if spec is None:
        spec = MeshSpec()
    if isinstance(spec, MeshSpec) and spec.slices > 1:
        return build_multislice_mesh(spec, ranks, axis_names, device_type)
    degrees = spec.resolve(len(ranks)) if isinstance(spec, MeshSpec) \
        else dict(spec)
    shape = tuple(degrees[a] for a in axis_names)
    return _device_mesh(ranks, shape, axis_names, device_type)


def group_devices_by_slice(devices: Sequence[Any],
                           num_slices: int) -> List[List[Any]]:
    """Partition ranks into their slices: items that carry a
    ``slice_index`` group by it; plain ranks split into contiguous equal
    groups."""
    by_idx: Dict[int, List[Any]] = {}
    if all(getattr(d, "slice_index", None) is not None for d in devices):
        for d in devices:
            by_idx.setdefault(d.slice_index, []).append(d)
        if len(by_idx) == num_slices:
            return [by_idx[i] for i in sorted(by_idx)]
        raise ValueError(
            f"spec wants {num_slices} slices but devices report "
            f"{len(by_idx)} distinct slice_index values")
    per = len(devices) // num_slices
    return [list(devices[i * per:(i + 1) * per]) for i in range(num_slices)]


def build_multislice_mesh(spec: MeshSpec,
                          devices: Optional[Sequence[int]] = None,
                          axis_names: Sequence[str] = MESH_AXES,
                          device_type: Optional[str] = None):
    """Compose per-slice meshes under an outermost "slice" axis:
    collectives that name "slice" cross slices, all other axes stay
    within one."""
    ranks = list(devices if devices is not None else world_ranks())
    degrees = spec.resolve(len(ranks))
    inner_shape = tuple(degrees[a] for a in axis_names)
    groups = group_devices_by_slice(ranks, spec.slices)
    flat = [int(r) for g in groups for r in g]
    return _device_mesh(flat, (spec.slices, *inner_shape),
                        ("slice", *axis_names), device_type)


def virtual_mesh(n_devices: int,
                 spec: Union[MeshSpec, Dict[str, int], None] = None,
                 device_type: Optional[str] = None):
    """Mesh over the first n ranks of the world group."""
    return build_mesh(spec, devices=world_ranks()[:n_devices],
                      device_type=device_type)


def local_mesh(device_type: Optional[str] = None):
    """A dp-major mesh over every rank of the world group."""
    return build_mesh(MeshSpec(dp=-1), device_type=device_type)


def mesh_shape_for(n_devices: int, prefer_tp: int = 1) -> MeshSpec:
    """Heuristic spec: cap tp at prefer_tp (and at n), rest goes to dp."""
    tp = math.gcd(prefer_tp, n_devices)
    return MeshSpec(dp=-1, tp=tp)


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a PartitionSpec over its axis names (the pair the JAX
    package's NamedSharding is)."""
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> list:
        """The DTensor placements of this sharding, one per mesh
        dimension: ``Shard(d)`` where tensor dimension d names the mesh
        axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        on = {}
        for d, entry in enumerate(self.spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    on[axis] = d
        return [Shard(on[a]) if a in on else Replicate()
                for a in self.mesh.mesh_dim_names]


# ---------------------------------------------------------------------------
# Logical axis rules
# ---------------------------------------------------------------------------

#: rule list: logical axis name -> mesh axis (or tuple of mesh axes, or None)
Rules = Sequence[Tuple[str, Union[str, Tuple[str, ...], None]]]


@dataclass
class AxisRules:
    """Maps logical axis names used by model code to physical mesh axes.
    First matching rule wins; unknown logical axes are unsharded (None).
    """
    rules: Rules = field(default_factory=lambda: default_axis_rules())

    def mesh_axes(self, logical: Sequence[Optional[str]]) -> PartitionSpec:
        out: List[Union[str, Tuple[str, ...], None]] = []
        for name in logical:
            if name is None:
                out.append(None)
                continue
            for key, axes in self.rules:
                if key == name:
                    out.append(axes)
                    break
            else:
                out.append(None)
        # Trim trailing Nones (canonical PartitionSpec form).
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)


def default_axis_rules(fsdp_enabled: bool = True,
                       multislice: bool = False) -> Rules:
    """The standard decoder-LM mapping: batch -> dp(+fsdp), sequence ->
    sp, embed -> fsdp (param sharding), heads/mlp/vocab -> tp, experts ->
    ep, pipeline stage -> pp. multislice=True prepends the "slice" axis to
    the batch mapping."""
    if multislice:
        batch_axes = (("slice", "dp", "fsdp") if fsdp_enabled
                      else ("slice", "dp"))
        return (("batch", batch_axes),) + tuple(
            r for r in default_axis_rules(fsdp_enabled) if r[0] != "batch")
    return (
        ("batch", ("dp", "fsdp") if fsdp_enabled else "dp"),
        ("seq", "sp"),
        ("embed", "fsdp" if fsdp_enabled else None),
        ("heads", "tp"),
        ("kv", None),
        ("mlp", "tp"),
        ("vocab", "tp"),
        ("expert", "ep"),
        ("stage", "pp"),
    )


def _map_logical(fn, tree):
    """Apply fn to every logical-axis tuple in a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_logical(fn, v) for v in tree]
    return fn(tree)


def logical_to_mesh(tree: Any, logical_tree: Any, mesh,
                    rules: Optional[AxisRules] = None) -> Any:
    """Map a tree of logical-axis tuples to a tree of NamedShardings."""
    rules = rules or AxisRules()
    return _map_logical(
        lambda logical: NamedSharding(mesh, rules.mesh_axes(logical)),
        logical_tree)


def named_sharding(mesh, *axes: Union[str, Tuple[str, ...], None]
                   ) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*axes))


def shard_constraint(x: Any, mesh, *logical: Optional[str],
                     rules: Optional[AxisRules] = None) -> Any:
    """Lay ``x`` out as its logical axes say: a DTensor is redistributed
    to the spec's placements, a plain tensor (a full value on every rank)
    is distributed as a DTensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    rules = rules or AxisRules()
    placements = NamedSharding(mesh, rules.mesh_axes(logical)).placements()
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)
