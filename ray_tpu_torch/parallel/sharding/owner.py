"""MeshOwner — the one place device meshes are built, validated, and
handed out (counterpart of ray_tpu/parallel/sharding/owner.py, with its
names).

``MeshOwner`` builds a ``torch.distributed.device_mesh.DeviceMesh`` over
ranks of the world process group (through ``parallel.mesh.build_mesh``),
validates the degree layout against the ranks there are, carries the
:class:`SpecLayout`, and is the only factory for shardings — pruning spec
axes the mesh doesn't carry, so the canonical family specs target any
mesh shape.

Where the JAX package places a whole array on a mesh and reads its
per-device shards back, a rank of the port holds only its own shard:
``place`` returns this rank's shard of a full tensor and
``per_device_bytes`` counts what this rank holds. Every rank of the world
group constructs the owner (the mesh's process groups are formed
collectively); ``ray_tpu_mesh_devices`` gauges every live owner.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from ...util import metrics as _metrics
from ..mesh import (MESH_AXES, MeshSpec, NamedSharding, PartitionSpec,
                    _device_mesh, build_mesh, world_ranks)
from .layout import DEFAULT_LAYOUT, SpecLayout, prune_spec

_G_MESH = _metrics.Gauge(
    "ray_tpu_mesh_devices",
    "devices spanned by a live MeshOwner", tag_keys=("owner",))


def _tree_map(fn, tree, *rest):
    """Map fn over the leaves of a tree of dicts, lists and tuples (a
    PartitionSpec, a tensor or None is a leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


class MeshOwner:
    """Owns one device mesh + its SpecLayout.

    Build from a :class:`MeshSpec` (or plain ``{axis: degree}`` dict) over
    ranks of the world group, or adopt an existing DeviceMesh with
    :meth:`from_mesh`. All sharding decisions downstream go through
    :meth:`sharding` / :meth:`param_shardings` / :meth:`place`.
    ``device_type`` is "cuda" unless given ("cpu" for CPU ranks).
    """

    _ids = itertools.count()

    def __init__(self, spec: Union[MeshSpec, Dict[str, int], None] = None,
                 devices: Optional[Sequence[int]] = None,
                 layout: Optional[SpecLayout] = None,
                 name: str = "", device_type: Optional[str] = None):
        devices = list(devices if devices is not None else world_ranks())
        if isinstance(spec, dict):
            # partial degree dicts are the common spelling ({"tp": 2});
            # fill the other axes at 1 and take exactly the ranks the
            # layout needs (-1 wildcards keep every rank)
            spec = {a: int(spec.get(a, 1)) for a in MESH_AXES}
            if all(v > 0 for v in spec.values()):
                need = math.prod(spec.values())
                if need > len(devices):
                    raise ValueError(
                        f"mesh {spec} needs {need} devices; "
                        f"{len(devices)} available (ranks of the world "
                        f"process group: start that many, e.g. through "
                        f"MeshGroup)")
                devices = devices[:need]
        self._adopt(build_mesh(spec, devices=devices,
                               device_type=device_type), layout, name)

    def _adopt(self, mesh, layout: Optional[SpecLayout], name: str) -> None:
        self.mesh = mesh
        self.layout = layout or DEFAULT_LAYOUT
        self.name = name or f"mesh-{next(self._ids)}"
        self.axis_sizes: Dict[str, int] = dict(
            zip(mesh.mesh_dim_names, mesh.shape))
        _G_MESH.set(self.num_devices, tags={"owner": self.name})

    @classmethod
    def from_mesh(cls, mesh, layout: Optional[SpecLayout] = None,
                  name: str = "") -> "MeshOwner":
        self = cls.__new__(cls)
        self._adopt(mesh, layout, name)
        return self

    @classmethod
    def _one_axis_mesh(cls, what: str, axis: str, n: int,
                       devices: Optional[Sequence[int]],
                       layout: Optional[SpecLayout], name: str,
                       device_type: Optional[str]) -> "MeshOwner":
        devices = list(devices if devices is not None else world_ranks())
        if n < 1:
            raise ValueError(f"{what} must be >= 1, got {n}")
        if n > len(devices):
            raise ValueError(
                f"{what}={n} needs {n} devices; {len(devices)} available "
                f"(ranks of the world process group)")
        mesh = _device_mesh(devices[:n], (n,), (axis,), device_type)
        return cls.from_mesh(mesh, layout=layout, name=name)

    @classmethod
    def tp_mesh(cls, tp: int, devices: Optional[Sequence[int]] = None,
                layout: Optional[SpecLayout] = None, name: str = "",
                device_type: Optional[str] = None) -> "MeshOwner":
        """One-axis tensor-parallel mesh over the first ``tp`` ranks —
        the serve-replica shape (one replica = one mesh spanning tp
        ranks)."""
        lay = layout or DEFAULT_LAYOUT
        return cls._one_axis_mesh("tp", lay.tp_axis, tp, devices, lay,
                                  name, device_type)

    @classmethod
    def fsdp_mesh(cls, fsdp: int, devices: Optional[Sequence[int]] = None,
                  layout: Optional[SpecLayout] = None, name: str = "",
                  device_type: Optional[str] = None) -> "MeshOwner":
        """One-axis fsdp mesh over the first ``fsdp`` ranks — the
        pipeline-stage shape."""
        lay = layout or DEFAULT_LAYOUT
        return cls._one_axis_mesh("fsdp", lay.fsdp_axis, fsdp, devices,
                                  lay, name, device_type)

    # -- introspection ------------------------------------------------------

    @property
    def num_devices(self) -> int:
        return int(math.prod(self.axis_sizes.values())) \
            if self.axis_sizes else 1

    @property
    def devices(self):
        """The mesh's ranks in mesh order."""
        return [int(r) for r in self.mesh.mesh.flatten().tolist()]

    def axis_size(self, axis: str) -> int:
        return self.axis_sizes.get(axis, 1)

    def coordinate(self) -> Optional[Dict[str, int]]:
        """This rank's index along each mesh axis (None off the mesh)."""
        coord = self.mesh.get_coordinate()
        if coord is None:
            return None
        return dict(zip(self.mesh.mesh_dim_names, coord))

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "axes": dict(self.axis_sizes),
                "devices": self.num_devices,
                "platform": self.mesh.device_type}

    # -- sharding factory ---------------------------------------------------

    def sharding(self, spec) -> NamedSharding:
        """PartitionSpec (or logical-axis tuple) -> NamedSharding on this
        mesh, with axes the mesh doesn't carry pruned to replication."""
        if spec is None:
            spec = PartitionSpec()
        elif not isinstance(spec, PartitionSpec):
            spec = self.layout.spec_for_logical(spec)
        return NamedSharding(self.mesh, prune_spec(spec, self.axis_sizes))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, PartitionSpec())

    def param_shardings(self, model) -> Dict[str, NamedSharding]:
        """Per-param NamedShardings from the model's logical axes through
        the layout's family mapping."""
        return {name: self.sharding(spec)
                for name, spec in self.layout.param_specs(model).items()}

    def _bounds(self, spec: PartitionSpec, shape: Tuple[int, ...]):
        """This rank's [lo, hi) along each dimension of a tensor of
        ``shape`` sharded by ``spec`` (already pruned)."""
        coord = self.coordinate()
        if coord is None:
            raise ValueError(f"rank is not on mesh {self.name!r}")
        out = []
        for d, n in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            parts, idx = 1, 0
            for a in axes:               # the first axis is the most major
                idx = idx * self.axis_size(a) + coord[a]
                parts *= self.axis_size(a)
            if n % parts:
                raise ValueError(
                    f"dimension {d} of size {n} does not tile {parts} "
                    f"shards of spec {spec}")
            step = n // parts
            out.append((idx * step, (idx + 1) * step))
        return out

    def local_shard(self, x, spec):
        """This rank's shard of the full tensor ``x`` under ``spec`` (a
        PartitionSpec, a logical-axis tuple or None), as a tensor of its
        own: the full tensor can be freed."""
        sh = self.sharding(spec)
        idx = tuple(slice(lo, hi) for lo, hi in
                    self._bounds(sh.spec, tuple(x.shape)))
        return x[idx].clone()

    def place(self, tree, specs=None):
        """This rank's shards of a tree of full tensors. ``specs`` may be
        a matching tree of PartitionSpecs, a single spec for every leaf,
        or None (replicate: each rank keeps its own copy)."""
        if specs is None or isinstance(specs, PartitionSpec):
            return _tree_map(lambda x: self.local_shard(x, specs), tree)
        return _tree_map(lambda x, s: self.local_shard(x, s), tree, specs)

    # -- validation ---------------------------------------------------------

    def validate_divisible(self, axis: str, dim: int, what: str) -> None:
        """Loud error when a dimension can't tile the mesh axis and the
        caller requires exact tiling."""
        size = self.axis_size(axis)
        if size > 1 and dim % size:
            raise ValueError(
                f"{what} dimension {dim} not divisible by mesh axis "
                f"{axis!r} (size {size})")

    def per_device_bytes(self, tree) -> Dict[int, int]:
        """{this rank: bytes of the tensors in ``tree``} — what this rank
        keeps resident (each rank reports its own; a gang gathers
        them)."""
        import torch
        import torch.distributed as dist

        total = [0]

        def add(x):
            if isinstance(x, torch.Tensor):
                total[0] += x.numel() * x.element_size()
            return x

        _tree_map(add, tree)
        return {dist.get_rank(): total[0]}
