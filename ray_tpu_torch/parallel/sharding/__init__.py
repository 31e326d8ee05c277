"""ray_tpu_torch.parallel.sharding — the sharded execution layer
(counterpart of ray_tpu/parallel/sharding, with its names).

- :class:`SpecLayout` (layout.py) — the ``data``/``fsdp``/``tp`` axis
  vocabulary producing canonical PartitionSpecs per parameter family,
  bridged to model ``logical_axes()`` tables.
- :class:`MeshOwner` (owner.py) — builds/validates a
  ``torch.distributed`` DeviceMesh over ranks and is the single
  sharding factory.
- lowering helpers (lower.py) — :func:`lower_jit` (DTensor plane),
  :func:`lower_shard_map` (manual plane: explicit collectives over
  owner-bound axes) and :func:`sharded_init`.
- tensor_parallel.py — the explicit (Megatron) tensor-parallel split of
  the serving models over a tp group, which the tp engine runs.

``FsdpPlane`` / ``FsdpParams`` (the in-program fsdp plane) are not ported
yet (ROADMAP A4.2) and raise.
"""
from .layout import DEFAULT_LAYOUT, LOGICAL_TO_AXES, SpecLayout, prune_spec
from .lower import lower_jit, lower_shard_map, sharded_init
from .owner import MeshOwner


class _NotPorted:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}, the in-program fsdp plane, is not "
            "ported yet (ROADMAP.md A4.2)")


class FsdpPlane(_NotPorted):
    """Not ported yet (ROADMAP A4.2)."""


class FsdpParams(_NotPorted):
    """Not ported yet (ROADMAP A4.2)."""


__all__ = [
    "DEFAULT_LAYOUT", "FsdpParams", "FsdpPlane", "LOGICAL_TO_AXES",
    "MeshOwner", "SpecLayout", "lower_jit", "lower_shard_map",
    "prune_spec", "sharded_init",
]
