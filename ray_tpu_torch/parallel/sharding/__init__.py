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
- :class:`FsdpPlane` / :class:`FsdpParams` (fsdp.py) — sharded parameter
  and optimizer storage over a gang's fsdp axis (ZeRO-3 style), what a
  pipeline stage with ``fsdp > 1`` runs on.
- codec.py — the quantized reduce-scatter of ``make_zero_update_spmd``
  (``quantize_blocks``, ``quantized_scatter_mean``, ...).
"""
from .fsdp import FsdpParams, FsdpPlane
from .layout import DEFAULT_LAYOUT, LOGICAL_TO_AXES, SpecLayout, prune_spec
from .lower import lower_jit, lower_shard_map, sharded_init
from .owner import MeshOwner

__all__ = [
    "DEFAULT_LAYOUT", "FsdpParams", "FsdpPlane", "LOGICAL_TO_AXES",
    "MeshOwner", "SpecLayout", "lower_jit", "lower_shard_map",
    "prune_spec", "sharded_init",
]
