"""ray_tpu_torch.parallel — the parallel layer of the port (counterpart of
ray_tpu/parallel).

- ``quant``: the block-scaled wire codecs (int8, e4m3) of the
  compiled-graph channels and the host collectives;
- ``collective``: actor-to-actor collectives over the object store
  (allreduce/allgather/reducescatter/broadcast/reduce/send/recv/barrier);
- ``zero``: the ZeRO-sharded dp update over the collective
  (``ZeroUpdater``) and the flat-vector and opt-state reshard helpers;
- ``pipeline``: the 1F1B and interleaved 1F1B schedules, and the
  in-program pipeline ``pipeline_spmd`` over a mesh's pp axis of gang
  ranks, with ``stack_stages``;
- ``mesh``: ``MeshSpec`` / ``build_mesh`` (a torch DeviceMesh over the
  ranks of the world process group) and the logical-axis rules;
- ``mesh_group``: ``MeshGroup``, a gang of rank actors that forms a
  process group;
- ``sharding``: ``MeshOwner``, ``SpecLayout``, the lowering helpers and
  the fsdp plane (``FsdpPlane``); ``zero.make_zero_update_spmd`` is the
  ZeRO update over a mesh axis of gang ranks.

The names below load on first use, so a worker that only decodes a
channel's codec never imports torch.
"""
import importlib

_EXPORTS = {
    "QuantizedTensor": "quant", "quantize": "quant", "dequantize": "quant",
    "create_collective_group": "collective",
    "destroy_collective_group": "collective", "get_group": "collective",
    "allreduce": "collective", "allgather": "collective",
    "reducescatter": "collective", "broadcast": "collective",
    "reduce": "collective", "send": "collective", "recv": "collective",
    "barrier": "collective",
    "ZeroUpdater": "zero", "make_zero_update_spmd": "zero",
    "schedule_1f1b": "pipeline", "schedule_interleaved_1f1b": "pipeline",
    "pipeline_spmd": "pipeline", "stack_stages": "pipeline",
    "MeshSpec": "mesh", "build_mesh": "mesh", "virtual_mesh": "mesh",
    "local_mesh": "mesh", "named_sharding": "mesh",
    "shard_constraint": "mesh", "logical_to_mesh": "mesh",
    "AxisRules": "mesh", "default_axis_rules": "mesh",
    "mesh_shape_for": "mesh",
    "MeshGroup": "mesh_group", "MeshWorkerMixin": "mesh_group",
    "MeshOwner": "sharding", "SpecLayout": "sharding",
    "lower_jit": "sharding", "lower_shard_map": "sharding",
    "FsdpPlane": "sharding",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
