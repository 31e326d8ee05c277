"""Train configuration dataclasses (counterpart of ray_tpu/train/config.py,
with its names).

Parity with the reference's AIR configs (ref: python/ray/air/config.py —
ScalingConfig/RunConfig/FailureConfig/CheckpointConfig). ScalingConfig
carries a MeshSpec: the backend forms one gloo world over the gang's
workers and hands each the DeviceMesh over it (``train.get_mesh()``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..parallel.mesh import MeshSpec


@dataclass
class ScalingConfig:
    """The gang: ``num_workers`` rank actors, each holding one device.

    ``device_type`` is the one field the JAX package's ScalingConfig
    lacks: the device each rank holds, None for the CUDA card (rank r
    takes card ``r % device_count``) or "cpu" (the tests). It goes to
    every rank's ``setup_mesh`` as MeshGroup's ``device_type`` does.
    ``devices_per_worker`` is accepted for the reference's signature and
    must be None or 1: a rank of the port holds one device, and the mesh
    spans the gang's ranks (ROADMAP C, "Differences by design")."""
    num_workers: int = 1
    use_tpu: bool = False
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    mesh: Optional[MeshSpec] = None          # parallelism layout per worker gang
    devices_per_worker: Optional[int] = None
    placement_strategy: str = "SPREAD"
    device_type: Optional[str] = None

    def __post_init__(self):
        if self.devices_per_worker not in (None, 1):
            raise ValueError(
                f"devices_per_worker={self.devices_per_worker}: a worker of "
                f"the port holds one device and the mesh spans the gang's "
                f"workers (ROADMAP C, 'Differences by design'); ask for "
                f"num_workers ranks instead")

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        res.setdefault("CPU", 1.0)
        if self.use_tpu:
            res.setdefault("TPU", 1.0)
        return res


@dataclass
class PipelineConfig:
    """Knobs for the compiled-graph pipeline engine
    (train/pipeline_cgraph.py CompiledPipelineEngine). Carried as one
    object so trainers/benches/smokes configure the engine uniformly."""
    num_microbatches: int = 4
    virtual_stages: int = 1      # model chunks per actor (interleaving)
    dp: int = 1                  # data-parallel pipeline replicas
    # in-actor sharded param/opt-state axis (parallel.sharding
    # FsdpPlane): each stage's chunk params + moments live 1/fsdp per
    # rank; composes with dp and the stages into pp x dp x fsdp
    fsdp: int = 1
    zero_update: bool = True     # ZeRO-shard the dp optimizer update
    # slow-wire codecs: "int8"/"e4m3" block-scaled quantization, None =
    # full precision. grad_codec compresses the dp gradient sync (ZeRO
    # reduce-scatter/all-gather or the replicated allreduce); wire_codec
    # compresses the cgraph activation/cotangent channel payloads
    # between stages.
    grad_codec: Optional[str] = None
    wire_codec: Optional[str] = None
    remat: bool = False          # recompute fwd in bwd (activation remat)
    channel_bytes: int = 1 << 20  # per-slot channel capacity
    resources_per_stage: Dict[str, float] = field(default_factory=dict)
    # fault tolerance: non-empty dir enables atomic rename-commit
    # checkpoints; every > 0 snapshots after each Nth step and
    # engine.recover() resumes from the newest commit
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0

    def engine_kwargs(self) -> Dict[str, Any]:
        return {
            "num_microbatches": self.num_microbatches,
            "virtual_stages": self.virtual_stages,
            "dp": self.dp,
            "fsdp": self.fsdp,
            "zero_update": self.zero_update,
            "grad_codec": self.grad_codec,
            "wire_codec": self.wire_codec,
            "remat": self.remat,
            "channel_bytes": self.channel_bytes,
            "resources_per_stage": self.resources_per_stage or None,
            "checkpoint_dir": self.checkpoint_dir,
            "checkpoint_every": self.checkpoint_every,
        }


@dataclass
class FailureConfig:
    max_failures: int = 0    # 0 = fail fast; -1 = unlimited restarts


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 0
    # Tune stop criteria, e.g. {"training_iteration": 10} (ref:
    # air.RunConfig stop)
    stop: Optional[Dict[str, Any]] = None
    # remote-storage mirror of the experiment dir (ref: tune/syncer.py
    # SyncConfig(upload_dir))
    upload_dir: Optional[str] = None
    sync_period_s: float = 5.0

    def resolved_storage_path(self) -> str:
        """``storage_path/name``; by default a directory of the port's own
        under the home directory."""
        base = self.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")
        name = self.name or "train_run"
        return os.path.join(base, name)


@dataclass
class Result:
    """What fit() returns (ref: python/ray/air/result.py)."""
    metrics: Dict[str, Any]
    checkpoint: Optional[Any]            # train.Checkpoint
    path: str
    error: Optional[BaseException] = None
    metrics_history: list = field(default_factory=list)
