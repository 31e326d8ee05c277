"""ray_tpu_torch.train — distributed training (counterpart of
ray_tpu/train, with its names).

ref: python/ray/train — BaseTrainer.fit (base_trainer.py:570),
DataParallelTrainer (data_parallel_trainer.py:432), BackendExecutor
(backend_executor.py:45), WorkerGroup (worker_group.py:100),
session.report (session.py:429). A trainer's workers are the ranks of
one gloo world, one device each (the CUDA card unless
``ScalingConfig.device_type`` says "cpu"); the loop reads the DeviceMesh
over them with ``get_mesh()`` and runs its collectives over the mesh's
axes, and ``train.torch.prepare_model`` wraps a module in DDP over the
same world. Reporting and checkpoints ride the runtime.

Beside the trainers: the compiled-graph pipeline engine
(``CompiledPipelineEngine``, 1F1B and interleaved 1F1B over stage
actors, the ZeRO-sharded dp update, checkpoints and recovery), its
single-process reference ``run_reference_1f1b``, ``reshard_checkpoint``,
and the older dynamic engine ``PipelineEngine``. Those four load on first
use: a process that only unpickles a Checkpoint or a report (the result
queue's actor) never imports torch.
"""
import importlib

from .checkpoint import Checkpoint
from .config import (CheckpointConfig, FailureConfig, PipelineConfig,
                     Result, RunConfig, ScalingConfig)
from .session import (get_checkpoint, get_context, get_dataset_shard,
                      get_mesh, report)
from .trainer import DataParallelTrainer, JaxTrainer, TorchTrainer
from .backend_executor import BackendExecutor, TrainWorkerError

_ENGINES = {"CompiledPipelineEngine": "pipeline_cgraph",
            "reshard_checkpoint": "pipeline_cgraph",
            "run_reference_1f1b": "pipeline_cgraph",
            "PipelineEngine": "pipeline_engine"}

__all__ = [
    "Checkpoint", "CheckpointConfig", "FailureConfig", "Result", "RunConfig",
    "ScalingConfig", "PipelineConfig", "report", "get_context",
    "get_checkpoint", "get_mesh",
    "get_dataset_shard", "DataParallelTrainer", "JaxTrainer", "TorchTrainer",
    "BackendExecutor", "TrainWorkerError",
    "CompiledPipelineEngine", "PipelineEngine", "reshard_checkpoint",
    "run_reference_1f1b",
]


def __getattr__(name: str):
    module = _ENGINES.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
