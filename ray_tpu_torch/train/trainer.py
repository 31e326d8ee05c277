"""Trainers (counterpart of ray_tpu/train/trainer.py, with its names).

Parity with the reference's Train API (ref: python/ray/train/
base_trainer.py:570 fit; data_parallel_trainer.py:432 training_loop
driving BackendExecutor over a WorkerGroup; torch/torch_trainer.py:16).
`DataParallelTrainer` is the generic base; failure handling = gang
restart from the latest checkpoint (ref: FailureConfig semantics).
`JaxTrainer` keeps its name for the API; in the port its loop runs
torch, as `TorchTrainer`'s does.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from .backend_executor import BackendExecutor, TrainWorkerError
from .checkpoint import Checkpoint, prune_checkpoints
from .config import Result, RunConfig, ScalingConfig


class DataParallelTrainer:
    """Runs `train_loop_per_worker` on a gang of workers, streams results,
    persists rank-0 checkpoints, restarts the gang on worker failure."""

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.train_loop = train_loop_per_worker
        self.train_config = dict(train_loop_config or {})
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = dict(datasets or {})
        self.resume_checkpoint = resume_from_checkpoint

    # -- dataset sharding ----------------------------------------------------

    def _dataset_shards(self) -> Optional[List[dict]]:
        """Each worker's datasets: a ``Shardable`` (a ``Dataset``) split
        into exactly n ``DataShard``s, a ``DatasetPipeline`` split into n
        sub-pipelines, a list or tuple dealt round robin (rank i takes
        items i, i + n, ...), any other object whole to every worker."""
        if not self.datasets:
            return None
        from ..data import DataShard, DatasetPipeline
        from ..data.iterator import Shardable

        n = self.scaling.num_workers
        shards: List[dict] = [{} for _ in range(n)]
        for name, ds in self.datasets.items():
            if isinstance(ds, Shardable):
                # the DataShard contract: exactly n shards, rows
                # disjoint and exhaustive (enforced here so a broken
                # implementer fails loudly, not with silently skewed
                # or duplicated per-rank data)
                parts = ds.split_shards(n)
                if len(parts) != n or not all(
                        isinstance(p, DataShard) for p in parts):
                    raise TypeError(
                        f"dataset {name!r}: split_shards({n}) must "
                        f"return exactly {n} DataShards (the Shardable "
                        f"contract); got {len(parts)} x "
                        f"{[type(p).__name__ for p in parts[:3]]}")
            elif isinstance(ds, DatasetPipeline):
                parts = ds.split(n)
            elif isinstance(ds, (list, tuple)):
                parts = [list(ds[i::n]) for i in range(n)]
            else:
                parts = [ds] * n
            for i in range(n):
                shards[i][name] = parts[i]
        return shards

    # -- the controller loop -------------------------------------------------

    def fit(self) -> Result:
        path = self.run_config.resolved_storage_path()
        os.makedirs(path, exist_ok=True)
        max_failures = self.run_config.failure_config.max_failures
        ckpt_cfg = self.run_config.checkpoint_config
        failures = 0
        latest_ckpt = self.resume_checkpoint
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        error: Optional[BaseException] = None

        while True:
            executor = BackendExecutor(
                self.scaling, experiment_name=self.run_config.name or "train")
            try:
                executor.start(self.train_loop, self.train_config,
                               dataset_shards=self._dataset_shards(),
                               checkpoint=latest_ckpt)
                while True:
                    results = executor.next_results()
                    if results is None:
                        break
                    rank0 = results[0]
                    last_metrics = dict(rank0["metrics"])
                    last_metrics["iteration"] = rank0["iteration"]
                    history.append(last_metrics)
                    if rank0.get("checkpoint") is not None:
                        latest_ckpt = rank0["checkpoint"]
                        ckpt_dir = os.path.join(
                            path, f"checkpoint_{rank0['iteration']:06d}")
                        latest_ckpt.to_directory(ckpt_dir)
                        latest_ckpt = Checkpoint.from_directory(ckpt_dir)
                        prune_checkpoints(path, ckpt_cfg.num_to_keep)
                break  # clean finish
            except TrainWorkerError as e:
                failures += 1
                if max_failures >= 0 and failures > max_failures:
                    error = e
                    break
                time.sleep(0.2)  # gang restart backoff
            except Exception as e:  # noqa: BLE001 — surface in Result
                error = e
                traceback.print_exc()
                break
            finally:
                executor.shutdown()

        return Result(metrics=last_metrics, checkpoint=latest_ckpt,
                      path=path, error=error, metrics_history=history)


class JaxTrainer(DataParallelTrainer):
    """The mesh trainer: a gang of workers, one device each, in one gloo
    world; the loop reads the DeviceMesh over the gang through
    ``train.get_mesh()`` and runs its collectives over the mesh's axes
    (``mesh.get_group("dp")`` for data parallelism). The name is the JAX
    package's; the loop runs torch. North-star config: GPT-2 small DDP."""


class TorchTrainer(DataParallelTrainer):
    """Torch data-parallel trainer (ref: torch/torch_trainer.py:16): every
    worker is a rank of the gang's gloo world before the loop runs, so
    ``dist.get_world_size()`` is ``num_workers`` and
    ``train.torch.prepare_model(model)`` returns a genuine
    DistributedDataParallel whose gradients average across workers, on
    the card or on CPU ranks. The gang forms its world as every trainer's
    does (the JAX package's broker rendezvous and its teardown after the
    loop have no counterpart: the world is the gang's, and ends with its
    worker processes)."""
