"""Worker-side training session (counterpart of ray_tpu/train/session.py,
with its names).

Parity with the reference's `_TrainSession` / `ray.train.report`
(ref: python/ray/train/_internal/session.py:429 report — queue-based
result channel consumed by the trainable; :470 get_dataset_shard). Here
the channel is a Queue actor of the port's runtime, and the "process
group" is the gang's gloo world, with the DeviceMesh over it."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

_session_lock = threading.Lock()
_session: Optional["_Session"] = None


@dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    trial_name: str = ""

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank


@dataclass
class _Session:
    context: TrainContext
    result_queue: Any                      # ray_tpu_torch.util.queue.Queue
    mesh: Any = None
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    latest_checkpoint: Optional[Any] = None
    iteration: int = 0
    stop_requested: bool = False


def init_session(context: TrainContext, result_queue, mesh=None,
                 dataset_shards=None, checkpoint=None) -> None:
    global _session
    with _session_lock:
        _session = _Session(context=context, result_queue=result_queue,
                            mesh=mesh, dataset_shards=dict(dataset_shards or {}),
                            latest_checkpoint=checkpoint)


def shutdown_session() -> None:
    global _session
    with _session_lock:
        _session = None


def _get_session() -> "_Session":
    if _session is None:
        raise RuntimeError(
            "No training session active; train.report/get_context only work "
            "inside a train_loop_per_worker launched by a Trainer.")
    return _session


def get_context() -> TrainContext:
    return _get_session().context


def get_mesh():
    """The ``torch.distributed.device_mesh.DeviceMesh`` over the gang's
    ranks (the gang's gloo world): its ``dp`` axis spans the workers, so
    a sum over it is data parallel across them."""
    return _get_session().mesh


def report(metrics: Dict[str, Any], checkpoint=None) -> None:
    """Report metrics (and optionally a checkpoint) for this iteration.
    Only rank 0's checkpoint is persisted (reference semantics)."""
    s = _get_session()
    s.iteration += 1
    payload = {
        "rank": s.context.world_rank,
        "iteration": s.iteration,
        "metrics": dict(metrics),
        "checkpoint": checkpoint if s.context.world_rank == 0 else None,
    }
    s.result_queue.put(payload)


def get_checkpoint():
    """Latest checkpoint to restore from (set on restart after failure)."""
    return _get_session().latest_checkpoint


def get_dataset_shard(name: str = "train"):
    return _get_session().dataset_shards.get(name)
