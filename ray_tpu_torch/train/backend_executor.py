"""BackendExecutor + WorkerGroup — the gang that runs the train loop
(counterpart of ray_tpu/train/backend_executor.py, with its names).

Parity with the reference (ref: python/ray/train/_internal/
backend_executor.py:45 — start:104, start_training:342,
get_next_results:457; worker_group.py:100), on the port's mesh layer: the
executor forms the gang's world as MeshGroup does (rank 0 picks a free
address, every worker joins the gloo world there as its rank and builds
its DeviceMesh over the gang), and the user loop reads the mesh through
``train.get_mesh()``. Where the JAX package gives each worker a mesh of
its own local devices, the port's mesh spans the gang, one device a rank.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._vendor import cloudpickle
from ray_tpu_torch.core.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.util.queue import Queue

from ..parallel.mesh import MeshSpec
from ..parallel.mesh_group import _TIMEOUT_S, MeshWorkerMixin, _spec_kwargs
from .config import ScalingConfig
from .session import TrainContext, init_session, shutdown_session

# how long the gang may take to be placed, and a call that returns at once
# (an address, a session, a finished loop's result) to come back
_PLACEMENT_TIMEOUT_S = 60.0
_CALL_TIMEOUT_S = 60.0


class TrainWorkerError(RuntimeError):
    """A worker (or its node) died mid-training."""


class _TrainWorker(MeshWorkerMixin):
    """Actor hosting one rank of the gang."""

    def setup_session(self, rank: int, world: int, queue_actor,
                      dataset_shard_blob: Optional[bytes],
                      checkpoint, experiment_name: str) -> bool:
        q = Queue.__new__(Queue)
        q.actor = queue_actor
        shards = (cloudpickle.loads(dataset_shard_blob)
                  if dataset_shard_blob else {})
        init_session(
            TrainContext(world_rank=rank, world_size=world,
                         experiment_name=experiment_name),
            result_queue=q,
            mesh=getattr(self, "_mesh", None),
            dataset_shards=shards,
            checkpoint=checkpoint)
        return True

    def run_train_fn(self, fn_blob: bytes, config: Dict[str, Any]):
        fn = cloudpickle.loads(fn_blob)
        try:
            if config:
                return fn(config)
            try:
                return fn()
            except TypeError as e:
                if "positional argument" in str(e):
                    return fn({})
                raise
        finally:
            shutdown_session()


class BackendExecutor:
    def __init__(self, scaling: ScalingConfig, experiment_name: str = ""):
        self.scaling = scaling
        self.experiment_name = experiment_name
        self.queue: Optional[Queue] = None
        self.workers: List[Any] = []
        self._pg = None
        self._run_refs: List[Any] = []
        self._pending: Dict[int, dict] = {}

    # ---- lifecycle ---------------------------------------------------------

    def start(self, train_fn: Callable, train_config: Dict[str, Any],
              dataset_shards: Optional[List[dict]] = None,
              checkpoint=None) -> None:
        s = self.scaling
        self._pending = {}
        n = s.num_workers
        res = s.worker_resources()
        bundles = [dict(res) for _ in range(n)]
        self._pg = placement_group(bundles, strategy=s.placement_strategy)
        if not self._pg.ready(timeout=_PLACEMENT_TIMEOUT_S):
            raise TrainWorkerError("placement group for train workers not ready")
        self.queue = Queue()
        cls = ray_tpu_torch.remote(_TrainWorker)
        self.workers = [
            cls.options(
                num_cpus=res.get("CPU", 1.0),
                resources={k: v for k, v in res.items() if k != "CPU"},
                placement_group=self._pg,
                placement_group_bundle_index=i,
            ).remote()
            for i in range(n)
        ]
        # the gang's world: rank 0 hosts the rendezvous store at a port
        # free on its host (as MeshGroup forms a gang)
        coordinator = ray_tpu_torch.get(self.workers[0].free_address.remote(),
                                        timeout=_TIMEOUT_S)
        ray_tpu_torch.get([
            w.setup_mesh.remote(i, n, coordinator,
                                _spec_kwargs(s.mesh or MeshSpec()),
                                s.devices_per_worker, s.device_type or "cuda")
            for i, w in enumerate(self.workers)], timeout=_TIMEOUT_S)
        shard_blobs = []
        for i in range(n):
            shard = dataset_shards[i] if dataset_shards else None
            shard_blobs.append(cloudpickle.dumps(shard) if shard else None)
        ray_tpu_torch.get([
            w.setup_session.remote(i, n, self.queue.actor, shard_blobs[i],
                                   checkpoint, self.experiment_name)
            for i, w in enumerate(self.workers)], timeout=_CALL_TIMEOUT_S)
        blob = cloudpickle.dumps(train_fn)
        self._run_refs = [w.run_train_fn.remote(blob, train_config)
                          for w in self.workers]

    # ---- result streaming --------------------------------------------------

    def _drain_queue(self) -> None:
        """Pull every queued report into the persistent per-iteration buffer.

        The buffer must live on `self`: a single drain can dequeue partial
        rows for several iterations at once, and any rows not returned by
        this call must survive until their iteration completes."""
        for p in self.queue.get_batch(256):
            self._pending.setdefault(p["iteration"], {})[p["rank"]] = p

    def _pop_complete(self) -> Optional[List[dict]]:
        for it in sorted(self._pending):
            if len(self._pending[it]) == len(self.workers):
                row = self._pending.pop(it)
                return [row[r] for r in sorted(row)]
        return None

    def next_results(self, timeout: float = 600.0) -> Optional[List[dict]]:
        """One result per rank for the next finished iteration, or None when
        training completed. Raises TrainWorkerError once a worker has died
        or its loop raised and no iteration it finished is left to return,
        without waiting for its peers: they may be waiting for it in a
        collective, which only the gang's shutdown ends."""
        deadline = time.monotonic() + timeout
        while True:
            # the finished loops are read before the queue: everything
            # they reported is in it by then
            done, _ = ray_tpu_torch.wait(self._run_refs,
                                         num_returns=len(self._run_refs),
                                         timeout=0.0)
            self._drain_queue()
            row = self._pop_complete()
            if row is not None:
                return row
            try:
                ray_tpu_torch.get(done, timeout=_CALL_TIMEOUT_S)
            except RayTpuError as e:
                raise TrainWorkerError(str(e)) from e
            if len(done) == len(self._run_refs):
                return None
            if time.monotonic() > deadline:
                raise TrainWorkerError(
                    f"timed out waiting for training results ({timeout}s)")
            time.sleep(0.01)

    def finish(self) -> List[Any]:
        return ray_tpu_torch.get(self._run_refs, timeout=_CALL_TIMEOUT_S)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self.queue is not None:
            self.queue.shutdown()
            self.queue = None
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
