"""Gang-scheduled mesh formation (counterpart of
ray_tpu/parallel/mesh_group.py, with its names).

A program over a mesh of ranks is N coordinated processes entering the
same code — a gang. ``MeshGroup`` owns that gang: it spawns one actor per
rank (in a placement group), has rank 0 pick a free TCP port for the
rendezvous, passes each actor its rank and that address, has each call
``torch.distributed.init_process_group`` (where the JAX package calls
``jax.distributed.initialize``) and build a ``MeshOwner`` over the world
it formed, and then ``run()`` broadcasts a callable for SPMD execution.

The backend is gloo: it runs on CPU ranks, and it is the one that lets
several ranks share one CUDA card (NCCL refuses two ranks on one
device). The process group is initialized before any CUDA DeviceMesh is
built, which would otherwise default to NCCL.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.placement_group import (placement_group,
                                                remove_placement_group)

from .mesh import MeshSpec

# gloo runs on CPU ranks and lets several ranks share one CUDA card (NCCL
# refuses two ranks on one device)
_BACKEND = "gloo"
# how long a rank waits for the others, to form the group and in any of
# its collectives
_TIMEOUT_S = 300.0


def free_address(host: str = "127.0.0.1") -> str:
    """host:port of a TCP port that was free a moment ago (bound to port
    0, then released), for a rendezvous that binds it next."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return f"{host}:{s.getsockname()[1]}"


class MeshWorkerMixin:
    """Mixin giving an actor the mesh-formation protocol; ``setup_mesh``
    is invoked once on every rank by MeshGroup. Mesh construction goes
    through the shared ownership layer (parallel.sharding.MeshOwner)."""

    def free_address(self) -> str:
        return free_address()

    def setup_mesh(self, process_id: int, num_processes: int,
                   coordinator: Optional[str], spec_kwargs: dict,
                   devices_per_process: Optional[int] = None,
                   device_type: Optional[str] = None) -> int:
        """Join the world group at ``coordinator`` (host:port) as rank
        ``process_id`` of ``num_processes`` and build this rank's
        MeshOwner over it. A rank holds one device, so
        ``devices_per_process`` is accepted for the reference's signature
        and must be None or 1. Returns the devices this rank holds."""
        import datetime

        import torch.distributed as dist

        from .sharding import MeshOwner

        if devices_per_process not in (None, 1):
            raise ValueError("a rank of the port holds one device; "
                             f"devices_per_process={devices_per_process}")
        self._process_id = process_id
        self._num_processes = num_processes
        if device_type == "cuda":
            import torch

            # this rank's card, chosen before the mesh is built (as a
            # launcher's LOCAL_RANK would): ranks share the cards round
            # robin, all on the one card of a one-card host
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        if dist.is_initialized():
            # a process joins one world: a second gang cannot re-form it
            if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                            process_id):
                raise RuntimeError(
                    f"this process is already rank {dist.get_rank()} of a "
                    f"world of {dist.get_world_size()}")
        else:
            if num_processes > 1 and not coordinator:
                raise ValueError("a gang of more than one rank needs a "
                                 "coordinator address")
            dist.init_process_group(
                _BACKEND,
                init_method=f"tcp://{coordinator or free_address()}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=_TIMEOUT_S))
        self._owner = MeshOwner(MeshSpec(**spec_kwargs),
                                name=f"gang-p{process_id}",
                                device_type=device_type)
        self._mesh = self._owner.mesh
        return 1

    @property
    def mesh(self):
        return self._mesh

    @property
    def mesh_owner(self):
        """The sharding-layer MeshOwner (sharding factory, layout, this
        rank's accounting) backing :attr:`mesh`."""
        return self._owner

    def mesh_run(self, fn_blob: bytes, *args, **kwargs):
        from ray_tpu_torch._vendor import cloudpickle

        fn = cloudpickle.loads(fn_blob)
        return fn(self, *args, **kwargs)


class MeshGroup:
    """Forms and drives a gang of mesh workers, one rank each.

    worker_cls must mix in MeshWorkerMixin. ``device_type`` goes to every
    rank's ``setup_mesh`` ("cpu" ranks in the tests; the default is the
    CUDA card). ``workers`` forms the gang over actors the caller made and
    placed (each mixing in MeshWorkerMixin; rank i is ``workers[i]``)
    instead of spawning ``num_workers`` of ``worker_cls``: the pipeline
    engine forms each fsdp stage's gang so, its stage actor as rank 0.
    """

    def __init__(self, num_workers: int,
                 spec: Optional[MeshSpec] = None,
                 worker_cls: Optional[type] = None,
                 devices_per_process: Optional[int] = None,
                 resources_per_worker: Optional[dict] = None,
                 coordinator: Optional[str] = None,
                 device_type: Optional[str] = None,
                 workers: Optional[List[Any]] = None):
        self.num_workers = num_workers
        self.spec = spec or MeshSpec()
        self._pg = None
        if workers is not None:
            if len(workers) != num_workers:
                raise ValueError(f"{len(workers)} workers for a gang of "
                                 f"{num_workers}")
            self.workers = list(workers)
        else:
            cls = worker_cls or _DefaultMeshWorker
            res = dict(resources_per_worker or {"CPU": 1.0})
            bundles = [dict(res) for _ in range(num_workers)]
            self._pg = placement_group(bundles, strategy="SPREAD")
            if not self._pg.ready():
                raise TimeoutError("MeshGroup placement group not ready")
            remote_cls = ray_tpu_torch.remote(cls)
            self.workers = [
                remote_cls.options(
                    num_cpus=res.get("CPU", 1.0),
                    resources={k: v for k, v in res.items() if k != "CPU"},
                    placement_group=self._pg,
                    placement_group_bundle_index=i,
                ).remote()
                for i in range(num_workers)
            ]
        try:
            if coordinator is None:
                # rank 0 hosts the rendezvous store: a port free on its
                # host, never a fixed one (gangs side by side collide)
                coordinator = ray_tpu_torch.get(
                    self.workers[0].free_address.remote(),
                    timeout=_TIMEOUT_S)
            self.coordinator = coordinator
            self.devices_per_worker = ray_tpu_torch.get([
                w.setup_mesh.remote(i, num_workers, coordinator,
                                    _spec_kwargs(self.spec),
                                    devices_per_process, device_type)
                for i, w in enumerate(self.workers)], timeout=_TIMEOUT_S)
        except BaseException:
            self.shutdown()
            raise

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Gang-invoke fn(worker_self, *args) on every worker; returns all
        results."""
        return ray_tpu_torch.get(self.run_async(fn, *args, **kwargs))

    def run_async(self, fn: Callable, *args, **kwargs):
        from ray_tpu_torch._vendor import cloudpickle

        blob = cloudpickle.dumps(fn)
        return [w.mesh_run.remote(blob, *args, **kwargs)
                for w in self.workers]

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass


class _DefaultMeshWorker(MeshWorkerMixin):
    pass


def _spec_kwargs(spec: MeshSpec) -> dict:
    return {"dp": spec.dp, "fsdp": spec.fsdp, "tp": spec.tp,
            "sp": spec.sp, "ep": spec.ep, "pp": spec.pp}
