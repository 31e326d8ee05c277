"""Torch DDP backend for TorchTrainer (counterpart of
ray_tpu/train/torch_backend.py, with its names).

ref: python/ray/train/torch/config.py:69 _setup_torch_process_group and
train_loop_utils.py prepare_model (DDP wrap). In the port every trainer's
gang already is a gloo world when the user loop starts: the backend
executor forms it, with rank 0's free address as the rendezvous (what the
JAX package's TorchTrainer does through a broker actor before its loop).
So ``setup_torch_process_group`` returns at once inside a trainer's loop,
and ``prepare_model`` wraps in a DistributedDataParallel over that world,
a module on the card included (gloo stages CUDA tensors through the
host; it is also what lets several ranks share one card).
"""
from __future__ import annotations

import datetime
from typing import Any


def setup_torch_process_group(init_method: str, rank: int,
                              world_size: int,
                              timeout_s: float = 120.0) -> None:
    """Join a gloo world at ``init_method`` as ``rank`` (ref:
    config.py:113); a no-op where this process is in one already."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(
        backend="gloo", init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def teardown_torch_process_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def prepare_model(model: Any) -> Any:
    """Wrap for data-parallel training (ref: train_loop_utils.py:329
    prepare_model): DDP when a multi-worker process group is up,
    pass-through otherwise. DDP broadcasts rank 0's parameters and
    buffers at construction, averages the gradients over the world in
    the backward, and (``broadcast_buffers``) broadcasts rank 0's
    buffers again before each forward."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    if dist.is_initialized() and dist.get_world_size() > 1:
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(loader: Any) -> Any:
    """Shard a DataLoader across the gang with a DistributedSampler
    (ref: train_loop_utils.py prepare_data_loader)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return loader
    sampler = DistributedSampler(loader.dataset,
                                 num_replicas=dist.get_world_size(),
                                 rank=dist.get_rank(),
                                 shuffle=True)
    return DataLoader(loader.dataset, batch_size=loader.batch_size,
                      sampler=sampler, num_workers=0,
                      collate_fn=loader.collate_fn,
                      drop_last=loader.drop_last)
