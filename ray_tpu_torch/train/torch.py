"""ray_tpu_torch.train.torch — the reference's `ray.train.torch` surface
(ref: python/ray/train/torch/__init__.py; counterpart of
ray_tpu/train/torch.py): prepare_model wraps in DDP over the gang's gloo
world; prepare_data_loader shards with a DistributedSampler. The gang's
world exists before the user loop runs, under either trainer."""
from .torch_backend import (prepare_data_loader, prepare_model,
                            setup_torch_process_group,
                            teardown_torch_process_group)

__all__ = ["prepare_data_loader", "prepare_model",
           "setup_torch_process_group", "teardown_torch_process_group"]
