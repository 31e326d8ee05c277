"""ray_tpu_torch.models — counterpart of ray_tpu.models. This slice ports
the Llama family (dense forward and paged serving programs)."""
from .convert import llama_params_from_numpy
from .llama import Llama, LlamaConfig

__all__ = ["Llama", "LlamaConfig", "llama_params_from_numpy"]
