"""ray_tpu_torch.models — counterpart of ray_tpu.models. Ported so far:
the Llama family (dense forward and paged serving programs) and the GPT-2
family (the training path: forward, losses, dropout)."""
from .convert import gpt_params_from_numpy, llama_params_from_numpy
from .gpt import GPT, GPTConfig
from .llama import Llama, LlamaConfig

__all__ = ["GPT", "GPTConfig", "Llama", "LlamaConfig",
           "gpt_params_from_numpy", "llama_params_from_numpy"]
