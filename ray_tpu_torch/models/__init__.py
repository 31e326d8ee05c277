"""ray_tpu_torch.models — counterpart of ray_tpu/models: the six model
families it exports, GPT-2 (training and paged serving), Llama (dense
forward and paged serving), ResNet, ViT, the MLP and the Mixtral-style
MoE, each with a loader of the JAX package's parameters from numpy."""
from .convert import (gpt_params_from_numpy, llama_params_from_numpy,
                      mlp_params_from_numpy, moe_params_from_numpy,
                      resnet_params_from_numpy, vit_params_from_numpy)
from .gpt import GPT, GPTConfig
from .llama import Llama, LlamaConfig
from .mlp import MLP, MLPConfig
from .moe import MoE, MoEConfig
from .resnet import ResNet, ResNetConfig
from .vit import ViT, ViTConfig

__all__ = [
    "GPT", "GPTConfig", "Llama", "LlamaConfig", "ResNet", "ResNetConfig",
    "ViT", "ViTConfig", "MLP", "MLPConfig", "MoE", "MoEConfig",
    "gpt_params_from_numpy", "llama_params_from_numpy",
    "mlp_params_from_numpy", "moe_params_from_numpy",
    "resnet_params_from_numpy", "vit_params_from_numpy",
]
