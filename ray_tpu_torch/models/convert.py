"""Parameters from numpy: load weights exported by the JAX package (as
numpy arrays) into the port, so both compute with the same numbers."""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .gpt import GPT, GPTConfig
from .llama import Llama, LlamaConfig, Params
from .mlp import MLP, MLPConfig
from .moe import MoE, MoEConfig
from .resnet import ResNet, ResNetConfig
from .vit import ViT, ViTConfig


def _params_from_numpy(np_params: Mapping[str, np.ndarray],
                       want: Dict[str, Tuple[int, ...]], dtype: torch.dtype,
                       device: torch.device) -> Params:
    if set(np_params) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(np_params))}, extra "
                         f"{sorted(set(np_params) - set(want))}")
    out = {}
    for name, shape in want.items():
        # float32 first: numpy has no bfloat16 that torch can read
        arr = np.asarray(np_params[name]).astype(np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return out


def llama_params_from_numpy(np_params: Mapping[str, np.ndarray],
                            config: LlamaConfig,
                            device: torch.device) -> Params:
    """{name: array} with the JAX Llama's names and shapes -> the port's
    params in ``config.param_dtype`` on ``device``. Raises on a missing,
    extra or mis-shaped entry."""
    return _params_from_numpy(np_params, Llama(config).param_shapes(),
                              config.param_dtype, device)


def gpt_params_from_numpy(np_params: Mapping[str, np.ndarray],
                          config: GPTConfig, device: torch.device) -> Params:
    """{name: array} with the JAX GPT's names and shapes -> the port's
    params in ``config.param_dtype`` on ``device``. Raises on a missing,
    extra or mis-shaped entry."""
    return _params_from_numpy(np_params, GPT(config).param_shapes(),
                              config.param_dtype, device)


def moe_params_from_numpy(np_params: Mapping[str, np.ndarray],
                          config: MoEConfig, device: torch.device) -> Params:
    """{name: array} with the JAX MoE's names and shapes -> the port's
    params in ``config.param_dtype`` on ``device``. Raises on a missing,
    extra or mis-shaped entry."""
    return _params_from_numpy(np_params, MoE(config).param_shapes(),
                              config.param_dtype, device)


def vit_params_from_numpy(np_params: Mapping[str, np.ndarray],
                          config: ViTConfig, device: torch.device) -> Params:
    """{name: array} with the JAX ViT's names and shapes -> the port's
    params in ``config.param_dtype`` on ``device``. Raises on a missing,
    extra or mis-shaped entry."""
    return _params_from_numpy(np_params, ViT(config).param_shapes(),
                              config.param_dtype, device)


def mlp_params_from_numpy(np_params: Mapping[str, np.ndarray],
                          config: MLPConfig, device: torch.device) -> Params:
    """{name: array} with the JAX MLP's names and shapes -> the port's
    params in ``config.dtype`` on ``device``. Raises on a missing, extra
    or mis-shaped entry."""
    return _params_from_numpy(np_params, MLP(config).param_shapes(),
                              config.dtype, device)


def resnet_params_from_numpy(np_params: Mapping[str, np.ndarray],
                             np_state: Mapping[str, np.ndarray],
                             config: ResNetConfig, device: torch.device
                             ) -> Tuple[Params, Params]:
    """The JAX ResNet's (params, state) as {path: array} -> the port's
    params in ``config.param_dtype`` and state in f32, on ``device``.
    Raises on a missing, extra or mis-shaped entry of either."""
    param_shapes, state_shapes = ResNet(config).shapes()
    return (_params_from_numpy(np_params, param_shapes, config.param_dtype,
                               device),
            _params_from_numpy(np_state, state_shapes, torch.float32, device))
