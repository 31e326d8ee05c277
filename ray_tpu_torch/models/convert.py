"""Parameters from numpy: load weights exported by the JAX package (as
numpy arrays) into the port, so both compute with the same numbers."""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .gpt import GPT, GPTConfig
from .llama import Llama, LlamaConfig, Params


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
