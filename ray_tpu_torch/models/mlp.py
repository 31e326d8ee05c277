"""Small MLP (counterpart of ray_tpu/models/mlp.py) — RL policy/value
nets and test fixtures.

Params are a dict with the JAX model's names and shapes (``w{i}`` [in,
out], ``b{i}`` [out]), so weights load straight from numpy
(``mlp_params_from_numpy``)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    hidden: Tuple[int, ...] = (256, 256)
    out_dim: int = 1
    activation: str = "tanh"
    dtype: torch.dtype = torch.float32


# jax.nn.gelu defaults to the tanh approximation
_ACTS = {"tanh": torch.tanh, "relu": F.relu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu}


def _orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    """An n x n orthogonal matrix drawn uniformly (Haar): the QR of a
    normal matrix with the signs of R's diagonal moved into Q, as
    ``jax.random.orthogonal`` draws it. Same distribution, not the same
    numbers."""
    a = torch.randn((n, n), generator=generator, dtype=torch.float32,
                    device=generator.device)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


class MLP:
    def __init__(self, config: MLPConfig):
        self.config = config

    def _dims(self) -> Tuple[int, ...]:
        c = self.config
        return (c.in_dim,) + tuple(c.hidden) + (c.out_dim,)

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        dims = self._dims()
        shapes = {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"w{i}"] = (a, b)
            shapes[f"b{i}"] = (b,)
        return shapes

    def init(self, generator: torch.Generator) -> Params:
        """Orthogonal weights (the PPO-stable choice) scaled by sqrt(2),
        the last layer's by 0.01; zero biases; on ``generator.device``."""
        c = self.config
        dims = self._dims()
        params = {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            w = _orthogonal(max(a, b), generator)[:a, :b]
            scale = 0.01 if i == len(dims) - 2 else math.sqrt(2.0)
            params[f"w{i}"] = (w * scale).to(c.dtype)
            params[f"b{i}"] = torch.zeros((b,), dtype=c.dtype,
                                          device=generator.device)
        return params

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        act = _ACTS[c.activation]
        n = len(c.hidden) + 1
        h = x.to(c.dtype)
        for i in range(n):
            h = h @ params[f"w{i}"] + params[f"b{i}"]
            if i < n - 1:
                h = act(h)
        return h
