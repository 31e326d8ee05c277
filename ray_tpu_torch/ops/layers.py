"""Numeric layers (counterpart of ray_tpu/ops/layers.py).

Plain PyTorch: these are elementwise chains and reductions that the JAX
package leaves to XLA fusion, not kernels. All statistics are f32 even
for bf16 inputs, and results are cast back to the input dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
               device: Optional[torch.device] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary cos/sin tables: [seq_len, head_dim/2] each (f32), on
    ``device`` (torch's default device when None)."""
    half = head_dim // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, D]; cos/sin: [S_max, D/2];
    positions: [B, S] overrides the default arange (decode steps). The
    head splits into halves (x1 = x[..., :D/2], x2 = x[..., D/2:]), not
    interleaved pairs, as in the JAX package."""
    dtype = x.dtype
    if positions is not None:
        c = cos[positions]           # [B, S, D/2]
        s = sin[positions]
    else:
        c = cos[None, : x.shape[1]]   # [1, S, D/2]
        s = sin[None, : x.shape[1]]
    c = c[:, :, None, :]             # [B|1, S, 1, D/2]
    s = s[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rot = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return rot.to(dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy with optional z-loss. logits [..., V]
    (f32-upcast); labels [...] int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    mask = (labels != ignore_index).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
