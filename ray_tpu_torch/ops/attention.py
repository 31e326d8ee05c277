"""Reference attention (counterpart of ray_tpu/ops/attention.py) — the
correctness oracle and the path for shapes the kernel does not take."""
from __future__ import annotations

from typing import Optional

import torch


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  sm_scale: Optional[float] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention. q [B, Sq, H, D], k/v [B, Skv, H, D] (Sq may
    differ from Skv). Returns [B, Sq, H, D] in q's dtype; the math is f32
    whatever the input dtype. The causal mask aligns the diagonals with an
    offset of Skv - Sq and masks with -inf."""
    orig_dtype = q.dtype
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        logits = logits + bias
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = qi + (sk - sq) >= ki
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(orig_dtype)
