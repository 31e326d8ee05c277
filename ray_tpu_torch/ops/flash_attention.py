"""Flash attention forward (counterpart of ray_tpu/ops/flash_attention.py).

``flash_attention_fwd`` computes attention out plus the per-row
logsumexp, the function of the JAX package's two forward Pallas kernels
(``_fwd_single_kernel`` and the tiled ``_fwd_kernel``). For a CUDA tensor
it launches the hand-written Hopper kernel in ``csrc/flash_fwd.cu`` or
raises; for a CPU tensor it runs ``flash_attention_fwd_plain``, the same
function in plain PyTorch, which the tests and chip_smoke.py hold the
kernel against.

The backward kernels belong to the training slice: on a CUDA tensor that
requires grad the wrapper raises rather than return a result with no
gradient.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import mha_reference

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)      # the kernel's template instances
TILE = 64                      # the kernel's Q and K/V tile rows
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and q.shape[1] != k.shape[1]:
        # the diagonal mask assumes square attention; mha_reference
        # applies the (seq_k - seq_q) offset this path does not
        raise ValueError(
            f"causal flash_attention requires seq_q == seq_k, got "
            f"{q.shape[1]} != {k.shape[1]}; use mha_reference for "
            "offset-causal decode")


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch. q [B, Sq, H, D], k/v
    [B, Sk, H, D] -> (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32).
    Same arithmetic as the kernels it stands for: q is scaled in its own
    dtype, scores and softmax statistics are f32, masked scores are
    -1e30, and probabilities are cast to v's dtype before the P.V
    product (accumulated in f32)."""
    _check(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype).transpose(1, 2).contiguous()
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D], lse [B, H, Sq] f32). CPU tensors run the plain
    version; CUDA tensors launch csrc/flash_fwd.cu, which takes bf16 or
    f32, head_dim 32/64/128, contiguous [B, S, H, D] inputs with S a
    multiple of 64 — anything else raises."""
    _check(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for {q.device}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPE_CODE or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash kernel takes bf16 or f32 (all alike), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{HEAD_DIMS}, got {d}")
    if sq % TILE or sk % TILE:
        raise ValueError(f"flash kernel needs seq lengths that are "
                         f"multiples of {TILE}, got {sq}, {sk}")
    if b * h > 65535:
        raise ValueError(f"flash kernel grid takes batch*heads <= 65535, "
                         f"got {b * h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs {name} contiguous and "
                             f"16-byte aligned")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention has no backward kernel yet on CUDA")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d,
                            _DTYPE_CODE[q.dtype], int(causal),
                            float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0   # kernel launches since last reset


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """Flash attention. q/k/v: [batch, seq, heads, head_dim] -> same shape.

    ``block_q``/``block_k`` are accepted for parity with the JAX
    signature; the CUDA kernel uses its own tiles. Sequence lengths that
    are not multiples of 128 go to ``mha_reference``, as in the JAX
    package."""
    del block_q, block_k
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _check(q, k, v, causal)
    if q.shape[1] % 128 != 0 or k.shape[1] % 128 != 0:
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return flash_attention_fwd(q, k, v, causal, sm_scale)[0]
