"""Flash attention (counterpart of ray_tpu/ops/flash_attention.py).

``flash_attention_fwd`` computes attention out plus the per-row
logsumexp, the function of the JAX package's two forward Pallas kernels
(``_fwd_single_kernel`` and the tiled ``_fwd_kernel``).
``flash_attention_bwd`` computes dq, dk, dv from the forward's residuals,
the function of its three backward Pallas kernels (``_bwd_fused_kernel``,
``_bwd_dq_kernel``, ``_bwd_dkv_kernel``). For a CUDA tensor each launches
its hand-written Hopper kernel (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``)
or raises; for a CPU tensor it runs its ``*_plain`` version, the same
function in plain PyTorch, which the tests and chip_smoke.py hold the
kernel against.

``flash_attention`` is the differentiable entry point: a
``torch.autograd.Function`` (the counterpart of the JAX package's
``custom_vjp``) whose forward saves (q, k, v, out, lse) and whose
backward runs ``flash_attention_bwd`` on them, never the forward again.
The two raw functions return tensors without a gradient. The forward
goes through the dispatcher op ``ray_tpu_torch::flash_fwd``, so a
selective checkpoint (``ops.remat``) can keep out and lse, as the JAX
package's remat policy saves ``flash_out`` and ``flash_lse``, and the
backward of a rematerialised block does not launch the forward kernel
again.

The kernels are instantiated for head dims 32, 64 and 128. A CUDA call
with another head dim below 128 zero-pads q, k, v (and ``do``) to the
next instance, launches the same kernel and slices the result back: zero
columns add nothing to q.k^T, to delta, or to the first D columns of
out, dq, dk and dv, and ``sm_scale`` stays 1/sqrt(D) of the unpadded D.
A head dim above 128 still raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import mha_reference

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)      # the kernels' template instances
TILE = 64                      # sequence lengths step by 64 rows
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
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


def _check_kernel_inputs(fn: str, q: torch.Tensor, k: torch.Tensor,
                         **more: torch.Tensor) -> None:
    """Raise unless the CUDA kernels take these tensors: all on one CUDA
    device, bf16 or f32 alike, head_dim 32/64/128, sequence lengths that
    are multiples of 64, batch*heads within the grid, contiguous and
    16-byte aligned."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {q.device}")
    named = dict(q=q, k=k, **more)
    if any(t.device != q.device for t in named.values()):
        raise ValueError(f"{fn}: {', '.join(named)} must lie on one device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in named.values()):
        raise TypeError(f"{fn}: the kernel takes bf16 or f32 (all alike), "
                        f"got {[str(t.dtype) for t in named.values()]}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim must be one of {HEAD_DIMS}, "
                         f"got {d}")
    if sq % TILE or k.shape[1] % TILE:
        raise ValueError(f"{fn}: the kernel needs seq lengths that are "
                         f"multiples of {TILE}, got {sq}, {k.shape[1]}")
    if b * h > 65535:
        raise ValueError(f"{fn}: the kernel grid takes batch*heads <= "
                         f"65535, got {b * h}")
    for name, t in named.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: the kernel needs {name} contiguous and "
                             f"16-byte aligned")


def _instance_for(fn: str, d: int) -> int:
    """The smallest kernel instance that holds head dim ``d``."""
    for inst in HEAD_DIMS:
        if d <= inst:
            return inst
    raise ValueError(f"{fn}: head_dim {d} is above {HEAD_DIMS[-1]}, the "
                     f"largest kernel instance; no kernel takes it")


def padded_head_dim_call(launch, d_pad: int, *args):
    """``launch(*args)`` with each 4-D tensor of ``args`` ([B, S, H, D]:
    q, k, v, out, do) zero-padded on its last dim from D to ``d_pad``,
    and each 4-D tensor of the result sliced back to D (other arguments,
    lse among them, pass as they are). Exact for attention: the padded
    columns of q and k add zero to every score, those of v make zero
    output columns, and those of do add zero to delta. ``sm_scale`` must
    be among ``args``, fixed from the unpadded D: ``launch`` would take
    1/sqrt(d_pad) otherwise."""
    d = args[0].shape[-1]
    padded = [torch.nn.functional.pad(a, (0, d_pad - d))
              if isinstance(a, torch.Tensor) and a.dim() == 4 else a
              for a in args]
    return tuple(r[..., :d].contiguous() if r.dim() == 4 else r
                 for r in launch(*padded))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _scale_q(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """q * sm_scale rounded to q's dtype, as the JAX kernels scale it
    (``q * jnp.asarray(sm_scale, q.dtype)``): the one rounding of q that
    every kernel and plain version shares."""
    return q * torch.tensor(sm_scale, dtype=q.dtype)


def _scaled_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   sm_scale: float) -> torch.Tensor:
    """[B, H, Sq, Sk] f32 scores as the kernels form them: q scaled in its
    own dtype, the product in f32, masked scores -1e30."""
    qs = _scale_q(q, sm_scale)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    return s


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch. q [B, Sq, H, D],
    k/v [B, Sk, H, D] -> (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    f32). Same arithmetic as the kernels it stands for: q is scaled in
    its own dtype, scores and softmax statistics are f32, masked scores
    are -1e30, and probabilities are cast to v's dtype before the P.V
    product (accumulated in f32)."""
    _check(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scaled_scores(q, k, causal, sm_scale)
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
    """(out [B, Sq, H, D], lse [B, H, Sq] f32), without a gradient. CPU
    tensors run the plain version; CUDA tensors launch csrc/flash_fwd.cu,
    which takes bf16 or f32, head_dim up to 128 (32/64/128 directly, the
    others zero-padded to the next of them), contiguous [B, S, H, D]
    inputs with S a multiple of 64 — anything else raises."""
    _check(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        return padded_head_dim_call(
            _launch_fwd, _instance_for("flash_attention_fwd", d), q, k, v,
            causal, sm_scale)
    return _launch_fwd(q, k, v, causal, sm_scale)


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs("flash_attention_fwd", q, k, v=v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), b, h, sq,
                            k.shape[1], d, _DTYPE_CODE[q.dtype], int(causal),
                            float(sm_scale), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0   # kernel launches since last reset


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) in f32, [B, H, Sq]: the elementwise
    reduction the JAX package leaves to XLA outside its kernels (f32
    products of the input-dtype values, summed in f32). Eager PyTorch
    does not fuse the upcasts, the product and the sum, so for 16-bit
    CUDA tensors it is the diagonal of each position's [H, H] product
    dO . out^T with 16-bit operands accumulated in f32 (``out_dtype``):
    one read of each input, the same exact products summed in another
    order."""
    if do.device.type == "cuda" and do.dtype != torch.float32:
        b, s, h, d = do.shape
        prod = torch.bmm(do.reshape(b * s, h, d),
                         out.reshape(b * s, h, d).transpose(1, 2),
                         out_dtype=torch.float32)
        rows = prod.diagonal(dim1=1, dim2=2).reshape(b, s, h)
    else:
        rows = (do.float() * out.float()).sum(-1)
    return rows.transpose(1, 2).contiguous()


def _check_bwd(q, k, v, out, lse, do, causal) -> None:
    _check(q, k, v, causal)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    b, sq, h, _ = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, Sq] = {(b, h, sq)} f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function in plain PyTorch: (q, k, v, out
    [B, S, H, D], lse [B, H, Sq] f32, do [B, Sq, H, D]) -> (dq, dk, dv)
    in the input dtype. Same arithmetic and rounding points as the TPU
    kernels: s = (q*scale in q's dtype).k^T in f32, masked -1e30,
    p = exp(s - lse); dv = p (in do's dtype)^T.do and dp = do.v^T in f32;
    ds = p * (dp - delta) * scale cast to k's dtype; dq = ds.k and
    dk = ds^T.q with q unscaled, accumulated in f32."""
    _check_bwd(q, k, v, out, lse, do, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scaled_scores(q, k, causal, sm_scale) - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - _delta(out, do)[..., None]) * sm_scale).to(k.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's residuals and the output gradient
    ``do``. CPU tensors run the plain version; CUDA tensors launch
    csrc/flash_bwd.cu (its two kernels count as one launch) under the
    forward's conditions, head dims padded as there — anything else
    raises. delta = rowsum(do * out) is computed here, outside the kernel,
    as the JAX package does, and so is q * sm_scale in q's dtype
    (``_scale_q``), which the bf16 kernels read beside q."""
    _check_bwd(q, k, v, out, lse, do, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         sm_scale)
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        return padded_head_dim_call(
            _launch_bwd, _instance_for("flash_attention_bwd", d), q, k, v,
            out, lse, do, causal, sm_scale)
    return _launch_bwd(q, k, v, out, lse, do, causal, sm_scale)


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_kernel_inputs("flash_attention_bwd", q, k, v=v, out=out, do=do)
    if lse.device != q.device or not lse.is_contiguous() \
            or lse.data_ptr() % 16:
        raise ValueError("flash_attention_bwd: lse must be contiguous and "
                         "16-byte aligned on q's device")
    b, sq, h, d = q.shape
    delta = _delta(out, do)
    qs = _scale_q(q, sm_scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("flash_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd(q.data_ptr(), qs.data_ptr(), k.data_ptr(),
                            v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(),
                            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
                            sq, k.shape[1], d, _DTYPE_CODE[q.dtype],
                            int(causal), float(sm_scale), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0   # kernel launches since last reset


# the forward as the dispatcher op ray_tpu_torch::flash_fwd (through
# torch.library.Library: the first call of a torch.library.custom_op
# imports torch._dynamo, seconds in every process)
_LIB = torch.library.Library("ray_tpu_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float sm_scale) -> (Tensor, Tensor)")


def _flash_fwd_op(q, k, v, causal: bool, sm_scale: float):
    return flash_attention_fwd(q, k, v, causal, sm_scale)


_LIB.impl("flash_fwd", _flash_fwd_op, "CompositeExplicitAutograd")


class _Flash(torch.autograd.Function):
    """Counterpart of the JAX package's ``_flash`` custom_vjp
    (``_flash_vjp_fwd`` / ``_flash_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = torch.ops.ray_tpu_torch.flash_fwd(q, k, v, causal,
                                                    sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd's output gradient may be a strided view
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """Flash attention. q/k/v: [batch, seq, heads, head_dim] -> same shape,
    differentiable with respect to q, k and v.

    ``block_q``/``block_k`` are accepted for parity with the JAX
    signature; the CUDA kernels use their own tiles. Sequence lengths that
    are not multiples of 128 go to ``mha_reference``, as in the JAX
    package."""
    del block_q, block_k
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _check(q, k, v, causal)
    if q.shape[1] % 128 != 0 or k.shape[1] % 128 != 0:
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return _Flash.apply(q, k, v, causal, sm_scale)
