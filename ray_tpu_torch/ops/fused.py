"""Fused block entry and exit (counterpart of ray_tpu/ops/fused.py).

``ln_matmul_fwd`` computes layernorm(x; g, b) . w + wb, the function of
the JAX package's ``_ln_matmul_kernel``; ``matmul_residual_fwd`` computes
a . w + b + res, the function of its ``_mm_res_kernel``. For a CUDA tensor
each launches its hand-written Hopper kernel (``csrc/ln_matmul.cu``,
``csrc/mm_res.cu``) or raises; for a CPU tensor it runs its ``*_plain``
version, the same function in plain PyTorch with the same rounding
points, which the tests and chip_smoke.py hold the kernel against.

``matmul_partial_f32_fwd`` is the f32-output instance of the same
``csrc/mm_res.cu`` kernel, a . w (+ b) (+ res) in f32, never rounded: a
rank's partial of a row-parallel product under tensor parallelism, summed
over the ranks before it is rounded (the tensor-parallel GPT's fused exit,
models/gpt.py). It has no TPU counterpart of its own: the JAX package's
fused exit runs unsplit under GSPMD.

``ln_matmul`` and ``matmul_residual`` are the differentiable entry points:
``torch.autograd.Function``s (the counterparts of the JAX package's
``custom_vjp``s) whose forward saves what the JAX forward saves, (x, g, b,
w) and (a, w), and whose backward is the JAX package's plain recompute
backward (``ln_matmul_bwd``, ``matmul_residual_bwd``): the TPU kernels
have no backward kernel, so neither does the port.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

TILE = 64                      # D and F must be multiples of this
_MAX_ROW_TILES = 65535         # the kernels' grid rows (64 rows or more each)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p]
_MR_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check_shapes(fn: str, a: torch.Tensor, w: torch.Tensor,
                  **vectors: Tuple[torch.Tensor, int]) -> None:
    """a [N, K] . w [K, F]; each named vector must have the given length."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"{fn}: need a [N, K] and w [K, F], got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    for name, (t, n) in vectors.items():
        if t.shape != (n,):
            raise ValueError(f"{fn}: {name} must be [{n}], got "
                             f"{tuple(t.shape)}")


def _check_kernel_inputs(fn: str, mats: dict, vecs: dict) -> None:
    """Raise unless the CUDA kernel takes these tensors: all on one CUDA
    device, the matrices bf16 or f32 alike and the vectors f32, K and F
    multiples of 64, rows within the grid, all contiguous and 16-byte
    aligned."""
    first = next(iter(mats.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {first.device}")
    named = {**mats, **vecs}
    if any(t.device != first.device for t in named.values()):
        raise ValueError(f"{fn}: {', '.join(named)} must lie on one device")
    if first.dtype not in _DTYPE_CODE or any(t.dtype != first.dtype
                                             for t in mats.values()):
        raise TypeError(f"{fn}: the kernel takes bf16 or f32 matrices (all "
                        f"alike), got {[str(t.dtype) for t in mats.values()]}")
    n, k = first.shape
    f = mats["w"].shape[1]
    if k % TILE or f % TILE:
        raise ValueError(f"{fn}: the kernel needs K and F multiples of "
                         f"{TILE}, got K={k}, F={f}")
    if n > _MAX_ROW_TILES * TILE:
        raise ValueError(f"{fn}: the kernel grid takes at most "
                         f"{_MAX_ROW_TILES * TILE} rows, got {n}")
    for name, t in named.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: the kernel needs {name} contiguous and "
                             f"16-byte aligned")


def _ln_ref(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
            eps: float) -> torch.Tensor:
    """layernorm(x) * g + b in f32, the statistics two-pass in f32 (as
    ray_tpu/ops/fused.py::_ln_ref)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def ln_matmul_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor, wb: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the normalised row rounded
    to w's dtype, its product with w accumulated in f32 (an f32 product of
    the rounded operands), wb added in f32, one cast to x's dtype."""
    h = _ln_ref(x, g, b, eps).to(w.dtype)
    return (h.float() @ w.float() + wb.float()).to(x.dtype)


def ln_matmul_fwd(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  w: torch.Tensor, wb: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """layernorm(x; g, b) . w + wb, x [N, D], w [D, F] -> [N, F] in x's
    dtype, without a gradient. CPU tensors run the plain version; CUDA
    tensors launch csrc/ln_matmul.cu (its statistics kernel and its GEMM
    count as one launch), which takes x and w bf16 or f32 alike, D and F
    multiples of 64, contiguous and 16-byte aligned (g, b and wb go to it
    as f32) — anything else raises."""
    _check_shapes("ln_matmul_fwd", x, w, g=(g, x.shape[-1]),
                  b=(b, x.shape[-1]), wb=(wb, w.shape[-1]))
    if x.device.type == "cpu":
        return ln_matmul_plain(x, g, b, w, wb, eps)
    vecs = dict(g=g.float(), b=b.float(), wb=wb.float())   # exact casts
    _check_kernel_inputs("ln_matmul_fwd", dict(x=x, w=w), vecs)
    (n, d), f = x.shape, w.shape[1]
    out = torch.empty((n, f), dtype=x.dtype, device=x.device)
    stats = torch.empty(2 * n, dtype=torch.float32, device=x.device)
    lib = _build.load("ln_matmul", _LN_ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.ln_matmul(x.data_ptr(), vecs["g"].data_ptr(),
                            vecs["b"].data_ptr(), w.data_ptr(),
                            vecs["wb"].data_ptr(), stats.data_ptr(),
                            out.data_ptr(), n, d, f,
                            _DTYPE_CODE[x.dtype], float(eps),
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ln_matmul launch failed: cudaError {err}")
    ln_matmul_fwd.launches += 1
    return out


ln_matmul_fwd.launches = 0     # kernel launches since last reset


def matmul_residual_plain(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          res: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a . w accumulated in f32
    (an f32 product), then + b and + res in f32, one cast to a's dtype."""
    return (a.float() @ w.float() + b.float() + res.float()).to(a.dtype)


def matmul_residual_fwd(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        res: torch.Tensor) -> torch.Tensor:
    """a . w + b + res, a [N, K], w [K, F], res [N, F] -> [N, F] in a's
    dtype, without a gradient. CPU tensors run the plain version; CUDA
    tensors launch csrc/mm_res.cu, which takes a, w and res bf16 or f32
    alike, K and F multiples of 64, contiguous and 16-byte aligned (b goes
    to it as f32) — anything else raises."""
    _check_shapes("matmul_residual_fwd", a, w, b=(b, w.shape[-1]))
    if res.shape != (a.shape[0], w.shape[1]):
        raise ValueError(f"matmul_residual_fwd: res must be "
                         f"{(a.shape[0], w.shape[1])}, got {tuple(res.shape)}")
    if a.device.type == "cpu":
        return matmul_residual_plain(a, w, b, res)
    b32 = b.float()                                         # exact cast
    _check_kernel_inputs("matmul_residual_fwd", dict(a=a, w=w, res=res),
                         dict(b=b32))
    n, k = a.shape
    f = w.shape[1]
    out = torch.empty((n, f), dtype=a.dtype, device=a.device)
    lib = _build.load("mm_res", _MR_ARGTYPES)
    with torch.cuda.device(a.device):
        err = lib.mm_res(a.data_ptr(), w.data_ptr(), b32.data_ptr(),
                         res.data_ptr(), out.data_ptr(), n, k, f,
                         _DTYPE_CODE[a.dtype], 0,
                         torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mm_res launch failed: cudaError {err}")
    matmul_residual_fwd.launches += 1
    return out


matmul_residual_fwd.launches = 0   # kernel launches since last reset


def matmul_partial_f32_plain(a: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor] = None,
                             res: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The f32 instance's function in plain PyTorch: a . w accumulated in
    f32 (an f32 product), then + b and + res in f32 where given, in that
    order; returned in f32, never rounded."""
    out = a.float() @ w.float()
    if b is not None:
        out = out + b.float()
    if res is not None:
        out = out + res.float()
    return out


def matmul_partial_f32_fwd(a: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None,
                           res: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """a . w (+ b) (+ res), a [N, K], w [K, F], res [N, F] -> [N, F] f32,
    without a gradient; b and res are each left out when None. CPU tensors
    run the plain version; CUDA tensors launch csrc/mm_res.cu's f32-output
    instance, which takes a, w and res bf16 or f32 alike, K and F multiples
    of 64, contiguous and 16-byte aligned (b goes to it as f32) — anything
    else raises. One fixed summation order: bitwise equal from call to
    call."""
    f = w.shape[-1] if w.dim() == 2 else -1
    _check_shapes("matmul_partial_f32_fwd", a, w,
                  **({} if b is None else dict(b=(b, f))))
    if res is not None and res.shape != (a.shape[0], f):
        raise ValueError(f"matmul_partial_f32_fwd: res must be "
                         f"{(a.shape[0], f)}, got {tuple(res.shape)}")
    if a.device.type == "cpu":
        return matmul_partial_f32_plain(a, w, b, res)
    b32 = None if b is None else b.float()                 # exact cast
    _check_kernel_inputs("matmul_partial_f32_fwd",
                         dict(a=a, w=w, **({} if res is None
                                           else dict(res=res))),
                         {} if b32 is None else dict(b=b32))
    n, k = a.shape
    out = torch.empty((n, f), dtype=torch.float32, device=a.device)
    lib = _build.load("mm_res", _MR_ARGTYPES)
    with torch.cuda.device(a.device):
        err = lib.mm_res(a.data_ptr(), w.data_ptr(),
                         None if b32 is None else b32.data_ptr(),
                         None if res is None else res.data_ptr(),
                         out.data_ptr(), n, k, f, _DTYPE_CODE[a.dtype], 1,
                         torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mm_res (f32 out) launch failed: cudaError {err}")
    matmul_partial_f32_fwd.launches += 1
    return out


matmul_partial_f32_fwd.launches = 0   # kernel launches since last reset


def ln_matmul_bwd(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  w: torch.Tensor, dout: torch.Tensor, eps: float
                  ) -> Tuple[torch.Tensor, ...]:
    """(dx, dg, db, dw, dwb) of ln_matmul, as the JAX package's
    ``_ln_matmul_bwd``: the layernorm recomputed from x in f32 and rounded
    to w's dtype; dout cast to w's dtype (the vjp of the f32 upcast);
    dh = dout . w^T and dw = h^T . dout in that dtype (f32 accumulation);
    dwb = rowsum(dout) in f32; the layernorm's backward in f32. Each
    gradient comes back in the dtype the JAX backward gives it: dx and
    dwb in x's, dg, db and dw in their parameter's. The product h . w
    itself is not recomputed."""
    gf = g.float()
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    h = (xhat * gf + b.float()).to(w.dtype)
    d = dout.to(w.dtype)
    dh = (d @ w.T).float()
    dw = h.T @ d
    dwb = dout.float().sum(0)
    dg = (dh * xhat).sum(0)
    db = dh.sum(0)
    dxhat = dh * gf
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype), dg.to(g.dtype), db.to(b.dtype), dw.to(w.dtype),
            dwb.to(x.dtype))


def matmul_residual_bwd(a: torch.Tensor, w: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """(da, dw, db, dres) of matmul_residual, as the JAX package's
    ``_mm_res_bwd``: da = dout . w^T and dw = a^T . dout as f32 products
    cast to a's and w's dtypes, db = rowsum(dout) in f32 cast to a's dtype,
    dres = dout. When a, w and dout are all bf16, both products run in
    bf16 with f32 accumulation instead: every operand is then bf16-valued,
    and the product of two bf16 values is exact in f32, so the f32 product
    rounded back to bf16 is the same function up to the order of the sums,
    at the bf16 rate (an f32 product would be some 5.8 TFLOP of f32 FMA a
    GPT-2 small training step)."""
    if a.dtype == w.dtype == dout.dtype == torch.bfloat16:
        da, dw = dout @ w.T, a.T @ dout
    else:
        d32 = dout.float()
        da, dw = d32 @ w.float().T, a.float().T @ d32
    db = dout.float().sum(0)
    return da.to(a.dtype), dw.to(w.dtype), db.to(a.dtype), dout


class _LnMatmul(torch.autograd.Function):
    """Counterpart of the JAX package's ``ln_matmul`` custom_vjp
    (``_ln_matmul_fwd`` / ``_ln_matmul_bwd``)."""

    @staticmethod
    def forward(ctx, x, g, b, w, wb, eps):
        out = ln_matmul_fwd(x, g, b, w, wb, eps)
        ctx.save_for_backward(x, g, b, w)
        ctx.eps = eps
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        x, g, b, w = ctx.saved_tensors
        return (*ln_matmul_bwd(x, g, b, w, dout, ctx.eps), None)


class _MatmulResidual(torch.autograd.Function):
    """Counterpart of the JAX package's ``matmul_residual`` custom_vjp
    (``_mm_res_fwd`` / ``_mm_res_bwd``)."""

    @staticmethod
    def forward(ctx, a, w, b, res):
        out = matmul_residual_fwd(a, w, b, res)
        ctx.save_for_backward(a, w)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        a, w = ctx.saved_tensors
        return matmul_residual_bwd(a, w, dout)


def ln_matmul(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              w: torch.Tensor, wb: torch.Tensor, eps: float = 1e-5,
              block_m: int = 256, block_n: int = 768) -> torch.Tensor:
    """layernorm(x, g, b) . w + wb, fused. x [N, D], w [D, F] -> [N, F],
    differentiable with respect to x, g, b, w and wb. ``block_m`` and
    ``block_n`` are accepted for parity with the JAX signature; the CUDA
    kernel uses its own tiles."""
    del block_m, block_n
    return _LnMatmul.apply(x, g, b, w, wb, eps)


def matmul_residual(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    res: torch.Tensor, block_m: int = 256,
                    block_n: int = 768) -> torch.Tensor:
    """a . w + b + res, fused. a [N, K], w [K, F], res [N, F] -> [N, F],
    differentiable with respect to all four. ``block_m`` and ``block_n``
    are accepted for parity with the JAX signature."""
    del block_m, block_n
    return _MatmulResidual.apply(a, w, b, res)
