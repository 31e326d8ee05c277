#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build    — compile ray_tpu_torch/csrc/flash_fwd.cu, flash_bwd.cu,
              ln_matmul.cu and mm_res.cu with nvcc for sm_90a, one nvcc
              each, started together; print the card's name and power
              limit.
2. kernels  — each kernel against its plain PyTorch version on the same
              inputs at the main paths' shapes, with the tolerances below,
              and a planted lower-precision control that must fail them;
              kernel, plain and library-call times with CUDA events, and the
              card's bound for the same work; then, untimed, at the shapes
              and types that reach the kernels' other instances. The fused
              block entry and exit (ln_matmul, mm_res) at GPT-2 small's four
              training shapes, timed beside the cuBLAS composition of the
              same function; and matmul_residual's bf16 backward products
              against the f32 products they stand for. The flash backward
              runs twice on the same inputs and must be bitwise equal;
              each timed flash case prints its time over SDPA's and its
              share of the bound. GPT-2 small's LM head at one training
              chunk: f32 logits and dx, dw against the f32 products of the
              same bf16 operands and f32 cotangent, with a planted control
              (logits and cotangent rounded to bf16) that must fail.
3. forward  — Llama-2-7B at full width (32 layers, d_model 4096, 32 heads,
              bf16, random weights from seed 0): `apply` on [1, 1024] and
              [1, 4096] tokens must launch the flash kernel once per layer
              and match the same forward through mha_reference; three
              planted faults in that reference forward must not.
4. serving  — LLMServer("llama2-7b") answers 8 concurrent requests; every
              request finishes by length, no KV block leaks, and each
              prompt's paged-prefill logits match the dense flash forward.
5. training — GPT-2 small at full width (12 layers, d_model 768, 12 heads
              of 64, vocab 50257 padded to 50304; bf16 compute, f32
              params, random weights from seed 0), the twin of bench.py
              main(): B=40, S=1024, loss_chunked over 10 chunks,
              torch.optim.AdamW(lr=3e-4, weight_decay=0.1), 3 warm-up and
              10 timed steps, each launching flash_fwd and flash_bwd once
              per layer; the loss starts at ln(50304) and falls. Then a
              gradient check at B=4: every parameter's gradient against the
              same model through mha_reference, which three planted
              backward faults must fail.
6. fused    — the same training with GPTConfig(fused_entry_exit=True):
              each step launches ln_matmul and mm_res twice per layer and
              the flash kernels once; the same loss checks; then a
              gradient check at B=4 against the unfused model, which two
              planted faults in the fused backward must fail.

Three main paths are counted: serving (phases 3-4), training (phase 5's
steps) and fused training (phase 6's steps). Every launch count is zeroed
just before each and read just after it; the kernel comparisons of phase
2 and the gradient checks do not count.
The last three lines are the card (as nvidia-smi prints it), the kernels
JSON line and the result JSON line. Without a CUDA device, or without the
ray_tpu_torch package beside this file, the script fails before printing
any result.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
KERNEL_SOURCES = ("flash_fwd", "flash_bwd", "ln_matmul", "mm_res")

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel call
# is max(bytes / bandwidth, operations / peak rate of the operand type).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Tolerances, each with its reason.
#   flash out, bf16: 3e-2, as tests/test_ops.py:61 (bf16 output rounding;
#     the kernel also sums in another order than the plain version).
#   flash out, f32: 2e-5, as tests/test_ops.py:30 (summation order only).
#   flash out, scaled: the largest error in a row (b, s, h) over the
#     largest |ref| in that row, maximised over rows, so that rows whose
#     outputs are small (long causal rows average many values) are held
#     as tightly as the rest. bf16: 2e-2, a few 2^-8 roundings of p and
#     of out; f32: 1e-5. The control below, p rounded to float8_e4m3
#     before P.V (a lower-precision P.V), must fail one of the checks.
#   flash lse: f32 statistics over the same scaled inputs, so summation
#     order only: 1e-3 for bf16 inputs, 2e-5 for f32.
TOL_OUT = {"bfloat16": 3e-2, "float32": 2e-5}
TOL_OUT_ROW = {"bfloat16": 2e-2, "float32": 1e-5}
TOL_LSE = {"bfloat16": 1e-3, "float32": 2e-5}
#   Llama-2-7B logits (std about 1.3 at this random init), flash forward
#   against the mha_reference forward and against the engine's paged
#   prefill: max abs over every compared logit 0.6, and root mean square
#   of the difference over the reference's std 0.1. The paths round to
#   bf16 at other places (the kernel's bf16 probabilities, matmuls of
#   other row counts), and 32 layers of random weights with a bf16
#   residual stream amplify a one-ulp difference to a few tenths of a
#   logit at the worst of 33 M logits. The forward phase reads three
#   planted faults through the reference path (causal mask off, sm_scale
#   off by sqrt 2, last layer skipped) and fails unless each of them
#   fails this check.
TOL_LOGITS = 0.6
TOL_LOGITS_RMS = 0.1
LOGIT_CONTROLS = ("causal mask off", "sm_scale x sqrt(2)",
                  "last layer skipped")

#   flash_bwd, dq/dk/dv: the largest error over the tensor's largest |ref|
#     (bf16 1e-2, about two ulps of the largest gradient; f32 1e-5,
#     summation order only), and each row's largest error over the row's
#     largest |ref|, floored at 1/64 of the tensor's largest |ref| (bf16
#     2e-2, a few ulps of the row's largest value, as for out above; f32
#     1e-5). The floor keeps rows whose gradient is zero in exact
#     arithmetic (dq of the first causal row: one key, ds = p (dp -
#     delta) = 0) from dividing rounding noise by zero. The control below,
#     ds rounded to float8_e4m3 before its two products, must fail one of
#     the checks.
TOL_GRAD = {"bfloat16": 1e-2, "float32": 1e-5}
TOL_GRAD_ROW = {"bfloat16": 2e-2, "float32": 1e-5}
GRAD_ROW_FLOOR = 1.0 / 64
#   GPT-2 small gradients at B=4, S=1024, flash model against the same
#   model through mha_reference (both bf16): each parameter's
#   ||g - g_ref|| / ||g_ref|| at most TOL_TRAIN_GRAD (w_qkv and b_qkv
#   per third). The two paths round to bf16 at other places: the
#   kernels round ds to bf16, and a row of ds sums to zero, so dq and dk
#   (sums over 1024 keys) cancel heavily and their relative rounding
#   error grows, to about 3e-2 in the q and k thirds of w_qkv (1e-3 to
#   5e-3 elsewhere). Left out: the key third of b_qkv, whose exact
#   gradient is zero (a bias on every key shifts a row of scores by a
#   constant, which the softmax cancels), so both paths give rounding
#   noise and its ratio means nothing. The training phase reads three
#   planted faults in the backward, swapped into the autograd Function
#   as a plain backward, and fails unless each of them fails this check.
TOL_TRAIN_GRAD = 0.1
ZERO_GRADIENT = "b_qkv[k]"
TRAIN_FAULTS = ("delta left out", "causal mask off",
                "sm_scale left out of ds")
BWD_CONTROL = "ds in float8_e4m3"
#   ln_matmul and mm_res outputs: the largest error over the largest |ref|
#     (bf16 1e-2: a rounding flip moves one output by one ulp, at most
#     2^-7 of the largest |ref|; f32 1e-5, summation order only, over up
#     to 6400 terms), and the root mean square of the error over that of
#     ref (bf16 3e-3: flips are rare, so this stays far below the ulp;
#     f32 1e-5). The control, the normalised row (ln_matmul) or a
#     (mm_res) rounded to float8_e4m3 before the product (a
#     lower-precision product), must fail one of the checks.
TOL_FUSED = {"bfloat16": 1e-2, "float32": 1e-5}
TOL_FUSED_RMS = {"bfloat16": 3e-3, "float32": 1e-5}
#   GPT-2 small gradients at B=4, S=1024, fused model against the unfused
#   one (both flash, bf16): each parameter's ||g - g_ref|| / ||g_ref|| at
#   most TOL_FUSED_GRAD, b_qkv's key third left out as above. The paths
#   round at other places: the fused entry and exit add the bias (and the
#   residual) in f32 before one rounding, the unfused path rounds the
#   product and then adds in bf16, so every activation differs by
#   roundings, which the flash backward's bf16 ds amplifies in the q and
#   k thirds of w_qkv. The fused training phase reads two planted faults
#   in the fused backward, swapped in as its plain backward functions,
#   and fails unless each of them fails this check. A third, the
#   layernorm backward without its mean term, is read and printed but not
#   required to fail: at this random init the mean of dxhat = (dout .
#   w^T) * g over a row is near zero, so leaving it out moves the
#   gradients (4.7e-2 in the q third of w_qkv) about as much as the
#   rounding noise of the sound run (4.1e-2) does.
TOL_FUSED_GRAD = 0.1
FUSED_FAULTS = ("dres dropped", "layernorm backward without its variance term")
FUSED_SHOWN = ("layernorm backward without its mean term",)

#   GPT-2 small's LM head at one chunk ([4096, 768] x [50304, 768], bf16
#   operands): the logits' largest error over the largest |ref| of the
#   f32 product of the same bf16 operands at most 1e-4 (the sound head
#   keeps the f32 accumulation and differs by summation order, about
#   1e-6; the control, logits rounded to bf16, differs by up to half a
#   bf16 ulp, about 2e-3 of the largest logit). dx and dw against the f32
#   products of the f32 cotangent rounded once to bf16: at most 5% of the
#   entries may differ at all, by at most one bf16 ulp (of |ref|, floored
#   at 1/1024 of the largest). The head's hi/lo split reproduces the f32
#   cotangent's products to about 2^-16, so only near-ties flip (on an
#   H100: 0.95% of dx and 0.3% of dw, by one ulp). The control, logits and
#   cotangent rounded to bf16 (the head before its repair), fails the
#   logits by 20x and moves 31% of dw and up to 2 ulps of dx there: dx,
#   whose cotangent is mostly the exact -1 of the target, alone would not
#   tell them apart.
TOL_HEAD_LOGITS = 1e-4
TOL_HEAD_SHARE = 0.05
TOL_HEAD_ULPS = 1.0

# Timed kernel cases: (label, [B, S, H, D], dtype, causal)
GPT_CASE = "GPT-2 training"    # the training path's attention shape
FWD_CASES = [
    ("Llama S=1024", (1, 1024, 32, 128), "bfloat16", True),
    ("Llama S=4096", (1, 4096, 32, 128), "bfloat16", True),
    (GPT_CASE, (40, 1024, 12, 64), "bfloat16", True),
    ("non-causal", (2, 256, 12, 64), "bfloat16", False),
    ("f32", (2, 256, 4, 32), "float32", True),
]
FWD_MAIN = "Llama S=4096"
BWD_CASES = [
    (GPT_CASE, (40, 1024, 12, 64), "bfloat16", True),
    ("S=4096", (2, 4096, 12, 64), "bfloat16", True),
    ("non-causal", (2, 256, 12, 64), "bfloat16", False),
    ("f32", (2, 256, 4, 32), "float32", True),
]
# Checked against the plain version but not timed: the kernels' other
# template instances, a length that is a multiple of 64 but not of 128
# (the bf16 kernels' 128-row tiles then end half empty), a single 64-row
# tile, and non-causal attention with seq_q != seq_k either way.
# (label, [B, Sq, H, D], Sk, dtype, causal)
EDGE_CHECKS = [
    ("bf16 one 64-row tile", (1, 64, 2, 64), 64, "bfloat16", True),
    ("bf16 Sq=192 Sk=64", (1, 192, 2, 64), 64, "bfloat16", False),
]
FWD_CHECKS = [
    ("bf16 hd32 S=192", (2, 192, 8, 32), 192, "bfloat16", True),
    ("bf16 Sq!=Sk", (1, 128, 4, 64), 320, "bfloat16", False),
    ("f32 hd64 Sq!=Sk", (1, 64, 2, 64), 256, "float32", False),
    ("f32 hd128", (1, 256, 2, 128), 256, "float32", True),
]
BWD_CHECKS = FWD_CHECKS + [
    ("bf16 hd128", (1, 256, 4, 128), 256, "bfloat16", True),
] + EDGE_CHECKS
FWD_CHECKS += EDGE_CHECKS
# Fused block entry and exit at GPT-2 small's training shapes (B*S = 40960
# rows): (label, kernel, N, K, F). ln_matmul: LN1 + QKV, LN2 + FC; mm_res:
# attention projection + residual, MLP out + residual.
FUSED_CASES = [
    ("QKV", "ln_matmul", 40960, 768, 2304),
    ("FC", "ln_matmul", 40960, 768, 3072),
    ("proj", "mm_res", 40960, 768, 768),
    ("MLP out", "mm_res", 40960, 3072, 768),
]
FUSED_MAIN = {"ln_matmul": "FC", "mm_res": "MLP out"}
# Checked against the plain version but not timed: every main shape in
# f32, a row count that is not a multiple of 64, and widths other than
# GPT-2 small's (d_model 64; GPT-2 xl's 1600 and 6400, whose F leaves the
# last 128-column tile half full). (label, kernel, N, K, F, dtype)
FUSED_CHECKS = [(f"{label} f32", kernel, n, k, f, "float32")
                for label, kernel, n, k, f in FUSED_CASES] + [
    ("ragged N", "ln_matmul", 1000, 768, 2304, "bfloat16"),
    ("ragged N", "mm_res", 1000, 3072, 768, "bfloat16"),
    ("D=64", "ln_matmul", 256, 64, 192, "bfloat16"),
    ("D=64", "mm_res", 256, 64, 192, "bfloat16"),
    ("xl D=1600", "ln_matmul", 512, 1600, 4800, "bfloat16"),
    ("xl K=6400", "mm_res", 512, 6400, 1600, "bfloat16"),
    ("ragged xl f32", "ln_matmul", 300, 1600, 4800, "float32"),
    ("ragged D=64 f32", "mm_res", 300, 64, 192, "float32"),
]
# GPT-2 small training, as bench.py main(): batch, length, LM-head chunk
# rows, optimizer, warm-up and timed steps; the gradient check's batch.
TRAIN_BATCH, TRAIN_SEQ, HEAD_CHUNK_ROWS = 40, 1024, 4096
TRAIN_LR, TRAIN_WD = 3e-4, 0.1
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
GRAD_BATCH = 4
H100_BF16_PEAK = 989e12        # MFU denominator, as PEAK_FLOPS
#   Step-0 loss: the init's logits are x.wte_v with x layernormed (unit
#   variance per feature) and wte ~ N(0, 0.02^2), so they are about
#   N(0, d_model * 0.02^2) and the loss is about ln(V) + d_model * 0.02^2
#   / 2 = 10.8258 + 0.1536 for GPT-2 small; it must lie within 0.05.
TOL_LOSS0 = 0.05
# Device kernels of a profiled step, by class: (class, name fragments).
KERNEL_CLASSES = (("flash_fwd", ("flash_fwd_",)),
                  ("flash_bwd", ("flash_bwd_",)),
                  ("ln_matmul", ("ln_matmul_kernel",)),
                  ("mm_res", ("mm_res_kernel",)),
                  ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
                  ("optimizer", ("multi_tensor_apply",)))
ENGINE_CONFIG = dict(max_batch=8, num_blocks=256, block_size=16,
                     max_blocks_per_seq=16, prefill_buckets=(16, 32, 64))
N_REQUESTS, MAX_TOKENS = 8, 32


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call over `reps` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_bound(shape, dtype: str, causal: bool):
    """(ms, 'bytes'|'operations') the card needs at least for one call."""
    b, s, h, d = shape
    itemsize = 2 if dtype == "bfloat16" else 4
    moved = 4 * b * s * h * d * itemsize + b * h * s * 4   # q k v out + lse
    flops = 4 * b * h * s * s * d // (2 if causal else 1)
    t_bytes = moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_bwd_bound(shape, sk, dtype, causal):
    """(ms, 'bytes'|'operations') the card needs at least for one backward:
    q, out, do, k, v and lse read once, dq, dk, dv written once; five
    products of 2*Sq*Sk*D FLOPs per head, halved by the causal mask."""
    b, sq, h, d = shape
    itemsize = 2 if dtype == "bfloat16" else 4
    moved = 4 * b * h * d * (sq + sk) * itemsize + b * h * sq * 4
    flops = 10 * b * h * sq * sk * d // (2 if causal else 1)
    t_bytes = moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def out_errors(out, ref):
    """(max abs error, max over rows of the row's largest error over the
    row's largest |ref|) of attention outputs [B, S, H, D]."""
    diff = (out.float() - ref.float()).abs()
    row_ref = ref.float().abs().amax(-1).clamp_min(1e-30)
    return diff.max().item(), (diff.amax(-1) / row_ref).max().item()


def out_agrees(err_abs, err_row, dtype):
    return err_abs <= TOL_OUT[dtype] and err_row <= TOL_OUT_ROW[dtype]


def flash_plain_p_fp8(q, k, v, causal):
    """Control: flash_attention_fwd_plain's out with p rounded to
    float8_e4m3 before P.V, a planted lower-precision P.V."""
    import torch

    qs = q * torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        n = q.shape[1]
        idx = torch.arange(n, device=q.device)
        s = s.masked_fill(idx[:, None] < idx[None, :], -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhqk,bkhd->bhqd",
                       p.to(torch.float8_e4m3fn).float(), v.float())
    out = acc / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype).transpose(1, 2).contiguous()


def grad_errors(got, ref):
    """Over dq, dk, dv: (the largest error over the tensor's largest
    |ref|, each row's largest error over the row's largest |ref| floored
    at GRAD_ROW_FLOOR of the tensor's), each maximised."""
    scaled = rows = 0.0
    for g, r in zip(got, ref):
        diff = (g.float() - r.float()).abs()
        ref_abs = r.float().abs()
        top = ref_abs.max().clamp_min(1e-30)
        scaled = max(scaled, (diff.max() / top).item())
        row_ref = ref_abs.amax(-1).clamp_min(top * GRAD_ROW_FLOOR)
        rows = max(rows, (diff.amax(-1) / row_ref).max().item())
    return scaled, rows


def grads_agree(scaled, rows, dtype):
    return scaled <= TOL_GRAD[dtype] and rows <= TOL_GRAD_ROW[dtype]


def bwd_variant(q, k, v, out, lse, do, causal, sm_scale, fault):
    """flash_attention_bwd_plain's arithmetic with one planted fault (a
    control for the gradient checks; it launches no kernel): ds rounded
    to float8_e4m3 instead of the input dtype, delta left out of ds, the
    causal mask off in the recompute of p, or sm_scale left out of ds."""
    import torch

    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal and fault != "causal mask off":
        idx = torch.arange(q.shape[1], device=q.device)
        s = s.masked_fill(idx[:, None] < idx[None, :], -1e30)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = 0.0 if fault == "delta left out" else \
        (do.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) * (1.0 if fault == "sm_scale left out of ds"
                             else sm_scale)
    ds = ds.to(torch.float8_e4m3fn if fault == BWD_CONTROL
               else k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_bound(kernel, n, k, f, dtype):
    """(ms, 'bytes'|'operations') the card needs at least for one call of
    ln_matmul (x [n, k], g, b [k] f32, w [k, f], wb [f]) or mm_res (a
    [n, k], w [k, f], b [f], res [n, f]): each input read once, the output
    [n, f] written once; the product's 2*n*k*f FLOPs at the operand type's
    rate (the layernorm's and the epilogue's f32 work, under 0.5 GFLOP at
    these shapes, takes less time at the f32 rate than the product)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    if kernel == "ln_matmul":
        moved = (n * k + k * f + f + n * f) * itemsize + 2 * k * 4
    else:
        moved = (n * k + k * f + f + 2 * n * f) * itemsize
    t_bytes = moved / PEAK_BYTES_PER_S
    t_ops = 2 * n * k * f / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fused_inputs(kernel, n, k, f, dtype, seed):
    """Inputs on the card at the model's scales: ln_matmul's x with an
    offset (so the mean matters), g and b f32 parameters near one and
    zero, w and wb at the init's std 0.02; mm_res's a and res standard
    normal, w and b at std 0.02."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def r(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=getattr(torch, dt))

    if kernel == "ln_matmul":
        return (r(n, k) * 2 + 0.5, 1 + 0.1 * r(k, dt="float32"),
                0.1 * r(k, dt="float32"), 0.02 * r(k, f), 0.02 * r(f))
    return r(n, k), 0.02 * r(k, f), 0.02 * r(f), r(n, f)


def fused_errors(out, ref):
    """(max abs error over max |ref|, rms error over rms ref)."""
    diff = out.float() - ref.float()
    ref = ref.float()
    return ((diff.abs().max() / ref.abs().max()).item(),
            (diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item())


def fused_agrees(scaled, rms, dtype):
    return scaled <= TOL_FUSED[dtype] and rms <= TOL_FUSED_RMS[dtype]


def fused_control(kernel, args):
    """Control: the plain version with the normalised row (ln_matmul) or a
    (mm_res) rounded to float8_e4m3 before the product."""
    import torch

    from ray_tpu_torch.ops.fused import _ln_ref

    f8 = torch.float8_e4m3fn
    if kernel == "ln_matmul":
        x, g, b, w, wb = args
        h = _ln_ref(x, g, b, 1e-5).to(f8).float()
        return (h @ w.float() + wb.float()).to(x.dtype)
    a, w, b, res = args
    return (a.to(f8).float() @ w.float() + b.float()
            + res.float()).to(a.dtype)


def phase_kernels_fused():
    """ln_matmul and mm_res against their plain versions at the training
    path's shapes, timed beside the plain version and beside the cuBLAS
    composition of the same function (there is no single PyTorch call:
    addmm(wb, layer_norm(x), w) and addmm(res + b, a, w)); untimed checks
    at f32 and at other shapes; then matmul_residual's backward products
    in bf16 against the f32 products they stand for."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import (ln_matmul_fwd, ln_matmul_plain,
                                   matmul_residual_fwd, matmul_residual_plain)

    fns = {"ln_matmul": (ln_matmul_fwd, ln_matmul_plain),
           "mm_res": (matmul_residual_fwd, matmul_residual_plain)}
    rows = []
    cases = [(label, kernel, n, k, f, "bfloat16", True)
             for label, kernel, n, k, f in FUSED_CASES]
    cases += [(*case, False) for case in FUSED_CHECKS]
    for i, (label, kernel, n, k, f, dtype, timed) in enumerate(cases):
        args = fused_inputs(kernel, n, k, f, dtype, SEED + 200 + i)
        fn, plain = fns[kernel]
        out = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        check(out.shape == (n, f) and out.dtype == args[0].dtype,
              f"{kernel} {label}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out.float()).all()),
              f"{kernel} {label}: non-finite output")
        err_abs = (out.float() - ref.float()).abs().max().item()
        scaled, rms = fused_errors(out, ref)
        text = (f"{kernel} {label} [{n}, {k}] x [{k}, {f}] {dtype}: max abs "
                f"err {err_abs:.3e}, scaled {scaled:.3e} (tol "
                f"{TOL_FUSED[dtype]}), rms {rms:.3e} (tol "
                f"{TOL_FUSED_RMS[dtype]})")
        row = dict(label=label, kernel=kernel, shape=[n, k, f], dtype=dtype,
                   max_abs_err=err_abs, scaled_err=scaled, rms_err=rms)
        control = None
        if timed:
            control = fused_errors(fused_control(kernel, args), ref)
            ms = cuda_ms(lambda: fn(*args), reps=20)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
            if kernel == "ln_matmul":
                x, g, b, w, wb = args
                gc_, bc_ = g.to(x.dtype), b.to(x.dtype)
                lib_ms = cuda_ms(lambda: torch.addmm(
                    wb, F.layer_norm(x, (k,), gc_, bc_), w), reps=20)
            else:
                a, w, b, res = args
                lib_ms = cuda_ms(lambda: torch.addmm(res + b, a, w), reps=20)
            bound_ms, bound_by = fused_bound(kernel, n, k, f, dtype)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       control_scaled_err=control[0],
                       control_rms_err=control[1])
            text += (f"; control (float8 operand): scaled {control[0]:.3e}, "
                     f"rms {control[1]:.3e}; kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, cuBLAS composition {lib_ms:.4f} "
                     f"ms, bound {bound_ms:.4f} ms ({bound_by})")
        print(f"[kernels] {text}")
        check(fused_agrees(scaled, rms, dtype),
              f"{kernel} {label} disagrees with its plain version")
        check(control is None or not fused_agrees(*control, dtype),
              f"{kernel} {label}: the float8 control passes the check")
        rows.append(row)
        del args, out, ref
        torch.cuda.empty_cache()
    return rows, fused_bwd_products()


def fused_bwd_products():
    """matmul_residual's backward at the MLP-out shape, bf16: da and dw as
    bf16 products (f32 accumulation), the route the port takes, against
    the f32 products of the same bf16 values rounded once, the JAX
    package's route; both timed."""
    import torch

    from ray_tpu_torch.ops.fused import matmul_residual_bwd

    _, _, n, k, f = next(c for c in FUSED_CASES if c[0] == "MLP out")
    a, w, _, dout = fused_inputs("mm_res", n, k, f, "bfloat16", SEED + 300)

    def f32_route():
        d32 = dout.float()
        return ((d32 @ w.float().T).to(a.dtype),
                (a.float().T @ d32).to(w.dtype))

    got, want = matmul_residual_bwd(a, w, dout)[:2], f32_route()
    errs = {name: fused_errors(g, r)
            for name, g, r in zip(("da", "dw"), got, want)}
    bf16_ms = cuda_ms(lambda: matmul_residual_bwd(a, w, dout), reps=10)
    f32_ms = cuda_ms(f32_route, reps=3, warmup=1)
    print(f"[kernels] matmul_residual backward [{n}, {k}] x [{k}, {f}]: "
          f"bf16 products vs f32 products rounded to bf16: "
          + ", ".join(f"{name} scaled {e[0]:.3e}, rms {e[1]:.3e}"
                      for name, e in errs.items())
          + f" (tol {TOL_FUSED['bfloat16']}, {TOL_FUSED_RMS['bfloat16']}); "
          f"bf16 route {bf16_ms:.4f} ms, f32 route {f32_ms:.4f} ms")
    check(all(fused_agrees(*e, "bfloat16") for e in errs.values()),
          "matmul_residual's bf16 backward products disagree with the f32 "
          "products")
    return dict(errors=errs, bf16_ms=bf16_ms, f32_ms=f32_ms)


def logits_errors(got, ref):
    """Max abs difference, and max abs and root mean square of the
    difference over the reference's std."""
    diff = (got.float() - ref.float())
    std = ref.float().std().item()
    max_abs = diff.abs().max().item()
    return dict(max_abs=max_abs, max_over_std=max_abs / std,
                rms_over_std=diff.pow(2).mean().sqrt().item() / std)


def logits_agree(e):
    return e["max_abs"] <= TOL_LOGITS and e["rms_over_std"] <= TOL_LOGITS_RMS


def control_forward(name, model, params, tokens):
    """The mha_reference forward with one planted fault (a control for
    the logits check; it launches no kernel)."""
    import ray_tpu_torch.models.llama as llama_mod

    c = dataclasses.replace(model.config, use_flash=False)
    if name == "last layer skipped":
        c = dataclasses.replace(c, n_layer=c.n_layer - 1)
        return llama_mod.Llama(c).apply(params, tokens)
    fault = {"causal mask off": dict(causal=False),
             "sm_scale x sqrt(2)": dict(sm_scale=math.sqrt(2 / c.head_dim))
             }[name]
    sound = llama_mod.mha_reference
    llama_mod.mha_reference = lambda q, k, v, causal=True: sound(
        q, k, v, **{"causal": causal, **fault})
    try:
        return llama_mod.Llama(c).apply(params, tokens)
    finally:
        llama_mod.mha_reference = sound


def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(*KERNEL_SOURCES)
    build_s = time.perf_counter() - t0
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {', '.join(KERNEL_SOURCES)} built together in "
          f"{build_s:.2f} s")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[build] card: {card}")
    return card


def _randn(shapes, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda",
                        dtype=getattr(torch, dtype)) for s in shapes]


def phase_kernels_fwd():
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention_fwd, flash_attention_fwd_plain

    rows = []
    for i, (label, shape, dtype, causal) in enumerate(FWD_CASES):
        q, k, v = _randn([shape] * 3, dtype, SEED + i)
        out, lse = flash_attention_fwd(q, k, v, causal)
        ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        check(out.shape == q.shape and lse.shape == (shape[0], shape[2],
                                                     shape[1]),
              f"flash {label}: output shapes {tuple(out.shape)}, "
              f"{tuple(lse.shape)}")
        err_out, err_row = out_errors(out, ref_out)
        err_lse = (lse - ref_lse).abs().max().item()
        control = ""
        if dtype == "bfloat16":
            ctl_abs, ctl_row = out_errors(
                flash_plain_p_fp8(q, k, v, causal), ref_out)
            control = (f"; control (p in float8_e4m3): out err "
                       f"{ctl_abs:.3e}, row-scaled {ctl_row:.3e}")
        big = shape[0] * shape[1] >= 4096
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal),
                     reps=10 if big else 30)
        plain_ms = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, causal),
                           reps=2 if big else 10, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=10 if big else 30)
        bound_ms, bound_by = flash_bound(shape, dtype, causal)
        row = dict(label=label, shape=list(shape), dtype=dtype, causal=causal,
                   max_abs_err=err_out, row_scaled_err=err_row,
                   lse_max_abs_err=err_lse, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by, over_library=ms / lib_ms,
                   bound_share=bound_ms / ms)
        print(f"[kernels] flash_fwd {label} {list(shape)} {dtype} "
              f"causal={causal}: out err {err_out:.3e} (tol "
              f"{TOL_OUT[dtype]}), row-scaled {err_row:.3e} (tol "
              f"{TOL_OUT_ROW[dtype]}), lse err {err_lse:.3e} (tol "
              f"{TOL_LSE[dtype]}){control}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); kernel/sdpa "
              f"{ms / lib_ms:.2f}, {bound_ms / ms:.1%} of bound")
        check(out_agrees(err_out, err_row, dtype)
              and err_lse <= TOL_LSE[dtype],
              f"flash {label} disagrees with its plain version")
        check(not control or not out_agrees(ctl_abs, ctl_row, dtype),
              f"flash {label}: the float8 control passes the out check")
        check(bool(torch.isfinite(out.float()).all()), f"flash {label}: "
              f"non-finite output")
        rows.append(row)
        del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt
        torch.cuda.empty_cache()
    for i, (label, shape, sk, dtype, causal) in enumerate(FWD_CHECKS):
        b, sq, h, d = shape
        q, k, v = _randn([shape, (b, sk, h, d), (b, sk, h, d)], dtype,
                         SEED + len(FWD_CASES) + i)
        out, lse = flash_attention_fwd(q, k, v, causal)
        ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal)
        err_out, err_row = out_errors(out, ref_out)
        err_lse = (lse - ref_lse).abs().max().item()
        print(f"[kernels] flash_fwd check {label} q {list(shape)} seq_k {sk} "
              f"{dtype} causal={causal}: out err {err_out:.3e}, row-scaled "
              f"{err_row:.3e}, lse err {err_lse:.3e}")
        check(out_agrees(err_out, err_row, dtype)
              and err_lse <= TOL_LSE[dtype],
              f"flash {label} disagrees with its plain version")
    return rows


def phase_kernels_bwd():
    """flash_bwd against flash_attention_bwd_plain on the same residuals
    (out and lse from the forward kernel), timed beside the plain version
    and beside SDPA's backward (the yardstick: autograd through
    scaled_dot_product_attention, its graph retained between calls)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import (flash_attention_bwd,
                                   flash_attention_bwd_plain,
                                   flash_attention_fwd)

    rows = []
    cases = [(label, shape, shape[1], dtype, causal, True)
             for label, shape, dtype, causal in BWD_CASES]
    cases += [(label, shape, sk, dtype, causal, False)
              for label, shape, sk, dtype, causal in BWD_CHECKS]
    for i, (label, shape, sk, dtype, causal, timed) in enumerate(cases):
        b, sq, h, d = shape
        q, k, v, do = _randn([shape, (b, sk, h, d), (b, sk, h, d), shape],
                             dtype, SEED + 100 + i)
        scale = 1.0 / math.sqrt(d)
        out, lse = flash_attention_fwd(q, k, v, causal)
        got = flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        # no atomics, a fixed summation order: a second run is bitwise equal
        again = flash_attention_bwd(q, k, v, out, lse, do, causal)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"flash_bwd {label}: dq, dk, dv differ between two runs")
        del again
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        check(all(g.shape == r.shape and g.dtype == r.dtype
                  for g, r in zip(got, ref)),
              f"flash_bwd {label}: output shapes or dtypes differ")
        check(all(bool(torch.isfinite(g.float()).all()) for g in got),
              f"flash_bwd {label}: non-finite gradient")
        err_abs = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
        scaled, row_err = grad_errors(got, ref)
        control = ""
        if dtype == "bfloat16":
            ctl = grad_errors(bwd_variant(q, k, v, out, lse, do, causal,
                                          scale, BWD_CONTROL), ref)
            control = (f"; control ({BWD_CONTROL}): scaled {ctl[0]:.3e}, "
                       f"row-scaled {ctl[1]:.3e}")
        text = (f"{list(shape)} seq_k {sk} {dtype} causal={causal}: bitwise "
                f"equal over two runs; max abs err {err_abs:.3e}, scaled "
                f"{scaled:.3e} (tol {TOL_GRAD[dtype]}), row-scaled "
                f"{row_err:.3e} (tol "
                f"{TOL_GRAD_ROW[dtype]}){control}")
        row = dict(label=label, shape=list(shape), seq_k=sk, dtype=dtype,
                   causal=causal, max_abs_err=err_abs, scaled_err=scaled,
                   row_scaled_err=row_err)
        if timed:
            big = b * sq >= 4096
            ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                     causal),
                         reps=10 if big else 30)
            plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal), reps=2 if big else 10,
                warmup=1)
            with torch.enable_grad():
                leaves = [x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v)]
                o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
                g = do.transpose(1, 2)
                lib_ms = cuda_ms(lambda: torch.autograd.grad(
                    o, leaves, g, retain_graph=True), reps=10 if big else 30)
            bound_ms, bound_by = flash_bwd_bound(shape, sk, dtype, causal)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       over_library=ms / lib_ms, bound_share=bound_ms / ms)
            text += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                     f"backward {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}); kernel/sdpa {ms / lib_ms:.2f}, "
                     f"{bound_ms / ms:.1%} of bound")
            del leaves, o, g
        print(f"[kernels] flash_bwd {label} {text}")
        check(grads_agree(scaled, row_err, dtype),
              f"flash_bwd {label} disagrees with its plain version")
        check(not control or not grads_agree(*ctl, dtype),
              f"flash_bwd {label}: the float8 control passes the check")
        rows.append(row)
        del q, k, v, do, out, lse, got, ref
        torch.cuda.empty_cache()
    return rows


def phase_forward(server):
    import torch

    from ray_tpu_torch.models import Llama
    from ray_tpu_torch.ops import flash_attention_fwd

    model, params = server.engine.model, server.engine.params
    c = model.config
    check((c.n_layer, c.d_model, c.n_head, c.head_dim) == (32, 4096, 32, 128),
          f"not Llama-2-7B width: {c}")
    ref_model = Llama(dataclasses.replace(c, use_flash=False))
    dev = params["wte"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = {}
    for s in (1024, 4096):
        tokens = torch.randint(0, c.vocab_size, (1, s), generator=gen,
                               device=dev)
        before = flash_attention_fwd.launches
        logits = model.apply(params, tokens)
        torch.cuda.synchronize()
        launched = flash_attention_fwd.launches - before
        check(launched == c.n_layer,
              f"apply [1, {s}] launched the flash kernel {launched} times, "
              f"expected {c.n_layer}")
        check(logits.shape == (1, s, c.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"apply [1, {s}]: bad logits {tuple(logits.shape)}")
        ref = ref_model.apply(params, tokens)
        err = logits_errors(logits, ref)
        err_last = (logits[0, -1] - ref[0, -1]).abs().max().item()
        scale = ref.std().item()
        controls = {}
        if s == 1024:
            for name in LOGIT_CONTROLS:
                controls[name] = logits_errors(
                    control_forward(name, model, params, tokens), ref)
        del ref
        t0 = time.perf_counter()
        model.apply(params, tokens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[s] = dict(tokens_per_s=s / dt, seconds=dt, logits_err=err,
                      last_position_logits_err=err_last, controls=controls)
        print(f"[forward] apply [1, {s}]: {launched} flash launches, "
              f"logits vs mha_reference forward over all positions: max "
              f"abs err {err['max_abs']:.4f} (tol {TOL_LOGITS}; "
              f"{err['max_over_std']:.4f} of the logit std {scale:.3f}), "
              f"rms err {err['rms_over_std']:.4f} of the std (tol "
              f"{TOL_LOGITS_RMS}); max abs {err_last:.4f} at the last "
              f"position; prefill {s / dt:.1f} tokens/s ({dt * 1e3:.1f} ms)")
        for name, e in controls.items():
            print(f"[forward] control at [1, {s}], {name}: max abs err "
                  f"{e['max_abs']:.4f} ({e['max_over_std']:.4f} of the "
                  f"std), rms err {e['rms_over_std']:.4f} of the std")
        check(logits_agree(err), f"apply [1, {s}] flash vs reference logits")
        for name, e in controls.items():
            check(not logits_agree(e),
                  f"control '{name}' passes the logits check")
        del logits
        torch.cuda.empty_cache()
    return out


def phase_serving(server):
    import numpy as np
    import torch

    from ray_tpu_torch.ops import flash_attention_fwd

    engine = server.engine
    model, params = engine.model, engine.params
    prefills = {}            # prompt -> (logits on host, finish time, s)
    decode_log = []          # (seconds, active slots)
    run_prefill, run_decode = engine._prefill_fn, engine._decode_fn

    def recording_prefill(params, cache, tokens, length, block_row):
        t0 = time.perf_counter()
        logits, cache = run_prefill(params, cache, tokens, length, block_row)
        host = logits.float().cpu()          # waits for the device
        done = time.perf_counter()
        prefills[tuple(tokens[0, :length].tolist())] = (host, done,
                                                        done - t0)
        return logits, cache

    def timed_decode(*args):
        t0 = time.perf_counter()
        logits, cache = run_decode(*args)
        torch.cuda.synchronize()
        decode_log.append((time.perf_counter() - t0, int(args[5].sum())))
        return logits, cache

    engine._prefill_fn, engine._decode_fn = recording_prefill, timed_decode
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, model.config.vocab_size,
                            int(rng.integers(3, 61))).tolist()
               for _ in range(N_REQUESTS)]
    results, submitted, errors = [None] * N_REQUESTS, [0.0] * N_REQUESTS, []

    def client(i):
        submitted[i] = time.perf_counter()
        try:
            results[i] = server({"tokens": prompts[i],
                                 "max_tokens": MAX_TOKENS})
        except Exception as e:  # noqa: BLE001 — reported after join
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "serving clients hung")
    stats = server.stats()
    server.shutdown()
    check(not errors, f"serving clients failed: {errors}")
    for i, r in enumerate(results):
        check(r is not None and r["finish_reason"] == "length"
              and len(r["tokens"]) == MAX_TOKENS,
              f"request {i}: {r}")
    engine.pool.check_leaks()
    check(engine.pool.used_count == 0, "KV blocks still held after serving")

    errs = []
    for i, p in enumerate(prompts):
        check(tuple(p) in prefills, f"request {i} was never prefilled")
        paged = prefills[tuple(p)][0]
        padded = torch.zeros((1, 128), dtype=torch.long, device=engine.device)
        padded[0, :len(p)] = torch.tensor(p)
        before = flash_attention_fwd.launches
        dense = model.apply(params, padded)[0, len(p) - 1].float().cpu()
        check(flash_attention_fwd.launches - before == model.config.n_layer,
              "the dense comparison forward did not run the flash kernel")
        errs.append(logits_errors(paged, dense))
        check(int(paged.argmax()) == results[i]["tokens"][0],
              f"request {i}: first token is not the prefill argmax")
    ttfts = [prefills[tuple(p)][1] - submitted[i]
             for i, p in enumerate(prompts)]
    prefill_s = [prefills[tuple(p)][2] for p in prompts]
    dec_s = sum(s for s, _ in decode_log)
    dec_tokens = sum(n for _, n in decode_log)
    out = dict(ttft_p50_s=statistics.median(ttfts), ttft_max_s=max(ttfts),
               prefill_p50_s=statistics.median(prefill_s),
               prefill_max_s=max(prefill_s),
               decode_step_p50_s=statistics.median(s for s, _ in decode_log),
               decode_tokens_per_s=dec_tokens / dec_s,
               decode_steps=len(decode_log),
               tokens_per_s=N_REQUESTS * MAX_TOKENS / wall, wall_s=wall,
               kv_blocks_peak=stats["kv_blocks_peak"],
               prefill_logits_err=max(e["max_abs"] for e in errs),
               prefill_logits_rms_over_std=max(e["rms_over_std"]
                                               for e in errs))
    print(f"[serving] {N_REQUESTS} requests x {MAX_TOKENS} tokens, prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens: all "
          f"finished by length, no leaked blocks; TTFT p50 "
          f"{out['ttft_p50_s'] * 1e3:.1f} ms (max "
          f"{out['ttft_max_s'] * 1e3:.1f} ms), of which one prefill p50 "
          f"{out['prefill_p50_s'] * 1e3:.1f} ms (max "
          f"{out['prefill_max_s'] * 1e3:.1f} ms); decode {dec_tokens} tokens "
          f"in {len(decode_log)} steps, step p50 "
          f"{out['decode_step_p50_s'] * 1e3:.1f} ms, "
          f"{out['decode_tokens_per_s']:.1f} tokens/s; end to end "
          f"{out['tokens_per_s']:.1f} tokens/s over "
          f"{wall:.2f} s; KV blocks peak {stats['kv_blocks_peak']} of "
          f"{stats['kv_blocks_total']}")
    print(f"[serving] paged prefill logits vs dense flash forward (prompt "
          f"right-padded to 128): max abs err "
          f"{out['prefill_logits_err']:.4f} (tol {TOL_LOGITS}), rms err "
          f"{out['prefill_logits_rms_over_std']:.4f} of the std (tol "
          f"{TOL_LOGITS_RMS}); per request max abs "
          f"{[round(e['max_abs'], 4) for e in errs]}")
    check(all(map(logits_agree, errs)), "paged prefill disagrees with the "
                                        "dense flash forward")
    return out


def head_grad_errors(got, ref):
    """(share of entries not equal to the f32 product `ref` rounded once to
    bf16, largest difference in bf16 ulps of |ref| floored at 1/1024 of
    the largest |ref|) of a bf16-valued gradient."""
    import torch

    diff = (got.float() - ref.to(torch.bfloat16).float()).abs()
    mag = torch.maximum(ref.abs(), ref.abs().max() / 1024)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (diff > 0).float().mean().item(), (diff / ulp).max().item()


def head_agrees(logit_err, dx, dw):
    return (logit_err <= TOL_HEAD_LOGITS
            and all(share <= TOL_HEAD_SHARE and ulps <= TOL_HEAD_ULPS
                    for share, ulps in (dx, dw)))


def phase_lm_head():
    """GPT-2 small's LM head at one chunk of the training step ([4096, 768]
    bf16 activations by the [50304, 768] tied embedding, cast to bf16):
    its f32 logits against the f32 product of the same bf16 operands, and
    its dx and dw for the chunk's cross-entropy cotangent against the f32
    products of that f32 cotangent (JAX's transpose), computed once in f32
    and untimed; then the planted control, the route that rounds the
    logits and the cotangent to bf16, and the time of both routes'
    forward and backward."""
    import torch

    from ray_tpu_torch.models import GPT, GPTConfig

    c = GPTConfig.small(use_flash=True)
    model = GPT(c)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 300)
    n, v, d = HEAD_CHUNK_ROWS, c.padded_vocab, c.d_model
    x = torch.nn.functional.layer_norm(
        torch.randn(n, d, generator=gen, device="cuda"), (d,)).to(bf16)
    w = torch.randn(v, d, generator=gen, device="cuda") * 0.02
    targets = torch.randint(0, c.vocab_size, (n,), generator=gen,
                            device="cuda")
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    logits = model._lm_head(wr, xr)
    g = torch.softmax(logits.detach(), dim=-1)   # d(sum of the NLL)/dlogits
    g[torch.arange(n, device="cuda"), targets] -= 1.0
    logits.backward(g)
    xf, wf = x.float(), w.to(bf16).float()
    ref = xf @ wf.T
    top = ref.abs().max()
    logit_err = ((logits.detach() - ref).abs().max() / top).item()
    del ref
    ref_dx, ref_dw = g @ wf, g.T @ xf
    dx = head_grad_errors(xr.grad, ref_dx)
    dw = head_grad_errors(wr.grad, ref_dw)
    wb = w.to(bf16)
    ctl_err = (((x @ wb.T).float() - xf @ wf.T).abs().max() / top).item()
    gb = g.to(bf16)
    ctl_dx = head_grad_errors(gb @ wb, ref_dx)
    ctl_dw = head_grad_errors(gb.T @ x, ref_dw)
    del ref_dx, ref_dw, logits

    def head_step():
        xr.grad = wr.grad = None
        model._lm_head(wr, xr).backward(g)

    def control_step():
        xr.grad = wr.grad = None
        (xr @ wr.to(bf16).T).float().backward(g)

    ms = cuda_ms(head_step, reps=10)
    ctl_ms = cuda_ms(control_step, reps=10)
    print(f"[lm_head] [{n}, {d}] x [{v}, {d}] bf16: logits err "
          f"{logit_err:.3e} of max (tol {TOL_HEAD_LOGITS}); dx share off "
          f"{dx[0]:.4f}, max {dx[1]:.2f} ulp; dw share off {dw[0]:.4f}, max "
          f"{dw[1]:.2f} ulp (tol {TOL_HEAD_SHARE}, {TOL_HEAD_ULPS} ulp); "
          f"control (bf16 logits and cotangent): logits {ctl_err:.3e}, dx "
          f"{ctl_dx[0]:.4f} / {ctl_dx[1]:.2f} ulp, dw {ctl_dw[0]:.4f} / "
          f"{ctl_dw[1]:.2f} ulp; forward + backward {ms:.4f} ms, control "
          f"{ctl_ms:.4f} ms")
    check(head_agrees(logit_err, dx, dw),
          "the LM head disagrees with the f32 products")
    check(not head_agrees(ctl_err, ctl_dx, ctl_dw),
          "the bf16-rounding control passes the LM head check")
    out = dict(shape=[n, d, v], logits_err=logit_err, dx=dx, dw=dw,
               control=dict(logits_err=ctl_err, dx=ctl_dx, dw=ctl_dw),
               ms=ms, control_ms=ctl_ms)
    del x, w, xr, wr, g, gb, wb, xf, wf
    torch.cuda.empty_cache()
    return out


def ln_matmul_bwd_variant(x, g, b, w, dout, eps, fault):
    """Control: ln_matmul_bwd with one term of the layernorm backward
    left out of dx: the mean of dxhat over the row ("mean"), or xhat times
    the mean of dxhat * xhat ("variance")."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    rstd = (xc.square().mean(-1, keepdim=True) + eps).rsqrt()
    xhat = xc * rstd
    h = (xhat * g.float() + b.float()).to(w.dtype)
    d = dout.to(w.dtype)
    dh = (d @ w.T).float()
    dxhat = dh * g.float()
    mean_term = 0.0 if fault == "mean" else dxhat.mean(-1, keepdim=True)
    var_term = 0.0 if fault == "variance" else \
        xhat * (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - mean_term - var_term)
    return (dx.to(x.dtype), (dh * xhat).sum(0).to(g.dtype),
            dh.sum(0).to(b.dtype), (h.T @ d).to(w.dtype),
            dout.float().sum(0).to(x.dtype))


def grad_check(label, what, model, ref_model, params, counters, faults,
               tol, shown=()):
    """Every parameter's gradient of loss_chunked at [GRAD_BATCH, 1024],
    ``model`` against ``ref_model`` on the same params, and the same check
    on planted backward faults, each {name: (module, attribute,
    replacement)} swapped in for one gradient; each must fail the check,
    except those named in ``shown``, which are only printed. ``counters``
    are the kernels the model must launch for each layer ({name:
    (wrapper, launches per layer)})."""
    import torch

    c = model.config
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    tokens = torch.randint(0, c.vocab_size, (GRAD_BATCH, TRAIN_SEQ),
                           generator=gen, device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    names = list(params)

    def grads(m):
        loss = m.loss_chunked(params, tokens, targets, num_chunks=max(
            1, GRAD_BATCH * TRAIN_SEQ // HEAD_CHUNK_ROWS))
        return loss.item(), torch.autograd.grad(
            loss, [params[n] for n in names])

    ref_loss, ref = grads(ref_model)

    def rel_errors(g):
        """||g - g_ref|| / ||g_ref|| per parameter; w_qkv and b_qkv per
        third (q, k, v), since a fault in ds reaches only the q and k
        thirds."""
        out = {}
        for n, a, b in zip(names, g, ref):
            parts = zip("qkv", a.chunk(3, -1), b.chunk(3, -1)) \
                if n in ("w_qkv", "b_qkv") else [("", a, b)]
            for part, x, y in parts:
                key = f"{n}[{part}]" if part else n
                if key != ZERO_GRADIENT:
                    out[key] = ((x - y).norm() / y.norm()).item()
        return out

    before = {n: f.launches for n, (f, _) in counters.items()}
    loss, g = grads(model)
    launched = {n: f.launches - before[n] for n, (f, _) in counters.items()}
    expected = {n: per_layer * c.n_layer
                for n, (_, per_layer) in counters.items()}
    check(launched == expected, f"gradient check launched {launched}, "
                                f"expected {expected}")
    sound = rel_errors(g)
    del g
    controls = {}
    for fault, (module, attr, replacement) in faults.items():
        original = getattr(module, attr)
        setattr(module, attr, replacement)
        try:
            controls[fault] = rel_errors(grads(model)[1])
        finally:
            setattr(module, attr, original)

    def worst(errs):   # NaN counts as the worst
        name = max(errs, key=lambda n: math.inf if math.isnan(errs[n])
                   else errs[n])
        return name, errs[name]

    def agrees(errs):
        return all(e <= tol for e in errs.values())

    print(f"[{label}] gradient check [{GRAD_BATCH}, {TRAIN_SEQ}], {what}: "
          f"loss {loss:.6f} vs {ref_loss:.6f}; "
          f"worst ||g - g_ref|| / ||g_ref|| {worst(sound)[1]:.4e} "
          f"({worst(sound)[0]}; tol {tol}); per parameter "
          f"{json.dumps({n: round(e, 6) for n, e in sound.items()})}")
    for fault, errs in controls.items():
        print(f"[{label}] control{' (shown only)' if fault in shown else ''}"
              f", backward with {fault}: worst "
              f"{worst(errs)[1]:.4e} ({worst(errs)[0]}); per parameter "
              f"{json.dumps({n: float(f'{e:.4g}') for n, e in errs.items()})}")
    check(agrees(sound), f"{label}: model gradients disagree with the "
                         "reference model's")
    for fault, errs in controls.items():
        check(fault in shown or not agrees(errs),
              f"control '{fault}' passes the gradient check")
    return dict(loss=loss, ref_loss=ref_loss, rel_err=sound,
                controls={f: worst(e)[1] for f, e in controls.items()})


def phase_grad_check(model, params):
    """The flash model against the same model through mha_reference, with
    three planted faults swapped in for flash_attention_bwd."""
    from ray_tpu_torch.models import GPT
    from ray_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd

    fa_mod = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    faults = {fault: (fa_mod, "flash_attention_bwd",
                      lambda q, k, v, out, lse, do, causal, sm_scale,
                      fault=fault: bwd_variant(q, k, v, out, lse, do, causal,
                                               sm_scale, fault))
              for fault in TRAIN_FAULTS}
    return grad_check(
        "training", "flash vs mha_reference model", model,
        GPT(dataclasses.replace(model.config, use_flash=False)), params,
        {"flash_fwd": (flash_attention_fwd, 1),
         "flash_bwd": (flash_attention_bwd, 1)}, faults, TOL_TRAIN_GRAD)


def phase_fused_grad_check(model, params):
    """The fused model against the unfused model (both flash), with
    planted faults in the fused backward: matmul_residual's dres dropped,
    and ln_matmul's layernorm backward without its variance term (both
    must fail the check) or without its mean term (shown only)."""
    import torch

    from ray_tpu_torch.models import GPT
    from ray_tpu_torch.ops import ln_matmul_fwd, matmul_residual_fwd

    fused_mod = importlib.import_module("ray_tpu_torch.ops.fused")
    mr_bwd = fused_mod.matmul_residual_bwd
    faults = dict(zip(FUSED_FAULTS + FUSED_SHOWN, [
        (fused_mod, "matmul_residual_bwd",
         lambda a, w, dout: (*mr_bwd(a, w, dout)[:3],
                             torch.zeros_like(dout))),
        (fused_mod, "ln_matmul_bwd",
         lambda *args: ln_matmul_bwd_variant(*args, "variance")),
        (fused_mod, "ln_matmul_bwd",
         lambda *args: ln_matmul_bwd_variant(*args, "mean"))]))
    return grad_check(
        "training fused", "fused vs unfused model", model,
        GPT(dataclasses.replace(model.config, fused_entry_exit=False)),
        params, {"ln_matmul": (ln_matmul_fwd, 2),
                 "mm_res": (matmul_residual_fwd, 2)}, faults,
        TOL_FUSED_GRAD, shown=FUSED_SHOWN)


def profile_step(step, label):
    """One training step under torch.profiler: device time by kernel
    class and the device's idle share of the step (the profiler's own
    host cost is inside the step's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
    by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    by_class["other (elementwise, reductions, copies)"] = 0.0
    for key, ms in kernels.items():
        low = key.lower()
        name = next((n for n, frags in KERNEL_CLASSES
                     if any(f in low for f in frags)),
                    "other (elementwise, reductions, copies)")
        by_class[name] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"[{label}] profiled step: {wall_ms:.2f} ms wall, device busy "
          f"{busy:.2f} ms (idle share {1 - busy / wall_ms:.4f}), "
          f"{len(kernels)} distinct kernels; device ms by class "
          f"{json.dumps({n: round(t, 3) for n, t in by_class.items()})}")
    for key, ms in top:
        print(f"[{label}]   {ms:9.3f} ms  {key[:110]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms, device_ms_by_class=by_class,
                top_kernels_ms=dict(top))


def phase_training(kernel_ms, fused=False):
    """GPT-2 small, the twin of bench.py main(): train steps at full
    width, launches per step, loss, throughput, MFU, peak memory. With
    ``fused``, through GPTConfig(fused_entry_exit=True). ``kernel_ms``:
    the kernel phase's ms of each kernel's calls in one layer's forward
    and backward."""
    import torch

    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_residual_fwd)

    label = "training fused" if fused else "training"
    c = GPTConfig.small(use_flash=True, fused_entry_exit=fused)
    check((c.n_layer, c.d_model, c.n_head, c.head_dim, c.padded_vocab,
           c.dropout) == (12, 768, 12, 64, 50304, 0.0),
          f"not GPT-2 small width: {c}")
    model = GPT(c)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = {n: p.requires_grad_() for n, p in model.init(gen).items()}
    opt = torch.optim.AdamW(params.values(), lr=TRAIN_LR,
                            weight_decay=TRAIN_WD)
    tokens = torch.randint(0, c.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    num_chunks = TRAIN_BATCH * TRAIN_SEQ // HEAD_CHUNK_ROWS
    # every kernel's wrapper, and its launches a step on this path
    counters = {"flash_fwd": flash_attention_fwd,
                "flash_bwd": flash_attention_bwd, "ln_matmul": ln_matmul_fwd,
                "mm_res": matmul_residual_fwd}
    per_layer = {"flash_fwd": 1, "flash_bwd": 1,
                 "ln_matmul": 2 if fused else 0, "mm_res": 2 if fused else 0}
    expected = {n: k * c.n_layer for n, k in per_layer.items()}
    losses, per_step = [], []

    def step():
        before = {n: f.launches for n, f in counters.items()}
        opt.zero_grad(set_to_none=True)
        loss = model.loss_chunked(params, tokens, targets,
                                  num_chunks=num_chunks)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        per_step.append({n: f.launches - before[n]
                         for n, f in counters.items()})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():            # this training path starts here
        f.launches = 0
    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()
                if per_layer[n]}
    unexpected = {n: f.launches for n, f in counters.items()
                  if not per_layer[n] and f.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    loss_values = [x.item() for x in losses]
    prof = profile_step(step, label)   # a 14th step, after the counted ones
    sec_per_step = dt / TRAIN_STEPS
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / sec_per_step
    mfu = model.flops_per_token(TRAIN_SEQ) * tokens_per_s / H100_BF16_PEAK
    split = {n: c.n_layer * kernel_ms[n] for n in launches}
    split["rest"] = sec_per_step * 1e3 - sum(split.values())
    out = {
        "gpt2_small_train_tokens_per_sec_per_chip": tokens_per_s,
        "mfu": mfu, "sec_per_step": sec_per_step,
        "fused_entry_exit": fused,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps_timed": TRAIN_STEPS,
        "params": model.num_params(), "loss": loss_values[-1],
        "losses": loss_values,
        "peak_memory_gib": peak_gib, "launches": launches,
        "step_split_ms": split, "profile": prof,
    }
    print(f"[{label}] GPT-2 small ({model.num_params()} params) B="
          f"{TRAIN_BATCH} S={TRAIN_SEQ}: {tokens_per_s:.1f} tokens/s, "
          f"{sec_per_step * 1e3:.2f} ms/step, MFU {mfu:.4f} "
          f"({model.flops_per_token(TRAIN_SEQ)} FLOP/token over "
          f"{H100_BF16_PEAK:.0f} FLOP/s); losses "
          f"{[round(x, 4) for x in loss_values]}; peak {peak_gib:.2f} GiB "
          f"allocated; launches per step "
          f"{[dict(t) for t in {tuple(d.items()) for d in per_step}]}; step "
          f"split (launches x kernel ms): "
          + ", ".join(f"{n} {ms:.2f} ms" for n, ms in split.items()))
    check(all(n == expected for n in per_step),
          f"{label}: launches per step {per_step}, expected {expected}")
    check(not unexpected, f"{label} launched {unexpected}")
    check(all(math.isfinite(x) for x in loss_values),
          f"non-finite loss {loss_values}")
    loss0 = math.log(c.padded_vocab) + c.d_model * 0.02 ** 2 / 2
    check(abs(loss_values[0] - loss0) <= TOL_LOSS0,
          f"step-0 loss {loss_values[0]} is not ln({c.padded_vocab}) + "
          f"{c.d_model} * 0.02^2 / 2 = {loss0:.4f} (tol {TOL_LOSS0})")
    check(loss_values[-1] < loss_values[0],
          f"loss did not fall: {loss_values}")
    del opt
    torch.cuda.empty_cache()
    out["grad_check"] = (phase_fused_grad_check if fused
                         else phase_grad_check)(model, params)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "ray_tpu_torch")):
        print(f"chip_smoke: the ray_tpu_torch package is not beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_residual_fwd)
    from ray_tpu_torch.serve.llm import LLMServer

    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}")
    server = None
    try:
        with torch.no_grad():
            card = phase_build()
            fwd_rows = phase_kernels_fwd()
        bwd_rows = phase_kernels_bwd()
        lm_head = phase_lm_head()
        with torch.no_grad():
            fused_rows, fused_bwd = phase_kernels_fused()
            t0 = time.perf_counter()
            server = LLMServer("llama2-7b", engine_config=ENGINE_CONFIG,
                               seed=SEED)
            torch.cuda.synchronize()
            print(f"[serving] LLMServer('llama2-7b') built in "
                  f"{time.perf_counter() - t0:.1f} s, "
                  f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB "
                  f"allocated")
            wrappers = (flash_attention_fwd, flash_attention_bwd,
                        ln_matmul_fwd, matmul_residual_fwd)
            for f in wrappers:                  # the serving path starts here
                f.launches = 0
            forward = phase_forward(server)
            serving = phase_serving(server)
            serving_launches = flash_attention_fwd.launches
            check(serving_launches > 0,
                  "the serving path never launched flash_fwd")
            check(not any(f.launches for f in wrappers[1:]),
                  "the serving path launched a training kernel")
        server = None
        serving_peak_gib = torch.cuda.max_memory_allocated() / 2**30
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[training] Llama-2-7B released: "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        main_fwd = next(r for r in fwd_rows if r["label"] == FWD_MAIN)
        main_bwd = next(r for r in bwd_rows if r["label"] == GPT_CASE)
        gpt_fwd = next(r for r in fwd_rows if r["label"] == GPT_CASE)
        kernel_ms = {"flash_fwd": gpt_fwd["ms"], "flash_bwd": main_bwd["ms"]}
        training = phase_training(kernel_ms)
        gc.collect()
        torch.cuda.empty_cache()
        fused_ms = {r["label"]: r["ms"] for r in fused_rows if "ms" in r}
        training_fused = phase_training(
            {**kernel_ms, "ln_matmul": fused_ms["QKV"] + fused_ms["FC"],
             "mm_res": fused_ms["proj"] + fused_ms["MLP out"]}, fused=True)
        for path in (training, training_fused):
            for name, n in path["launches"].items():
                check(n > 0, f"a training path never launched {name}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if server is not None:
            server.shutdown()
    print(f"[memory] peak allocated: {serving_peak_gib:.1f} GiB up to the "
          f"end of serving, {training['peak_memory_gib']:.1f} GiB in the "
          f"training steps, {training_fused['peak_memory_gib']:.1f} GiB in "
          f"the fused training steps")
    fwd_launches = dict(serving=serving_launches,
                        training=training["launches"]["flash_fwd"],
                        training_fused=training_fused["launches"]["flash_fwd"])
    bwd_launches = dict(training=training["launches"]["flash_bwd"],
                        training_fused=training_fused["launches"]["flash_bwd"])

    def bf16_max_err(rows):
        return max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16")

    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        # one CUDA kernel computes the function of both forward kernels:
        # the tiled one (S > 1024) and the single-block one (S <= 1024)
        "replaces": ["ray_tpu/ops/flash_attention.py:59",
                     "ray_tpu/ops/flash_attention.py:110"],
        "launches": sum(fwd_launches.values()),
        "launches_by_path": fwd_launches,
        "max_abs_err": bf16_max_err(fwd_rows),
        "ms": main_fwd["ms"], "plain_ms": main_fwd["plain_ms"],
        "bound_ms": main_fwd["bound_ms"], "bound_by": main_fwd["bound_by"],
        "library_ms": main_fwd["library_ms"],
        "shape": "[1, 4096, 32, 128] bf16 causal",
        "by_shape": fwd_rows,
    }, {
        "name": "flash_bwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_bwd.cu",
        # two CUDA kernels (dk/dv, then dq), one launch of the wrapper,
        # compute the function of the three backward kernels
        "replaces": ["ray_tpu/ops/flash_attention.py:229",
                     "ray_tpu/ops/flash_attention.py:286",
                     "ray_tpu/ops/flash_attention.py:330"],
        "launches": sum(bwd_launches.values()),
        "launches_by_path": bwd_launches,
        "max_abs_err": bf16_max_err(bwd_rows),
        "ms": main_bwd["ms"], "plain_ms": main_bwd["plain_ms"],
        "bound_ms": main_bwd["bound_ms"], "bound_by": main_bwd["bound_by"],
        "library_ms": main_bwd["library_ms"],
        "shape": "[40, 1024, 12, 64] bf16 causal",
        "by_shape": bwd_rows,
    }]
    for name, replaces in (("ln_matmul", "ray_tpu/ops/fused.py:34"),
                           ("mm_res", "ray_tpu/ops/fused.py:117")):
        rows = [r for r in fused_rows if r["kernel"] == name]
        main_row = next(r for r in rows if r["label"] == FUSED_MAIN[name])
        n, k, f = main_row["shape"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": [replaces],
            "launches": training_fused["launches"][name],
            "launches_by_path": {
                "training_fused": training_fused["launches"][name]},
            "max_abs_err": bf16_max_err(rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            # no single PyTorch call computes either function: the cuBLAS
            # composition addmm(wb, layer_norm(x), w) / addmm(res + b, a, w)
            "library_ms": main_row["library_ms"],
            "library": "cuBLAS composition, not one call",
            "shape": f"[{n}, {k}] x [{k}, {f}] bf16",
            "by_shape": rows,
        })
    summary = {"forward": forward, "serving": serving, "training": training,
               "training_fused": training_fused,
               "fused_backward_products": fused_bwd, "lm_head": lm_head}
    print(f"[summary] {json.dumps(summary)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
