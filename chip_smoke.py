#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build    — compile ray_tpu_torch/csrc/flash_fwd.cu, flash_bwd.cu,
              ln_matmul.cu and mm_res.cu with nvcc for sm_90a, one nvcc
              each, started together; print ptxas's registers and spills
              (on one line for the Hopper GEMM of ln_matmul and mm_res),
              and the card's name and power limit.
2. kernels  — each kernel against its plain PyTorch version on the same
              inputs at the main paths' shapes, with the tolerances below,
              and a planted lower-precision control that must fail them;
              kernel, plain and library-call times with CUDA events, and the
              card's bound for the same work; then, untimed, at the shapes
              and types that reach the kernels' other instances. The fused
              block entry and exit (ln_matmul, mm_res) at GPT-2 small's four
              training shapes, timed beside the cuBLAS composition of the
              same function, each case run twice and bitwise equal, with
              two planted controls at each training shape (a float8
              operand; each row paired with the row 8 below it) that must
              fail; and matmul_residual's bf16 backward products against
              the f32 products they stand for. The flash backward
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
7. gpt serving — build_model("gpt2-small") (full width, f32 params, bf16
              compute, random weights from seed 0) served by LLMEngine
              with the prefix cache off and on, at the traffic harness's
              engine shape, on the same 8 requests of 32 new tokens (two
              48-token system prompts opening three requests each, a
              request that shares 44 tokens of one and diverges mid-block,
              and a repeat of an earlier prompt): one untimed run each
              way, then GPT_SERVING_PAIRS timed off/on pairs in
              alternating order. Every request finishes by length; no KV
              block leaks; the radix tree's invariants hold; the cache
              hits and copies a block on write; each first-token logits
              vector (full prefill or suffix extend) matches the dense
              flash forward of its prompt; the cache-on streams equal the
              cache-off ones up to a near-tie; two planted controls (the
              extend embedding positions 0..S-1, the block copy skipped)
              must fail the logits check. Prints TTFT, the decode step,
              tokens/s, the hit rate, and the host/device split of one
              decode step of GPT-2 small and of Llama-2-7B (the latter
              after phase 4).

8. moe      — MoEConfig.small (Mixtral-style at GPT-2 small width: 12
              layers, d_model 768, 12 heads of 64, 8 experts of d_ff
              3072, top-2, capacity factor 1.25, vocab 50304; bf16
              compute, f32 params, random weights from seed 0) trained
              through MoE.loss with torch.optim.AdamW at B=8, S=1024: 3
              warm-up and 10 timed steps, each launching flash_fwd and
              flash_bwd once per layer, plus one profiled step; the
              step-0 loss is GPT-2's cross entropy plus the measured aux
              loss, and falls; the share of routes dropped. Then the same
              model in f32 at B=2: every gradient and every layer's routes
              of the flash model against the mha_reference model, and
              four planted controls (capacity counted k-major, kept
              weights not renormalised, attention without its causal mask,
              logits rounded to bf16) that must fail.
9. vit      — ViT-B/16 (10 classes, bf16, remat) on 64 images of 224 x
              224: four AdamW steps (no kernel launch: 197 tokens take
              mha_reference), the loss falls from ln(10); bf16 logits
              against the f32 forward, with a planted control (patch
              vectors in (c, py, px) order) that must fail.
10. resnet  — ResNet-18/CIFAR at B=128 trained by SGD with momentum (the
              loss falls, every batch-norm buffer moves); the reference's
              resnet50_imagenet layout at 224, B=16: one step, its bf16
              forward against its f32 forward, and its f32 forward on the
              card against the CPU's, which two planted controls
              (symmetric padding, the unbiased variance) must fail.
11. head dims — flash_fwd and flash_bwd at head dims 16 and 48 (zero-padded
              to the 32 and 64 instances), causal and not, against the
              plain versions; the padded call with sm_scale from the
              padded D must fail; MoEConfig.tiny (head dim 16) in f32
              through the padded kernel against its mha_reference model.

12. disagg  — ray_tpu_torch.init(num_cpus=4), then
              DisaggLLM("gpt2-small", block_size=16), started on a thread
              while this process runs the reference and the control
              below: a PrefillStage and a DecodeStage actor, each in its
              own worker process on the card (their pids among
              nvidia-smi's compute apps where nvidia-smi sees this pid
              namespace; their CUDA memory in any case), joined by a two-stage compiled graph whose
              shared-memory channel carries the bf16 KV blocks. 8 prompts
              of 3-112 tokens from SEED and one of exactly 112 (7 blocks,
              the largest KV that fits the 4 MiB channel), 32 greedy
              tokens each, one at a time: each stream equals the
              in-process LLMEngine's on the same weights, every request
              finishes by length, and the decode stage holds no block
              afterwards. A prompt of 113-128 tokens (8 blocks) raises
              ChannelFullError. A planted control (the in-process
              engine's add_prefilled, fed a PrefillStage's blocks in
              reversed order; the stage shares the engine's model) must
              fail the stream check. Then DisaggLLM.compile builds the
              graph again on the same two stages with codec "int8" and
              "e4m3", for the first 3 prompts: the first tokens equal
              the raw run's (they come from the prefill, before the
              wire) and the share of equal decode tokens is printed.
              Prints each request's generate() wall time and the
              envelope bytes the prefill stage wrote for it (its
              ray_tpu_cgraph_channel_bytes_total, per codec) beside the
              in-process engine's per-request wall time.

Eight main paths are counted: serving (phases 3-4), training (phase 5's
steps), fused training (phase 6's steps), MoE training (phase 8's
steps), ViT and ResNet training (phases 9-10, which launch no
hand-written kernel), GPT serving (phase 7's timed engine runs, which
launch none either; it runs after phase 11) and disagg (phase 12's raw
run, none either: the driver's counts, zeroed just before it, and each
stage's, which start at zero with its process). Every launch count is
zeroed just before each and read just after it; the kernel comparisons
of phases 2 and 11, the gradient checks and phase 7's dense reference
forward do not count.
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
#     f32 1e-5). Two controls at each training shape must fail one of
#     the checks: the normalised row (ln_matmul) or a (mm_res) rounded to
#     float8_e4m3 before the product (a lower-precision product); and
#     each row paired with the row 8 below it, the two rows a thread of
#     the bf16 kernels holds in its register fragments: the layernorm of
#     row r taken with row r + 8's mean and rstd (ln_matmul), or row r + 8's
#     residual added to row r (mm_res), rows wrapping at the end.
TOL_FUSED = {"bfloat16": 1e-2, "float32": 1e-5}
TOL_FUSED_RMS = {"bfloat16": 3e-3, "float32": 1e-5}
FUSED_CONTROLS = ("float8 operand", "row r + 8's statistics or residual")
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
MOE_CASE = "MoE training"      # MoEConfig.small at B=8, S=1024
FWD_CASES = [
    ("Llama S=1024", (1, 1024, 32, 128), "bfloat16", True),
    ("Llama S=4096", (1, 4096, 32, 128), "bfloat16", True),
    (GPT_CASE, (40, 1024, 12, 64), "bfloat16", True),
    ("non-causal", (2, 256, 12, 64), "bfloat16", False),
    ("f32", (2, 256, 4, 32), "float32", True),
    (MOE_CASE, (8, 1024, 12, 64), "bfloat16", True),
]
FWD_MAIN = "Llama S=4096"
BWD_CASES = [
    (GPT_CASE, (40, 1024, 12, 64), "bfloat16", True),
    ("S=4096", (2, 4096, 12, 64), "bfloat16", True),
    ("non-causal", (2, 256, 12, 64), "bfloat16", False),
    ("f32", (2, 256, 4, 32), "float32", True),
    (MOE_CASE, (8, 1024, 12, 64), "bfloat16", True),
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
# Mixtral-style MoE training at GPT-2 small width (MoEConfig.small(): 12
# layers, d_model 768, 12 heads of 64, d_ff 3072, 8 experts, top-2,
# capacity factor 1.25, vocab 50304; bf16 compute, f32 params): batch,
# length, warm-up and timed steps (GPT-2's AdamW); the f32 gradient
# check's batch.
MOE_BATCH, MOE_SEQ = 8, 1024
MOE_WARMUP, MOE_STEPS = 3, 10
MOE_GRAD_BATCH = 2
#   Step-0 loss: the cross entropy as GPT-2 small's (ln(50304) + 768 *
#   0.02^2 / 2, within TOL_LOSS0) plus the aux loss measured in step 0.
#   At uniform routing each layer's aux loss is coeff * E * sum_e (K / E)
#   (1 / E) = coeff * K = 0.02, 0.24 over 12 layers; routing that is not
#   uniform raises it. The measured one must lie within a factor
#   TOL_MOE_AUX0 of 0.24.
TOL_MOE_AUX0 = 1.5
#   MoE gradients, full width in f32 at B=2, S=1024: the flash model (the
#   f32 kernel instances) against the use_flash=False model on the same
#   params. Each parameter's ||g - g_ref|| / ||g_ref|| at most
#   TOL_MOE_GRAD (b_qkv's key third left out, as above), and every
#   layer's routes (top-k experts and the kept set) equal: in f32 the two
#   attention paths differ by summation order only, far below any
#   router margin. Four planted controls must each fail (a route
#   mismatch or an error above the limit): capacity counted k-major (at
#   capacity factor MOE_DROP_CF, where routes drop, against the
#   reference at the same factor), kept weights not renormalised,
#   attention without its causal mask, logits rounded to bf16.
#   On the H100: sound 6.3e-7 (w_up), routes 100%; the controls 1.15,
#   1.75, 0.995 (routes differing) and, for the bf16 logits, 3.4e-5 with
#   every route equal: the limit sits between.
TOL_MOE_GRAD = 5e-6
MOE_DROP_CF = 0.5
MOE_CONTROLS = ("capacity counted k-major", "kept weights not renormalised",
                "attention without its causal mask", "logits rounded to bf16")
# ViT-B/16 (ViTConfig.b16(num_classes=10): 224 x 224 images, 196 patches
# + CLS = 197 tokens, bf16, remat): batch and AdamW steps on one batch.
# 197 is not a multiple of 8, so no step launches flash. Then the bf16
# logits against the f32 forward of the same params: the largest error
# over the largest |ref| at most TOL_VIT_LOGITS; a planted control
# (patch vectors in (c, py, px) order instead of (py, px, c)) must fail.
# On the H100 (NVIDIA H100 80GB HBM3, 700 W): 4.6e-3 sound, 0.47 for the
# control.
VIT_BATCH, VIT_STEPS = 64, 4
TOL_VIT_LOGITS = 0.05
VIT_CONTROL = "patch vectors in (c, py, px) order"
# ResNet-18/CIFAR as examples/resnet_cifar_train.py trains it (SGD, lr
# 0.1, momentum 0.9), at B=128 on 32 x 32 images, bf16; then the
# reference's resnet50_imagenet layout (basic blocks, stages 3, 4, 6, 3)
# at B=16 on 224 x 224 images: one step, and its train-mode forward
#   - in bf16 against the f32 forward on the card: the largest error
#     over the largest |ref| at most TOL_RESNET_BF16 (5.1e-3 on the
#     H100);
#   - in f32 on the card against the f32 forward on the CPU (cuDNN
#     against torch's CPU kernels): at most TOL_RESNET_F32 (1.5e-6 on
#     the H100). Two planted controls in the card's f32 forward must
#     fail it: symmetric padding (PyTorch's padding=k//2 in place of
#     XLA's SAME; 0.16) and the unbiased variance in batch norm (6.4e-4:
#     the last stage normalises over 16 * 7 * 7 = 784 values).
#   On one random batch the loss first rises (lr 0.1 from scratch: 2.30
#   to 8.66 on the H100) and falls below its start after 12 steps there:
#   20 steps.
RESNET_BATCH, RESNET_STEPS, RESNET_LR, RESNET_MOMENTUM = 128, 20, 0.1, 0.9
RESNET50_BATCH = 16
TOL_RESNET_BF16 = 0.05
TOL_RESNET_F32 = 3e-5
RESNET_CONTROLS = ("symmetric padding", "unbiased variance")
# Head dims that are not kernel instances, zero-padded to the next one:
# [B, S, H, D] bf16, each causal and not, forward and backward against the
# plain versions at the unpadded D (TOL_OUT, TOL_GRAD); the control, the
# padded call with sm_scale from the padded D, must fail.
HEAD_DIM_CASES = [(2, 256, 4, 16), (2, 256, 4, 48)]
# Device kernels of a profiled step, by class: (class, name fragments).
KERNEL_CLASSES = (("flash_fwd", ("flash_fwd_",)),
                  ("flash_bwd", ("flash_bwd_",)),
                  ("ln_matmul", ("ln_stats_kernel", "ln_matmul_f32_kernel",
                                 "gemm_kernel<128, true>",
                                 "gemm_kernel<256, true>")),
                  ("mm_res", ("mm_res_f32_kernel", "gemm_kernel<128, false>",
                              "gemm_kernel<256, false>")),
                  ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
                  ("optimizer", ("multi_tensor_apply",)))
ENGINE_CONFIG = dict(max_batch=8, num_blocks=256, block_size=16,
                     max_blocks_per_seq=16, prefill_buckets=(16, 32, 64))
N_REQUESTS, MAX_TOKENS = 8, 32
# GPT-2 small serving: the engine shape of scripts/traffic_harness.py:51-53
# and its traffic, cut to 8 requests: two system prompts of 48 tokens (6
# blocks of 8), each opening 3 requests with 8-24 user tokens of their own,
# one request sharing 44 tokens of a system prompt (a mid-block divergence,
# so a copy on write), one repeating an earlier prompt in full.
GPT_ENGINE_CONFIG = dict(block_size=8, num_blocks=256, max_batch=8,
                         max_blocks_per_seq=16,
                         prefill_buckets=(16, 32, 64, 128),
                         max_prefill_tokens_per_step=128)
GPT_SYSTEM_LEN, GPT_COW_SHARED, GPT_USER_LEN = 48, 44, (8, 24)
#   GPT-2 small first-token logits (std about 0.55 at this random init:
#   d_model * 0.02^2 = 0.31 is their variance), the engine's paged prefill
#   or suffix extend against the dense flash forward of the whole prompt
#   (padded to 128): max abs TOL_GPT_LOGITS, rms over the reference's std
#   TOL_GPT_LOGITS_RMS. The paths round to bf16 at other places (the
#   kernel's bf16 probabilities against mha_reference's f32 softmax, the
#   extend's products over fewer rows), over 12 layers: on the H100 the
#   sound run's worst request was 0.0298 / 0.0119. The two planted
#   controls must fail the check: the skipped block copy gave 0.2154 /
#   0.0931 at its worst request, the extend at positions 0..S-1 1.9185 /
#   0.7913; the limits sit between. The same max abs is the near-tie limit
#   of the stream comparison: a cache-on token may differ from the
#   cache-off one only at a step whose cache-off top-two margin is under
#   it.
TOL_GPT_LOGITS = 0.1
TOL_GPT_LOGITS_RMS = 0.05
GPT_SERVING_CONTROLS = ("extend at positions 0..S-1", "block copy skipped")
#   The decode steps whose host/device split is printed, at a full batch
#   of 8: (block size, table width, position written), as each serving
#   phase's engine and contexts have them.
DECODE_SPLIT_SHAPE = {"GPT-2 small": (8, 16, 96), "Llama-2-7B": (16, 16, 64)}
SPLIT_STEPS = 20
#   Timed cache-off/cache-on pairs of GPT serving, after one untimed pass
#   each way; the order alternates from pair to pair (off first, then on
#   first), so that neither mode always runs first.
GPT_SERVING_PAIRS = 4
# Phase 12, disaggregated GPT-2 small serving: a PrefillStage actor and a
# DecodeStage actor of the port's runtime, each in its own worker process
# on the card, joined by a two-stage compiled graph (DisaggLLM), at the
# engine shape below (the prefill buckets are the prefill stage's own).
# DISAGG_REQUESTS prompts of DISAGG_PROMPT_LEN tokens drawn from SEED,
# MAX_TOKENS greedy tokens each, one request at a time, against the
# in-process LLMEngine on the same weights: the streams must be equal.
# The raw KV of a prompt is n_layer * 2 * blocks * block_size * d_model * 2
# bytes in bf16: 7 blocks (112 tokens, 4,128,768 B) fit the graph's 4 MiB
# channel, 8 (113-128 tokens, 4,718,592 B) must raise ChannelFullError.
DISAGG_MODEL = "gpt2-small"
DISAGG_BLOCK = 16
DISAGG_ENGINE = dict(max_batch=8, num_blocks=256, max_blocks_per_seq=16,
                     prefill_buckets=(16, 32, 64, 128))
DISAGG_REQUESTS = 8
DISAGG_PROMPT_LEN = (3, 112)
DISAGG_OVER_LEN = (113, 128)
DISAGG_CODECS = ("int8", "e4m3")
DISAGG_CODEC_REQUESTS = 3
DISAGG_CONTROL = "blocks in reversed order"


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


def fused_control(kernel, args, fault):
    """A control (one of FUSED_CONTROLS): the plain version with the
    normalised row (ln_matmul) or a (mm_res) rounded to float8_e4m3 before
    the product; or with row r taking row r + 8's statistics (ln_matmul)
    or residual (mm_res)."""
    import torch

    from ray_tpu_torch.ops.fused import _ln_ref

    f8 = torch.float8_e4m3fn
    if kernel == "ln_matmul":
        x, g, b, w, wb = args
        if fault == FUSED_CONTROLS[0]:
            h = _ln_ref(x, g, b, 1e-5).to(f8).float()
        else:
            xf = x.float()
            mean = xf.mean(-1, keepdim=True)
            var = (xf - mean).square().mean(-1, keepdim=True)
            mean, var = mean.roll(-8, 0), var.roll(-8, 0)
            h = ((xf - mean) * torch.rsqrt(var + 1e-5) * g.float()
                 + b.float()).to(w.dtype).float()
        return (h @ w.float() + wb.float()).to(x.dtype)
    a, w, b, res = args
    if fault == FUSED_CONTROLS[0]:
        return (a.to(f8).float() @ w.float() + b.float()
                + res.float()).to(a.dtype)
    return (a.float() @ w.float() + b.float()
            + res.float().roll(-8, 0)).to(a.dtype)


def phase_kernels_fused():
    """ln_matmul and mm_res against their plain versions at the training
    path's shapes, timed beside the plain version and beside the cuBLAS
    composition of the same function (there is no single PyTorch call:
    addmm(wb, layer_norm(x), w) and addmm(res + b, a, w)), with the ratio
    to the composition and the share of the bound printed against the
    bars (not enforced: at most 1.0x the composition; at least 50% of the
    bound at FC and MLP out); untimed checks at f32 and at other shapes;
    every case run twice, bitwise equal; then matmul_residual's backward
    products in bf16 against the f32 products they stand for."""
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
        # no split-K, no atomics: a second call is bitwise equal
        check(torch.equal(out, fn(*args)),
              f"{kernel} {label}: the output differs between two calls")
        ref = plain(*args)
        check(out.shape == (n, f) and out.dtype == args[0].dtype,
              f"{kernel} {label}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out.float()).all()),
              f"{kernel} {label}: non-finite output")
        err_abs = (out.float() - ref.float()).abs().max().item()
        scaled, rms = fused_errors(out, ref)
        text = (f"{kernel} {label} [{n}, {k}] x [{k}, {f}] {dtype}: bitwise "
                f"equal over two calls; max abs "
                f"err {err_abs:.3e}, scaled {scaled:.3e} (tol "
                f"{TOL_FUSED[dtype]}), rms {rms:.3e} (tol "
                f"{TOL_FUSED_RMS[dtype]})")
        row = dict(label=label, kernel=kernel, shape=[n, k, f], dtype=dtype,
                   max_abs_err=err_abs, scaled_err=scaled, rms_err=rms)
        controls = {}
        if timed:
            controls = {fault: fused_errors(fused_control(kernel, args, fault),
                                            ref)
                        for fault in FUSED_CONTROLS}
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
            bars = [f"{ms / lib_ms:.2f}x the composition (bar 1.0x: "
                    f"{'met' if ms <= lib_ms else 'not met'})"]
            if label == FUSED_MAIN[kernel]:
                bars.append(f"bar 50% of bound: "
                            f"{'met' if bound_ms / ms >= 0.5 else 'not met'}")
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       over_library=ms / lib_ms, bound_share=bound_ms / ms,
                       controls={c: dict(scaled_err=e[0], rms_err=e[1])
                                 for c, e in controls.items()})
            text += "".join(f"; control ({c}): scaled {e[0]:.3e}, rms "
                            f"{e[1]:.3e}" for c, e in controls.items())
            text += (f"; kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, cuBLAS composition {lib_ms:.4f} "
                     f"ms, bound {bound_ms:.4f} ms ({bound_by}); "
                     f"{bound_ms / ms:.1%} of bound; " + "; ".join(bars))
        print(f"[kernels] {text}")
        check(fused_agrees(scaled, rms, dtype),
              f"{kernel} {label} disagrees with its plain version")
        for fault, e in controls.items():
            check(not fused_agrees(*e, dtype),
                  f"{kernel} {label}: the control ({fault}) passes the check")
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


def ptxas_kernels(report):
    """[(entry function, registers, 'N bytes spill stores, M bytes spill
    loads')] from nvcc's -Xptxas -v report, the entry functions' mangled
    names shortened to their names and int/bool template arguments."""
    import re

    found, fn, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # length-prefixed identifiers of the mangled name: the kernel's
            mangled = m.group(1)
            name = next((mangled[i.end(1):i.end(1) + int(i.group(1))]
                         for i in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled)
                         if mangled[i.end(1):i.end(1) + int(i.group(1))]
                         .endswith("_kernel")), mangled[:40])
            targs = re.findall(r"L([ib])(\d+)E", mangled)
            fn = name + (
                "<" + ", ".join(v if t == "i" else ("true" if v == "1"
                                                   else "false")
                                for t, v in targs) + ">" if targs else "")
            spills = ""
        m = re.search(r"(\d+ bytes spill stores, \d+ bytes spill loads)", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            found.append((fn, int(m.group(1)), spills))
            fn = None
    return found


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
    gemm = [f"{name} {fn}: {regs} registers, {spills}"
            for name in ("ln_matmul", "mm_res")
            for fn, regs, spills in ptxas_kernels(reports[name])
            if "gemm_kernel" in fn]
    print("[build] Hopper GEMM (hopper_gemm.cuh) ptxas: "
          + ("; ".join(gemm) or "library was current, no report"))
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


def param_rel_errors(names, got, ref):
    """||g - g_ref|| / ||g_ref|| per parameter; w_qkv and b_qkv per third
    (q, k, v), since a fault in ds reaches only the q and k thirds; the
    key third of b_qkv (ZERO_GRADIENT) left out."""
    out = {}
    for n, a, b in zip(names, got, ref):
        parts = zip("qkv", a.chunk(3, -1), b.chunk(3, -1)) \
            if n in ("w_qkv", "b_qkv") else [("", a, b)]
        for part, x, y in parts:
            key = f"{n}[{part}]" if part else n
            if key != ZERO_GRADIENT:
                out[key] = ((x - y).norm() / y.norm()).item()
    return out


def worst_error(errs):
    """(name, value) of the largest error; NaN counts as the largest."""
    name = max(errs, key=lambda n: math.inf if math.isnan(errs[n])
               else errs[n])
    return name, errs[name]


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
        return param_rel_errors(names, g, ref)

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

    worst = worst_error

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


def profiled(fn):
    """(wall ms, {kernel name: device ms}, kernel launches) of one call of
    ``fn`` under torch.profiler (the profiler's own host cost is inside
    the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a user annotation (Optimizer.step#AdamW.step) carries the device
    # time of the kernels inside it, which are counted on their own
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0 and not e.is_user_annotation]
    return (wall_ms, {e.key: e.self_device_time_total / 1e3 for e in device},
            sum(e.count for e in device))


def profile_step(step, label):
    """One training step under torch.profiler: device time by kernel
    class and the device's idle share of the step."""
    wall_ms, kernels, _ = profiled(step)
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


def moe_route_variant(model, xt, w_router, fault):
    """MoE._route with one planted fault (a control for the MoE gradient
    check): capacity positions counted k-major (every token's first
    choice queues before any second choice), or the kept weights left
    as the softmax gave them instead of renormalised."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.models.moe import Routes

    c = model.config
    T = xt.shape[0]
    E, K = c.num_experts, c.top_k
    cap = max(1, int(c.capacity_factor * T * K / E))
    probs = torch.softmax(xt.float() @ w_router.float(), dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)
    assign = F.one_hot(top_e, E).float()
    aux = c.aux_loss_coeff * E * (assign.sum(1).mean(0)
                                  * probs.mean(0)).sum()
    if fault == "capacity counted k-major":
        flat = assign.transpose(0, 1).reshape(K * T, E).T
        pos = (flat.cumsum(-1) - flat).T.reshape(K, T, E).transpose(0, 1)
    else:
        flat = assign.reshape(T * K, E).T
        pos = (flat.cumsum(-1) - flat).T.reshape(T, K, E)
    pos = (pos * assign).sum(-1)
    keep = (pos < cap) & (top_w > 0)
    top_w = torch.where(keep, top_w, torch.zeros_like(top_w))
    if fault != "kept weights not renormalised":
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    slot = torch.where(keep, pos, torch.full_like(pos, cap)).long()
    pos_oh = torch.zeros((T, K, cap + 1), device=xt.device)
    pos_oh.scatter_(-1, slot[..., None], 1.0)
    combine = torch.bmm((assign * top_w[..., None]).transpose(1, 2),
                        pos_oh[..., :cap])
    return Routes(combine, aux, top_e, keep)


def moe_recorded(model, fn, route=None):
    """fn() with ``model._route`` recording each layer's routes (or
    replaced by ``route(model, xt, w_router)``, a planted fault): (fn's
    result, [Routes of each layer's call])."""
    from ray_tpu_torch.models import MoE

    routes = []
    inner = route or MoE._route

    def recording(xt, w_router):
        r = inner(model, xt, w_router)
        routes.append(r)
        return r

    model._route = recording
    try:
        return fn(), routes
    finally:
        del model._route


def phase_moe_training(kernel_ms):
    """MoEConfig.small (Mixtral-style, GPT-2 small width) trained with
    AdamW at B=8, S=1024 through MoE.loss: launches a step (the flash
    kernels once per layer each), the loss and its aux term, the share
    of routes dropped at capacity, throughput, peak memory and the
    profiled step's device time by kernel class."""
    import torch

    from ray_tpu_torch.models import MoE, MoEConfig
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_residual_fwd)

    label = "moe training"
    c = MoEConfig.small()
    check((c.n_layer, c.d_model, c.n_head, c.head_dim, c.d_ff,
           c.num_experts, c.top_k, c.capacity_factor, c.padded_vocab,
           c.dtype, c.param_dtype, c.use_flash)
          == (12, 768, 12, 64, 3072, 8, 2, 1.25, 50304, torch.bfloat16,
              torch.float32, True), f"not MoEConfig.small: {c}")
    model = MoE(c)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = {n: p.requires_grad_() for n, p in model.init(gen).items()}
    opt = torch.optim.AdamW(params.values(), lr=TRAIN_LR,
                            weight_decay=TRAIN_WD)
    tokens = torch.randint(0, c.vocab_size, (MOE_BATCH, MOE_SEQ),
                           generator=gen, device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    counters = {"flash_fwd": flash_attention_fwd,
                "flash_bwd": flash_attention_bwd, "ln_matmul": ln_matmul_fwd,
                "mm_res": matmul_residual_fwd}
    expected = {"flash_fwd": c.n_layer, "flash_bwd": c.n_layer,
                "ln_matmul": 0, "mm_res": 0}
    losses, auxes, dropped, per_step = [], [], [], []

    def step():
        before = {n: f.launches for n, f in counters.items()}
        opt.zero_grad(set_to_none=True)
        loss, routes = moe_recorded(
            model, lambda: model.loss(params, tokens, targets))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        auxes.append(sum(r.aux.detach() for r in routes))
        dropped.append(sum((~r.keep).sum() for r in routes))
        per_step.append({n: f.launches - before[n]
                         for n, f in counters.items()})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():            # the MoE training path starts here
        f.launches = 0
    for _ in range(MOE_WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE_STEPS):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    loss_values = [x.item() for x in losses]
    aux_values = [x.item() for x in auxes]
    routes_a_step = MOE_BATCH * MOE_SEQ * c.top_k * c.n_layer
    drop_share = [x.item() / routes_a_step for x in dropped]
    prof = profile_step(step, label)   # one step after the counted ones
    sec_per_step = dt / MOE_STEPS
    tokens_per_s = MOE_BATCH * MOE_SEQ / sec_per_step
    split = {n: c.n_layer * kernel_ms[n] for n in ("flash_fwd", "flash_bwd")}
    split["rest"] = sec_per_step * 1e3 - sum(split.values())
    ce0 = math.log(c.padded_vocab) + c.d_model * 0.02 ** 2 / 2
    aux_uniform = c.aux_loss_coeff * c.top_k * c.n_layer
    out = {
        "moe_small_train_tokens_per_sec_per_chip": tokens_per_s,
        "sec_per_step": sec_per_step, "batch": MOE_BATCH, "seq": MOE_SEQ,
        "steps_timed": MOE_STEPS, "params": model.num_params(),
        "losses": loss_values, "aux_losses": aux_values,
        "dropped_route_share": drop_share, "peak_memory_gib": peak_gib,
        "launches": {n: v for n, v in launches.items() if expected[n]},
        "step_split_ms": split, "profile": prof,
    }
    print(f"[{label}] MoEConfig.small ({model.num_params()} params, "
          f"{c.num_experts} experts, top-{c.top_k}, capacity factor "
          f"{c.capacity_factor}) B={MOE_BATCH} S={MOE_SEQ}: "
          f"{tokens_per_s:.1f} tokens/s, {sec_per_step * 1e3:.2f} ms/step; "
          f"losses {[round(x, 4) for x in loss_values]}; aux losses "
          f"{[round(x, 4) for x in aux_values]} (uniform routing: "
          f"{aux_uniform:.2f}); share of (token, k) routes dropped "
          f"{[round(x, 4) for x in drop_share]}; peak {peak_gib:.2f} GiB "
          f"allocated; launches per step "
          f"{[dict(t) for t in {tuple(d.items()) for d in per_step}]}; step "
          f"split (launches x kernel ms): "
          + ", ".join(f"{n} {ms:.2f} ms" for n, ms in split.items()))
    check(all(n == expected for n in per_step),
          f"{label}: launches per step {per_step}, expected {expected}")
    check(all(math.isfinite(x) for x in loss_values + aux_values),
          f"{label}: non-finite loss {loss_values} or aux {aux_values}")
    check(1 / TOL_MOE_AUX0 <= aux_values[0] / aux_uniform <= TOL_MOE_AUX0,
          f"{label}: step-0 aux loss {aux_values[0]} is not within a factor "
          f"{TOL_MOE_AUX0} of {aux_uniform}")
    check(abs(loss_values[0] - ce0 - aux_values[0]) <= TOL_LOSS0,
          f"{label}: step-0 loss {loss_values[0]} is not ln("
          f"{c.padded_vocab}) + {c.d_model} * 0.02^2 / 2 = {ce0:.4f} plus "
          f"the aux loss {aux_values[0]:.4f} (tol {TOL_LOSS0})")
    check(loss_values[-1] < loss_values[0],
          f"{label}: loss did not fall: {loss_values}")
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    out["grad_check"] = phase_moe_grad_check(params)
    return out


def phase_moe_grad_check(params):
    """MoEConfig.small in f32 at B=2, S=1024: the flash model against the
    use_flash=False model on the same params (every parameter's gradient
    and every layer's routes), then the four planted controls."""
    import torch

    from ray_tpu_torch.models import MoE, MoEConfig
    from ray_tpu_torch.ops import flash_attention, flash_attention_fwd

    moe_mod = importlib.import_module("ray_tpu_torch.models.moe")
    label = "moe training"
    names = list(params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    c = MoEConfig.small(dtype=torch.float32)
    tokens = torch.randint(0, c.vocab_size, (MOE_GRAD_BATCH, MOE_SEQ),
                           generator=gen, device="cuda")
    targets = torch.roll(tokens, -1, dims=1)

    def run(model, route=None):
        """(loss, gradients, routes) of one loss and backward."""
        def fn():
            loss = model.loss(params, tokens, targets)
            return loss.item(), torch.autograd.grad(
                loss, [params[n] for n in names])
        (loss, grads), routes = moe_recorded(model, fn, route)
        return loss, grads, routes

    def compare(got, ref):
        """(per-parameter relative errors, share of layers' routes equal:
        top-k experts and kept set)."""
        errs = param_rel_errors(names, got[1], ref[1])
        same = [torch.equal(a.top_e, b.top_e) and torch.equal(a.keep, b.keep)
                for a, b in zip(got[2], ref[2])]
        return errs, sum(same) / len(same)

    def agrees(errs, route_share):
        return route_share == 1.0 and all(e <= TOL_MOE_GRAD
                                          for e in errs.values())

    flash_model, ref_model = MoE(c), MoE(dataclasses.replace(
        c, use_flash=False))
    before = flash_attention_fwd.launches
    sound = run(flash_model)
    check(flash_attention_fwd.launches - before == c.n_layer,
          f"{label}: the f32 flash model launched "
          f"{flash_attention_fwd.launches - before} flash_fwd, expected "
          f"{c.n_layer}")
    ref = run(ref_model)
    sound_errs, sound_routes = compare(sound, ref)
    del sound
    drop_cf = dataclasses.replace(c, capacity_factor=MOE_DROP_CF)
    ref_drop = run(MoE(dataclasses.replace(drop_cf, use_flash=False)))
    drop_share = sum((~r.keep).float().mean().item()
                     for r in ref_drop[2]) / c.n_layer
    results = {}
    for fault in MOE_CONTROLS:
        model = MoE(drop_cf if fault == "capacity counted k-major" else c)
        route = None
        against = ref_drop if model.config is drop_cf else ref
        if fault in ("capacity counted k-major",
                     "kept weights not renormalised"):
            def route(m, xt, w, fault=fault):
                return moe_route_variant(m, xt, w, fault)
        saved = {}
        if fault == "attention without its causal mask":
            saved[(moe_mod, "flash_attention")] = moe_mod.flash_attention
            moe_mod.flash_attention = (
                lambda q, k, v, causal=True, **kw:
                flash_attention(q, k, v, causal=False, **kw))
        if fault == "logits rounded to bf16":
            model._lm_head = (lambda wte, x, m=model: MoE._lm_head(
                m, wte, x).to(torch.bfloat16).float())
        try:
            results[fault] = compare(run(model, route), against)
        finally:
            for (mod, attr), fn in saved.items():
                setattr(mod, attr, fn)
    print(f"[{label}] gradient check [{MOE_GRAD_BATCH}, {MOE_SEQ}] f32, "
          f"flash vs mha_reference model: routes equal in "
          f"{sound_routes:.0%} of layers; worst ||g - g_ref|| / ||g_ref|| "
          f"{worst_error(sound_errs)[1]:.4e} ({worst_error(sound_errs)[0]}; "
          f"tol {TOL_MOE_GRAD}); per parameter "
          + json.dumps({n: float(f"{e:.4g}")
                        for n, e in sound_errs.items()}))
    print(f"[{label}] capacity factor {MOE_DROP_CF}: share of (token, k) "
          f"routes dropped {drop_share:.4f}")
    for fault, (errs, routes) in results.items():
        print(f"[{label}] control, {fault}: routes equal in {routes:.0%} of "
              f"layers; worst {worst_error(errs)[1]:.4e} "
              f"({worst_error(errs)[0]}); per parameter "
              f"{json.dumps({n: float(f'{e:.4g}') for n, e in errs.items()})}")
    check(agrees(sound_errs, sound_routes),
          f"{label}: f32 flash-model gradients or routes disagree with the "
          "mha_reference model's")
    check(drop_share > 0, f"{label}: no route dropped at capacity factor "
                          f"{MOE_DROP_CF}")
    for fault, (errs, routes) in results.items():
        check(not agrees(errs, routes),
              f"{label}: control '{fault}' passes the gradient check")
    return dict(rel_err=sound_errs, route_share=sound_routes,
                drop_share_at_drop_cf=drop_share,
                controls={f: dict(worst=worst_error(e)[1], route_share=r)
                          for f, (e, r) in results.items()})


def logits_rel_error(got, ref):
    """The largest |got - ref| over the largest |ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def phase_vit(counters):
    """ViT-B/16 (num_classes=10, bf16, remat) trained for a few AdamW
    steps on one batch of 64 images: the loss falls from ln(10) (the head
    starts at zero), no step launches a kernel (197 tokens take
    mha_reference); then the bf16 logits against the f32 forward, with a
    planted control."""
    import torch

    from ray_tpu_torch.models import ViT, ViTConfig

    label = "vit"
    c = ViTConfig.b16(num_classes=10)
    check((c.image_size, c.patch_size, c.n_layer, c.d_model, c.n_head,
           c.d_ff, c.num_patches + 1, c.dtype, c.remat)
          == (224, 16, 12, 768, 12, 3072, 197, torch.bfloat16, True),
          f"not ViT-B/16: {c}")
    model = ViT(c)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    params = {n: p.requires_grad_() for n, p in model.init(gen).items()}
    opt = torch.optim.AdamW(params.values(), lr=TRAIN_LR,
                            weight_decay=TRAIN_WD)
    images = torch.randn((VIT_BATCH, c.image_size, c.image_size, 3),
                         generator=gen, device="cuda")
    labels = torch.randint(0, c.num_classes, (VIT_BATCH,), generator=gen,
                           device="cuda")
    for f in counters:                  # the ViT training path starts here
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(VIT_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, images, labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    launches = {f.__name__: f.launches for f in counters}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del opt
    with torch.no_grad():
        got = model.apply(params, images)
        ref = ViT(dataclasses.replace(c, dtype=torch.float32,
                                      remat=False)).apply(params, images)
        err = logits_rel_error(got, ref)
        p = c.patch_size

        def patches_cpp(x):          # the control: (c, py, px) order
            B, H, W, C = x.shape
            x = x.reshape(B, H // p, p, W // p, p, C)
            return x.permute(0, 1, 3, 5, 2, 4).reshape(
                B, (H // p) * (W // p), p * p * C)

        model._patchify = patches_cpp
        ctl = logits_rel_error(model.apply(params, images), ref)
        del model._patchify
    print(f"[{label}] ViT-B/16 ({sum(v.numel() for v in params.values())} "
          f"params) B={VIT_BATCH} {c.image_size}x{c.image_size}, bf16, "
          f"remat: losses "
          f"{[round(x, 4) for x in losses]}; step s "
          f"{[round(x, 4) for x in step_s]} (host clock, the first with "
          f"its warm-up); peak {peak_gib:.2f} GiB; kernel launches "
          f"{launches}; bf16 logits vs the f32 forward: max err / max|ref| "
          f"{err:.4e} (tol {TOL_VIT_LOGITS}); control ({VIT_CONTROL}): "
          f"{ctl:.4e}")
    check(not any(launches.values()), f"{label}: the ViT path launched "
          f"{launches}; at 197 tokens its attention is mha_reference")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite "
                                                 f"loss {losses}")
    check(abs(losses[0] - math.log(c.num_classes)) <= 1e-4,
          f"{label}: step-0 loss {losses[0]} is not ln({c.num_classes}): "
          "the head starts at zero")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    check(err <= TOL_VIT_LOGITS, f"{label}: bf16 logits disagree with the "
                                 "f32 forward")
    check(ctl > TOL_VIT_LOGITS, f"{label}: the control '{VIT_CONTROL}' "
                                "passes the logits check")
    return dict(losses=losses, step_s=step_s, peak_memory_gib=peak_gib,
                launches=launches, logits_rel_err=err, control=ctl)


def resnet_forward_variant(model, params, state, images, fault):
    """ResNet.apply(train=True) with one planted fault (a control for the
    f32 forward check): PyTorch's symmetric padding=k//2 in place of
    XLA's SAME, or the unbiased batch variance."""
    import torch
    import torch.nn.functional as F


    resnet_mod = importlib.import_module("ray_tpu_torch.models.resnet")
    saved = resnet_mod._same_pad, torch.Tensor.var
    if fault == "symmetric padding":
        resnet_mod._same_pad = (lambda x, k, stride, value=0.0:
                                F.pad(x, [k // 2] * 4, value=value))
    else:
        var = torch.Tensor.var
        torch.Tensor.var = (lambda self, dim=None, unbiased=False, **kw:
                            var(self, dim=dim, unbiased=True, **kw))
    try:
        return model.apply(params, state, images, train=True)[0]
    finally:
        resnet_mod._same_pad, torch.Tensor.var = saved


def phase_resnet(counters):
    """ResNet-18/CIFAR trained by SGD with momentum (loss falls, batch-norm
    state moves), then the reference's resnet50_imagenet layout at 224:
    one step, and its f32 forward checks with two planted controls."""
    import torch

    from ray_tpu_torch.models import ResNet, ResNetConfig

    label = "resnet"
    c = ResNetConfig.resnet18_cifar()
    check((c.stage_sizes, c.width, c.small_inputs, c.num_classes, c.dtype)
          == ((2, 2, 2, 2), 64, True, 10, torch.bfloat16),
          f"not ResNet-18/CIFAR: {c}")
    model = ResNet(c)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    params, state0 = model.init(gen)
    params = {n: p.requires_grad_() for n, p in params.items()}
    opt = torch.optim.SGD(params.values(), lr=RESNET_LR,
                          momentum=RESNET_MOMENTUM)
    images = torch.randn((RESNET_BATCH, 32, 32, 3), generator=gen,
                         device="cuda")
    labels = torch.randint(0, 10, (RESNET_BATCH,), generator=gen,
                           device="cuda")
    for f in counters:              # the ResNet training path starts here
        f.launches = 0
    torch.cuda.synchronize()
    losses, step_s, state = [], [], state0
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, state = model.loss(params, state, images, labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    launches = {f.__name__: f.launches for f in counters}
    moved = sum(not torch.equal(state[n], state0[n]) for n in state)
    del opt
    print(f"[{label}] ResNet-18/CIFAR B={RESNET_BATCH} 32x32 bf16, SGD lr "
          f"{RESNET_LR} momentum {RESNET_MOMENTUM}: losses "
          f"{[round(x, 4) for x in losses]}; step s "
          f"{[round(x, 4) for x in step_s]} (host clock); batch-norm "
          f"buffers moved {moved} of {len(state)}; kernel launches "
          f"{launches}")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite "
                                                 f"loss {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    check(moved == len(state), f"{label}: {len(state) - moved} batch-norm "
                               "buffers did not move")
    check(not any(launches.values()), f"{label} launched {launches}")

    c50 = ResNetConfig.resnet50_imagenet()
    model = ResNet(c50)
    params, state0 = model.init(gen)
    params = {n: p.requires_grad_() for n, p in params.items()}
    images = torch.randn((RESNET50_BATCH, 224, 224, 3), generator=gen,
                         device="cuda")
    labels = torch.randint(0, c50.num_classes, (RESNET50_BATCH,),
                           generator=gen, device="cuda")
    opt = torch.optim.SGD(params.values(), lr=RESNET_LR,
                          momentum=RESNET_MOMENTUM)
    t0 = time.perf_counter()
    loss, state = model.loss(params, state0, images, labels)
    loss.backward()
    opt.step()
    loss50 = loss.item()
    step50_s = time.perf_counter() - t0
    del opt
    f32 = ResNet(dataclasses.replace(c50, dtype=torch.float32))
    with torch.no_grad():
        ref, _ = f32.apply(params, state, images, train=True)
        bf16, _ = model.apply(params, state, images, train=True)
        cpu_params = {n: p.detach().cpu() for n, p in params.items()}
        cpu_ref, _ = f32.apply(cpu_params, {n: v.cpu() for n, v in
                                            state.items()},
                               images.cpu(), train=True)
        err_bf16 = logits_rel_error(bf16, ref)
        err_f32 = logits_rel_error(ref.cpu(), cpu_ref)
        controls = {fault: logits_rel_error(resnet_forward_variant(
            f32, params, state, images, fault).cpu(), cpu_ref)
            for fault in RESNET_CONTROLS}
    print(f"[{label}] resnet50_imagenet (basic blocks, stages 3, 4, 6, 3; "
          f"{sum(v.numel() for v in params.values())} params) B="
          f"{RESNET50_BATCH} 224x224: one step, loss {loss50:.4f}, "
          f"{step50_s:.3f} s (host clock, with its warm-up); train-mode "
          f"logits max err / max|ref|: bf16 vs f32 on the card "
          f"{err_bf16:.4e} (tol {TOL_RESNET_BF16}); f32 on the card vs f32 "
          f"on the CPU {err_f32:.4e} (tol {TOL_RESNET_F32}); controls "
          f"{json.dumps({f: float(f'{e:.4g}') for f, e in controls.items()})}")
    check(math.isfinite(loss50), f"{label}: non-finite loss {loss50}")
    check(err_bf16 <= TOL_RESNET_BF16, f"{label}: bf16 logits disagree "
                                       "with the f32 forward")
    check(err_f32 <= TOL_RESNET_F32, f"{label}: the card's f32 forward "
                                     "disagrees with the CPU's")
    for fault, e in controls.items():
        check(e > TOL_RESNET_F32, f"{label}: control '{fault}' passes the "
                                  "f32 forward check")
    return dict(resnet18_losses=losses, resnet18_step_s=step_s,
                launches=launches, resnet50_loss=loss50,
                resnet50_step_s=step50_s, logits_rel_err_bf16=err_bf16,
                logits_rel_err_f32_vs_cpu=err_f32, controls=controls)


def phase_head_dims():
    """flash_attention_fwd / _bwd at head dims 16 and 48 (zero-padded to
    the 32 and 64 instances) against the plain versions at the unpadded
    D, and the padded call with sm_scale from the padded D, which must
    fail."""
    import torch

    from ray_tpu_torch.models import MoE, MoEConfig
    from ray_tpu_torch.ops import (flash_attention_bwd,
                                   flash_attention_bwd_plain,
                                   flash_attention_fwd,
                                   flash_attention_fwd_plain)

    fa_mod = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    rows = []
    for i, shape in enumerate(HEAD_DIM_CASES):
        d = shape[-1]
        d_pad = fa_mod._instance_for("head dims", d)
        for causal in (True, False):
            q, k, v, do = _randn([shape] * 4, "bfloat16", SEED + 200 + i)
            out, lse = flash_attention_fwd(q, k, v, causal)
            ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal)
            err_out, err_row = out_errors(out, ref_out)
            err_lse = (lse - ref_lse).abs().max().item()
            grads = flash_attention_bwd(q, k, v, out, lse, do, causal)
            ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
            scaled, row_err = grad_errors(grads, ref)
            wrong, _ = fa_mod.padded_head_dim_call(
                fa_mod._launch_fwd, d_pad, q, k, v, causal,
                1.0 / math.sqrt(d_pad))
            ctl_abs, ctl_row = out_errors(wrong, ref_out)
            print(f"[head dims] {list(shape)} bf16 causal={causal}, padded "
                  f"to {d_pad}: out err {err_out:.3e}, row-scaled "
                  f"{err_row:.3e}, lse err {err_lse:.3e}; grads scaled "
                  f"{scaled:.3e}, row-scaled {row_err:.3e}; control "
                  f"(sm_scale from D={d_pad}): out err {ctl_abs:.3e}, "
                  f"row-scaled {ctl_row:.3e}")
            check(out.shape == q.shape and all(g.shape == q.shape
                                               for g in grads),
                  f"head dim {d}: output shapes")
            check(out_agrees(err_out, err_row, "bfloat16")
                  and err_lse <= TOL_LSE["bfloat16"],
                  f"flash_fwd at head dim {d} disagrees with its plain "
                  "version")
            check(grads_agree(scaled, row_err, "bfloat16"),
                  f"flash_bwd at head dim {d} disagrees with its plain "
                  "version")
            check(not out_agrees(ctl_abs, ctl_row, "bfloat16"),
                  f"head dim {d}: the sm_scale control passes")
            rows.append(dict(shape=list(shape), causal=causal, padded_to=d_pad,
                             max_abs_err=err_out, row_scaled_err=err_row,
                             lse_err=err_lse, grad_scaled_err=scaled,
                             grad_row_err=row_err, control_err=ctl_abs))
    # MoEConfig.tiny (head dim 16) in f32 at S=128 through the padded
    # kernel, against the same model through mha_reference
    c = MoEConfig.tiny(dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    params = MoE(c).init(gen)
    tokens = torch.randint(0, c.vocab_size, (2, 128), generator=gen,
                           device="cuda")
    before = flash_attention_fwd.launches
    logits, _ = MoE(c).apply(params, tokens)
    launched = flash_attention_fwd.launches - before
    ref, _ = MoE(dataclasses.replace(c, use_flash=False)).apply(params,
                                                                tokens)
    err = (logits - ref).abs().max().item()
    print(f"[head dims] MoEConfig.tiny f32 [2, 128] (head dim 16): "
          f"{launched} flash_fwd launches, logits max abs err {err:.3e} "
          f"against the mha_reference model (tol {TOL_OUT['float32']})")
    check(launched == c.n_layer and err <= TOL_OUT["float32"],
          "MoEConfig.tiny through the padded flash kernel disagrees with "
          "its mha_reference model")
    rows.append(dict(model="MoEConfig.tiny f32", launches=launched,
                     logits_max_abs_err=err))
    return rows


def decode_split(label, model, params):
    """The host/device split of one decode step at a full batch of 8
    (DECODE_SPLIT_SHAPE), one slot inactive: the wall p50 over
    SPLIT_STEPS synchronised steps, then one step under torch.profiler
    for its device-busy ms and kernel launches. The busy share is busy ms
    over that wall p50; the profiled step's own wall, which carries the
    profiler's host cost, is printed beside it."""
    import torch

    bs, width, pos = DECODE_SPLIT_SHAPE[label]
    c = model.config
    n = pos // bs + 1                        # blocks each slot holds
    dev = params["wte"].device
    cache = model.init_paged_cache(8 * n, bs, dev)
    rows = torch.full((8, width), -1, dtype=torch.long, device=dev)
    rows[:, :n] = torch.arange(8 * n, device=dev).reshape(8, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tokens = torch.randint(0, c.vocab_size, (8,), generator=gen, device=dev)
    positions = torch.full((8,), pos, dtype=torch.long, device=dev)
    active = torch.ones(8, dtype=torch.bool, device=dev)
    active[-1] = False                       # one slot's writes dropped

    def step():
        return model.paged_decode_step(params, cache, tokens, positions,
                                       rows, active)

    for _ in range(3):
        step()
    walls = []
    for _ in range(SPLIT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    q1, _, q3 = statistics.quantiles(walls, n=4)
    prof_wall, kernels, launches = profiled(step)
    busy = sum(kernels.values())
    print(f"[decode split] {label}, B=8 at position {pos}: wall p50 "
          f"{wall:.3f} ms over {SPLIT_STEPS} steps (quartiles {q1:.3f}, "
          f"{q3:.3f}); device busy {busy:.3f} ms (busy share "
          f"{busy / wall:.4f}), {launches} kernel launches "
          f"({wall * 1e3 / launches:.1f} us of wall each); profiled step "
          f"{prof_wall:.3f} ms wall")
    return dict(wall_p50_ms=wall, wall_q1_ms=q1, wall_q3_ms=q3,
                device_busy_ms=busy, device_busy_share=busy / wall,
                launches=launches, host_us_per_launch=wall * 1e3 / launches,
                profiled_wall_ms=prof_wall)


def gpt_serving_prompts(vocab):
    """The phase's 8 prompts, from SEED (GPT_ENGINE_CONFIG's comment)."""
    import numpy as np

    rng = np.random.default_rng(SEED)

    def user():
        return rng.integers(1, vocab, int(rng.integers(
            GPT_USER_LEN[0], GPT_USER_LEN[1] + 1))).tolist()

    systems = [rng.integers(1, vocab, GPT_SYSTEM_LEN).tolist()
               for _ in range(2)]
    prompts = [systems[i % 2] + user() for i in range(6)]
    diverging = user()
    if diverging[0] == systems[0][GPT_COW_SHARED]:
        diverging[0] = diverging[0] % (vocab - 1) + 1
    prompts.append(systems[0][:GPT_COW_SHARED] + diverging)
    prompts.append(list(prompts[0]))
    return prompts


def extend_positions_from_zero(model, params, cache, tokens, start, length,
                               block_row):
    """Control: GPT.paged_prefill_extend with C 1's fault, the suffix
    embedded at positions 0..S-1 instead of start.. (used only by the
    control run)."""
    from ray_tpu_torch.ops import paged_attention_prefill, paged_write_prefill

    x = model._embed(params["wte"], params["wpe"], tokens)
    for li in range(model.config.n_layer):
        lp = model._paged_layer_params(params, li)
        q, k, v = model._paged_qkv(x, lp)
        kl = paged_write_prefill(cache["k"][li], block_row, k[0], length,
                                 start)
        vl = paged_write_prefill(cache["v"][li], block_row, v[0], length,
                                 start)
        attn = paged_attention_prefill(q[0], kl, vl, block_row, start,
                                       length)
        x = model._paged_proj(x, attn, lp)
    last = x[0, max(int(length) - 1, 0)]
    return model._paged_logits(params, last), cache


def run_gpt_engine(model, params, prompts, prefix_cache, fault=None):
    """Serve ``prompts`` (GPT_MAX_TOKENS each, greedy) through one
    LLMEngine, driven inline by run_until_idle. Records each request's
    first-token logits (and whether a full prefill or an extend computed
    them), the top-two logit margin behind every token, TTFT and each
    decode step's time. Checks that every request finished by length,
    that nothing ran off the card, and the pool's and the tree's
    accounting. ``fault`` plants one of GPT_SERVING_CONTROLS."""
    import torch

    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    engine = LLMEngine(model, params, EngineConfig(
        **GPT_ENGINE_CONFIG, prefix_cache=prefix_cache))
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    last = {}
    first = {}               # request id -> (logits on host, how, cached)
    margins = {}             # request id -> top-two margin of each token
    decode_s, copies = [], []

    def top2_margin(logits):
        top = logits.float().topk(2, dim=-1).values
        return (top[..., 0] - top[..., 1]).cpu()

    def recording(kind, fn):
        def run(*args):
            logits, cache = fn(*args)
            check(logits.is_cuda, f"{kind} logits on {logits.device}")
            last["logits"] = logits.float().cpu()
            last["how"] = kind
            return logits, cache
        return run

    start_sequence = engine._start_sequence

    def started(req, blocks, p, tok):
        first[req.request_id] = (last["logits"], last["how"],
                                 req.cache_hit_tokens)
        margins[req.request_id] = [float(top2_margin(last["logits"]))]
        start_sequence(req, blocks, p, tok)

    def timed_decode(*args):
        slots = {seq.slot: seq.req.request_id for seq in engine._running}
        t0 = time.perf_counter()
        logits, cache = run_decode(*args)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        check(logits.is_cuda, f"decode logits on {logits.device}")
        m = top2_margin(logits)
        for slot, rid in slots.items():
            margins[rid].append(float(m[slot]))
        return logits, cache

    extend = engine._extend_fn
    if fault == "extend at positions 0..S-1":
        def extend(*args):
            return extend_positions_from_zero(model, *args)
    cow = engine._cow_fn

    def counted_cow(cache, src, dst):
        copies.append((src, dst))
        if fault == "block copy skipped":
            return cache
        return cow(cache, src, dst)

    run_decode = engine._decode_fn
    engine._prefill_fn = recording("prefill", engine._prefill_fn)
    engine._extend_fn = recording("extend", extend)
    engine._decode_fn = timed_decode
    engine._cow_fn = counted_cow
    engine._start_sequence = started
    streams = [engine.add_request(p, max_tokens=MAX_TOKENS) for p in prompts]
    reqs = list(engine._waiting)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_until_idle(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [st.tokens(timeout=1) for st in streams]
    for i, (st, toks) in enumerate(zip(streams, tokens)):
        check(st.finish_reason == "length" and len(toks) == MAX_TOKENS,
              f"gpt serving request {i}: {st.finish_reason}, "
              f"{len(toks)} tokens")
    cache_stats = engine.cache_stats()
    if prefix_cache:
        engine.prefix_cache.check_invariants()
        resident = engine.prefix_cache.resident_blocks
        check(engine.pool.used_count == resident,
              f"{engine.pool.used_count} blocks held, {resident} cached")
        engine.prefix_cache.clear()
    engine.pool.check_leaks()
    check(engine.pool.used_count == 0, "KV blocks still held after serving")
    ids = [r.request_id for r in reqs]
    return dict(tokens=tokens, first=[first[r] for r in ids],
                margins=[margins[r] for r in ids],
                ttft_s=[r.first_token_at - r.submitted_at for r in reqs],
                decode_s=decode_s, wall_s=wall, copies=len(copies),
                cache_stats=cache_stats)


def gpt_logits_agree(e):
    return (e["max_abs"] <= TOL_GPT_LOGITS
            and e["rms_over_std"] <= TOL_GPT_LOGITS_RMS)


def phase_gpt_serving(wrappers):
    """GPT-2 small through the paged engine, prefix cache off and on
    (phase 7 of the module docstring). The launch counts of ``wrappers``
    are zeroed just before the timed engine runs and read just after
    them: the warm-up, the planted controls and the dense reference
    forward are not the path."""
    import torch

    from ray_tpu_torch.ops import flash_attention_fwd
    from ray_tpu_torch.serve.llm import build_model

    t0 = time.perf_counter()
    model, params = build_model("gpt2-small", seed=SEED)
    c = model.config
    check((c.n_layer, c.d_model, c.n_head, c.head_dim, c.padded_vocab)
          == (12, 768, 12, 64, 50304) and c.dtype == torch.bfloat16
          and params["wte"].dtype == torch.float32
          and params["wte"].is_cuda, f"not GPT-2 small on the card: {c}")
    print(f"[gpt serving] build_model('gpt2-small') in "
          f"{time.perf_counter() - t0:.1f} s, {model.num_params()} params")
    prompts = gpt_serving_prompts(c.vocab_size)
    for prefix_cache in (False, True):          # warm-up, untimed
        run_gpt_engine(model, params, prompts, prefix_cache)
    for f in wrappers:                  # the GPT serving path starts here
        f.launches = 0
    runs = {"off": [], "on": []}
    for i in range(GPT_SERVING_PAIRS):
        for name in (("off", "on") if i % 2 == 0 else ("on", "off")):
            runs[name].append(run_gpt_engine(model, params, prompts,
                                             name == "on"))
    launches = {f.__name__: f.launches for f in wrappers}
    print(f"[gpt serving] hand-written kernel launches of the "
          f"{2 * GPT_SERVING_PAIRS} timed engine runs: {launches}")
    check(not any(launches.values()),
          "the GPT serving path launched a hand-written kernel: its paged "
          "prefill, extend and decode are plain PyTorch, as in the JAX "
          "package")
    controls = {name: run_gpt_engine(model, params, prompts, True,
                                     fault=name)
                for name in GPT_SERVING_CONTROLS}

    # the reference: the dense flash forward of each prompt (a check, so
    # its launches are asserted here and not counted as the path's)
    dense = []
    for p in prompts:
        padded = torch.zeros((1, 128), dtype=torch.long,
                             device=params["wte"].device)
        padded[0, :len(p)] = torch.tensor(p)
        before = flash_attention_fwd.launches
        dense.append(model.apply(params, padded)[0, len(p) - 1].float().cpu())
        check(flash_attention_fwd.launches - before == c.n_layer,
              "the dense comparison forward did not run the flash kernel")
    checked = {f"{name} {i}": r for name in ("off", "on")
               for i, r in enumerate(runs[name])}
    checked.update(controls)
    errs = {name: [logits_errors(f[0], d) for f, d in zip(r["first"], dense)]
            for name, r in checked.items()}
    # beside it, printed: against the cache-off engine's paged prefill,
    # the same attention arithmetic over the whole prompt
    off0 = runs["off"][0]
    errs_off = {name: [logits_errors(f[0], g[0]) for f, g in
                       zip(r["first"], off0["first"])]
                for name, r in checked.items() if name != "off 0"}
    for name in ("off 0", "on 0", *GPT_SERVING_CONTROLS):
        hows = [f"{how}@{cached}" for _, how, cached in checked[name]["first"]]
        print(f"[gpt serving] {name}: first-token logits vs dense flash "
              f"forward, per request (computed by@cached tokens): "
              + ", ".join(f"{h} max abs {e['max_abs']:.4f} rms "
                          f"{e['rms_over_std']:.4f}"
                          for h, e in zip(hows, errs[name])))
        if name in errs_off:
            print(f"[gpt serving] {name}: the same vs the cache-off paged "
                  f"prefill: " + ", ".join(
                      f"max abs {e['max_abs']:.4f} rms "
                      f"{e['rms_over_std']:.4f}" for e in errs_off[name]))

    # cache-on against cache-off streams, pair by pair, up to a near-tie
    # of cache-off
    agree, diverged = [], []
    for pair, (off, on) in enumerate(zip(runs["off"], runs["on"])):
        agree.append(sum(a == b for a, b in zip(off["tokens"],
                                                on["tokens"])))
        for i, (a, b) in enumerate(zip(off["tokens"], on["tokens"])):
            if a == b:
                continue
            d = next(k for k in range(len(a)) if a[k] != b[k])
            tie = next((k for k, m in enumerate(off["margins"][i])
                        if m < TOL_GPT_LOGITS), len(a))
            diverged.append(dict(pair=pair, request=i, step=d,
                                 margin=off["margins"][i][d],
                                 first_near_tie=tie))
    print(f"[gpt serving] cache-on and cache-off streams agree in full for "
          f"{agree} of {len(prompts)} requests in each pair; diverged: "
          f"{diverged} (near-tie limit {TOL_GPT_LOGITS})")

    def stat(run):
        tt = run["ttft_s"]
        return dict(ttft_p50_s=statistics.median(tt), ttft_max_s=max(tt),
                    decode_step_p50_s=statistics.median(run["decode_s"]),
                    decode_steps=len(run["decode_s"]),
                    tokens_per_s=len(prompts) * MAX_TOKENS / run["wall_s"],
                    wall_s=run["wall_s"], cache_stats=run["cache_stats"],
                    copies=run["copies"])

    out = {"per_run": {name: [stat(r) for r in rs]
                       for name, rs in runs.items()}}
    for name, sts in out["per_run"].items():
        med = {k: statistics.median(st[k] for st in sts)
               for k in ("ttft_p50_s", "ttft_max_s", "decode_step_p50_s",
                         "tokens_per_s")}
        out[name] = dict(med, cache_stats=sts[0]["cache_stats"],
                         copies=sts[0]["copies"])
        print(f"[gpt serving] prefix cache {name}: {len(prompts)} requests x "
              f"{MAX_TOKENS} tokens, prompts "
              f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
              f"{len(sts)} runs (after one untimed run each way; order "
              f"alternating): TTFT p50 "
              f"{[round(st['ttft_p50_s'] * 1e3, 2) for st in sts]} ms "
              f"(median {med['ttft_p50_s'] * 1e3:.2f}); TTFT max "
              f"{[round(st['ttft_max_s'] * 1e3, 2) for st in sts]} ms; "
              f"decode step p50 "
              f"{[round(st['decode_step_p50_s'] * 1e3, 2) for st in sts]} "
              f"ms over {sts[0]['decode_steps']} steps; end to end "
              f"{[round(st['tokens_per_s'], 1) for st in sts]} tokens/s; "
              f"{sts[0]['copies']} block copies; cache "
              f"{sts[0]['cache_stats']}")
    out["launches"] = launches

    def worst(es):
        return dict(max_abs=max(e["max_abs"] for e in es),
                    rms_over_std=max(e["rms_over_std"] for e in es))

    out["first_logits_err"] = {name: worst(es) for name, es in errs.items()}
    out["first_logits_err_vs_off"] = {name: worst(es)
                                      for name, es in errs_off.items()}
    out["streams_agree"] = agree
    out["diverged"] = diverged
    out["decode_split"] = decode_split("GPT-2 small", model, params)

    for name in checked:
        if name in GPT_SERVING_CONTROLS:
            check(not all(map(gpt_logits_agree, errs[name])),
                  f"control '{name}' passes the first-token logits check")
        else:
            check(all(map(gpt_logits_agree, errs[name])),
                  f"cache {name}: first-token logits disagree with the "
                  f"dense flash forward")
    for on in runs["on"]:
        check(on["cache_stats"]["prefix_hit_tokens"] > 0,
              "the cache never hit")
        check(on["copies"] >= 1, "the cache never copied a block on write")
    for dv in diverged:
        check(dv["first_near_tie"] <= dv["step"],
              f"pair {dv['pair']} request {dv['request']} diverged at step "
              f"{dv['step']} with cache-off margins all >= {TOL_GPT_LOGITS} "
              f"up to it")
    return out


def smi_pids():
    """The pids nvidia-smi lists as holding a context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {int(line) for line in out.split() if line.strip().isdigit()}


def disagg_prompts(vocab):
    """DISAGG_REQUESTS prompts, then one of exactly DISAGG_PROMPT_LEN[1]
    tokens (the largest that fits the channel) and one of
    DISAGG_OVER_LEN tokens (over it), from SEED."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(DISAGG_PROMPT_LEN[0], DISAGG_PROMPT_LEN[1] + 1,
                        DISAGG_REQUESTS).tolist()
    lens += [DISAGG_PROMPT_LEN[1],
             int(rng.integers(DISAGG_OVER_LEN[0], DISAGG_OVER_LEN[1] + 1))]
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def run_disagg(llm, prompts):
    """-> (token streams, finish reasons, generate() wall seconds, the
    envelope bytes the prefill stage wrote for each request), one request
    at a time."""
    streams, reasons, wall, sent = [], [], [], []

    def prefill_sent():
        return llm.placement(timeout=60)["prefill"]["channel_bytes_sent"]

    before = prefill_sent()
    for p in prompts:
        t0 = time.perf_counter()
        out = llm.generate(p, max_tokens=MAX_TOKENS, timeout=300)
        wall.append(time.perf_counter() - t0)
        streams.append(out["tokens"])
        reasons.append(out["finish_reason"])
        after = prefill_sent()
        sent.append(after - before)
        before = after
    return streams, reasons, wall, sent


def phase_disagg(wrappers, card, device=None):
    """GPT-2 small served disaggregated (phase 12 of the module
    docstring). The driver's launch counts of ``wrappers`` are zeroed
    just before the raw DisaggLLM run and read just after it; each
    stage reports its own process's counts, which start at zero with the
    process. ``device`` (None: the card) is for a rehearsal on the
    CPU, where the checks of the card fail by design."""
    import torch

    t_phase = time.perf_counter()
    import ray_tpu_torch
    from ray_tpu_torch.cgraph.compiled import DEFAULT_CHANNEL_BYTES
    from ray_tpu_torch.exceptions import ChannelFullError
    from ray_tpu_torch.serve.llm import (DisaggLLM, EngineConfig,
                                         LLMEngine, PrefillStage,
                                         blocks_for_tokens, build_model)

    model, params = build_model(DISAGG_MODEL, seed=SEED, device=device)
    c = model.config
    check((c.n_layer, c.d_model, c.n_head) == (12, 768, 12)
          and c.dtype == torch.bfloat16 and params["wte"].is_cuda,
          f"not GPT-2 small on the card: {c}")
    *prompts, edge, over = disagg_prompts(c.vocab_size)
    itemsize = torch.empty((), dtype=c.dtype).element_size()

    def kv_bytes(p):
        # arithmetic: the raw KV a prompt's blocks hold
        return (c.n_layer * 2 * blocks_for_tokens(len(p), DISAGG_BLOCK)
                * DISAGG_BLOCK * c.d_model * itemsize)

    check(kv_bytes(edge) < DEFAULT_CHANNEL_BYTES < kv_bytes(over),
          f"the size-limit prompts do not straddle the channel: "
          f"{kv_bytes(edge)}, {kv_bytes(over)}, {DEFAULT_CHANNEL_BYTES}")

    ray_tpu_torch.init(num_cpus=4)
    out = {}
    try:
        # the two stages start in their worker processes (a torch import,
        # a CUDA context, GPT-2 small's init) while this process runs the
        # reference and the control; the thread that starts them only
        # waits on the runtime
        started = {}

        def start_stages():
            t0 = time.perf_counter()
            try:
                started["llm"] = DisaggLLM(
                    DISAGG_MODEL, block_size=DISAGG_BLOCK,
                    engine_config=DISAGG_ENGINE, seed=SEED, device=device)
                started["where"] = started["llm"].placement(timeout=300)
            except Exception as e:           # raised in this thread below
                started["error"] = e
            started["s"] = time.perf_counter() - t0

        starter = threading.Thread(target=start_stages, daemon=True)
        starter.start()

        # the reference: the in-process engine on the same weights, one
        # request at a time
        t_ref = time.perf_counter()
        engine_config = dict(DISAGG_ENGINE, block_size=DISAGG_BLOCK)
        engine = LLMEngine(model, params, EngineConfig(**engine_config))
        local, local_s = [], []
        for p in prompts + [edge]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = engine.add_request(p, max_tokens=MAX_TOKENS)
            engine.run_until_idle(timeout=600)
            local.append(st.tokens(timeout=1))
            local_s.append(time.perf_counter() - t0)
            check(st.finish_reason == "length", f"in-process engine: "
                  f"{st.finish_reason}")

        # the planted control, in this process: the same engine adopts a
        # prefill stage's blocks (the stage on the engine's own model and
        # weights) in reversed order, request by request until a stream
        # differs
        pre = PrefillStage((model, params), DISAGG_BLOCK,
                           buckets=DISAGG_ENGINE["prefill_buckets"])
        ctl_equal = []
        for p, want in zip(prompts, local):
            shipped = pre.prefill({"tokens": p, "max_tokens": MAX_TOKENS})
            st = engine.add_prefilled(
                shipped["prompt"], {n: t.flip(1).contiguous()
                                    for n, t in shipped["kv"].items()},
                shipped["first_token"], max_tokens=MAX_TOKENS)
            engine.run_until_idle(timeout=600)
            ctl_equal.append(st.tokens(timeout=1) == want)
            if not ctl_equal[-1]:
                break
        print(f"[disagg] control '{DISAGG_CONTROL}': streams equal "
              f"{ctl_equal} (stops at the first that differs)")
        check(not all(ctl_equal), f"control '{DISAGG_CONTROL}' passes the "
              f"stream-equality check")
        engine.pool.check_leaks()
        ref_s = time.perf_counter() - t_ref
        del engine, pre, model, params
        gc.collect()
        torch.cuda.empty_cache()

        starter.join(timeout=600)
        check(not starter.is_alive(), "the stages did not start in 600 s")
        if "error" in started:
            raise started["error"]
        llm, where, start_s = started["llm"], started["where"], started["s"]
        on_card = smi_pids()
        driver_listed = os.getpid() in on_card
        print(f"[disagg] stages up in {start_s:.1f} s, started beside "
              f"the reference and the control ({ref_s:.1f} s): {where}; "
              f"nvidia-smi compute pids {sorted(on_card)} (driver "
              f"{os.getpid()} {'listed' if driver_listed else 'not listed'})")
        for stage, w in where.items():
            check(w["device"].startswith("cuda")
                  and w["memory_allocated"] > 0,
                  f"the {stage} stage is not on the card: {w}")
            if driver_listed:
                # nvidia-smi sees this process's pid namespace
                check(w["pid"] in on_card,
                      f"the {stage} stage's pid {w['pid']} holds no "
                      f"context on the card: {sorted(on_card)}")
        check(where["prefill"]["pid"] != where["decode"]["pid"]
              and os.getpid() not in (where["prefill"]["pid"],
                                      where["decode"]["pid"]),
              f"the stages do not run in two worker processes: {where}")

        for f in wrappers:                   # the disagg path starts here
            f.launches = 0
        raw, reasons, raw_s, sent = run_disagg(llm, prompts + [edge])
        launches = {f.__name__: f.launches for f in wrappers}
        stage_launches = {stage: w["kernel_launches"] for stage, w in
                          llm.placement(timeout=60).items()}
        stats = llm.stats()
        print(f"[disagg] hand-written kernel launches of the raw run: "
              f"driver {launches}, stages {stage_launches}")
        for counts in [launches, *stage_launches.values()]:
            check(not any(counts.values()),
                  "the disagg path launched a hand-written kernel: its "
                  "paged prefill and decode are plain PyTorch")
        equal = [a == b for a, b in zip(raw, local)]
        print(f"[disagg] raw KV: streams equal to the in-process engine's "
              f"for {sum(equal)} of {len(equal)} requests (prompts "
              f"{[len(p) for p in prompts + [edge]]} tokens); decode "
              f"stats {stats}")
        check(all(equal), f"disaggregated streams differ from the "
              f"in-process engine's: {equal}")
        check(all(r == "length" for r in reasons), f"finish {reasons}")
        check(stats["kv_blocks_used"] == 0,
              f"the decode stage holds {stats['kv_blocks_used']} blocks")
        raw_kv = [kv_bytes(p) for p in prompts + [edge]]
        check(all(kv <= e < kv + 16384 for kv, e in zip(raw_kv, sent)),
              f"the prefill stage's envelopes {sent} do not carry the raw "
              f"KV {raw_kv} once")

        t0 = time.perf_counter()
        try:
            llm.generate(over, max_tokens=MAX_TOKENS, timeout=120)
            raised = None
        except ChannelFullError as e:
            raised = e
        over_s = time.perf_counter() - t0
        print(f"[disagg] {len(over)}-token prompt ({kv_bytes(over)} B of "
              f"KV) over the {DEFAULT_CHANNEL_BYTES} B channel: "
              f"{type(raised).__name__} after {over_s:.2f} s: {raised}")
        check(raised is not None, "an over-size KV shipment did not raise "
              "ChannelFullError")

        # the KV block-quantized on the wire: the graph compiled again
        # on the same two stages, as DisaggLLM(codec=...) compiles it
        codec_out = {}
        few = prompts[:DISAGG_CODEC_REQUESTS]
        t_codec = time.perf_counter()
        for codec in DISAGG_CODECS:
            llm.compile(codec)
            streams, reasons, _, codec_sent = run_disagg(llm, few)
            firsts = all(a[0] == b[0] for a, b in zip(streams, raw))
            same = sum(x == y for a, b in zip(streams, raw)
                       for x, y in zip(a[1:], b[1:]))
            total = sum(len(b) - 1 for b in raw[:len(few)])
            codec_out[codec] = dict(first_tokens_equal=firsts,
                                    decode_tokens_equal=same,
                                    decode_tokens=total,
                                    envelope_bytes=codec_sent)
            print(f"[disagg] codec {codec}: first tokens equal to the raw "
                  f"run's: {firsts}; decode tokens equal {same} of {total} "
                  f"({same / total:.4f}); finish {set(reasons)}; envelope "
                  f"bytes {codec_sent} (raw {sent[:len(few)]})")
            check(firsts, f"codec {codec}: a first token differs from the "
                  f"raw run's (it is taken before the wire)")
            check(all(r == "length" for r in reasons),
                  f"codec {codec}: finish {reasons}")
            # one byte an element and an f32 scale per 256, against
            # bf16's two: 0.508 of the raw envelope
            check(all(e < 0.55 * r for e, r in zip(codec_sent, sent)),
                  f"codec {codec}: envelopes {codec_sent} not under 0.55 "
                  f"of the raw run's {sent}")
        check(llm.stats()["kv_blocks_used"] == 0,
              "the decode stage holds blocks after the codec runs")
        codec_s = time.perf_counter() - t_codec
        t_down = time.perf_counter()
        llm.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    down_s = time.perf_counter() - t_down

    def p50max(xs):
        return statistics.median(xs), max(xs)

    print(f"[disagg] {card}: per-request generate() wall "
          f"{[round(t * 1e3, 1) for t in raw_s]} ms (p50 "
          f"{p50max(raw_s)[0] * 1e3:.1f}, max {p50max(raw_s)[1] * 1e3:.1f}); "
          f"KV envelope bytes the prefill stage wrote {sent} (p50 "
          f"{p50max(sent)[0]:.0f}, max {p50max(sent)[1]}; the raw KV "
          f"they carry {raw_kv}); in-process engine per-request wall "
          f"{[round(t * 1e3, 1) for t in local_s]} ms (p50 "
          f"{p50max(local_s)[0] * 1e3:.1f}, max "
          f"{p50max(local_s)[1] * 1e3:.1f}); the phase took "
          f"{time.perf_counter() - t_phase:.1f} s: the reference and the "
          f"control {ref_s:.1f}, the raw run {sum(raw_s):.1f} (generate), "
          f"the codec runs {codec_s:.1f}, shutdown {down_s:.1f}")
    out.update(start_s=start_s, placement=where, launches=launches,
               stage_launches=stage_launches, streams_equal=equal,
               over_raised=type(raised).__name__, over_s=over_s,
               control_equal=ctl_equal, codecs=codec_out,
               wall_s=raw_s, envelope_bytes=sent, local_wall_s=local_s,
               reference_s=ref_s, codec_s=codec_s, shutdown_s=down_s,
               card=card)
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
            serving["decode_split"] = decode_split(
                "Llama-2-7B", server.engine.model, server.engine.params)
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
        gc.collect()
        torch.cuda.empty_cache()
        moe_fwd = next(r for r in fwd_rows if r["label"] == MOE_CASE)
        moe_bwd = next(r for r in bwd_rows if r["label"] == MOE_CASE)
        moe_training = phase_moe_training(
            {"flash_fwd": moe_fwd["ms"], "flash_bwd": moe_bwd["ms"]})
        for path in (training, training_fused, moe_training):
            for name, n in path["launches"].items():
                check(n > 0, f"a training path never launched {name}")
        gc.collect()
        torch.cuda.empty_cache()
        vit = phase_vit(wrappers)
        gc.collect()
        torch.cuda.empty_cache()
        resnet = phase_resnet(wrappers)
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            head_dims = phase_head_dims()
            gpt_serving = phase_gpt_serving(wrappers)
        gc.collect()
        torch.cuda.empty_cache()
        disagg = phase_disagg(wrappers, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if server is not None:
            server.shutdown()
    print(f"[memory] peak allocated: {serving_peak_gib:.1f} GiB up to the "
          f"end of serving, {training['peak_memory_gib']:.1f} GiB in the "
          f"training steps, {training_fused['peak_memory_gib']:.1f} GiB in "
          f"the fused training steps, {moe_training['peak_memory_gib']:.1f} "
          f"GiB in the MoE training steps, {vit['peak_memory_gib']:.1f} GiB "
          f"in the ViT-B/16 steps")

    def disagg_launches(wrapper):
        # the driver's count and both stages' counts on the disagg path
        return disagg["launches"][wrapper.__name__] + sum(
            counts[wrapper.__name__]
            for counts in disagg["stage_launches"].values())

    fwd_launches = dict(serving=serving_launches,
                        training=training["launches"]["flash_fwd"],
                        training_fused=training_fused["launches"]["flash_fwd"],
                        moe_training=moe_training["launches"]["flash_fwd"],
                        gpt_serving=gpt_serving["launches"][
                            flash_attention_fwd.__name__],
                        disagg=disagg_launches(flash_attention_fwd))
    bwd_launches = dict(training=training["launches"]["flash_bwd"],
                        training_fused=training_fused["launches"]["flash_bwd"],
                        moe_training=moe_training["launches"]["flash_bwd"],
                        disagg=disagg_launches(flash_attention_bwd))

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
                "training_fused": training_fused["launches"][name],
                "disagg": disagg_launches(
                    ln_matmul_fwd if name == "ln_matmul"
                    else matmul_residual_fwd)},
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
               "moe_training": moe_training, "vit": vit, "resnet": resnet,
               "head_dims": head_dims, "gpt_serving": gpt_serving,
               "disagg": disagg,
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
