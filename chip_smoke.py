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
              fail; mm_res's f32-output instance (the tensor-parallel
              exits' partials) at GPT-2 small's tp=2 shapes on 8192 rows,
              timed beside torch.mm(out_dtype=float32) and the two adds,
              with and without b and res, and ln_matmul on the tp column
              shards; and matmul_residual's bf16 backward products against
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
13. pipeline — ray_tpu_torch.init, then GPT-2 small (as phase 5, seed 0)
              split by gpt_pipeline_stages into 2 stage actors on the card,
              each in its own worker process, trained by
              CompiledPipelineEngine (1F1B over 4 microbatches of 2
              sequences of 1024 tokens, the tied wte/head gradients
              exchanged, GPT-2's AdamW): 1 warm-up and 3 timed steps on one
              batch, while this process runs run_reference_1f1b on the
              same chunks and batches beside the stages' start-up. The
              step-0 loss is ln(50304) + 768 * 0.02^2 / 2 and GPT.loss on
              the same 8 sequences; the loss falls; the losses and final
              params equal the reference's bit for bit; a planted control
              (the reference without the tied exchange) must not; each
              stage launches flash_fwd and flash_bwd 24 times a step (6
              layers x 4 microbatches), read from the stage processes.
              Then the ZeRO dp update: dp=2 replicas of the same split
              (four stage processes an engine), 2 steps under SGD with
              momentum with zero_update on, off, and a planted control
              (the shard update without its 1/dp mean), three engines
              side by side: step-0 losses equal, the ZeRO step-1 loss
              within its limit of the replicated one's and the control's
              not, 0.4-0.62 of the replicated optimizer bytes. Prints the
              step wall p50 and tokens/s, the reference's step wall, each
              stage's forward, backward and update ms, the bytes on each
              edge a step, each stage's peak memory, and the phase's
              seconds.
14. tp      — right after phase 4, with the tp=1 server released:
              ray_tpu_torch.init(num_cpus=4), then LLMServer("llama2-7b",
              engine_config={"tp": 2}): two rank actors on the card in a
              gloo process group (NCCL refuses two ranks on one device),
              each holding 16 of the 32 heads, its FFN columns and
              vocabulary rows and its KV heads of every block, built from
              the seed-0 init one full tensor at a time. The dense flash
              apply at [1, 1024] on the ranks (32 flash launches each, at
              [1, 1024, 16, 128]) against phase 3's tp=1 logits with
              phase 3's limits, and a planted control (layer 0's w_o
              all-reduce skipped) that must fail them; each collective's
              cost at a decode step's shapes; then phase 4's 8 requests:
              every one finishes by length, no block leaks, and each
              step's logits agree with tp=1's within the same limits
              until the two streams part; KV bytes per rank half of
              tp=1's. Prints the decode step p50, TTFT and the requests'
              wall time beside tp=1's, where the streams part and tp=1's
              top-two margin there.

15. fsdp pipeline — inside phase 13's runtime, right after its P=2
              engine: the same split, params, microbatches, AdamW and 4
              steps at fsdp=2, each stage a gang of two rank processes on
              the card in a gloo group (the stage actor, which runs the
              chunk's forward and backward, and a peer holding the other
              half of the stage's flat params and moments; the stage
              gathers the params once a step and scatters the gradient's
              chunks at the update). The losses and final params equal
              phase 13's run_reference_1f1b result bit for bit; between
              steps each rank holds at most half of its stage's params and
              moments plus 64 B, and together what the fsdp=1 stage holds
              up to the padding; each stage process launches flash_fwd and
              flash_bwd 24 times a step, the peers none; every rank's
              shards and moments are on the card. A planted control (a
              second engine, started beside the first, whose stage 0 hands
              its peer the gradient chunk one element on) must differ by
              step 2. Then quantize_blocks / dequantize_blocks (the
              in-program ZeRO's codec) on a [4, 2^20] f32 tensor on the
              card, int8 and e4m3, bitwise equal to the CPU's. Prints the
              step p50 beside phase 13's, each stage's gather and update
              ms, each rank's bytes and the phase's seconds.

16. pp spmd — in a runtime of its own: GPT-2 small (as phase 13:
              the seed-0 init and batch, 4 microbatches of 2 sequences of
              1024 tokens) trained by GPT.loss_pp, backward and each
              rank's own AdamW step on the full params (1 warm-up and 3
              timed steps) by a gang of two gloo rank processes on the
              card at MeshSpec(pp=2): the in-program pipeline
              (pipeline_spmd: 5 ticks of 6 layers a rank, the ring
              ppermute between ticks, the psum of the outputs, the pvary
              sums in the backward, all staged through the host), beside
              the same steps at pp=1 in a one-rank gang. The step-0 loss
              is ln(50304) + 768 * 0.02^2 / 2 and GPT.loss_chunked on the
              same 8 sequences; the loss falls; the two ranks' losses,
              step-0 gradients and final params are bitwise equal; each
              loss and final param lies within its limit of pp=1's (bit
              for bit predicted; whether it held is printed); two planted
              controls (x_mb's cotangent not summed over pp; stage 1 fed
              one tick late) must fail those checks; each rank launches
              flash_fwd and flash_bwd 30 times a timed step. Prints the
              step p50 beside pp=1's, the ms a step of each collective
              kind, each rank's peak memory, one more step of each rank
              and of pp=1 under torch.profiler (device ms by kernel
              class, idle share) and the phase's seconds.
17. train   — last, in a runtime of its own: the train package on two
              gang workers on the card (gloo ranks of one world, the
              mesh's dp axis across them). Part A, GPT-2 small DDP by
              JaxTrainer: each rank holds phase 5's seed-0 params and
              takes 4 of phase 13's 8 sequences through
              get_dataset_shard; 1 + 3 steps of loss_chunked, backward,
              the gradient mean over dp (one flat f32 buffer through the
              host and gloo) and GPT-2's AdamW, a train.report each, rank
              0's last with a Checkpoint of its params. Held to one
              process here that takes each rank's shard's gradient in
              turn, averages them and steps the same AdamW: the step-0
              loss is ln(50304) + 768 * 0.02^2 / 2, the loss falls, the
              ranks are bitwise equal after every step, every mean loss,
              the step-0 mean gradient and every final param lie within
              their limits of the reference's (bit for bit predicted;
              whether it held is printed), the checkpoint fit persisted
              reads back bitwise rank 0's params (and wte in bf16), and
              each rank launches flash_fwd and flash_bwd 12 times a
              timed step; two planted controls (the all-reduce skipped;
              the sum not halved) must fail those checks. Part B,
              ResNet-18/CIFAR by TorchTrainer: phase 10's config and 128
              synthetic images, 64 a rank, the functional ResNet in an
              nn.Module through train.torch.prepare_model (DDP), 20 SGD
              steps; the loss falls, the ranks' params are bitwise equal
              after every step and within their limit of one process on
              the mean of the two shards' gradients, the batch-norm
              state moves, no hand-written kernel launches; the control
              (prepare_model bypassed) must part the ranks. Prints each
              part's step p50 beside its reference's, the gradient
              mean's ms and bytes, gang start-up, each rank's peak
              memory, the seconds of the fits and the ranks' reports,
              and the phase's seconds.
18. remat   — right after phase 6: GPT-2 small as phase 5 (B=40, S=1024,
              loss_chunked over 10 chunks, seed-0 params) with
              GPTConfig.remat off and on: one loss and backward each on
              the same batch, bitwise equal (else within the limit below,
              the largest difference printed), the same with dropout 0.1
              and one seed, and a planted control (masks drawn anew from
              the generator in the recompute) that must fail; then 1 + 3
              AdamW steps each: peak memory, step p50, flash launches a
              step (12 + 12 either way: the policy saves flash's out and
              lse). Then Llama at Llama-2-7B's width cut to 4 layers, B=1,
              S=4096: one loss and backward with remat off and on, the
              loss bitwise; peak memory above the params and the flash
              launches (full-block remat: 8 flash_fwd against 4).
19. tp train — after phase 16, in a runtime of its own: a gang of four
              gloo rank processes on the card. Part A, GPT-2 small
              (remat on, phase 16's seed-0 params and batch) by
              GPT(tp=2).loss_chunked on two ranks; its planted control
              (each row-parallel exit's backward summing the cotangent
              over tp); part B, GPT.loss_pp at MeshSpec(pp=2, tp=2) on
              four. Each rank holds its step-0 loss and gradient shards to
              the one-process loss_chunked / loss_pp it computes itself;
              the ranks of a pp group are bitwise equal and the
              replicated params equal on every rank; then 1 + 3 AdamW
              steps on each rank's shards. Part C, part A with
              fused_entry_exit=True, remat off and then on: ln_matmul on
              each rank's column shard, the row-parallel exits through
              mm_res's f32 instance (the bias and residual on tp rank 0,
              the f32 sum rounded once); its planted control (the exit's
              backward giving db and dres on rank 0 only). Part D, ring
              attention: GPT-2 small with seq_axis "sp" by gpt_sp_loss at
              MeshSpec(dp=2, sp=2) on four ranks (each 4 sequences of 512
              positions), held to one process's loss with use_flash=False
              on the whole batch, the four ranks bitwise equal; its
              planted control (the wrapped shards' mask dropped) must fail
              the loss check. Prints the step p50, the collectives' ms and
              bytes by kind (part D: the ring's ppermutes and the
              parameter-gradient sums), the launches a rank (flash 12 + 12
              a step in parts A and C, 30 + 30 in part B; ln_matmul and
              mm_res's f32 instance in part C; none in part D), peak
              memory, one profiled step's busy share per rank, and the
              phase's seconds.

Nineteen main paths are counted: serving (phases 3-4), training (phase
5's steps), fused training (phase 6's steps), MoE training (phase 8's
steps), ViT and ResNet training (phases 9-10, which launch no
hand-written kernel), GPT serving (phase 7's timed engine runs, which
launch none either; it runs after phase 11), disagg (phase 12's raw
run, none either: the driver's counts, zeroed just before it, and each
stage's, which start at zero with its process), pipeline (phase 13's
engine steps: the driver's counts, zeroed just before them, and each
stage's), the fsdp pipeline (phase 15's engine steps, counted so, with
its peers'), tp (phase 14's apply on the two ranks, counted on each
rank from just before it to just after it; the control's launches do
not count), pp spmd (phase 16's timed steps, counted on each rank
from just before them to just after them, and the driver's, zeroed
just before the run), train ddp (phase 17 part A's sound run, counted on
each rank from just before its timed steps to just after them, and the
driver's, zeroed just before the fit), train resnet (part B's sound
run, counted so; it launches none), remat (phase 18's remat-on timed
steps and its Llama remat-on step), tp train, pp tp, fused tp and sp
ring (phase 19's parts A-D, counted on each rank from just before their
timed steps to just after them, and the driver's, zeroed just before
each run; sp ring launches no hand-written kernel). Every
launch count is zeroed just before each and read just after it; the
kernel comparisons of phases 2 and 11, the gradient checks, phase 7's
dense reference forward, phase 13's in-process reference, phase 15's
control, phase 16's pp=1 run and controls, phase 17's references and
controls, phase 18's remat-off runs, one-step checks and control, and
phase 19's references and controls do not count.
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
# the shape phase 13's stages give the kernels (microbatches of 2
# sequences), appended last so the checks above keep their seeds
PIPE_CHECK = ("pipeline microbatch", (2, 1024, 12, 64), 1024, "bfloat16",
              True)
FWD_CHECKS.append(PIPE_CHECK)
BWD_CHECKS.append(PIPE_CHECK)
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
# The tensor-parallel fused path's shapes (phase 19 part C: GPT-2 small at
# tp=2 on phase 16's 8 x 1024 tokens, N = 8192), appended last so the
# cases above keep their seeds: mm_res's f32-output instance, the
# row-parallel exits' partials, timed with b and res (tp rank 0's call,
# "mm_res_f32"), checked without them (the other rank's, "mm_res_f32
# bare"), and ln_matmul on the column shards of w_qkv and w_fc. The f32
# output is held to f32's limits (summation order only). (label, kernel,
# N, K, F, dtype, timed)
TP_N = 8 * 1024
FUSED_TP_CASES = [
    ("tp proj", "mm_res_f32", TP_N, 384, 768, "bfloat16", True),
    ("tp MLP out", "mm_res_f32", TP_N, 1536, 768, "bfloat16", True),
    ("tp proj bare", "mm_res_f32 bare", TP_N, 384, 768, "bfloat16", False),
    ("tp MLP out bare", "mm_res_f32 bare", TP_N, 1536, 768, "bfloat16",
     False),
    ("tp QKV shard", "ln_matmul", TP_N, 768, 1152, "bfloat16", False),
    ("tp FC shard", "ln_matmul", TP_N, 768, 1536, "bfloat16", False),
    ("tp ragged f32", "mm_res_f32", 1000, 384, 768, "float32", False),
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
                                 "gemm_kernel<128, true",
                                 "gemm_kernel<256, true")),
                  # both instances of mm_res (bf16 out, f32 out)
                  ("mm_res", ("mm_res_f32_kernel", "gemm_kernel<128, false",
                              "gemm_kernel<256, false")),
                  ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
                  ("optimizer", ("multi_tensor_apply",)))
ENGINE_CONFIG = dict(max_batch=8, num_blocks=256, block_size=16,
                     max_blocks_per_seq=16, prefill_buckets=(16, 32, 64))
N_REQUESTS, MAX_TOKENS = 8, 32
# Phase 14, tensor-parallel Llama-2-7B: TP rank actors of the port's
# runtime on the one card (a gloo process group: NCCL refuses two ranks on
# one device), each building its shard from the seed-0 init the tp=1
# server used. The dense apply at [1, 1024] is held to the tp=1 server's
# logits with the forward phase's limits (TOL_LOGITS, TOL_LOGITS_RMS), and
# a planted control (the first row-parallel all-reduce, layer 0's w_o,
# skipped on every rank) must fail them (on the H100: sound 0.3038 max
# abs / 0.0409 rms of the std, control 9.6205 / 1.3374). The serving
# requests of phase 4 are teacher-forced on tp=1's tokens (the engine
# emits tp=1's token at each step and decodes on from it), so every one
# of their N_REQUESTS x MAX_TOKENS steps sees tp=1's context, and each
# step's logits are held to tp=1's with the same limits. tp=2's logits
# differ from tp=1's by bf16 noise of about 0.3 max abs, which can swap
# a top two that tp=1 holds apart by more than phase 7's near-tie limit
# TOL_GPT_LOGITS (a free-running request parted at a tp=1 margin of
# 0.2430), so where tp=2's own choice differs is printed, and must lie
# where tp=1's margin is at most twice that step's max abs error. A
# planted control in the decode path (TP_KV_CONTROL) must fail the step
# check. TP_COLLECTIVE_REPS timed calls of each collective at a decode
# step's shapes give its cost.
TP = 2
TP_CONTROL = "first row-parallel all-reduce skipped"
TP_KV_CONTROL = "rank 1's KV heads reversed in the decode steps"
TP_COLLECTIVE_REPS = 20
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
# Pipeline-parallel training (phase 13): GPT-2 small split by
# gpt_pipeline_stages into PIPE_STAGES stage actors on the card, 1F1B over
# PIPE_MICROBATCHES microbatches of PIPE_MB sequences of TRAIN_SEQ tokens,
# GPT-2's AdamW; PIPE_WARMUP + PIPE_STEPS steps on one batch, held bit for
# bit to run_reference_1f1b in this process (a planted control, the same
# reference without the tied exchange, must differ). The step-0 loss is
# held to TOL_LOSS0 of ln(V) + d_model * 0.02^2 / 2 and to
# TOL_PIPE_FULL_LOSS of GPT.loss over the same sequences (the bound of
# tests/test_pipeline_cgraph.py:188-189). Every channel carries
# PIPE_CHANNEL_SLACK bytes over the largest hop, the tied wte gradient
# (f32 [V, d_model]). The whole stage split's launches: flash_fwd and
# flash_bwd once per layer and microbatch.
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_MB = 2, 4, 2
PIPE_WARMUP, PIPE_STEPS = 1, 3
TOL_PIPE_FULL_LOSS = 1e-3
PIPE_CHANNEL_SLACK = 1 << 20
PIPE_CONTROL = "reference without the tied exchange"
# The ZeRO dp update on the card: PIPE_DP replicas of the same split
# (PIPE_STAGES * PIPE_DP stage processes), PIPE_DP_MICROBATCHES each (the
# same sequences), PIPE_DP_STEPS steps with zero_update on and off, and a
# planted control (the ZeRO update without its 1/dp mean), three engines
# side by side. Under SGD with momentum: Adam's update does not change
# when every gradient is scaled, so a skipped mean would not show in its
# losses. The step-0 losses must be equal; the step-1 loss of the ZeRO
# run must lie within TOL_ZERO_LOSS1 (absolute) of the replicated run's,
# and the control's must not; each ZeRO replica holds 0.4-0.62 of the
# replicated optimizer bytes (tests/test_pipeline_cgraph.py:269-271).
PIPE_DP, PIPE_DP_MICROBATCHES, PIPE_DP_STEPS = 2, 2, 2
PIPE_DP_LR, PIPE_DP_MOMENTUM = 0.1, 0.9
TOL_ZERO_LOSS1 = 1e-4
ZERO_OPT_BYTES = (0.4, 0.62)
ZERO_CONTROL = "ZeroUpdater without the 1/dp mean"
# the object store holds the channels' segments (sparse until written)
# and the dp collectives' rows
PIPE_OBJECT_STORE = 48 << 30
# Phase 15: the same split, microbatches, params, optimizer and steps at
# fsdp=FSDP (each stage a gang of FSDP rank processes on the card), held
# bit for bit to phase 13's run_reference_1f1b result; each rank holds at
# most FSDP_BYTES_SLACK bytes over 1/FSDP of its stage's params and
# moments between steps. The planted control (a second engine, its stage
# 0 handing rank 1 the gradient chunk one element on) must differ by
# step FSDP_CONTROL_STEPS. The quantizer of the in-program ZeRO on the
# card: QUANT_SHAPE f32 at QUANT_BLOCK, bitwise the CPU's.
FSDP = 2
FSDP_BYTES_SLACK = 64
FSDP_CONTROL = "rank 1's gradient chunk taken one element on"
FSDP_CONTROL_STEPS = 2
QUANT_SHAPE, QUANT_BLOCK = (4, 1 << 20), 256
# The in-program pipeline (phase 16): GPT-2 small's seed-0 init and
# batch (as phase 13: PP_SPMD_MICROBATCHES microbatches of PP_SPMD_MB
# sequences of TRAIN_SEQ tokens), trained by GPT.loss_pp + backward +
# each rank's own AdamW step on the full params (TRAIN_LR, TRAIN_WD) by
# a gang of PP_SPMD gloo rank processes on the card at MeshSpec(pp=2),
# beside the same steps at pp=1 in a one-rank gang. The ranks must be
# bitwise equal to each other (losses, step-0 gradients, final params);
# each step's loss within TOL_PP_LOSS and every final param within
# TOL_PP_PARAM (absolute) of pp=1's, bit for bit predicted. The two
# controls must fail them: with x_mb's cotangent not summed over pp, rank
# 1's wte/wpe gradients hold no embedding part (its wpe moves by about lr
# a step less than pp=1's: 1.2e-3 after 4 steps); stage 1 fed one tick
# late moves the step-0 loss. Each rank launches flash_fwd and flash_bwd
# (M + P - 1) * L / P = 30 times a step: the ticks that carry no
# microbatch are computed, as in the reference.
PP_SPMD, PP_SPMD_MICROBATCHES, PP_SPMD_MB = 2, 4, 2
PP_SPMD_WARMUP, PP_SPMD_STEPS = 1, 3
TOL_PP_LOSS = 1e-4
TOL_PP_PARAM = 1e-5
PP_SUM_CONTROL = "x_mb's cotangent not summed over pp"
PP_LATE_CONTROL = "stage 1 fed one tick late"
PP_COLLECTIVES = (("tick", "tick ppermutes"),
                  ("tick.T", "their transposes"),
                  ("output", "output psum"),
                  ("x_mb.T", "embedding cotangent psum"),
                  ("stage_params.T", "stage-gradient sum"))
# The train package (phase 17), in a runtime of its own: TRAIN_WORKERS
# gang workers on the card (rank r on card r % device_count, all on the
# one card here; gloo lets them share it).
# Part A, GPT-2 small DDP by JaxTrainer (examples/gpt2_ddp_train.py at
# full width): every rank holds phase 5's seed-0 params and takes its
# TRAIN_DDP_SEQS / TRAIN_WORKERS sequences of phase 13's batch through
# get_dataset_shard; a step runs loss_chunked, backward, the mean of the
# gradients over the mesh's dp axis (one flat f32 buffer, through the
# host and gloo) and GPT-2's AdamW; DDP_WARMUP + DDP_STEPS steps, a report
# each, rank 0's last with a Checkpoint of its params (and wte in bf16).
# Held to one process on the card that takes each rank's shard's gradient
# in turn, averages them and steps the same AdamW: every mean loss within
# TOL_DDP_LOSS, the step-0 mean gradient within TOL_DDP_GRAD (the largest
# error of a tensor over its largest |value|) and every final param within
# TOL_DDP_PARAM (absolute), bit for bit predicted (both add the same two
# f32 gradients; halving is exact); the ranks bitwise equal after every
# step. Two planted controls, run in the same gang after the sound run,
# must fail those checks: the all-reduce skipped (each rank steps on its
# own shard: the ranks part, and the step-0 gradient is one shard's) and
# the sum not halved (the step-0 gradient twice the mean; AdamW all but
# cancels the factor, yet through eps its params part by 9.1e-4 on the
# H100). Each rank launches flash_fwd and flash_bwd 12 times a timed
# step. The limits sit between the sound run (bit for bit on the H100)
# and the controls (there: losses off by 0.63 and 4.7e-4, step-0
# gradients by 1.27 and 1.0, params by 2.4e-3 and 9.1e-4).
# Part B, ResNet-18/CIFAR by TorchTrainer (BASELINE's 2-worker config):
# phase 10's config, SGD lr and momentum, RESNET_BATCH synthetic images
# dealt to the ranks as a dataset (RESNET_BATCH / TRAIN_WORKERS a rank),
# the functional ResNet wrapped in an nn.Module and passed through
# train.torch.prepare_model (DDP over the gang's gloo world),
# RESNET_DDP_STEPS steps with cuDNN deterministic: phase 10's 20, since
# at its lr the loss first rises (4 steps took it from 2.30 to 3.14 on
# the H100) and falls below its start after about 12. The ranks' params
# bitwise equal after every step and within TOL_RESNET_DDP_PARAM of one
# process stepping on the mean of the two shards' gradients; the
# batch-norm state moves; no hand-written kernel launches. The control
# (prepare_model bypassed) must part the ranks.
TRAIN_WORKERS, TRAIN_DDP_SEQS = 2, 8
DDP_WARMUP, DDP_STEPS = 1, 3
TOL_DDP_LOSS = 1e-4
TOL_DDP_GRAD = 1e-6
TOL_DDP_PARAM = 1e-5
DDP_SKIP_CONTROL = "all-reduce skipped"
DDP_HALF_CONTROL = "sum not halved"
RESNET_DDP_STEPS = RESNET_STEPS
TOL_RESNET_DDP_PARAM = 1e-4
RESNET_DDP_CONTROL = "prepare_model bypassed"
TRAIN_COLLECTIVE_REPS = 3
# Remat (phase 18). Part 1: GPT-2 small as phase 5 (seed-0 params, B =
# TRAIN_BATCH, S = TRAIN_SEQ, loss_chunked over HEAD_CHUNK_ROWS-row chunks,
# GPT-2's AdamW) with remat off and on: one loss and backward each on the
# same batch, and the same with dropout REMAT_DROPOUT and one generator
# seed. The losses and every gradient are bitwise equal (the recompute
# runs the same ops on the same values; the dropout masks come from a
# generator seeded per layer); where they are not, the largest relative
# difference (of a tensor's largest |value|) is printed and held to
# TOL_REMAT. The planted control REMAT_CONTROL (each block drawing its
# masks from the model's one generator, which the recompute has moved
# on) must fail it. Then REMAT_WARMUP + REMAT_STEPS AdamW steps each:
# peak memory, step p50 and flash launches a step (GPT's policy saves
# flash's out and lse, so 12 flash_fwd a step either way). Part 2: Llama
# at Llama-2-7B's width (d_model 4096, 32 heads of 128, d_ff 11008,
# vocab 32000), cut to REMAT_LLAMA_LAYERS layers, B=1, S =
# REMAT_LLAMA_SEQ, bf16, seed-0 params: one loss and backward with remat
# off and on; the loss bitwise, the gradients as above; the full-block
# remat launches flash_fwd twice a layer.
REMAT_WARMUP, REMAT_STEPS = 1, 3
TOL_REMAT = 1e-6
REMAT_DROPOUT = 0.1
REMAT_CONTROL = "dropout masks drawn anew in the recompute"
REMAT_LLAMA_LAYERS, REMAT_LLAMA_SEQ = 4, 4096
# Tensor-parallel training (phase 19), in a runtime of its own: a gang of
# TP_TRAIN_RANKS gloo rank processes on the card, GPT-2 small (remat on)
# from the seed-0 init and phase 16's batch. Part A: GPT(tp=TP_TRAIN)
# .loss_chunked over PP_SPMD_MICROBATCHES chunks on two ranks; part B:
# loss_pp at pp=PP_SPMD x tp=TP_TRAIN over PP_SPMD_MICROBATCHES
# microbatches on four. Each rank computes the one-process reference
# (loss_chunked, or loss_pp at pp=1) on the full params and holds its
# step-0 loss within TOL_TP_LOSS of it and each of its gradient shards
# (GPT.shard_param of the reference's) within TOL_TP_GRAD, as
# ||g - g_ref|| / ||g_ref|| per parameter (w_qkv and b_qkv per third,
# b_qkv's key third left out: phase 5's measure). In bf16 the split
# rounds at other places than one process (the row-parallel partials are
# summed in f32, the column-parallel inputs' cotangents are bf16 partials
# summed over tp), as phase 5's flash and reference models do; the
# forward differs only where an f32 sum in another order rounds to
# another bf16 value. The planted control TP_TRAIN_CONTROL (the gradient
# through each row-parallel exit counted tp times) must fail the gradient
# check. The ranks of a pp group are bitwise equal, and the replicated
# params bitwise equal on every rank. Then TP_TRAIN_WARMUP +
# TP_TRAIN_STEPS AdamW steps on each rank's shards.
TP_TRAIN, TP_TRAIN_RANKS = 2, 4
TP_TRAIN_WARMUP, TP_TRAIN_STEPS = 1, 3
TOL_TP_LOSS = 1e-3
TOL_TP_GRAD = 0.1
TP_TRAIN_CONTROL = "row-parallel exit's cotangent summed over tp"
TP_SPLIT_PARAMS = ("wte", "w_qkv", "b_qkv", "w_proj", "w_fc", "b_fc",
                   "w_out")
# Part C: part A with GPTConfig.fused_entry_exit, remat off and then on
# (each from the same shards and one reference, the one-process fused
# loss_chunked): ln_matmul on each rank's column shard of w_qkv and w_fc,
# each row-parallel exit through the f32 instance of mm_res (tp rank 0
# adding the bias and the residual), summed in f32 over tp and rounded
# once. The limits are part A's. The planted control TP_FUSED_CONTROL
# (the exit's backward giving the bias and residual cotangents on tp rank
# 0 only, as autograd would if left to follow the forward) must fail the
# gradient check.
TP_FUSED_CONTROL = "fused exit's db and dres on tp rank 0 only"
# phase 19's sound paths, as the kernels line names them
TP_TRAIN_PATHS = ("tp_train", "pp_tp", "fused_tp", "sp_ring")
# Part D: ring attention. GPT-2 small with seq_axis "sp" (remat on) on all
# four ranks at MeshSpec(dp=SP_DP, sp=SP): phase 16's batch (8 x 1024),
# each rank 4 sequences of 512 positions (global positions), the tied
# head over SP_HEAD_CHUNKS chunks, the loss a mean over dp and sp, the
# params replicated and entering through pvary over dp and sp, so every
# rank steps AdamW on the full gradient. Held to one process's GPT.loss
# with use_flash=False on the whole batch: the step-0 loss within
# TOL_SP_LOSS and every parameter's gradient within TOL_TP_GRAD (as part
# A); the four ranks bitwise equal. The loss check also holds each
# token's cross entropy (before any step, through GPT.apply on each rank's
# chunk at its global positions) to the reference's: the root mean square
# of the difference over the batch at most TOL_SP_TOKEN_RMS. The planted
# control SP_CONTROL (the wrapped shards' mask dropped: the first half's
# queries see the second half's keys) must fail the loss check. The mean
# loss alone cannot see it: the leak moves each token's loss by either
# sign (on the CPU at full width in f32, B=2: rms 0.158 over the batch,
# at most 0.87), so the mean moves by a random walk (3.6e-3 there, 2.1e-4
# on the H100 at B=8 against the sound run's 4.1e-5); bf16 against f32
# moves a token by rms 0.006 there.
SP_DP, SP, SP_HEAD_CHUNKS = 2, 2, 4
TOL_SP_LOSS = 1e-3
TOL_SP_TOKEN_RMS = 0.05
SP_CONTROL = "wrapped shards' mask dropped"


class SmokeFailure(Exception):
    pass


class SkipMeanSGD:
    """The ZeRO check's planted control, as an optimizer factory: its SGD
    multiplies every gradient by ``dp`` before the step, so a ZeroUpdater
    built on it updates its shard with the sum of the replicas' gradients
    — the update of a ZeroUpdater that skips the 1/dp mean. Picklable: the
    stage processes build it."""

    def __init__(self, dp, **sgd):
        self.dp = dp
        self.sgd = sgd

    def __call__(self, params):
        import torch

        dp = self.dp

        class SumSGD(torch.optim.SGD):
            @torch.no_grad()
            def step(self, closure=None):
                for group in self.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.mul_(dp)
                return super().step(closure)

        return SumSGD(params, **self.sgd)


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
    [n, k], w [k, f], b [f], res [n, f]; "mm_res_f32": b and the output
    f32): each input read once, the output [n, f] written once; the
    product's 2*n*k*f FLOPs at the operand type's rate (the layernorm's
    and the epilogue's f32 work, under 0.5 GFLOP at these shapes, takes
    less time at the f32 rate than the product)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    if kernel == "ln_matmul":
        moved = (n * k + k * f + f + n * f) * itemsize + 2 * k * 4
    elif kernel == "mm_res_f32":
        # a, w, res in their type, b in f32, out in f32
        moved = (n * k + k * f + n * f) * itemsize + f * 4 + n * f * 4
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
    or residual (mm_res); "mm_res_f32" as mm_res, left in f32."""
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
    out_dtype = torch.float32 if kernel == "mm_res_f32" else a.dtype
    if fault == FUSED_CONTROLS[0]:
        return (a.to(f8).float() @ w.float() + b.float()
                + res.float()).to(out_dtype)
    return (a.float() @ w.float() + b.float()
            + res.float().roll(-8, 0)).to(out_dtype)


def phase_kernels_fused():
    """ln_matmul and mm_res against their plain versions at the training
    path's shapes, timed beside the plain version and beside the cuBLAS
    composition of the same function (there is no single PyTorch call:
    addmm(wb, layer_norm(x), w) and addmm(res + b, a, w)), with the ratio
    to the composition and the share of the bound printed against the
    bars (not enforced: at most 1.0x the composition; at least 50% of the
    bound at FC and MLP out); untimed checks at f32 and at other shapes;
    every case run twice, bitwise equal; then matmul_residual's backward
    products in bf16 against the f32 products they stand for. The
    tensor-parallel cases (FUSED_TP_CASES) include mm_res's f32-output
    instance, timed beside torch.mm(a, w, out_dtype=float32) and the two
    adds."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import (ln_matmul_fwd, ln_matmul_plain,
                                   matmul_partial_f32_fwd,
                                   matmul_partial_f32_plain,
                                   matmul_residual_fwd, matmul_residual_plain)

    fns = {"ln_matmul": (ln_matmul_fwd, ln_matmul_plain),
           "mm_res": (matmul_residual_fwd, matmul_residual_plain),
           "mm_res_f32": (matmul_partial_f32_fwd, matmul_partial_f32_plain),
           "mm_res_f32 bare": (matmul_partial_f32_fwd,
                               matmul_partial_f32_plain)}
    rows = []
    cases = [(label, kernel, n, k, f, "bfloat16", True)
             for label, kernel, n, k, f in FUSED_CASES]
    cases += [(*case, False) for case in FUSED_CHECKS]
    cases += FUSED_TP_CASES
    for i, (label, kernel, n, k, f, dtype, timed) in enumerate(cases):
        args = fused_inputs("ln_matmul" if kernel == "ln_matmul"
                            else "mm_res", n, k, f, dtype, SEED + 200 + i)
        if kernel == "mm_res_f32 bare":      # a tp rank past 0: no b, res
            args = args[:2]
        fn, plain = fns[kernel]
        f32_out = kernel.startswith("mm_res_f32")
        out_dtype = torch.float32 if f32_out else args[0].dtype
        tol_key = "float32" if f32_out else dtype
        out = fn(*args)
        torch.cuda.synchronize()
        # no split-K, no atomics: a second call is bitwise equal
        check(torch.equal(out, fn(*args)),
              f"{kernel} {label}: the output differs between two calls")
        ref = plain(*args)
        check(out.shape == (n, f) and out.dtype == out_dtype,
              f"{kernel} {label}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out.float()).all()),
              f"{kernel} {label}: non-finite output")
        err_abs = (out.float() - ref.float()).abs().max().item()
        scaled, rms = fused_errors(out, ref)
        text = (f"{kernel} {label} [{n}, {k}] x [{k}, {f}] {dtype}"
                f"{' -> f32' if f32_out else ''}: bitwise "
                f"equal over two calls; max abs "
                f"err {err_abs:.3e}, scaled {scaled:.3e} (tol "
                f"{TOL_FUSED[tol_key]}), rms {rms:.3e} (tol "
                f"{TOL_FUSED_RMS[tol_key]})")
        row = dict(label=label, kernel="ln_matmul" if kernel == "ln_matmul"
                   else "mm_res", shape=[n, k, f], dtype=dtype,
                   max_abs_err=err_abs, scaled_err=scaled, rms_err=rms)
        if f32_out:
            row["instance"] = "f32 out" + (", no b or res"
                                           if kernel.endswith("bare") else "")
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
            elif f32_out:
                # tensor_parallel.matmul_f32's product, then the adds
                a, w, b, res = args
                b32 = b.float()
                lib_ms = cuda_ms(lambda: torch.mm(
                    a, w, out_dtype=torch.float32).add_(b32).add_(res),
                    reps=20)
            else:
                a, w, b, res = args
                lib_ms = cuda_ms(lambda: torch.addmm(res + b, a, w), reps=20)
            bound_ms, bound_by = fused_bound(kernel, n, k, f, dtype)
            bars = [f"{ms / lib_ms:.2f}x the composition (bar 1.0x: "
                    f"{'met' if ms <= lib_ms else 'not met'})"]
            if label == FUSED_MAIN.get(kernel):
                bars.append(f"bar 50% of bound: "
                            f"{'met' if bound_ms / ms >= 0.5 else 'not met'}")
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       over_library=ms / lib_ms, bound_share=bound_ms / ms,
                       controls={c: dict(scaled_err=e[0], rms_err=e[1])
                                 for c, e in controls.items()})
            text += "".join(f"; control ({c}): scaled {e[0]:.3e}, rms "
                            f"{e[1]:.3e}" for c, e in controls.items())
            lib_name = "mm(out f32) + adds" if f32_out \
                else "cuBLAS composition"
            text += (f"; kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} "
                     f"ms, bound {bound_ms:.4f} ms ({bound_by}); "
                     f"{bound_ms / ms:.1%} of bound; " + "; ".join(bars))
        print(f"[kernels] {text}")
        check(fused_agrees(scaled, rms, tol_key),
              f"{kernel} {label} disagrees with its plain version")
        for fault, e in controls.items():
            check(not fused_agrees(*e, tol_key),
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


def phase_forward(server, tp_ref):
    """Phase 3: Llama-2-7B's flash apply at S=1024 and 4096 against the
    mha_reference forward and its planted controls. Keeps the [1, 1024]
    tokens and logits on the host in ``tp_ref`` (phase 14 holds the
    tensor-parallel apply to them)."""
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
        if s == 1024:
            tp_ref["apply"] = (tokens.cpu(), logits.float().cpu())
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


def top2_margin(logits):
    """Top-two logit margin of each row (on the host)."""
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu()


def record_prefills(engine):
    """Wrap an engine's prefill program: -> {prompt tuple: (its logits on
    the host, when they were there, the prefill's seconds)}. Phases 4 and
    14 take TTFT from the client's submit to that time."""
    prefills = {}
    run_prefill = engine._prefill_fn

    def recording_prefill(params, cache, tokens, length, block_row):
        t0 = time.perf_counter()
        logits, cache = run_prefill(params, cache, tokens, length, block_row)
        host = logits.float().cpu()          # waits for the device
        done = time.perf_counter()
        prefills[tuple(tokens[0, :length].tolist())] = (host, done,
                                                        done - t0)
        return logits, cache

    engine._prefill_fn = recording_prefill
    return prefills


def force_streams(engine, streams):
    """Teacher forcing: every token an engine emits for a prompt is
    replaced by that prompt's token in ``streams`` (prompt tuple -> tokens)
    at the same step, and decoding goes on from it. -> {request id: the
    tokens the engine chose itself}."""
    own = {}
    emit = engine._emit

    def forced(seq, tok):
        want = streams[tuple(seq.req.prompt)][len(seq.req.generated)]
        own.setdefault(seq.req.request_id, []).append(tok)
        seq.pending = want
        emit(seq, want)

    engine._emit = forced
    return own


def record_step_logits(engine):
    """Wrap an engine's prefill and decode programs (outside any timing
    wrapper already installed) and its ``_start_sequence``: -> {request
    id: [the f32 logits behind each token it emits, on the host]}, the
    prefill's first, then one row per decode step."""
    rows, last = {}, {}
    prefill, decode = engine._prefill_fn, engine._decode_fn
    start_sequence = engine._start_sequence

    def recorded_prefill(*args):
        logits, cache = prefill(*args)
        last["row"] = logits.float().cpu()
        return logits, cache

    def recorded_decode(*args):
        slots = {seq.slot: seq.req.request_id for seq in engine._running}
        logits, cache = decode(*args)
        host = logits.float().cpu()
        for slot, rid in slots.items():
            rows[rid].append(host[slot])
        return logits, cache

    def started(req, blocks, p, tok):
        rows[req.request_id] = [last["row"]]
        start_sequence(req, blocks, p, tok)

    engine._prefill_fn, engine._decode_fn = recorded_prefill, recorded_decode
    engine._start_sequence = started
    return rows


def phase_serving(server, tp_ref):
    """Phase 4: LLMServer("llama2-7b") answers N_REQUESTS concurrent
    requests. Keeps the prompts, each request's tokens and the logits
    behind each token, the decode step p50, TTFT and the KV cache's bytes
    in ``tp_ref`` (phase 14 serves the same requests at tp=2 and holds
    them to these)."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import flash_attention_fwd

    engine = server.engine
    model, params = engine.model, engine.params
    prefills = record_prefills(engine)
    decode_log = []          # (seconds, active slots)
    run_decode = engine._decode_fn

    def timed_decode(*args):
        t0 = time.perf_counter()
        logits, cache = run_decode(*args)
        torch.cuda.synchronize()
        decode_log.append((time.perf_counter() - t0, int(args[5].sum())))
        return logits, cache

    engine._decode_fn = timed_decode
    step_logits = record_step_logits(engine)
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
    tp_ref["serving"] = dict(
        prompts=prompts, tokens=[r["tokens"] for r in results],
        logits=[step_logits[r["request_id"]] for r in results],
        decode_step_p50_s=out["decode_step_p50_s"],
        ttft_p50_s=out["ttft_p50_s"], wall_s=wall,
        kv_bytes=engine.kv_bytes_per_chip()[0])
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


def remat_control_layer(self, x, lp, seed):
    """REMAT_CONTROL, swapped in for GPT._layer: each block draws its
    dropout masks from the model's one generator (``_control_gen``), so
    the recompute draws new ones."""
    from ray_tpu_torch.ops.remat import remat

    def block(x, lp):
        return self._block(x, lp, self._control_gen)

    if self.config.remat:
        return remat(block, x, lp, saved=self.REMAT_SAVED)
    return block(x, lp)


def remat_difference(a, b):
    """(bitwise equal, the largest |a - b| over the largest |b| of any
    tensor, its name) of two {name: tensor} dicts."""
    import torch

    same = all(torch.equal(a[n], b[n]) for n in b)
    worst = max((float((a[n] - b[n]).abs().max())
                 / max(float(b[n].abs().max()), 1e-30), n) for n in b)
    return same, worst[0], worst[1]


def phase_remat(wrappers):
    """Phase 18: remat at full width (module docstring). Part 1, GPT-2
    small as phase 5 with remat off and on: one loss and backward each on
    the same batch (bitwise, else within TOL_REMAT), then REMAT_WARMUP +
    REMAT_STEPS AdamW steps each (peak memory, step p50, flash launches
    a step); the dropout case, and its planted control, which must fail.
    Part 2, Llama at Llama-2-7B's width cut to REMAT_LLAMA_LAYERS layers:
    one loss and backward each. The launch counts of ``wrappers`` are
    zeroed just before each remat-on run and read just after it (the
    remat path); the remat-off runs and the controls do not count."""
    import torch

    from ray_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig

    t_phase = time.perf_counter()
    fwd, bwd = wrappers[:2]
    remat_launches = {f.__name__: 0 for f in wrappers}

    def counted(fn, count):
        """fn(), and the launches of ``wrappers`` while it ran."""
        before = {f.__name__: f.launches for f in wrappers}
        out = fn()
        torch.cuda.synchronize()
        got = {f.__name__: f.launches - before[f.__name__]
               for f in wrappers}
        if count:
            for name, n in got.items():
                remat_launches[name] += n
        return out, got

    # ---- part 1: GPT-2 small ----------------------------------------------
    base = GPTConfig.small(use_flash=True)
    check((base.n_layer, base.d_model, base.n_head, base.head_dim,
           base.padded_vocab, base.remat) == (12, 768, 12, 64, 50304, True),
          f"not GPT-2 small with remat on by default: {base}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = {n: p.requires_grad_()
              for n, p in GPT(base).init(gen).items()}
    tokens = torch.randint(0, base.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device="cuda")
    targets = torch.roll(tokens, -1, dims=1)
    num_chunks = TRAIN_BATCH * TRAIN_SEQ // HEAD_CHUNK_ROWS
    names = list(params)

    def loss_and_grads(model, seed=None):
        g = None
        if seed is not None:
            g = torch.Generator(device="cuda")
            g.manual_seed(seed)
        loss = model.loss_chunked(params, tokens, targets, generator=g,
                                  num_chunks=num_chunks)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def pair(dropout=0.0, control=False):
        """(loss off, loss on, bitwise, worst relative difference, its
        tensor) of one loss and backward at remat off and on."""
        out = {}
        for on in (False, True):
            model = GPT(dataclasses.replace(base, remat=on,
                                            dropout=dropout))
            if control:
                model._control_gen = torch.Generator(device="cuda")
                model._control_gen.manual_seed(SEED + 18)
            out[on] = loss_and_grads(model, SEED + 18 if dropout else None)
        (l0, g0), (l1, g1) = out[False], out[True]
        same, worst, where = remat_difference(
            {"loss": l1, **g1}, {"loss": l0, **g0})
        return float(l0), float(l1), same, worst, where

    sound = pair()
    dropped = pair(REMAT_DROPOUT)
    sound_gpt_layer = GPT._layer
    GPT._layer = remat_control_layer
    try:
        control = pair(REMAT_DROPOUT, control=True)
    finally:
        GPT._layer = sound_gpt_layer

    steps = {}
    for on in (False, True):
        model = GPT(dataclasses.replace(base, remat=on))
        run_params = {n: p.detach().clone().requires_grad_()
                      for n, p in params.items()}
        opt = torch.optim.AdamW(run_params.values(), lr=TRAIN_LR,
                                weight_decay=TRAIN_WD)
        losses, walls, per_step = [], [], []

        def step():
            opt.zero_grad(set_to_none=True)
            loss = model.loss_chunked(run_params, tokens, targets,
                                      num_chunks=num_chunks)
            loss.backward()
            opt.step()
            return loss.detach()

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(REMAT_WARMUP + REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, got = counted(step, on and i >= REMAT_WARMUP)
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
            per_step.append(got)
        steps[on] = dict(
            losses=losses, walls=walls, launches_per_step=per_step,
            step_p50_ms=statistics.median(walls[REMAT_WARMUP:]) * 1e3,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del opt, run_params
    del params
    gc.collect()
    torch.cuda.empty_cache()

    want = {fwd.__name__: base.n_layer, bwd.__name__: base.n_layer}
    for on in (False, True):
        r = steps[on]
        print(f"[remat] GPT-2 small B={TRAIN_BATCH} S={TRAIN_SEQ} remat="
              f"{on}: step walls {[round(t * 1e3, 2) for t in r['walls']]}"
              f" ms (p50 of the {REMAT_STEPS} timed {r['step_p50_ms']:.2f}"
              f" ms), peak allocated {r['peak_gib']:.2f} GiB, losses "
              f"{[round(x, 4) for x in r['losses']]}, launches a step "
              f"{r['launches_per_step'][-1]}")
    print(f"[remat] one loss and backward, remat off vs on: losses "
          f"{sound[0]!r} / {sound[1]!r}, bitwise {sound[2]}, worst "
          f"relative difference {sound[3]:.3e} ({sound[4]}); with dropout "
          f"{REMAT_DROPOUT}: losses {dropped[0]!r} / {dropped[1]!r}, "
          f"bitwise {dropped[2]}, worst {dropped[3]:.3e} ({dropped[4]}); "
          f"control '{REMAT_CONTROL}': bitwise {control[2]}, worst "
          f"{control[3]:.3e} ({control[4]})")
    for label, r in (("remat off vs on", sound),
                     (f"dropout {REMAT_DROPOUT}", dropped)):
        check(r[2] or r[3] <= TOL_REMAT,
              f"remat: {label} differ by {r[3]} in {r[4]} (limit "
              f"{TOL_REMAT})")
    check(not control[2] and control[3] > TOL_REMAT,
          f"control '{REMAT_CONTROL}' passes the remat check")
    for on in (False, True):
        r = steps[on]
        check(all(got[fwd.__name__] == want[fwd.__name__]
                  and got[bwd.__name__] == want[bwd.__name__]
                  for got in r["launches_per_step"]),
              f"remat={on}: flash launches a step "
              f"{r['launches_per_step']}, want {want}")
        check(all(math.isfinite(x) for x in r["losses"])
              and r["losses"][-1] < r["losses"][0],
              f"remat={on}: losses {r['losses']}")
    check(steps[True]["peak_gib"] < steps[False]["peak_gib"],
          f"remat on peaks at {steps[True]['peak_gib']:.2f} GiB, not below "
          f"remat off's {steps[False]['peak_gib']:.2f}")

    # ---- part 2: Llama at Llama-2-7B's width ------------------------------
    lc = LlamaConfig.llama2_7b(n_layer=REMAT_LLAMA_LAYERS)
    check((lc.d_model, lc.n_head, lc.head_dim, lc.d_ff, lc.vocab_size,
           lc.dtype) == (4096, 32, 128, 11008, 32000, torch.bfloat16),
          f"not Llama-2-7B's width: {lc}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    lparams = {n: p.requires_grad_() for n, p in Llama(lc).init(gen).items()}
    ltok = torch.randint(0, lc.vocab_size, (1, REMAT_LLAMA_SEQ),
                         generator=gen, device="cuda")
    ltgt = torch.roll(ltok, -1, dims=1)
    lnames = list(lparams)
    llama = {}
    for on in (False, True):
        model = Llama(dataclasses.replace(lc, remat=on))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def run():
            loss = model.loss(lparams, ltok, ltgt)
            return loss.detach(), torch.autograd.grad(
                loss, [lparams[n] for n in lnames])

        t0 = time.perf_counter()
        (loss, grads), got = counted(run, on)
        llama[on] = dict(loss=loss, grads=dict(zip(lnames, grads)),
                         launches=got, seconds=time.perf_counter() - t0,
                         peak_above_gib=(torch.cuda.max_memory_allocated()
                                         - start) / 2**30)
    same, worst, where = remat_difference(llama[True]["grads"],
                                          llama[False]["grads"])
    l_off, l_on = (float(llama[on]["loss"]) for on in (False, True))
    loss_bitwise = torch.equal(llama[True]["loss"], llama[False]["loss"])
    for on in (False, True):
        r = llama[on]
        print(f"[remat] Llama-2-7B width, {REMAT_LLAMA_LAYERS} layers, B=1 "
              f"S={REMAT_LLAMA_SEQ}, remat={on}: loss {float(r['loss'])!r}, "
              f"{r['seconds'] * 1e3:.1f} ms, peak above the params "
              f"{r['peak_above_gib']:.2f} GiB, launches {r['launches']}")
    print(f"[remat] Llama remat off vs on: loss bitwise {loss_bitwise}; "
          f"gradients bitwise {same}, worst relative difference "
          f"{worst:.3e} ({where})")
    check(loss_bitwise, f"Llama loss {l_on!r} at remat on, {l_off!r} off")
    check(same or worst <= TOL_REMAT,
          f"Llama gradients differ by {worst} in {where}")
    want_l = {False: (REMAT_LLAMA_LAYERS, REMAT_LLAMA_LAYERS),
              True: (2 * REMAT_LLAMA_LAYERS, REMAT_LLAMA_LAYERS)}
    for on in (False, True):
        got = llama[on]["launches"]
        check((got[fwd.__name__], got[bwd.__name__]) == want_l[on],
              f"Llama remat={on}: flash launches {got}, want "
              f"{want_l[on]}")
    check(llama[True]["peak_above_gib"] < llama[False]["peak_above_gib"],
          "Llama's remat does not lower its peak")
    del lparams, llama
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[remat] the phase took {phase_s:.1f} s")
    return dict(
        gpt=dict(bitwise=sound[2], worst=sound[3], losses=sound[:2],
                 dropout_bitwise=dropped[2], dropout_worst=dropped[3],
                 control_bitwise=control[2], control_worst=control[3],
                 steps={str(on): steps[on] for on in (False, True)}),
        llama=dict(loss_bitwise=loss_bitwise, losses=[l_off, l_on],
                   grads_bitwise=same, grads_worst=worst),
        launches=remat_launches, phase_s=phase_s)


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
    return kernel_breakdown(wall_ms, kernels, label)


def kernel_breakdown(wall_ms, kernels, label):
    """Print and return a profiled step's device time by kernel class, its
    top kernels and the device's idle share of the step."""
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
    c = GPTConfig.small(use_flash=True, fused_entry_exit=fused, remat=False)
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


def stage_op_ms(report):
    """{method: ms} of one stage's ops in the step its report closes (the
    executor's per-op wall spans, host clock; a CUDA stage's ops end in a
    copy to the host, its update in a synchronize)."""
    out = {}
    for op in (report.get("perf") or {}).get("ops", ()):
        out[op["method"]] = out.get(op["method"], 0.0) \
            + (op["t1"] - op["t0"]) * 1e3
    return out


def first_difference(got, want):
    """(index, name) of the first leaf where two chunk-param lists differ
    bitwise, with its max abs difference, or None."""
    from ray_tpu_torch.parallel.zero import tree_flatten

    for g, (a, b) in enumerate(zip(got, want)):
        names = [f"chunk {g} {k}" for k in _leaf_names(a)]
        for name, x, y in zip(names, tree_flatten(a)[0],
                              tree_flatten(b)[0]):
            y = y.to(x.device)
            if not (x.shape == y.shape and x.dtype == y.dtype
                    and bool((x == y).all())):
                return name, float((x.float() - y.float()).abs().max())
    return None


def _leaf_names(tree, prefix=""):
    """The leaves' names of a nested dict, in tree_flatten order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def fsdp_offset_fault(w):
    """On a phase-15 stage actor (rank 0 of its fsdp gang): plant
    FSDP_CONTROL. The sharded update's scatter then hands rank 1 the
    chunk of the flat gradient that starts one element after its own."""
    import torch

    from ray_tpu_torch.parallel.sharding import lower

    sound = lower.scatter

    def shifted(x, axis_name, src, shape, dtype, device=None):
        if x is not None:
            c = x.shape[0] // FSDP
            x = torch.cat([x[:c], x[c + 1:], x[:1]])
        return sound(x, axis_name, src, shape, dtype, device)

    lower.scatter = shifted
    return True


def phase_quant_codec(device):
    """The in-program ZeRO's quantizer on the card: quantize_blocks and
    dequantize_blocks on a seeded QUANT_SHAPE f32 tensor, int8 and e4m3,
    bitwise equal to the same calls on its CPU copy."""
    import torch

    from ray_tpu_torch.parallel.sharding.codec import (dequantize_blocks,
                                                       quantize_blocks)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    x = torch.randn(QUANT_SHAPE, generator=gen, device=device)
    x[0, :QUANT_BLOCK] = 0.0                    # an all-zero block
    out = {}
    for codec in ("int8", "e4m3"):
        q, sc = quantize_blocks(x, codec, QUANT_BLOCK)
        d = dequantize_blocks(q, sc, codec)
        qc, scc = quantize_blocks(x.cpu(), codec, QUANT_BLOCK)
        dc = dequantize_blocks(qc, scc, codec)
        out[codec] = dict(
            device=str(q.device),
            payload_equal=bool(torch.equal(q.cpu(), qc)),
            scales_equal=bool(torch.equal(sc.cpu().view(torch.int32),
                                          scc.view(torch.int32))),
            dequantized_equal=bool(torch.equal(d.cpu(), dc)),
            max_abs_err=float((d - x).abs().max()))
    print(f"[fsdp pipeline] quantize_blocks on {QUANT_SHAPE} f32, block "
          f"{QUANT_BLOCK}, on the card against the CPU: {out}")
    for codec, r in out.items():
        check(r["device"].startswith(device.type), f"{codec}: not on "
              f"{device}: {r}")
        check(r["payload_equal"] and r["scales_equal"]
              and r["dequantized_equal"], f"{codec} quantizer on the card "
              f"differs from the CPU's: {r}")
    return out


def start_fsdp_engines(fns, sp, tx, tied, channel, device):
    """Start phase 15's two engines, the checked one and the planted
    control's, each on a thread of its own: phase 13 calls this beside
    its own engine's start, so their processes come up together. Returns
    (threads, {name: engine or the exception it raised, name + " s":
    seconds})."""
    from ray_tpu_torch.train import CompiledPipelineEngine

    started = {}

    def start(name):
        t0 = time.perf_counter()
        try:
            started[name] = CompiledPipelineEngine(
                fns, sp, tx, num_microbatches=PIPE_MICROBATCHES, fsdp=FSDP,
                tied=tied, channel_bytes=channel, setup_timeout=600,
                device=device)
        except Exception as e:               # raised in phase 15
            started[name] = e
        started[name + " s"] = time.perf_counter() - t0

    threads = [threading.Thread(target=start, args=(n,), daemon=True)
               for n in ("engine", "control")]
    for t in threads:
        t.start()
    return threads, started


def stop_fsdp_engines(threads, started):
    """Shut down what start_fsdp_engines started (idempotent)."""
    for t in threads:
        t.join(timeout=900)
    for name in ("engine", "control"):
        engine = started.get(name)
        if engine is not None and not isinstance(engine, Exception):
            engine.shutdown()


def phase_fsdp_pipeline(ctx, wrappers, card, device=None):
    """Phase 15: phase 13's GPT-2 small split at fsdp=FSDP, inside phase
    13's runtime, on the two engines start_fsdp_engines started beside
    phase 13's (the checked one and the planted control's). The checked
    one takes phase 13's steps on phase 13's batch, held bit for bit to
    phase 13's reference, with each rank's bytes, the flash launches of
    each stage process and none in the peers; the control must differ by
    step FSDP_CONTROL_STEPS. Then the quantizer on the card."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch._vendor import cloudpickle
    from ray_tpu_torch.parallel.zero import tree_flatten

    t_phase = time.perf_counter()
    sp, mbs, tgts, steps = ctx["sp"], ctx["mbs"], ctx["tgts"], ctx["steps"]
    counters = ctx["counters"]
    starters, started = ctx["fsdp_starters"]
    for t in starters:
        t.join(timeout=900)
    join_s = time.perf_counter() - t_phase
    check(not any(t.is_alive() for t in starters),
          "the fsdp engines did not start in 900 s")
    engines = [started[n] for n in ("engine", "control")]
    try:
        for e in engines:
            if isinstance(e, Exception):
                raise e
        engine, control = engines
        where0 = engine.placement()[0]
        for f in wrappers:                   # the fsdp pipeline path starts
            f.launches = 0
        losses, walls, reports, wheres = [], [], [], [where0]
        for _ in range(steps):
            losses.append(engine.step(mbs, tgts, timeout=600))
            walls.append(engine.last_step_s)
            reports.append(engine.last_reports)
            wheres.append(engine.placement()[0])
        driver_launches = {f.__name__: f.launches for f in wrappers}
        new_params = engine.get_params()
        opt_bytes = engine.opt_state_bytes()
        engine.shutdown()
        t_ctl = time.perf_counter()
        check(ray_tpu_torch.get(control.actor_grid[0][0].mesh_run.remote(
            cloudpickle.dumps(fsdp_offset_fault)), timeout=60),
            "the control's fault was not planted")
        ctl_losses = [control.step(mbs, tgts, timeout=600)
                      for _ in range(FSDP_CONTROL_STEPS)]
        ctl_s = time.perf_counter() - t_ctl
    finally:
        stop_fsdp_engines(starters, started)
    where1 = wheres[-1]
    ranks = [w["fsdp_ranks"] for w in where1]
    print(f"[fsdp pipeline] {PIPE_STAGES} stages x fsdp={FSDP} up in "
          f"{started['engine s']:.1f} s (the control's engine and phase "
          f"13's beside it; the control's {started['control s']:.1f} s; "
          f"waited for here {join_s:.1f} s): ranks "
          + "; ".join(f"stage {i}: " + ", ".join(
              f"pid {r['pid']} {r['device']} shards+moments on "
              f"{r['tensor_devices']} {r['shard_bytes']} + {r['opt_bytes']} "
              f"B, {r['memory_allocated'] / 2**30:.2f} GiB allocated"
              for r in rs) for i, rs in enumerate(ranks)))
    pids = [r["pid"] for rs in ranks for r in rs]
    check(len(set(pids)) == PIPE_STAGES * FSDP and os.getpid() not in pids,
          f"the ranks do not run in {PIPE_STAGES * FSDP} worker processes: "
          f"{pids}")
    check(all(w["device"].startswith("cuda") for w in where1)
          and all(r["device"].startswith("cuda")
                  and r["tensor_devices"]
                  and all(d.startswith("cuda") for d in r["tensor_devices"])
                  for rs in ranks for r in rs),
          f"a rank's shards or moments are not on the card: {ranks}")

    # launches: the stage processes as in phase 13; none in the peers
    per_step = [[{n: now["kernel_launches"][f.__name__]
                  - was["kernel_launches"][f.__name__]
                  for n, f in counters.items()}
                 for was, now in zip(w0, w1)]
                for w0, w1 in zip(wheres, wheres[1:])]
    stage_launches = [w["kernel_launches"] for w in where1]
    peer_launches = [r["kernel_launches"] for rs in ranks for r in rs[1:]]
    print(f"[fsdp pipeline] flash launches per step and stage "
          f"{per_step[-1]}; driver {driver_launches}; stages since start "
          f"{stage_launches}; peers since start {peer_launches}")
    check(all(d == {n: ctx["per_step_want"] for n in counters}
              for step in per_step for d in step),
          f"launches per step and stage {per_step}, expected "
          f"{ctx['per_step_want']} of each flash kernel")
    check(not any(driver_launches.values()),
          f"the driver launched {driver_launches} on the fsdp path")
    check(not any(v for p in peer_launches for v in p.values()),
          f"a peer launched a kernel: {peer_launches}")
    check(not any(s[f.__name__] for s in stage_launches
                  for f in wrappers[2:]),
          f"a stage launched a fused kernel: {stage_launches}")

    # the trajectory, bit for bit against phase 13's reference
    ref_losses, ref_params = ctx["ref_losses"], ctx["ref_params"]
    diff = first_difference(new_params, ref_params)
    ctl_equal = ctl_losses == ref_losses[:FSDP_CONTROL_STEPS]
    print(f"[fsdp pipeline] losses {losses}; phase 13's reference "
          f"{ref_losses}; equal {losses == ref_losses}; final params equal "
          f"{diff is None} (first differing: {diff}); control "
          f"'{FSDP_CONTROL}' {ctl_losses}: equal {ctl_equal} ({ctl_s:.1f} s)")
    check(losses == ref_losses, f"the fsdp engine's losses {losses} differ "
          f"from the reference's {ref_losses}")
    check(diff is None, f"the fsdp engine's final params differ from the "
          f"reference's at {diff}")
    check(not ctl_equal, f"control '{FSDP_CONTROL}' passes the trajectory "
          f"equality by step {FSDP_CONTROL_STEPS}")

    # bytes: each rank at most 1/FSDP of its stage, the sum the fsdp=1
    # stage's up to the padding and Adam's per-tensor step counts
    per_rank = [r["fsdp_bytes_per_chip"]
                for r in sorted(reports[-1], key=lambda r: r["stage"])]
    sums = []
    for i, per in enumerate(per_rank):
        total = sum(per.values())
        sums.append(total)
        n_leaves = len(tree_flatten(sp[i])[0])
        numel = sum(t.numel() for t in tree_flatten(sp[i])[0])
        pad = (-numel) % FSDP
        fsdp1 = ctx["fsdp1_bytes"][i]
        print(f"[fsdp pipeline] stage {i}: bytes a rank {per} (1/{FSDP} of "
              f"{total} is {total / FSDP:.0f}); fsdp=1 stage {fsdp1} B "
              f"(params + moments), padding {pad} elements, {n_leaves} "
              f"leaves; optimizer bytes over the gang {opt_bytes[i]}")
        check(len(per) == FSDP
              and max(per.values()) <= total / FSDP + FSDP_BYTES_SLACK,
              f"stage {i}'s ranks hold {per}: more than 1/{FSDP} of "
              f"{total} + {FSDP_BYTES_SLACK}")
        check(abs(total - fsdp1) <= 3 * 4 * pad + 4 * (n_leaves + FSDP),
              f"stage {i}: the ranks hold {total} B in all, the fsdp=1 "
              f"stage {fsdp1} B")

    # readings
    timed = walls[PIPE_WARMUP:]
    step_p50 = statistics.median(timed)
    last = sorted(reports[-1], key=lambda r: r["stage"])
    gather_ms = [r["sync_breakdown"]["gather_ms"] for r in last]
    update_ms = [r["update_ms"] for r in last]
    peaks = [r["max_memory_allocated"] for rs in ranks for r in rs]
    print(f"[fsdp pipeline] {card}: step wall "
          f"{[round(t * 1e3, 2) for t in walls]} ms (p50 of the "
          f"{PIPE_STEPS} timed {step_p50 * 1e3:.2f} ms; phase 13's fsdp=1 "
          f"p50 {ctx['step_p50'] * 1e3:.2f} ms); a stage's gather "
          f"{gather_ms} ms and update (the scatter and the shard steps) "
          f"{update_ms} ms in the last step; peak "
          f"{[round(p / 2**30, 2) for p in peaks]} GiB a rank")
    quant = phase_quant_codec(torch.device("cuda" if device is None
                                           else device))
    phase_s = time.perf_counter() - t_phase
    print(f"[fsdp pipeline] {card}: the phase took {phase_s:.1f} s")
    return dict(losses=losses, step_wall_s=walls, step_p50_s=step_p50,
                gather_ms=gather_ms, update_ms=update_ms,
                bytes_per_rank=per_rank, bytes_sums=sums,
                control_losses=ctl_losses, control_s=ctl_s,
                start_s=started["engine s"], peak_bytes=peaks,
                stage_launches=stage_launches, peer_launches=peer_launches,
                driver_launches=driver_launches, quant=quant,
                phase_s=phase_s, card=card)


def phase_pipeline(wrappers, card, device=None):
    """Pipeline-parallel GPT-2 small training over compiled graphs (phase
    13 of the module docstring). The driver's launch counts of
    ``wrappers`` are zeroed just before the engine's steps and read just
    after them; each stage reports its own process's counts, which start
    at zero with the process. ``device`` (None: the card) is for a
    rehearsal on the CPU, where the checks of the card fail by design."""
    import functools

    import torch

    t_phase = time.perf_counter()
    import ray_tpu_torch
    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.models.gpt import gpt_pipeline_stages
    from ray_tpu_torch.train import (CompiledPipelineEngine,
                                     run_reference_1f1b)
    from ray_tpu_torch.train.pipeline_cgraph import channel_bytes_by_edge

    dev = torch.device("cuda" if device is None else device)
    c = GPTConfig.small(use_flash=True, remat=False)
    check((c.n_layer, c.d_model, c.n_head, c.head_dim, c.padded_vocab,
           c.dtype) == (12, 768, 12, 64, 50304, torch.bfloat16),
          f"not GPT-2 small: {c}")
    model = GPT(c)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    batch = PIPE_MICROBATCHES * PIPE_MB
    tokens = torch.randint(0, c.vocab_size, (batch, TRAIN_SEQ),
                           generator=gen, device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    mbs, tgts = list(tokens.split(PIPE_MB)), list(targets.split(PIPE_MB))
    fns, sp, tied = gpt_pipeline_stages(model, params, PIPE_STAGES)
    with torch.no_grad():
        full_loss = float(model.loss(params, tokens, targets))
    tx = functools.partial(torch.optim.AdamW, lr=TRAIN_LR,
                           weight_decay=TRAIN_WD)
    channel = c.padded_vocab * c.d_model * 4 + PIPE_CHANNEL_SLACK
    steps = PIPE_WARMUP + PIPE_STEPS
    counters = {"flash_fwd": wrappers[0], "flash_bwd": wrappers[1]}
    per_step_want = c.n_layer // PIPE_STAGES * PIPE_MICROBATCHES

    ray_tpu_torch.init(num_cpus=16, object_store_memory=PIPE_OBJECT_STORE)
    fsdp_starters = None
    try:
        # the two stages start in their worker processes (a torch import,
        # a CUDA context, their chunk's params through the object store)
        # while this process runs the reference and the control
        started = {}

        def start_engine():
            t0 = time.perf_counter()
            try:
                started["engine"] = CompiledPipelineEngine(
                    fns, sp, tx, num_microbatches=PIPE_MICROBATCHES,
                    tied=tied, channel_bytes=channel, setup_timeout=600,
                    device=device)
            except Exception as e:           # raised in this thread below
                started["error"] = e
            started["s"] = time.perf_counter() - t0

        starter = threading.Thread(target=start_engine, daemon=True)
        starter.start()
        # phase 15's engines come up beside this one
        fsdp_starters = start_fsdp_engines(fns, sp, tx, tied, channel,
                                           device)
        ref_losses, ref_params = run_reference_1f1b(
            fns, sp, tx, [(mbs, tgts)] * steps, tied=tied, device=device)
        ctl_losses, _ = run_reference_1f1b(
            fns, sp, tx, [(mbs, tgts)] * 2, device=device)
        starter.join(timeout=900)
        check(not starter.is_alive(), "the stages did not start in 900 s")
        if "error" in started:
            raise started["error"]
        engine, start_s = started["engine"], started["s"]
        try:
            where0 = engine.placement()[0]
            for f in wrappers:               # the pipeline path starts here
                f.launches = 0
            sent0 = channel_bytes_by_edge()
            losses, walls, reports, wheres = [], [], [], [where0]
            for _ in range(steps):
                losses.append(engine.step(mbs, tgts, timeout=600))
                walls.append(engine.last_step_s)
                reports.append(engine.last_reports)
                wheres.append(engine.placement()[0])
            driver_launches = {f.__name__: f.launches for f in wrappers}
            sent1 = channel_bytes_by_edge()
            where1 = wheres[-1]
            new_params = engine.get_params()
            opt1 = engine.opt_state_bytes()
        finally:
            engine.shutdown()
        # the reference's step time, with nothing else on the card: the
        # timed steps' count, on copies of the same chunks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_reference_1f1b(fns, sp, tx, [(mbs, tgts)] * PIPE_STEPS,
                           tied=tied, device=device)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        on_card = all(w["device"].startswith("cuda") for w in where1)
        pids = [w["pid"] for w in where1]
        print(f"[pipeline] {PIPE_STAGES} stages up in {start_s:.1f} s "
              f"beside the reference: pids {pids} (driver {os.getpid()}), "
              f"devices {[w['device'] for w in where1]}, params "
              f"{[w['param_bytes'] for w in where1]} B; channel slot "
              f"{channel} B")
        check(on_card and all(w["memory_allocated"] > 0 for w in where1),
              f"a stage is not on the card: {where1}")
        check(len(set(pids)) == PIPE_STAGES and os.getpid() not in pids,
              f"the stages do not run in {PIPE_STAGES} worker processes: "
              f"{pids}")

        # launches: each stage's own counters, read between the steps
        stage_launches = [w["kernel_launches"] for w in where1]
        per_step = [[{n: now["kernel_launches"][f.__name__]
                      - was["kernel_launches"][f.__name__]
                      for n, f in counters.items()}
                     for was, now in zip(w0, w1)]
                    for w0, w1 in zip(wheres, wheres[1:])]
        print(f"[pipeline] flash launches per step and stage "
              f"{per_step[-1]} (every step: "
              f"{all(s == per_step[-1] for s in per_step)}); driver "
              f"{driver_launches}; stages since start {stage_launches}")
        check(all(d == {n: per_step_want for n in counters}
                  for step in per_step for d in step),
              f"launches per step and stage {per_step}, expected "
              f"{per_step_want} of each flash kernel")
        check(not any(driver_launches.values()),
              f"the driver launched {driver_launches} on the pipeline path")
        check(not any(s[f.__name__] for s in stage_launches
                      for f in wrappers[2:]),
              f"a stage launched a fused kernel: {stage_launches}")

        # the trajectory, bit for bit, and the planted control
        diff = first_difference(new_params, ref_params)
        first_step = next((i for i, (a, b) in enumerate(
            zip(losses, ref_losses)) if a != b), None)
        ctl_equal = ctl_losses == losses[:len(ctl_losses)]
        loss0 = math.log(c.padded_vocab) + c.d_model * 0.02 ** 2 / 2
        print(f"[pipeline] losses {losses}; reference {ref_losses}; "
              f"equal {losses == ref_losses} (first differing step "
              f"{first_step}); final params equal {diff is None} "
              f"(first differing: {diff}); control '{PIPE_CONTROL}' "
              f"{ctl_losses}: equal {ctl_equal}; GPT.loss on the same "
              f"{batch} sequences {full_loss}; step-0 target {loss0:.4f}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(abs(losses[0] - loss0) <= TOL_LOSS0,
              f"step-0 loss {losses[0]} is not {loss0:.4f} within "
              f"{TOL_LOSS0}")
        check(abs(losses[0] - full_loss) <= TOL_PIPE_FULL_LOSS,
              f"step-0 loss {losses[0]} is not GPT.loss {full_loss} within "
              f"{TOL_PIPE_FULL_LOSS}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(losses == ref_losses, f"the engine's losses {losses} differ "
              f"from the reference's {ref_losses} from step {first_step}")
        check(diff is None, f"the engine's final params differ from the "
              f"reference's at {diff}")
        check(not ctl_equal, f"control '{PIPE_CONTROL}' passes the "
              f"trajectory equality")

        # readings
        timed = walls[PIPE_WARMUP:]
        step_p50 = statistics.median(timed)
        tokens_per_s = batch * TRAIN_SEQ / step_p50
        last = sorted(reports[-1], key=lambda r: r["stage"])
        before = sorted(reports[-2], key=lambda r: r["stage"])
        op_ms = [stage_op_ms(r) for r in last]
        # the executor's cumulative seconds a stage spent in its ops, in
        # blocked channel reads (the bubble) and in sends, over the last
        # step
        split_ms = [{k: (r["perf"][f"{k}_s"] - b["perf"][f"{k}_s"]) * 1e3
                     for k in ("exec", "bubble", "send")}
                    for r, b in zip(last, before)]
        edge_bytes = {}
        for w0, w1 in zip(where0, where1):
            for e, b in w1["channel_bytes"].items():
                edge_bytes[e] = (b - w0["channel_bytes"].get(e, 0)) // steps
        for e, b in sent1.items():
            if b > sent0.get(e, 0):      # this engine's edges, not phase 12's
                edge_bytes[e] = (b - sent0.get(e, 0)) // steps
        peaks = [w["max_memory_allocated"] for w in where1]
        print(f"[pipeline] {card}: step wall {[round(t * 1e3, 2) for t in walls]} "
              f"ms (p50 of the {PIPE_STEPS} timed {step_p50 * 1e3:.2f} ms, "
              f"{tokens_per_s:.1f} tokens/s); run_reference_1f1b in this "
              f"process {ref_s * 1e3 / PIPE_STEPS:.2f} ms a step "
              f"({PIPE_STEPS} steps in {ref_s:.3f} s, its copy of the "
              f"params and its optimizer's set-up included)")
        for i, (r, ms) in enumerate(zip(last, op_ms)):
            print(f"[pipeline] stage {i} (last step): "
                  + ", ".join(f"{m} {v:.2f} ms" for m, v in sorted(ms.items()))
                  + f"; update_ms {r['update_ms']}; exec / bubble / send "
                  + " / ".join(f"{v:.2f}" for v in split_ms[i].values())
                  + f" ms; peak {peaks[i] / 2**30:.2f} GiB allocated")
        print(f"[pipeline] bytes a step by edge: {dict(sorted(edge_bytes.items()))}")
        pipeline_s = time.perf_counter() - t_phase
        fsdp = phase_fsdp_pipeline(dict(
            sp=sp, mbs=mbs, tgts=tgts, steps=steps, counters=counters,
            per_step_want=per_step_want, ref_losses=ref_losses,
            ref_params=ref_params, step_p50=step_p50,
            fsdp1_bytes=[w["param_bytes"] + o
                         for w, o in zip(where1, opt1)],
            fsdp_starters=fsdp_starters),
            wrappers, card, device)
        del ref_params, new_params
        gc.collect()
        torch.cuda.empty_cache()

        # the ZeRO dp update: three engines side by side
        t_dp = time.perf_counter()
        sgd = dict(lr=PIPE_DP_LR, momentum=PIPE_DP_MOMENTUM)
        variants = {"zero": (True, functools.partial(torch.optim.SGD, **sgd)),
                    "replicated": (False, functools.partial(
                        torch.optim.SGD, **sgd)),
                    "control": (True, SkipMeanSGD(PIPE_DP, **sgd))}
        runs = {}

        def run_dp(name, zero_update, dp_tx):
            t0 = time.perf_counter()
            try:
                eng = CompiledPipelineEngine(
                    fns, sp, dp_tx, num_microbatches=PIPE_DP_MICROBATCHES,
                    dp=PIPE_DP, zero_update=zero_update, tied=tied,
                    channel_bytes=channel, setup_timeout=600,
                    device=device)
                try:
                    up = time.perf_counter() - t0
                    ls, ws = [], []
                    for _ in range(PIPE_DP_STEPS):
                        ls.append(eng.step(mbs, tgts, timeout=600))
                        ws.append(eng.last_step_s)
                    runs[name] = dict(
                        losses=ls, walls=ws, start_s=up,
                        opt_bytes=eng.opt_state_bytes(),
                        sync_ms=[r["sync_ms"] for r in eng.last_reports],
                        peaks=[w["max_memory_allocated"]
                               for row in eng.placement() for w in row])
                finally:
                    eng.shutdown()
            except Exception as e:           # raised in the driver below
                runs[name] = {"error": e}

        threads = [threading.Thread(target=run_dp, args=(n, *v), daemon=True)
                   for n, v in variants.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        check(not any(t.is_alive() for t in threads),
              "a dp engine did not finish in 900 s")
        for name in variants:
            if "error" in runs[name]:
                raise runs[name]["error"]
        dp_s = time.perf_counter() - t_dp
        zero, repl, ctl = (runs[n] for n in ("zero", "replicated",
                                             "control"))
        ratios = [a / b for a, b in zip(zero["opt_bytes"],
                                        repl["opt_bytes"])]
        err, ctl_err = (abs(r["losses"][1] - repl["losses"][1])
                        for r in (zero, ctl))
        for name, r in runs.items():
            print(f"[pipeline zero] {name}: losses {r['losses']}, step "
                  f"walls {[round(t * 1e3, 1) for t in r['walls']]} ms, up "
                  f"in {r['start_s']:.1f} s, opt bytes {r['opt_bytes']}, "
                  f"sync {r['sync_ms']} ms, peaks "
                  f"{[round(p / 2**30, 2) for p in r['peaks']]} GiB")
        print(f"[pipeline zero] dp={PIPE_DP} x P={PIPE_STAGES}: step-1 loss "
              f"off the replicated run's by {err} (limit {TOL_ZERO_LOSS1}); "
              f"control '{ZERO_CONTROL}' by {ctl_err}; ZeRO opt bytes over "
              f"replicated {[round(x, 4) for x in ratios]}; the three "
              f"engines took {dp_s:.1f} s side by side")
        check(zero["losses"][0] == repl["losses"][0] == ctl["losses"][0],
              f"step-0 losses differ: {zero['losses'][0]}, "
              f"{repl['losses'][0]}, {ctl['losses'][0]}")
        check(err <= TOL_ZERO_LOSS1, f"the ZeRO step-1 loss is off the "
              f"replicated one's by {err} > {TOL_ZERO_LOSS1}")
        check(ctl_err > TOL_ZERO_LOSS1, f"control '{ZERO_CONTROL}' passes: "
              f"{ctl_err} <= {TOL_ZERO_LOSS1}")
        check(all(ZERO_OPT_BYTES[0] <= x <= ZERO_OPT_BYTES[1]
                  for x in ratios), f"ZeRO opt bytes over replicated "
              f"{ratios} outside {ZERO_OPT_BYTES}")
    finally:
        if fsdp_starters is not None:        # in case phase 15 never ran
            stop_fsdp_engines(*fsdp_starters)
        ray_tpu_torch.shutdown()
    phase_s = time.perf_counter() - t_phase
    print(f"[pipeline] {card}: the phase took {phase_s:.1f} s: "
          f"the P={PIPE_STAGES} engine and its reference {pipeline_s:.1f}, "
          f"phase 15 (fsdp={FSDP}) {fsdp['phase_s']:.1f}, the dp={PIPE_DP} "
          f"engines {dp_s:.1f}")
    launches = {n: sum(s[f.__name__] for s in stage_launches)
                + driver_launches[f.__name__] for n, f in counters.items()}
    return dict(losses=losses, reference_losses=ref_losses,
                control_losses=ctl_losses, full_loss=full_loss,
                step_wall_s=walls, step_p50_s=step_p50,
                tokens_per_s=tokens_per_s, reference_s=ref_s,
                start_s=start_s, op_ms=op_ms, split_ms=split_ms,
                edge_bytes=edge_bytes,
                peak_bytes=peaks, launches=launches,
                stage_launches=stage_launches,
                driver_launches=driver_launches,
                zero={n: {k: v for k, v in r.items()} for n, r in runs.items()},
                zero_loss1_err=err, zero_control_err=ctl_err,
                zero_opt_ratios=ratios, dp_s=dp_s, phase_s=phase_s,
                fsdp=fsdp, card=card)


def tp_sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tp_rank_apply(w, tokens, fault=None):
    """On a tp rank of phase 14: this rank's flash apply on ``tokens``
    (every rank gathers the logits; rank 0 returns them on the host), its
    flash launches and heads, and the seconds it took. ``fault`` plants
    TP_CONTROL: each rank keeps its own partial of layer 0's w_o product
    (the same skip on every rank, so the collectives still pair up)."""
    import torch

    from ray_tpu_torch.ops import flash_attention_fwd

    model = w.model
    if fault is not None:
        sound, skipped = model._mm_row, []

        def first_unreduced(x, weight):
            if skipped:
                return sound(x, weight)
            skipped.append(True)
            return model._mm(x, weight)

        model._mm_row = first_unreduced
    try:
        before = flash_attention_fwd.launches
        tp_sync(w.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = model.apply(w.params, tokens.to(w.device))
        tp_sync(w.device)
        seconds = time.perf_counter() - t0
    finally:
        if fault is not None:
            del model._mm_row
    return dict(logits=logits.float().cpu() if w.rank == 0 else None,
                device=str(logits.device), seconds=seconds,
                launches=flash_attention_fwd.launches - before,
                heads=model._heads)


def tp_rank_collectives(w, reps):
    """On a tp rank of phase 14: the median ms of the group's f32
    all-reduce of a decode step's row-parallel partial [8, d_model] and
    of the logits gather of this rank's [8, V / tp] slice, on the card."""
    import torch

    c, tp = w.model.config, w.model.tp
    partial = torch.randn(8, c.d_model, device=w.device)
    logits = torch.randn(8, c.padded_vocab // tp.size, device=w.device)

    def median_ms(fn):
        times = []
        for _ in range(reps):
            tp_sync(w.device)
            t0 = time.perf_counter()
            fn()
            tp_sync(w.device)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    with torch.no_grad():        # the serving path's all-reduce
        return dict(
            all_reduce_ms=median_ms(lambda: tp.all_reduce_f32(partial)),
            gather_ms=median_ms(lambda: tp.gather_last(logits)))


def tp_rank_kv_fault(w, on):
    """On a tp rank of phase 14: plant (``on``) or lift TP_KV_CONTROL:
    rank 1's decode steps see its cache with its KV heads in reverse
    order (and write the step's keys and values into that order)."""
    model = w.model
    if not on:
        model.__dict__.pop("paged_decode_step", None)
        return True
    if w.rank == 1:
        sound = model.paged_decode_step

        def swapped(params, cache, *args):
            logits, out = sound(params, {n: t.flip(-2)
                                         for n, t in cache.items()}, *args)
            return logits, {n: t.flip(-2) for n, t in out.items()}

        model.paged_decode_step = swapped
    return True


def phase_tp(tp_ref, card):
    """Phase 14: Llama-2-7B at tp=TP through LLMServer(engine_config=
    {"tp": TP}): TP rank actors on the card, each with its shard from the
    seed-0 init. The dense apply at [1, 1024] against the tp=1 logits of
    phase 3 (and the planted control), the collectives' cost, then phase
    4's requests teacher-forced on phase 4's tokens, each step's logits
    against phase 4's (and the planted decode-path control), with KV
    bytes per chip, decode step p50, TTFT and the phase's wall time."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.serve.llm import LLMServer

    t_phase = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    server = None
    try:
        t0 = time.perf_counter()
        server = LLMServer("llama2-7b", seed=SEED,
                           engine_config={**ENGINE_CONFIG, "tp": TP})
        engine = server.engine
        up_s = time.perf_counter() - t0
        ranks = engine.ranks
        check([r["device"] for r in ranks] == ["cuda:0"] * TP,
              f"tp ranks not on the card: {ranks}")
        print(f"[tp] {TP} ranks up in {up_s:.1f} s (pids "
              f"{[r['pid'] for r in ranks]}, on {ranks[0]['device']}; "
              f"params {[round(r['param_bytes'] / 2**30, 2) for r in ranks]}"
              f" GiB, KV cache {[r['kv_bytes'] for r in ranks]} B a rank)")
        group = engine.mesh_group
        tokens, ref = tp_ref["apply"]
        group.run(tp_rank_apply, tokens[:, :128])          # warm-up
        runs = group.run(tp_rank_apply, tokens)
        got = runs[0]["logits"]
        err = logits_errors(got, ref)
        launches = [r["launches"] for r in runs]
        control = logits_errors(
            group.run(tp_rank_apply, tokens, TP_CONTROL)[0]["logits"], ref)
        print(f"[tp] apply [1, 1024] at tp={TP} vs the tp=1 logits: max abs "
              f"err {err['max_abs']:.4f} (tol {TOL_LOGITS}), rms err "
              f"{err['rms_over_std']:.4f} of the std (tol "
              f"{TOL_LOGITS_RMS}); flash launches per rank {launches} at "
              f"[1, 1024, {runs[0]['heads']}, 128]; "
              f"{[round(r['seconds'] * 1e3, 1) for r in runs]} ms per rank; "
              f"control '{TP_CONTROL}': max abs {control['max_abs']:.4f}, "
              f"rms {control['rms_over_std']:.4f} of the std")
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"tp apply logits {tuple(got.shape)}")
        check(all(r["device"] == "cuda:0" for r in runs),
              f"tp apply ran on {[r['device'] for r in runs]}")
        check(launches == [engine.model.config.n_layer] * TP,
              f"tp apply launched flash {launches} times per rank")
        check(logits_agree(err), "tp apply disagrees with the tp=1 logits")
        check(not logits_agree(control),
              f"control '{TP_CONTROL}' passes the logits check")
        coll = group.run(tp_rank_collectives, TP_COLLECTIVE_REPS)
        c = engine.model.config
        per_step = 2 * c.n_layer + 1
        print(f"[tp] collectives on the card (gloo): f32 all-reduce of "
              f"[8, {c.d_model}] {[round(x['all_reduce_ms'], 3) for x in coll]}"
              f" ms p50 per rank (staged through the host by gloo), logits "
              f"gather of [8, {c.padded_vocab // TP}] "
              f"{[round(x['gather_ms'], 3) for x in coll]} ms (staged to the "
              f"host here); a decode step makes {per_step} all-reduces and "
              f"one gather")

        ser = tp_ref["serving"]
        prompts = ser["prompts"]
        streams = {tuple(p): t for p, t in zip(prompts, ser["tokens"])}
        prefills = record_prefills(engine)
        decode_s = []
        run_decode = engine._decode_fn

        def timed_decode(*args):
            t1 = time.perf_counter()
            out = run_decode(*args)
            decode_s.append(time.perf_counter() - t1)
            return out

        engine._decode_fn = timed_decode
        step_logits = record_step_logits(engine)
        own = force_streams(engine, streams)

        def serve_forced(what):
            """Phase 4's requests through the server, teacher-forced on
            tp=1's tokens: -> (results, submit times, wall seconds, each
            request's per-step logit errors against tp=1's)."""
            results, submitted = [None] * len(prompts), [0.0] * len(prompts)
            errors = []

            def client(i):
                submitted[i] = time.perf_counter()
                try:
                    results[i] = server({"tokens": prompts[i],
                                         "max_tokens": MAX_TOKENS})
                except Exception as e:  # noqa: BLE001 — reported after join
                    errors.append((i, repr(e)))

            t1 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t1
            check(not any(t.is_alive() for t in threads),
                  f"tp clients hung ({what})")
            check(not errors, f"tp serving clients failed ({what}): {errors}")
            step_errs = []
            for i, r in enumerate(results):
                check(r is not None and r["finish_reason"] == "length"
                      and r["tokens"] == ser["tokens"][i],
                      f"tp request {i} ({what}) did not follow tp=1's "
                      f"tokens: {r}")
                rows = step_logits[r["request_id"]]
                check(len(rows) == MAX_TOKENS,
                      f"tp request {i} ({what}): {len(rows)} logit rows")
                step_errs.append([logits_errors(got_row, ref_row)
                                  for got_row, ref_row in
                                  zip(rows, ser["logits"][i])])
            engine.pool.check_leaks()
            check(engine.pool.used_count == 0,
                  f"KV blocks still held after tp serving ({what})")
            return results, submitted, wall, step_errs

        results, submitted, wall, step_errs = serve_forced("sound")
        n_decode = len(decode_s)
        ttfts = [prefills[tuple(p)][1] - submitted[i]
                 for i, p in enumerate(prompts)]
        kv = engine.kv_bytes_per_chip()
        stats = server.stats()
        flat = [e for errs in step_errs for e in errs]
        worst = dict(max_abs=max(e["max_abs"] for e in flat),
                     rms_over_std=max(e["rms_over_std"] for e in flat))
        # where tp=2's own choice differs from tp=1's token: tp=1's
        # top-two margin there, and that step's max abs error (logits
        # within e of each other can only swap a top two closer than 2e)
        parted = []
        for i, r in enumerate(results):
            for k, (mine, want) in enumerate(zip(own[r["request_id"]],
                                                 ser["tokens"][i])):
                if mine != want:
                    parted.append(dict(
                        request=i, step=k,
                        tp1_margin=float(top2_margin(ser["logits"][i][k])),
                        max_abs=step_errs[i][k]["max_abs"]))
        check(all(d["tp1_margin"] <= 2 * d["max_abs"] for d in parted),
              f"tp=2 chose another token than its logits allow: {parted}")
        check(all(map(logits_agree, flat)),
              f"tp serving: a step's logits disagree with tp=1's (worst "
              f"{worst})")
        check(len(kv) == TP and len(set(kv.values())) == 1
              and kv[0] * TP == ser["kv_bytes"],
              f"KV bytes per chip {kv} against tp=1's {ser['kv_bytes']}")

        group.run(tp_rank_kv_fault, True)
        try:
            *_, control_errs = serve_forced(TP_KV_CONTROL)
        finally:
            group.run(tp_rank_kv_fault, False)
        control_flat = [e for errs in control_errs for e in errs]
        kv_control = dict(
            max_abs=max(e["max_abs"] for e in control_flat),
            rms_over_std=max(e["rms_over_std"] for e in control_flat),
            steps_failing=sum(not logits_agree(e) for e in control_flat))
        out = dict(
            up_s=up_s, apply_err=err, control_err=control,
            apply_launches=launches, collectives=coll,
            collectives_per_decode_step=per_step,
            kv_bytes_per_chip=kv, kv_bytes_tp1=ser["kv_bytes"],
            kv_blocks_peak_per_chip=stats["kv_blocks_peak_per_chip"],
            decode_step_p50_s=statistics.median(decode_s[:n_decode]),
            decode_step_p50_s_tp1=ser["decode_step_p50_s"],
            decode_steps=n_decode,
            ttft_p50_s=statistics.median(ttfts),
            ttft_p50_s_tp1=ser["ttft_p50_s"], wall_s=wall,
            wall_s_tp1=ser["wall_s"], steps_compared=len(flat),
            step_logits_err=worst, own_choice_differs=parted,
            kv_control_err=kv_control)
        print(f"[tp] {len(results)} requests x {MAX_TOKENS} tokens at "
              f"tp={TP}, teacher-forced on tp=1's tokens: all finished by "
              f"length, no leaked blocks; every step's logits against "
              f"tp=1's over {len(flat)} steps: worst max abs "
              f"{worst['max_abs']:.4f} (tol {TOL_LOGITS}), rms "
              f"{worst['rms_over_std']:.4f} of the std (tol "
              f"{TOL_LOGITS_RMS}); tp=2's own choice differs from tp=1's "
              f"token at {len(parted)} steps (request, step, tp=1 margin, "
              f"max abs there: "
              f"{[(d['request'], d['step'], round(d['tp1_margin'], 4), round(d['max_abs'], 4)) for d in parted]}"
              f"); control '{TP_KV_CONTROL}': worst max abs "
              f"{kv_control['max_abs']:.4f}, rms "
              f"{kv_control['rms_over_std']:.4f} of the std, "
              f"{kv_control['steps_failing']} of {len(control_flat)} steps "
              f"outside the limits; KV bytes per chip {kv} (tp=1: "
              f"{ser['kv_bytes']}); decode step p50 "
              f"{out['decode_step_p50_s'] * 1e3:.1f} ms over {n_decode} "
              f"steps (tp=1: {ser['decode_step_p50_s'] * 1e3:.1f} ms); "
              f"TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms (tp=1: "
              f"{ser['ttft_p50_s'] * 1e3:.1f} ms; both from the client's "
              f"submit to the prefill's logits on the host); {wall:.2f} s "
              f"for the requests (tp=1: {ser['wall_s']:.2f} s)")
        check(not all(map(logits_agree, control_flat)),
              f"control '{TP_KV_CONTROL}' passes the logits check")
        server.shutdown()
        launches_total = sum(launches)
    finally:
        if server is not None:
            server.shutdown()
        ray_tpu_torch.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = launches_total
    print(f"[tp] {card}: the phase took {out['phase_s']:.1f} s")
    return out


def _digests(tree):
    """{name: sha256 of the tensor's bytes} of a dict of f32 tensors."""
    import hashlib

    return {n: hashlib.sha256(t.detach().cpu().contiguous().numpy()
                              ).hexdigest() for n, t in tree.items()}


def pp_rank_run(w, mode, keep_params):
    """On a rank of phase 16's gangs: GPT-2 small from the seed-0 init and
    phase 13's batch, PP_SPMD_WARMUP + PP_SPMD_STEPS steps of
    GPT.loss_pp over the gang's pp axis, backward and AdamW on the full
    params. ``mode`` is "sound", "reference" (the one-rank gang),
    PP_SUM_CONTROL (every rank's pvary of x_mb without its backward sum),
    or, with no steps, "loss_chunked" (GPT.loss_chunked on the batch) or
    PP_LATE_CONTROL (the step-0 loss, rank 1 handed each tick's
    activation a tick late). The flash
    and fused launch counts, the collective record and the peak memory
    are zeroed just before the timed steps and read just after. Returns
    the losses, the step walls, the step-0 gradients' and final params'
    digests, the step-0 wpe gradient, the final params on the host when
    this rank's pp index is ``keep_params``, and (on the card, for the
    sound and reference runs) one more step under torch.profiler."""
    import torch

    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_residual_fwd)
    from ray_tpu_torch.parallel.sharding import lower

    t_start = time.perf_counter()
    owner = w.mesh_owner
    rank = owner.coordinate()["pp"]
    dev = torch.device(owner.mesh.device_type)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    c = GPTConfig.small(use_flash=True, remat=False)
    model = GPT(c)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    batch = PP_SPMD_MICROBATCHES * PP_SPMD_MB
    tokens = torch.randint(0, c.vocab_size, (batch, TRAIN_SEQ),
                           generator=gen, device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    M = PP_SPMD_MICROBATCHES
    out = dict(rank=rank, pid=os.getpid(), device=str(params["wte"].device))
    sound_pvary, sound_ppermute = lower.pvary, lower.ppermute
    if mode == "loss_chunked":
        with torch.no_grad():
            out["loss_chunked"] = float(model.loss_chunked(
                params, tokens, targets, num_chunks=M))
        return out
    if mode == PP_LATE_CONTROL:
        held = []

        def late(x, axis_name, perm, *, name=None):
            got = sound_ppermute(x, axis_name, perm, name=name)
            if rank != 1:
                return got
            prev = held.pop() if held else torch.zeros_like(got)
            held.append(got)
            return prev

        lower.ppermute = late
        try:
            with torch.no_grad():
                out["losses"] = [float(model.loss_pp(
                    params, tokens, targets, owner, num_microbatches=M))]
        finally:
            lower.ppermute = sound_ppermute
        return out
    if mode == PP_SUM_CONTROL:
        def unsummed(x, axis_name, *, name=None):
            return x if name == "x_mb" else sound_pvary(x, axis_name,
                                                        name=name)

        lower.pvary = unsummed
    try:
        for p in params.values():
            p.requires_grad_()
        opt = torch.optim.AdamW(list(params.values()), lr=TRAIN_LR,
                                weight_decay=TRAIN_WD)
        counted = (flash_attention_fwd, flash_attention_bwd, ln_matmul_fwd,
                   matmul_residual_fwd)
        losses, walls = [], []
        t_steps = time.perf_counter()
        for step in range(PP_SPMD_WARMUP + PP_SPMD_STEPS):
            if step == PP_SPMD_WARMUP:       # the timed steps start here
                sync()
                for f in counted:
                    f.launches = 0
                lower.collective_stats(reset=True)
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = model.loss_pp(params, tokens, targets, owner,
                                 num_microbatches=M)
            loss.backward()
            if step == 0:
                grads = {n: p.grad for n, p in params.items()}
                out["grad_digests"] = _digests(grads)
                out["wpe_grad"] = grads["wpe"].detach().cpu()
            opt.step()
            losses.append(float(loss.detach()))
            sync()
            walls.append(time.perf_counter() - t0)
        t_read = time.perf_counter()
        out["launches"] = {f.__name__: f.launches for f in counted}
        out["collectives"] = lower.collective_stats()
        out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda \
            else None
        out.update(losses=losses, walls=walls,
                   param_digests=_digests(params))
        if rank == keep_params:
            out["params"] = {n: p.detach().cpu() for n, p in params.items()}
        t_profile = time.perf_counter()
        if cuda and mode in ("sound", "reference"):
            # one more step, after every reading, under torch.profiler

            def step():
                opt.zero_grad(set_to_none=True)
                model.loss_pp(params, tokens, targets, owner,
                              num_microbatches=M).backward()
                opt.step()

            out["profiled"] = profiled(step)[:2]
        out["seconds"] = {k: round(b - a, 1) for k, a, b in (
            ("set-up", t_start, t_steps), ("steps", t_steps, t_read),
            ("readings", t_read, t_profile),
            ("profile", t_profile, time.perf_counter()))}
    finally:
        lower.pvary = sound_pvary
    del params, opt, loss
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_pp_spmd(wrappers, card, device=None):
    """Phase 16: GPT-2 small trained by GPT.loss_pp at pp=PP_SPMD on the
    card, PP_SPMD gloo rank processes of one gang, held to a one-rank
    gang's pp=1 run (module docstring). The driver's launch counts of
    ``wrappers`` are zeroed just before the pp=2 run and read just after
    (it launches nothing); each rank counts its own timed steps.
    ``device`` (None: the card) is for a rehearsal on the CPU, where the
    checks of the card fail by design."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.models import GPTConfig
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.mesh_group import MeshGroup

    t_phase = time.perf_counter()
    device_type = "cuda" if device is None else str(device)
    c = GPTConfig.small(use_flash=True, remat=False)
    P_, M = PP_SPMD, PP_SPMD_MICROBATCHES
    # the params and gradients come back through the object store
    ray_tpu_torch.init(num_cpus=4, object_store_memory=8 << 30)
    gangs = {}
    try:
        def form(name, n):
            try:
                gangs[name] = MeshGroup(n, spec=MeshSpec(pp=n),
                                        device_type=device_type)
            except Exception as e:           # raised in this thread below
                gangs[name + " error"] = e

        t0 = time.perf_counter()
        starters = [threading.Thread(target=form, args=a, daemon=True)
                    for a in (("pp1", 1), ("pp2", P_))]
        for t in starters:
            t.start()
        for t in starters:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in starters),
              "the pp spmd gangs did not form in 600 s")
        for name in ("pp1", "pp2"):
            if name + " error" in gangs:
                raise gangs[name + " error"]
        up_s = time.perf_counter() - t0
        run_s = {}

        def timed_run(label, name, mode, keep):
            t1 = time.perf_counter()
            out = gangs[name].run(pp_rank_run, mode, keep)
            run_s[label] = round(time.perf_counter() - t1, 1)
            return out

        # the first CUDA work of each process, side by side: GPT.loss_chunked
        # on the one-rank gang, the late-tick control on the pp=2 gang
        t1 = time.perf_counter()
        first = [gangs["pp1"].run_async(pp_rank_run, "loss_chunked", None),
                 gangs["pp2"].run_async(pp_rank_run, PP_LATE_CONTROL, None)]
        (chunked,), late = (ray_tpu_torch.get(refs, timeout=600)
                            for refs in first)
        run_s["loss_chunked beside the late control"] = round(
            time.perf_counter() - t1, 1)
        ref = timed_run("pp=1", "pp1", "reference", 0)[0]
        for f in wrappers:                   # the pp spmd path starts here
            f.launches = 0
        runs = timed_run("pp=2", "pp2", "sound", 0)
        driver_launches = {f.__name__: f.launches for f in wrappers}
        ctl = timed_run("sum control", "pp2", PP_SUM_CONTROL, 1)
    finally:
        for g in list(gangs.values()):
            if isinstance(g, MeshGroup):
                g.shutdown()
        ray_tpu_torch.shutdown()

    def worst_param_diff(got):
        return max(float((got[n] - ref["params"][n]).abs().max())
                   for n in ref["params"])

    r0 = runs[0]
    chunked_loss = chunked["loss_chunked"]
    devices = [r["device"] for r in runs] + [ref["device"]]
    print(f"[pp spmd] gangs up in {up_s:.1f} s: pp={P_} ranks pids "
          f"{[r['pid'] for r in runs]}, pp=1 pid {ref['pid']} (driver "
          f"{os.getpid()}), devices {devices}")
    check(all(d.startswith("cuda") for d in devices),
          f"a pp spmd rank is not on the card: {devices}")

    # the ranks are replicas: bitwise equal to each other
    ranks_equal = all(r["losses"] == r0["losses"]
                      and r["grad_digests"] == r0["grad_digests"]
                      and r["param_digests"] == r0["param_digests"]
                      for r in runs[1:])
    loss0 = math.log(c.padded_vocab) + c.d_model * 0.02 ** 2 / 2
    loss_err = max(abs(a - b) for a, b in zip(r0["losses"], ref["losses"]))
    param_err = worst_param_diff(r0["params"])
    bitwise = (r0["losses"] == ref["losses"]
               and r0["grad_digests"] == ref["grad_digests"]
               and r0["param_digests"] == ref["param_digests"])
    print(f"[pp spmd] losses at pp={P_} {r0['losses']}; pp=1 "
          f"{ref['losses']}; GPT.loss_chunked on the same "
          f"{PP_SPMD_MICROBATCHES * PP_SPMD_MB} sequences "
          f"{chunked_loss}; step-0 target {loss0:.4f}; the {P_} "
          f"ranks bitwise equal (losses, step-0 gradients, final params): "
          f"{ranks_equal}; against pp=1: worst loss difference {loss_err} "
          f"(limit {TOL_PP_LOSS}), worst final param difference "
          f"{param_err} (limit {TOL_PP_PARAM}); bit for bit with pp=1 "
          f"(predicted): {bitwise}")
    check(all(math.isfinite(x) for x in r0["losses"]),
          f"losses {r0['losses']}")
    check(abs(r0["losses"][0] - loss0) <= TOL_LOSS0,
          f"step-0 loss {r0['losses'][0]} is not {loss0:.4f} within "
          f"{TOL_LOSS0}")
    check(abs(r0["losses"][0] - chunked_loss) <= TOL_PIPE_FULL_LOSS,
          f"step-0 loss {r0['losses'][0]} is not GPT.loss_chunked "
          f"{chunked_loss} within {TOL_PIPE_FULL_LOSS}")
    check(r0["losses"][-1] < r0["losses"][0],
          f"loss did not fall: {r0['losses']}")
    check(ranks_equal, "the pp ranks are not bitwise equal to each other")
    check(loss_err <= TOL_PP_LOSS, f"a loss is off pp=1's by {loss_err}")
    check(param_err <= TOL_PP_PARAM,
          f"a final param is off pp=1's by {param_err}")

    # the launches: the ranks' timed steps
    ticks = M + P_ - 1
    want = {"flash_fwd": ticks * c.n_layer // P_,
            "flash_bwd": ticks * c.n_layer // P_}
    per_step = [{n: r["launches"][f.__name__] / PP_SPMD_STEPS
                 for n, f in zip(("flash_fwd", "flash_bwd"), wrappers)}
                for r in runs]
    ref_per_step = {n: ref["launches"][f.__name__] / PP_SPMD_STEPS
                    for n, f in zip(("flash_fwd", "flash_bwd"), wrappers)}
    print(f"[pp spmd] flash launches a step per rank {per_step} (want "
          f"{want}: {ticks} ticks x {c.n_layer // P_} layers); pp=1 "
          f"{ref_per_step}; driver {driver_launches}")
    check(all(d == want for d in per_step),
          f"launches per step and rank {per_step}, want {want}")
    check(not any(driver_launches.values()),
          f"the driver launched {driver_launches} on the pp spmd path")
    check(not any(r["launches"][f.__name__] for r in runs
                  for f in wrappers[2:]),
          "a pp rank launched a fused kernel")

    # the planted controls
    late_err = abs(late[0]["losses"][0] - ref["losses"][0])
    ctl_ranks_equal = all(r["grad_digests"] == ctl[0]["grad_digests"]
                          and r["param_digests"] == ctl[0]["param_digests"]
                          for r in ctl[1:])
    parted = sorted(n for n in ctl[0]["grad_digests"]
                    if ctl[1]["grad_digests"][n] != ctl[0]["grad_digests"][n])
    ctl_param_err = worst_param_diff(ctl[1]["params"])
    ctl_wpe_err = float((ctl[1]["wpe_grad"] - ref["wpe_grad"]).abs().max())
    print(f"[pp spmd] control '{PP_LATE_CONTROL}': step-0 loss "
          f"{late[0]['losses'][0]} (rank 1: {late[1]['losses'][0]}), off "
          f"pp=1's by {late_err}; control '{PP_SUM_CONTROL}': ranks "
          f"bitwise equal {ctl_ranks_equal}, rank 1's step-0 gradients "
          f"part from rank 0's at {parted}, its wpe gradient off pp=1's by "
          f"{ctl_wpe_err}, its worst final param off pp=1's by "
          f"{ctl_param_err}")
    check(late_err > TOL_PP_LOSS,
          f"control '{PP_LATE_CONTROL}' passes the loss check")
    check(not ctl_ranks_equal and ctl_param_err > TOL_PP_PARAM,
          f"control '{PP_SUM_CONTROL}' passes the checks")

    # readings
    step_p50 = statistics.median(r0["walls"][PP_SPMD_WARMUP:])
    ref_p50 = statistics.median(ref["walls"][PP_SPMD_WARMUP:])
    coll = [{k: round(r["collectives"].get(k, {}).get("seconds", 0.0)
                      * 1e3 / PP_SPMD_STEPS, 3) for k, _ in PP_COLLECTIVES}
            for r in runs]
    coll_bytes = {k: r0["collectives"].get(k, {}).get("bytes", 0)
                  // PP_SPMD_STEPS for k, _ in PP_COLLECTIVES}
    peaks = [r["peak_bytes"] for r in runs]

    def gib(b):
        return None if b is None else round(b / 2**30, 2)

    phase_s = time.perf_counter() - t_phase
    print(f"[pp spmd] {card}: step wall "
          f"{[round(t * 1e3, 2) for t in r0['walls']]} ms (p50 of the "
          f"{PP_SPMD_STEPS} timed {step_p50 * 1e3:.2f} ms) against pp=1's "
          f"{[round(t * 1e3, 2) for t in ref['walls']]} ms (p50 "
          f"{ref_p50 * 1e3:.2f} ms); collectives ms a step per rank ("
          + ", ".join(f"{k}: {label}" for k, label in PP_COLLECTIVES)
          + f") {coll}, bytes a step per rank {coll_bytes}; peak "
          f"allocated per rank {[gib(p) for p in peaks]} GiB (pp=1: "
          f"{gib(ref['peak_bytes'])} GiB); the phase took {phase_s:.1f} s "
          f"(gangs {up_s:.1f}, runs "
          f"{run_s} s; in the ranks of pp=2, pp=1 and the sum control "
          f"{[r['seconds'] for r in (r0, ref, ctl[0])]} s)")
    profiles = {label: kernel_breakdown(*r["profiled"], f"pp spmd {label}")
                for label, r in (("pp=2 rank 0", r0), ("pp=2 rank 1", runs[1]),
                                 ("pp=1", ref)) if "profiled" in r}
    return dict(losses=r0["losses"], reference_losses=ref["losses"],
                loss_chunked=chunked_loss, ranks_equal=ranks_equal,
                bitwise_with_pp1=bitwise, loss_err=loss_err,
                param_err=param_err, step_wall_s=r0["walls"],
                step_p50_s=step_p50, reference_step_wall_s=ref["walls"],
                reference_step_p50_s=ref_p50, collectives_ms=coll,
                collective_bytes=coll_bytes, peak_bytes=peaks,
                reference_peak_bytes=ref["peak_bytes"],
                launches_per_step=per_step,
                reference_launches_per_step=ref_per_step,
                late_control_err=late_err, sum_control_parted=parted,
                sum_control_param_err=ctl_param_err,
                sum_control_wpe_err=ctl_wpe_err, up_s=up_s, run_s=run_s,
                phase_s=phase_s, profiles=profiles,
                launches={n: sum(r["launches"][f.__name__] for r in runs)
                          for n, f in zip(("flash_fwd", "flash_bwd"),
                                          wrappers)},
                fused_launches={f.__name__: sum(r["launches"][f.__name__]
                                                for r in runs)
                                for f in wrappers[2:]})


def _tp_fused_control_exit(model, dtype):
    """TP_FUSED_CONTROL: ``model._exit`` (the tp model's fused exit)
    replaced by one whose backward gives the bias and residual cotangents
    on tp rank 0 only, as autograd would if it followed the forward."""
    import torch

    from ray_tpu_torch.models.gpt import _RowParallelExit

    tp = model.tp

    class RankZeroOnly(_RowParallelExit):
        @staticmethod
        def backward(ctx, dout):
            da, dw, db, dres, _ = _RowParallelExit.backward(ctx, dout)
            if tp.rank:
                db, dres = torch.zeros_like(db), torch.zeros_like(dres)
            return da, dw, db, dres, None

    def exit_(a, wt, b, res):
        return RankZeroOnly.apply(a, wt.to(dtype), b.to(dtype), res, tp)

    model._exit = exit_


def tp_train_rank_run(w, part, mode):
    """On a rank of phase 19's gang: GPT-2 small from the seed-0 init and
    phase 16's batch. ``part`` "A" runs GPT(tp=2).loss_chunked over M
    chunks on the mesh {"tp": TP_TRAIN} (the ranks past it return None);
    "B" runs loss_pp over M microbatches on {"pp": PP_SPMD, "tp":
    TP_TRAIN}; "C" runs part A's loss_chunked with fused_entry_exit, with
    remat off and then on. Each rank first computes the one-process
    reference on the full params (loss_chunked, or loss_pp at pp=1; part
    C's fused), takes its shard of the reference gradient and frees the
    rest. ``mode`` "sound": TP_TRAIN_WARMUP + TP_TRAIN_STEPS AdamW steps
    on this rank's shards (part C: for each remat setting, from the same
    shards), the step-0 loss and gradients held to the reference's, the
    kernel launches, collectives and peak memory of the timed steps, and
    (parts A and B) one more step, under torch.profiler on the mesh's
    first rank;
    TP_TRAIN_CONTROL (part A): the step-0 loss and gradients alone, each
    row-parallel exit's backward summing its cotangent over tp;
    TP_FUSED_CONTROL (part C): the same, the fused exit's backward giving
    the bias and residual cotangents on tp rank 0 only. The ranks off
    part A's and C's mesh run their first CUDA work instead."""
    import torch

    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.models.gpt import _LMHead
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_partial_f32_fwd,
                                   matmul_residual_fwd)
    from ray_tpu_torch.parallel.sharding import MeshOwner, lower
    from ray_tpu_torch.parallel.sharding.tensor_parallel import (
        TensorParallel)

    t_start = time.perf_counter()
    dev = torch.device(w.mesh_owner.mesh.device_type)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # every rank builds every mesh, in one order: their groups form
    # collectively
    spec = {"pp": PP_SPMD, "tp": TP_TRAIN} if part == "B" \
        else {"tp": TP_TRAIN}
    owner = MeshOwner(spec, device_type=dev.type)
    ref_owner = MeshOwner({"pp": 1, "dp": -1}, device_type=dev.type) \
        if part == "B" else None
    coord = owner.coordinate()
    c = GPTConfig.small(use_flash=True, fused_entry_exit=part == "C")
    full = GPT(c)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    full_params = full.init(gen)
    batch = PP_SPMD_MICROBATCHES * PP_SPMD_MB
    tokens = torch.randint(0, c.vocab_size, (batch, TRAIN_SEQ),
                           generator=gen, device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    if coord is None:
        # off the tp mesh: this rank's first CUDA work (its context,
        # cuBLAS, the kernels' libraries) runs here, beside the part, and
        # not inside a later part's first step
        with torch.no_grad():
            full.loss_chunked(full_params, tokens[:1], targets[:1])
        sync()
        return None
    M = PP_SPMD_MICROBATCHES
    names = list(full_params)

    def loss_of(model, params, mesh):
        if part == "B":
            return model.loss_pp(params, tokens, targets, mesh,
                                 num_microbatches=M)
        return model.loss_chunked(params, tokens, targets, num_chunks=M)

    for p in full_params.values():
        p.requires_grad_()
    ref_loss = loss_of(full, full_params, ref_owner)
    ref_grads = torch.autograd.grad(ref_loss,
                                    [full_params[n] for n in names])
    model = full.tensor_parallel(TensorParallel.from_owner(owner, "tp"))
    ref = [model.shard_param(n, g) for n, g in zip(names, ref_grads)]
    shards = {n: model.shard_param(n, p.detach()).clone()
              for n, p in full_params.items()}
    del full_params, ref_grads
    out = dict(coord=coord, pid=os.getpid(), device=str(dev),
               ref_loss=float(ref_loss.detach()))
    if mode != "sound":
        tp, dtype = model.tp, c.dtype
        if mode == TP_TRAIN_CONTROL:
            def counted_twice(x, wt):
                part_sum = _LMHead.apply(x.reshape(-1, x.shape[-1]),
                                         wt.to(dtype).T)
                return tp.all_reduce_f32(tp.enter(part_sum)).reshape(
                    *x.shape[:-1], -1).to(dtype)

            model._mm_row = counted_twice
        else:
            _tp_fused_control_exit(model, dtype)
        params = {n: p.requires_grad_() for n, p in shards.items()}
        loss = loss_of(model, params, owner)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        out.update(loss0=float(loss.detach()),
                   rel_err=param_rel_errors(names, grads, ref))
        return out

    counted = (flash_attention_fwd, flash_attention_bwd, ln_matmul_fwd,
               matmul_residual_fwd, matmul_partial_f32_fwd)

    def train(model, profile=True):
        run = {}
        params = {n: p.clone().requires_grad_() for n, p in shards.items()}
        opt = torch.optim.AdamW(list(params.values()), lr=TRAIN_LR,
                                weight_decay=TRAIN_WD)
        losses, walls = [], []
        t_steps = time.perf_counter()
        for step in range(TP_TRAIN_WARMUP + TP_TRAIN_STEPS):
            if step == TP_TRAIN_WARMUP:          # the timed steps start here
                sync()
                for f in counted:
                    f.launches = 0
                lower.collective_stats(reset=True)
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = loss_of(model, params, owner)
            loss.backward()
            if step == 0:
                grads = [params[n].grad for n in names]
                run["rel_err"] = param_rel_errors(names, grads, ref)
                run["grad_digests"] = _digests(dict(zip(names, grads)))
                del grads
            opt.step()
            losses.append(float(loss.detach()))
            sync()
            walls.append(time.perf_counter() - t0)
        t_read = time.perf_counter()
        run["launches"] = {f.__name__: f.launches for f in counted}
        run["collectives"] = lower.collective_stats()
        run["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda \
            else None
        run.update(losses=losses, walls=walls, loss0=losses[0],
                   param_digests=_digests(params))
        t_profile = time.perf_counter()
        if cuda and profile:
            # one more step on every rank, under torch.profiler on the
            # first
            def step():
                opt.zero_grad(set_to_none=True)
                loss_of(model, params, owner).backward()
                opt.step()

            if any(coord.values()):
                step()
                sync()
            else:
                run["profiled"] = profiled(step)[:2]
        run["seconds"] = {k: round(b - a, 1) for k, a, b in (
            ("steps", t_steps, t_read),
            ("profile", t_profile, time.perf_counter()))}
        del params, opt, loss
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return run

    t_set_up = time.perf_counter() - t_start
    if part == "C":
        # no profiled step: parts A and D read the busy share
        for remat in (False, True):
            out["remat_on" if remat else "remat_off"] = train(GPT(
                dataclasses.replace(c, remat=remat), tp=model.tp),
                profile=False)
    else:
        out.update(train(model))
    out["set_up_s"] = round(t_set_up, 1)
    return out


def _leaky_ring(q, k, v, axis_name="sp", causal=True, sm_scale=None):
    """SP_CONTROL: ring_attention with the wrapped shards' mask dropped,
    so a rank's queries attend to the keys of the ranks after it."""
    from ray_tpu_torch.parallel.sharding import lower

    ring = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    sm_scale = 1.0 / q.shape[-1] ** 0.5 if sm_scale is None else sm_scale
    n = lower.axis_size(axis_name)
    out, lse = ring._block_attn_lse(q, k, v, sm_scale, causal=causal)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for _ in range(1, n):
        k = lower.ppermute(k, axis_name, perm, name="ring")
        v = lower.ppermute(v, axis_name, perm, name="ring")
        o_r, lse_r = ring._block_attn_lse(q, k, v, sm_scale, causal=False)
        out, lse = ring._merge(out, lse, o_r, lse_r)
    return out.to(q.dtype)


def sp_train_rank_run(w, mode):
    """On a rank of phase 19's gang, part D: GPT-2 small with seq_axis
    "sp" (remat on) from the seed-0 init and phase 16's batch, trained by
    gpt_sp_loss at MeshSpec(dp=SP_DP, sp=SP): this rank's [batch / SP_DP,
    TRAIN_SEQ / SP] shard, positions global, the params replicated and
    entering through pvary over dp and sp. Each rank first computes the
    one-process reference, GPT.loss with use_flash=False on the whole
    batch, and its gradients. ``mode`` "sound": TP_TRAIN_WARMUP +
    TP_TRAIN_STEPS AdamW steps on the full params, the step-0 loss and
    gradients held to the reference's, the launches, collectives and peak
    memory of the timed steps, and one more step under torch.profiler on
    the mesh's first rank; SP_CONTROL: the step-0 loss and gradients alone,
    through a ring without the wrapped shards' mask. Either way, first,
    each token's cross entropy against the reference's (``token_err``)."""
    import torch

    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.models.gpt import gpt_sp_loss
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_partial_f32_fwd,
                                   matmul_residual_fwd)
    from ray_tpu_torch.parallel.mesh import PartitionSpec
    from ray_tpu_torch.parallel.sharding import MeshOwner, lower

    t_start = time.perf_counter()
    dev = torch.device(w.mesh_owner.mesh.device_type)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    owner = MeshOwner({"dp": SP_DP, "sp": SP}, device_type=dev.type)
    coord = owner.coordinate()
    c = GPTConfig.small(seq_axis="sp")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    full_params = GPT(c).init(gen)
    batch = PP_SPMD_MICROBATCHES * PP_SPMD_MB
    tokens = torch.randint(0, c.vocab_size, (batch, TRAIN_SEQ),
                           generator=gen, device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    names = list(full_params)
    for p in full_params.values():
        p.requires_grad_()
    ref_model = GPT(dataclasses.replace(c, seq_axis=None, use_flash=False))
    ref_loss = ref_model.loss(full_params, tokens, targets)
    ref = torch.autograd.grad(ref_loss, [full_params[n] for n in names])
    b, s = batch // SP_DP, TRAIN_SEQ // SP
    rows = slice(coord["dp"] * b, (coord["dp"] + 1) * b)
    cols = slice(coord["sp"] * s, (coord["sp"] + 1) * s)
    tok, tgt = tokens[rows, cols], targets[rows, cols]

    def token_nll(logits, labels):
        return torch.logsumexp(logits, -1) - logits.gather(
            -1, labels[..., None])[..., 0]

    with torch.no_grad():
        ref_nll = token_nll(ref_model.apply(full_params, tokens[rows]),
                            targets[rows])[:, cols]
    params = {n: p.detach().clone().requires_grad_()
              for n, p in full_params.items()}
    del full_params
    model = GPT(c)
    out = dict(coord=coord, pid=os.getpid(), device=str(dev),
               ref_loss=float(ref_loss.detach()))

    def loss_of():
        return gpt_sp_loss(model, params, tok, tgt, owner,
                           num_chunks=SP_HEAD_CHUNKS)

    def token_err():
        """(rms, max abs) over this rank's tokens of the ring model's
        cross entropy against the reference's, before any step."""
        def body(tk, tg):
            pos = lower.axis_index("sp") * s + torch.arange(
                s, device=tk.device)[None]
            return token_nll(model.apply(params, tk, positions=pos), tg)

        spec = PartitionSpec("dp", "sp")
        with torch.no_grad():
            d = lower.lower_shard_map(body, owner, in_specs=(spec, spec),
                                      out_specs=spec)(tok, tgt) - ref_nll
        return d.square().mean().sqrt().item(), d.abs().max().item()

    if mode == SP_CONTROL:
        gpt_mod = importlib.import_module("ray_tpu_torch.models.gpt")
        gpt_mod.ring_attention = _leaky_ring
        try:
            out["token_err"] = token_err()
            loss = loss_of()
            grads = torch.autograd.grad(loss, [params[n] for n in names])
        finally:
            gpt_mod.ring_attention = importlib.import_module(
                "ray_tpu_torch.ops.ring_attention").ring_attention
        out.update(loss0=float(loss.detach()),
                   rel_err=param_rel_errors(names, grads, ref))
        return out
    out["token_err"] = token_err()

    counted = (flash_attention_fwd, flash_attention_bwd, ln_matmul_fwd,
               matmul_residual_fwd, matmul_partial_f32_fwd)
    opt = torch.optim.AdamW(list(params.values()), lr=TRAIN_LR,
                            weight_decay=TRAIN_WD)
    losses, walls = [], []
    t_steps = time.perf_counter()
    for step in range(TP_TRAIN_WARMUP + TP_TRAIN_STEPS):
        if step == TP_TRAIN_WARMUP:              # the timed steps start here
            sync()
            for f in counted:
                f.launches = 0
            lower.collective_stats(reset=True)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
        if step == 0:
            grads = [params[n].grad for n in names]
            out["rel_err"] = param_rel_errors(names, grads, ref)
            out["grad_digests"] = _digests(dict(zip(names, grads)))
            del ref, grads
        opt.step()
        losses.append(float(loss.detach()))
        sync()
        walls.append(time.perf_counter() - t0)
    t_read = time.perf_counter()
    out["launches"] = {f.__name__: f.launches for f in counted}
    out["collectives"] = lower.collective_stats()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    out.update(losses=losses, walls=walls, loss0=losses[0],
               param_digests=_digests(params))
    t_profile = time.perf_counter()
    if cuda:
        def step():
            opt.zero_grad(set_to_none=True)
            loss_of().backward()
            opt.step()

        if any(coord.values()):
            step()
            sync()
        else:
            out["profiled"] = profiled(step)[:2]
    out["seconds"] = {k: round(b - a, 1) for k, a, b in (
        ("set-up and reference", t_start, t_steps),
        ("steps", t_steps, t_read),
        ("profile", t_profile, time.perf_counter()))}
    del params, opt, loss
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def tp_run_report(label, desc, runs, per_layer_step, fused_per_step,
                  wrappers, driver):
    """Phase 19's checks and lines of one sound run of parts A-C:
    ``runs`` each rank's result, ``per_layer_step`` the flash launches a
    rank a step, ``fused_per_step`` {wrapper name: (least, most)} fused
    launches a rank a step (the others must be 0), ``driver`` the
    driver's launch counts over the run."""
    n_ranks = len(runs)
    worst = [worst_error(r["rel_err"]) for r in runs]
    loss_err = max(abs(r["loss0"] - r["ref_loss"]) for r in runs)
    # ranks of one tp coordinate (a pp group) hold the same shards; the
    # replicated params are the same on every rank
    groups = {}
    for r in runs:
        groups.setdefault(r["coord"]["tp"], []).append(r)
    groups_equal = all(
        r["losses"] == g[0]["losses"]
        and r["grad_digests"] == g[0]["grad_digests"]
        and r["param_digests"] == g[0]["param_digests"]
        for g in groups.values() for r in g[1:])
    replicated_equal = all(
        r["grad_digests"][n] == runs[0]["grad_digests"][n]
        and r["param_digests"][n] == runs[0]["param_digests"][n]
        for r in runs[1:] for n in r["param_digests"]
        if n not in TP_SPLIT_PARAMS)
    names = [f.__name__ for f in wrappers]
    per_step = [{n: r["launches"][n] / TP_TRAIN_STEPS for n in names}
                for r in runs]
    r0 = runs[0]
    p50 = statistics.median(r0["walls"][TP_TRAIN_WARMUP:])
    coll = {k: round(v["seconds"] * 1e3 / TP_TRAIN_STEPS, 3)
            for k, v in sorted(r0["collectives"].items())}
    coll_bytes = {k: v["bytes"] // TP_TRAIN_STEPS
                  for k, v in sorted(r0["collectives"].items())}
    peaks = [None if r["peak_bytes"] is None
             else round(r["peak_bytes"] / 2**30, 2) for r in runs]
    print(f"[tp train] {desc}, {n_ranks} ranks (pids "
          f"{[r['pid'] for r in runs]}): step-0 loss {r0['loss0']!r} "
          f"vs the one-process reference {r0['ref_loss']!r} (worst "
          f"rank {loss_err:.3e}, limit {TOL_TP_LOSS}); worst "
          f"||g - g_ref|| / ||g_ref|| per rank "
          f"{[(n, float(f'{e:.4g}')) for n, e in worst]} (limit "
          f"{TOL_TP_GRAD}); rank 0 per parameter "
          + json.dumps({n: float(f"{e:.4g}")
                        for n, e in r0["rel_err"].items()}))
    print(f"[tp train] {desc}: losses {r0['losses']}; pp groups "
          f"bitwise equal {groups_equal}; replicated params bitwise "
          f"equal on every rank {replicated_equal}; launches a step per "
          f"rank {per_step}; driver {driver}")
    print(f"[tp train] {desc}: step wall "
          f"{[round(t * 1e3, 2) for t in r0['walls']]} ms (p50 of the "
          f"{TP_TRAIN_STEPS} timed {p50 * 1e3:.2f} ms); collectives ms "
          f"a step on rank 0 {coll}, bytes a step {coll_bytes}; peak "
          f"allocated per rank {peaks} GiB; in the ranks "
          f"{[r['seconds'] for r in runs]} s")
    check(all(r["device"].startswith("cuda") for r in runs),
          f"{label}: ranks {[(r['coord'], r['device']) for r in runs]}")
    check(loss_err <= TOL_TP_LOSS,
          f"{label}: step-0 loss off the reference's by {loss_err}")
    check(all(e <= TOL_TP_GRAD for _, e in worst),
          f"{label}: gradients off the reference's: {worst}")
    check(groups_equal, f"{label}: a pp group's ranks differ")
    check(replicated_equal,
          f"{label}: the replicated params differ between ranks")
    check(all(math.isfinite(x) for x in r0["losses"])
          and r0["losses"][-1] < r0["losses"][0],
          f"{label}: losses {r0['losses']}")
    want = {n: fused_per_step.get(n, (0, 0)) for n in names[2:]}
    want.update({n: (per_layer_step, per_layer_step) for n in names[:2]})
    for d in per_step:
        for n, (lo, hi) in want.items():
            check(lo <= d[n] <= hi, f"{label}: {n} launched {d[n]} times "
                  f"a step on a rank, want {lo}-{hi}")
    check(not any(driver.values()),
          f"the driver launched {driver} on the {label} path")
    profiles = {f"rank {i}": kernel_breakdown(
        *r["profiled"], f"tp train {label} rank {i}")
        for i, r in enumerate(runs) if "profiled" in r}
    return dict(
        loss0=r0["loss0"], ref_loss=r0["ref_loss"], loss_err=loss_err,
        worst_grad_err=worst, losses=r0["losses"], step_wall_s=r0["walls"],
        step_p50_s=p50, collectives_ms=coll, collective_bytes=coll_bytes,
        peak_gib=peaks, launches_per_step=per_step, profiles=profiles,
        launches={n: sum(r["launches"][n] for r in runs) for n in names})


def phase_tp_train(wrappers, card, device=None):
    """Phase 19: a tensor-parallel GPT-2 small trained on the card, by a
    gang of TP_TRAIN_RANKS gloo rank processes (module docstring): part
    A, GPT(tp=2).loss_chunked on two of them, its planted control, and
    part B, loss_pp at pp=2 x tp=2 on all four; part C, part A fused
    (remat off, then on), its planted control; part D, ring attention at
    dp=2 x sp=2 on all four, its planted control. Each rank is held to
    the one-process reference it computes itself. The driver's launch
    counts of ``wrappers`` are zeroed just before each sound run and read
    just after (it launches nothing); each rank counts its own timed
    steps. ``device`` (None: the card) is for a rehearsal on the CPU,
    where the checks of the card fail by design."""
    import ray_tpu_torch
    from ray_tpu_torch.models import GPTConfig
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.mesh_group import MeshGroup

    t_phase = time.perf_counter()
    device_type = "cuda" if device is None else str(device)
    c = GPTConfig.small(use_flash=True)
    L = c.n_layer
    ray_tpu_torch.init(num_cpus=TP_TRAIN_RANKS)
    gang = None
    try:
        t0 = time.perf_counter()
        gang = MeshGroup(TP_TRAIN_RANKS, spec=MeshSpec(dp=-1),
                         device_type=device_type)
        up_s = time.perf_counter() - t0
        run_s, driver = {}, {}

        def timed_run(label, fn, *args):
            for f in wrappers:
                f.launches = 0
            t1 = time.perf_counter()
            res = [r for r in gang.run(fn, *args) if r is not None]
            run_s[label] = round(time.perf_counter() - t1, 1)
            driver[label] = {f.__name__: f.launches for f in wrappers}
            return res

        parts = {
            "tp_train": timed_run("tp_train", tp_train_rank_run, "A",
                                  "sound"),
            "control": timed_run("control", tp_train_rank_run, "A",
                                 TP_TRAIN_CONTROL),
            "pp_tp": timed_run("pp_tp", tp_train_rank_run, "B", "sound"),
            "fused_tp": timed_run("fused_tp", tp_train_rank_run, "C",
                                  "sound"),
            "fused_control": timed_run("fused_control", tp_train_rank_run,
                                       "C", TP_FUSED_CONTROL),
            "sp_ring": timed_run("sp_ring", sp_train_rank_run, "sound"),
            "sp_control": timed_run("sp_control", sp_train_rank_run,
                                    SP_CONTROL)}
    finally:
        if gang is not None:
            gang.shutdown()
        ray_tpu_torch.shutdown()

    ticks = PP_SPMD_MICROBATCHES + PP_SPMD - 1
    out = {}
    for label, n_ranks, want in (("tp_train", 2, L),
                                 ("pp_tp", 4, ticks * L // PP_SPMD)):
        runs = parts[label]
        check(len(runs) == n_ranks, f"{label}: {len(runs)} ranks")
        desc = (f"GPT(tp={TP_TRAIN}).loss_chunked" if label == "tp_train"
                else f"loss_pp at pp={PP_SPMD} x tp={TP_TRAIN}")
        out[label] = tp_run_report(label, desc, runs, want, {}, wrappers,
                                   driver[label])
    # part C: the fused entry (ln_matmul) and the row-parallel exits (the
    # f32 instance of mm_res) twice a layer a step; remat recomputes them
    # (the kernels are not dispatcher ops), at most once more
    fused_runs = parts["fused_tp"]
    check(len(fused_runs) == 2, f"fused_tp: {len(fused_runs)} ranks")
    names = [f.__name__ for f in wrappers]
    out["fused_tp"] = {}
    for key, hi in (("remat_off", 2 * L), ("remat_on", 4 * L)):
        runs = [dict(r, **r[key]) for r in fused_runs]
        out["fused_tp"][key] = tp_run_report(
            f"fused_tp {key}", f"GPT(tp={TP_TRAIN}, fused_entry_exit=True)"
            f".loss_chunked, {key.replace('_', ' ')}", runs, L,
            {names[2]: (2 * L, hi), names[4]: (2 * L, hi)}, wrappers,
            driver["fused_tp"])
    out["fused_tp"]["launches"] = {
        n: sum(out["fused_tp"][k]["launches"][n]
               for k in ("remat_off", "remat_on")) for n in names}
    for label, ctl_label, fault in (
            ("control", "tp_train", TP_TRAIN_CONTROL),
            ("fused_control", "fused_tp", TP_FUSED_CONTROL)):
        ctl = parts[label]
        ctl_worst = max((worst_error(r["rel_err"]) for r in ctl),
                        key=lambda x: x[1])
        print(f"[tp train] control '{fault}': worst ||g - g_ref|| / "
              f"||g_ref|| {ctl_worst[1]:.4g} ({ctl_worst[0]}), step-0 "
              f"loss {ctl[0]['loss0']!r}")
        check(ctl_worst[1] > TOL_TP_GRAD,
              f"control '{fault}' passes the gradient check")
        out[ctl_label]["control_worst"] = ctl_worst
    out["sp_ring"] = sp_report(parts["sp_ring"], parts["sp_control"],
                               wrappers, driver["sp_ring"], L)
    phase_s = time.perf_counter() - t_phase
    print(f"[tp train] the phase took {phase_s:.1f} s (gang {up_s:.1f} s, "
          f"runs {run_s} s)")
    out.update(up_s=up_s, run_s=run_s, phase_s=phase_s)
    return out


def sp_report(runs, ctl, wrappers, driver, n_layer):
    """Phase 19 part D's checks and lines: the four ranks' sound run
    (``runs``), its control (``ctl``), the driver's launch counts over
    the sound run and the model's layers."""
    check(len(runs) == SP_DP * SP and all(
        r["device"].startswith("cuda") for r in runs),
        f"sp_ring: ranks {[(r['coord'], r['device']) for r in runs]}")
    worst = [worst_error(r["rel_err"]) for r in runs]
    loss_err = max(abs(r["loss0"] - r["ref_loss"]) for r in runs)

    def token_rms(rs):
        # the ranks' chunks are equal in size
        return math.sqrt(sum(r["token_err"][0] ** 2 for r in rs) / len(rs))

    tok_rms = token_rms(runs)
    tok_max = max(r["token_err"][1] for r in runs)
    r0 = runs[0]
    bitwise = all(r["losses"] == r0["losses"]
                  and r["grad_digests"] == r0["grad_digests"]
                  and r["param_digests"] == r0["param_digests"]
                  for r in runs[1:])
    names = [f.__name__ for f in wrappers]
    launched = {n: sum(r["launches"][n] for r in runs) for n in names}
    p50 = statistics.median(r0["walls"][TP_TRAIN_WARMUP:])
    coll = {k: dict(calls=v["calls"] / TP_TRAIN_STEPS,
                    ms=round(v["seconds"] * 1e3 / TP_TRAIN_STEPS, 3),
                    bytes=v["bytes"] // TP_TRAIN_STEPS)
            for k, v in sorted(r0["collectives"].items())}
    peaks = [None if r["peak_bytes"] is None
             else round(r["peak_bytes"] / 2**30, 2) for r in runs]
    ctl_err = max(abs(r["loss0"] - r["ref_loss"]) for r in ctl)
    ctl_tok_rms = token_rms(ctl)
    ctl_tok_max = max(r["token_err"][1] for r in ctl)
    ctl_worst = max((worst_error(r["rel_err"]) for r in ctl),
                    key=lambda x: x[1])
    desc = f"gpt_sp_loss at dp={SP_DP} x sp={SP} (ring attention)"
    print(f"[tp train] {desc}, {len(runs)} ranks (pids "
          f"{[r['pid'] for r in runs]}): step-0 loss {r0['loss0']!r} vs "
          f"the one-process reference (use_flash=False) "
          f"{r0['ref_loss']!r} (worst rank {loss_err:.3e}, limit "
          f"{TOL_SP_LOSS}); each token's cross entropy against the "
          f"reference's: rms {tok_rms:.3e} (limit {TOL_SP_TOKEN_RMS}), max "
          f"{tok_max:.3e}; worst ||g - g_ref|| / ||g_ref|| per rank "
          f"{[(n, float(f'{e:.4g}')) for n, e in worst]} (limit "
          f"{TOL_TP_GRAD}); rank 0 per parameter "
          + json.dumps({n: float(f"{e:.4g}")
                        for n, e in r0["rel_err"].items()}))
    print(f"[tp train] {desc}: losses {r0['losses']}; ranks bitwise equal "
          f"(losses, step-0 gradients, params) {bitwise}; launches "
          f"{launched}; driver {driver}; control '{SP_CONTROL}': step-0 "
          f"loss {ctl[0]['loss0']!r}, off the reference by {ctl_err:.3e}, "
          f"tokens' cross entropy rms {ctl_tok_rms:.3e}, max "
          f"{ctl_tok_max:.3e}, worst gradient {ctl_worst[1]:.4g} "
          f"({ctl_worst[0]})")
    print(f"[tp train] {desc}: step wall "
          f"{[round(t * 1e3, 2) for t in r0['walls']]} ms (p50 of the "
          f"{TP_TRAIN_STEPS} timed {p50 * 1e3:.2f} ms); collectives a step "
          f"on rank 0 {json.dumps(coll)}; peak allocated per rank {peaks} "
          f"GiB; in the ranks {[r['seconds'] for r in runs]} s")
    def loss_agrees(err, rms):
        return err <= TOL_SP_LOSS and rms <= TOL_SP_TOKEN_RMS

    check(loss_agrees(loss_err, tok_rms),
          f"sp_ring: step-0 loss off the reference's by {loss_err}, the "
          f"tokens' by rms {tok_rms}")
    check(all(e <= TOL_TP_GRAD for _, e in worst),
          f"sp_ring: gradients off the reference's: {worst}")
    check(bitwise, "sp_ring: the ranks differ")
    check(all(math.isfinite(x) for x in r0["losses"])
          and r0["losses"][-1] < r0["losses"][0],
          f"sp_ring: losses {r0['losses']}")
    check(coll.get("ring", {}).get("calls") == 2 * (SP - 1) * n_layer
          and coll.get("ring.T", {}).get("calls") == 2 * (SP - 1)
          * n_layer, f"sp_ring: ppermutes a step {coll}")
    check(not any(launched.values()) and not any(driver.values()),
          f"sp_ring: the ring path launched {launched}, driver {driver}")
    check(not loss_agrees(ctl_err, ctl_tok_rms),
          f"control '{SP_CONTROL}' passes the loss check ({ctl_err}, "
          f"{ctl_tok_rms})")
    profiles = {f"rank {i}": kernel_breakdown(
        *r["profiled"], f"tp train sp_ring rank {i}")
        for i, r in enumerate(runs) if "profiled" in r}
    return dict(
        loss0=r0["loss0"], ref_loss=r0["ref_loss"], loss_err=loss_err,
        token_rms=tok_rms, token_max=tok_max,
        worst_grad_err=worst, losses=r0["losses"], step_wall_s=r0["walls"],
        step_p50_s=p50, collectives=coll, peak_gib=peaks,
        profiles=profiles, launches=launched, control_loss_err=ctl_err,
        control_token_rms=ctl_tok_rms, control_worst=ctl_worst)


def _tree_digest(tree):
    """One sha256 over a dict of tensors' per-tensor digests."""
    import hashlib

    return hashlib.sha256("".join(
        d for _, d in sorted(_digests(tree).items())).encode()).hexdigest()


def _gather(obj, group):
    """[every rank's ``obj``] over ``group`` (gloo, through pickle)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _max_rel_error(got, ref):
    """The largest |got - ref| of a tensor over its largest |ref|, the
    worst over the dict's tensors."""
    return max(float((got[n].float() - ref[n].float()).abs().max())
               / max(float(ref[n].float().abs().max()), 1e-30)
               for n in ref)


def _worst_abs(got, ref):
    return max(float((got[n].float() - ref[n].float()).abs().max())
               for n in ref)


def ddp_gpt_loop(config):
    """Phase 17, part A, on each rank of the JaxTrainer gang: GPT-2 small
    from the seed-0 init on this rank's shard, DDP_WARMUP + DDP_STEPS
    steps of loss_chunked, backward, the gradient mean over the mesh's dp
    axis and AdamW, once for each of ``config["runs"]`` ("sound" first,
    then the controls). The sound run's flash and fused counts and the
    peak memory are zeroed just before its timed steps and read just
    after; its ranks compare their params' digests after every step, and
    rank 0 reports a Checkpoint of its params at the last step. Rank 0
    holds every run to the one-process reference that the driver saved
    at ``config["reference"]`` (its losses, step-0 mean gradient and
    final params: a file, since half a gigabyte through the result queue
    takes seconds a trip) and reports the errors."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_residual_fwd)

    t_enter = time.time()
    rank = train.get_context().get_world_rank()
    mesh = train.get_mesh()
    group = mesh.get_group("dp")
    n = dist.get_world_size(group)
    dev = torch.device(mesh.device_type)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    c = GPTConfig.small(use_flash=True, remat=False)
    model = GPT(c)
    tokens = torch.stack(train.get_dataset_shard("train")).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    counted = (flash_attention_fwd, flash_attention_bwd, ln_matmul_fwd,
               matmul_residual_fwd)
    steps = DDP_WARMUP + DDP_STEPS
    ref = torch.load(config["reference"], map_location=dev) if rank == 0 \
        else None
    setup_s = time.time() - t_enter
    for mode in config["runs"]:
        t_run = time.perf_counter()
        report_s = digest_s = 0.0
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params = model.init(gen)
        for p in params.values():
            p.requires_grad_()
        opt = torch.optim.AdamW(list(params.values()), lr=TRAIN_LR,
                                weight_decay=TRAIN_WD)
        losses, walls, reduce_ms, ranks_equal = [], [], [], []
        for step in range(steps):
            if mode == "sound" and step == DDP_WARMUP:
                sync()           # the timed steps of the main path start
                for f in counted:
                    f.launches = 0
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
            # the ranks start each step together: what one did between
            # steps (a report) stays out of the other's step
            dist.barrier(group=group)
            sync()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = model.loss_chunked(params, tokens, targets)
            loss.backward()
            grads = [p.grad for p in params.values()]
            loss_sum = loss.detach().float().cpu().reshape(1)
            dist.all_reduce(loss_sum, group=group)
            sync()
            t1 = time.perf_counter()
            if mode != DDP_SKIP_CONTROL:
                flat = torch.cat([g.reshape(-1) for g in grads]).cpu()
                dist.all_reduce(flat, group=group)
                flat = flat.to(dev)
                if mode != DDP_HALF_CONTROL:
                    flat /= n
                off = 0
                for g in grads:
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()
                del flat
            sync()
            reduce_ms.append((time.perf_counter() - t1) * 1e3)
            if step == 0:
                grad0 = {nm: p.grad.detach().clone()
                         for nm, p in params.items()}
            opt.step()
            sync()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss_sum / n))
            if mode == "sound":
                t2 = time.perf_counter()
                ranks_equal.append(len(set(_gather(
                    _tree_digest(params), group))) == 1)
                digest_s += time.perf_counter() - t2
            metrics = {"run": mode, "step": step, "loss": losses[-1]}
            ckpt = None
            if mode == "sound" and rank == 0 and step == steps - 1:
                ckpt = train.Checkpoint.from_dict({
                    "step": step,
                    "params": {nm: p.detach() for nm, p in params.items()},
                    "wte_bf16": params["wte"].detach().to(torch.bfloat16)})
            t2 = time.perf_counter()
            train.report(metrics, checkpoint=ckpt)
            report_s += time.perf_counter() - t2
        mine = {"walls": walls, "reduce_ms": reduce_ms,
                "reduce_bytes": sum(g.numel() * 4 for g in grads),
                "final_digest": _tree_digest(params),
                "pid": os.getpid(), "device": str(params["wte"].device)}
        if mode == "sound":
            mine.update(launches={f.__name__: f.launches for f in counted},
                        peak_bytes=torch.cuda.max_memory_allocated()
                        if cuda else None, t_enter=t_enter,
                        param_digests=_digests(params),
                        wte_bf16_digest=_digests({"w": params["wte"].detach(
                        ).to(torch.bfloat16).view(torch.int16)})["w"])
        if ref is not None:
            mine.update(
                losses=losses,
                loss_err=max(abs(a - b) for a, b in
                             zip(losses, ref["losses"])),
                grad0_err=_max_rel_error(grad0, ref["grad0"]),
                grad0_bitwise=_digests(grad0) == _digests(ref["grad0"]),
                param_err=_worst_abs({nm: p.detach() for nm, p in
                                      params.items()}, ref["params"]))
        mine["seconds"] = {k: round(v, 2) for k, v in (
            ("set-up", setup_s), ("run", time.perf_counter() - t_run),
            ("reports", report_s), ("digests", digest_s))}
        every = _gather(mine, group)
        train.report({"run": mode, "ranks": every,
                      "ranks_equal": ranks_equal})
        del params, opt, loss, grads, grad0
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


def resnet_ddp_loop(config):
    """Phase 17, part B, on each rank of the TorchTrainer gang:
    ResNet-18/CIFAR from the seed SEED + 3 init, wrapped in an nn.Module,
    through train.torch.prepare_model (DDP) for the sound run and without
    it for the control, RESNET_DDP_STEPS SGD steps with momentum on this
    rank's images; the ranks compare their params' digests after every
    step. Rank 0 holds every run's final params to the one-process
    reference the driver saved at ``config["reference"]``. After the
    sound run, one gloo all-reduce of a flat f32 buffer of the params'
    size, timed."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import ResNet, ResNetConfig
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_residual_fwd)
    from ray_tpu_torch.train import torch as train_torch

    class ResNetModule(torch.nn.Module):
        """The functional ResNet as a module: its params as Parameters,
        its batch-norm state as buffers, updated by each train-mode
        forward, which returns the loss."""

        def __init__(self, model, params, state):
            super().__init__()
            self.model = model
            self.names = list(params)
            self.state_names = list(state)
            for i, nm in enumerate(self.names):
                self.register_parameter(f"p{i}",
                                        torch.nn.Parameter(params[nm]))
            for i, nm in enumerate(self.state_names):
                self.register_buffer(f"s{i}", state[nm].clone())

        def tree(self):
            return {nm: getattr(self, f"p{i}")
                    for i, nm in enumerate(self.names)}

        def state(self):
            return {nm: getattr(self, f"s{i}")
                    for i, nm in enumerate(self.state_names)}

        def forward(self, images, labels):
            loss, new_state = self.model.loss(self.tree(), self.state(),
                                              images, labels)
            with torch.no_grad():
                for nm, buf in self.state().items():
                    buf.copy_(new_state[nm])
            return loss

    t_enter = time.time()
    rank = train.get_context().get_world_rank()
    group = train.get_mesh().get_group("dp")
    n = dist.get_world_size(group)
    dev = torch.device(train.get_mesh().device_type)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shard = train.get_dataset_shard("train")
    images = torch.stack([im for im, _ in shard]).to(dev)
    labels = torch.stack([lb for _, lb in shard]).to(dev)
    model = ResNet(ResNetConfig.resnet18_cifar())
    counted = (flash_attention_fwd, flash_attention_bwd, ln_matmul_fwd,
               matmul_residual_fwd)
    ref = torch.load(config["reference"], map_location=dev) if rank == 0 \
        else None
    setup_s = time.time() - t_enter
    for mode in config["runs"]:
        t_run = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 3)
        params, state0 = model.init(gen)
        module = ResNetModule(model, params, state0)
        net = train_torch.prepare_model(module) if mode == "sound" \
            else module
        opt = torch.optim.SGD(net.parameters(), lr=RESNET_LR,
                              momentum=RESNET_MOMENTUM)
        if mode == "sound":
            sync()               # the main path's steps start here
            for f in counted:
                f.launches = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats()
        losses, walls, ranks_equal = [], [], []
        for step in range(RESNET_DDP_STEPS):
            dist.barrier(group=group)
            sync()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = net(images, labels)
            loss.backward()
            opt.step()
            sync()
            walls.append(time.perf_counter() - t0)
            loss_sum = loss.detach().float().cpu().reshape(1)
            dist.all_reduce(loss_sum, group=group)
            losses.append(float(loss_sum / n))
            ranks_equal.append(len(set(_gather(
                _tree_digest(module.tree()), group))) == 1)
            train.report({"run": mode, "step": step, "loss": losses[-1]})
        final = {nm: p.detach() for nm, p in module.tree().items()}
        mine = {"walls": walls, "pid": os.getpid(),
                "device": str(final[module.names[0]].device),
                "state_moved": sum(not torch.equal(module.state()[nm],
                                                   state0[nm])
                                   for nm in state0),
                "state_digest": _tree_digest(module.state())}
        out = {"run": mode}
        if mode == "sound":
            mine.update(launches={f.__name__: f.launches for f in counted},
                        peak_bytes=torch.cuda.max_memory_allocated()
                        if cuda else None, t_enter=t_enter)
            flat = torch.cat([p.reshape(-1) for p in final.values()])
            ms = []
            for _ in range(TRAIN_COLLECTIVE_REPS):
                sync()
                t0 = time.perf_counter()
                dist.all_reduce(flat, group=group)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            mine.update(reduce_ms=ms, reduce_bytes=flat.numel() * 4)
        if ref is not None:
            mine.update(param_err=_worst_abs(final, ref),
                        bitwise=_digests(final) == _digests(ref))
        mine["seconds"] = {"set-up": round(setup_s, 2),
                           "run": round(time.perf_counter() - t_run, 2)}
        out.update(ranks=_gather(mine, group), ranks_equal=ranks_equal)
        train.report(out)
        del net, module, opt, loss
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


def _train_fit(trainer_cls, loop, config, datasets, device_type, storage):
    """trainer_cls(loop).fit() on TRAIN_WORKERS ranks; (result, the fit's
    wall seconds, its start on the host's wall clock)."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig

    t_wall = time.time()
    t0 = time.perf_counter()
    result = trainer_cls(
        loop, train_loop_config=config, datasets=datasets,
        scaling_config=ScalingConfig(num_workers=TRAIN_WORKERS,
                                     device_type=device_type),
        run_config=RunConfig(name=loop.__name__,
                             storage_path=storage)).fit()
    check(result.error is None, f"{loop.__name__}: fit failed: "
                                f"{result.error!r}")
    return result, time.perf_counter() - t0, t_wall


def _runs(result):
    """{run: (its step reports, its closing report)} of a fit's history
    (rank 0's reports)."""
    out = {}
    for m in result.metrics_history:
        steps, _ = out.setdefault(m["run"], ([], None))
        if "ranks" in m:
            out[m["run"]] = (steps, m)
        else:
            steps.append(m)
    return out


def ddp_reference(model, params0, tokens, targets, steps):
    """Part A's one-process reference: each rank's shard's gradient in
    turn, their mean, AdamW. (losses, step-0 mean gradient, final params,
    step walls)."""
    import torch

    params = {nm: p.detach().clone().requires_grad_()
              for nm, p in params0.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=TRAIN_LR,
                            weight_decay=TRAIN_WD)
    losses, walls = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, shard_losses = [], []
        for r in range(TRAIN_WORKERS):
            opt.zero_grad(set_to_none=True)
            loss = model.loss_chunked(params, tokens[r::TRAIN_WORKERS],
                                      targets[r::TRAIN_WORKERS])
            loss.backward()
            grads.append({nm: p.grad for nm, p in params.items()})
            shard_losses.append(loss.detach().float())
        for nm, p in params.items():
            total = grads[0][nm]
            for g in grads[1:]:
                total = total + g[nm]
            p.grad = total / TRAIN_WORKERS
        if step == 0:
            grad0 = {nm: p.grad.detach().clone() for nm, p in params.items()}
        opt.step()
        loss_sum = shard_losses[0]
        for x in shard_losses[1:]:
            loss_sum = loss_sum + x
        losses.append(float(loss_sum / TRAIN_WORKERS))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del grads
    return losses, grad0, {nm: p.detach() for nm, p in params.items()}, walls


def resnet_reference(model, params0, state0, images, labels):
    """Part B's one-process reference: SGD with momentum on the mean of
    the two shards' gradients (train mode: batch statistics, so the
    gradients do not read the running state). (final params, walls)."""
    import torch

    params = {nm: p.detach().clone().requires_grad_()
              for nm, p in params0.items()}
    opt = torch.optim.SGD(list(params.values()), lr=RESNET_LR,
                          momentum=RESNET_MOMENTUM)
    walls = []
    for _ in range(RESNET_DDP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = []
        for r in range(TRAIN_WORKERS):
            loss, _ = model.loss(params, state0, images[r::TRAIN_WORKERS],
                                 labels[r::TRAIN_WORKERS])
            grads.append(torch.autograd.grad(loss, list(params.values())))
        for p, g0, g1 in zip(params.values(), *grads):
            p.grad = (g0 + g1) / TRAIN_WORKERS
        opt.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {nm: p.detach() for nm, p in params.items()}, walls


def phase_train(wrappers, card, device=None):
    """Phase 17: the train package on the card (module docstring): part A,
    GPT-2 small DDP by JaxTrainer, and part B, ResNet-18/CIFAR by
    TorchTrainer, each on TRAIN_WORKERS gang workers, each held to its
    one-process reference in this process. The driver's launch counts of
    ``wrappers`` are zeroed just before each fit and read just after (it
    launches nothing then); each rank counts its own sound run.
    ``device`` (None: the card) is for a rehearsal on the CPU, where the
    checks of the card fail by design."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch
    from ray_tpu_torch.models import GPT, GPTConfig, ResNet, ResNetConfig
    from ray_tpu_torch.train import Checkpoint, JaxTrainer, TorchTrainer

    t_phase = time.perf_counter()
    device_type = "cuda" if device is None else str(device)
    dev = torch.device(device_type)
    label = "train"
    storage = tempfile.mkdtemp(prefix="rtpu_train_")
    # the GPT gradient and params come back through the object store
    ray_tpu_torch.init(num_cpus=4, object_store_memory=8 << 30)
    try:
        # ---- part A: GPT-2 small DDP by JaxTrainer ----------------------
        c = GPTConfig.small(use_flash=True, remat=False)
        model = GPT(c)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params0 = model.init(gen)
        tokens = torch.randint(0, c.vocab_size, (TRAIN_DDP_SEQS, TRAIN_SEQ),
                               generator=gen, device=dev)
        targets = torch.roll(tokens, -1, dims=1)
        t_ref = time.perf_counter()
        ref_losses, ref_grad0, ref_params, ref_walls = ddp_reference(
            model, params0, tokens, targets, DDP_WARMUP + DDP_STEPS)
        reference = os.path.join(storage, "ddp_reference.pt")
        torch.save({"losses": ref_losses, "grad0": ref_grad0,
                    "params": ref_params}, reference)
        del params0, ref_grad0
        ref_s = time.perf_counter() - t_ref
        gc.collect()
        if device is None:
            torch.cuda.empty_cache()
        for f in wrappers:                 # the train ddp path starts here
            f.launches = 0
        ddp, ddp_s, ddp_t0 = _train_fit(
            JaxTrainer, ddp_gpt_loop,
            {"runs": ["sound", DDP_SKIP_CONTROL, DDP_HALF_CONTROL],
             "reference": reference},
            {"train": list(tokens.cpu())}, device_type, storage)
        ddp_driver = {f.__name__: f.launches for f in wrappers}
        t_ckpt = time.perf_counter()
        ckpt = Checkpoint.from_directory(
            ddp.checkpoint.to_directory()).to_dict()
        ckpt_s = time.perf_counter() - t_ckpt
        runs = _runs(ddp)
        steps, closing = runs["sound"]
        r0 = closing["ranks"][0]
        losses = [m["loss"] for m in steps]
        grad_err = r0["grad0_err"]
        ckpt_params = {nm: torch.from_numpy(a)
                       for nm, a in ckpt["params"].items()}
        param_err = _worst_abs({nm: t.to(dev) for nm, t in
                                ckpt_params.items()}, ref_params)
        loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
        bitwise = (losses == ref_losses and r0["grad0_bitwise"]
                   and r0["param_digests"] == _digests(ref_params))
        ckpt_ok = (_digests(ckpt_params) == r0["param_digests"]
                   and ckpt["wte_bf16"].dtype == torch.bfloat16
                   and _digests({"w": ckpt["wte_bf16"].view(torch.int16)}
                                )["w"] == r0["wte_bf16_digest"])
        del ckpt, ckpt_params, ref_params
        loss0 = math.log(c.padded_vocab) + c.d_model * 0.02 ** 2 / 2
        devices = [r["device"] for r in closing["ranks"]]
        print(f"[{label}] part A: GPT-2 small DDP by JaxTrainer, "
              f"{TRAIN_WORKERS} workers (pids "
              f"{[r['pid'] for r in closing['ranks']]}, driver "
              f"{os.getpid()}, devices {devices}), {TRAIN_DDP_SEQS} x "
              f"{TRAIN_SEQ} tokens dealt by get_dataset_shard: mean losses "
              f"{losses}; reference {ref_losses}; step-0 target "
              f"{loss0:.4f}; ranks bitwise equal after each step "
              f"{closing['ranks_equal']}; against the reference: worst loss "
              f"difference {loss_err} (limit {TOL_DDP_LOSS}), step-0 mean "
              f"gradient {grad_err} (limit {TOL_DDP_GRAD}), worst final "
              f"param {param_err} (limit {TOL_DDP_PARAM}); bit for bit "
              f"(predicted): {bitwise}; the persisted checkpoint bitwise "
              f"rank 0's params and bf16 wte: {ckpt_ok}")
        check(all(d.startswith(device_type) for d in devices),
              f"a train rank is not on {device_type}: {devices}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(abs(losses[0] - loss0) <= TOL_LOSS0,
              f"step-0 loss {losses[0]} is not {loss0:.4f} within "
              f"{TOL_LOSS0}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(all(closing["ranks_equal"]),
              "the DDP ranks are not bitwise equal after every step")
        check(loss_err <= TOL_DDP_LOSS,
              f"a mean loss is off the reference's by {loss_err}")
        check(grad_err <= TOL_DDP_GRAD,
              f"the step-0 mean gradient is off the reference's by "
              f"{grad_err}")
        check(param_err <= TOL_DDP_PARAM,
              f"a final param is off the reference's by {param_err}")
        check(ckpt_ok, "the persisted checkpoint is not rank 0's params")
        want = {"flash_attention_fwd": c.n_layer,
                "flash_attention_bwd": c.n_layer}
        per_step = [{nm: r["launches"][nm] / DDP_STEPS for nm in want}
                    for r in closing["ranks"]]
        print(f"[{label}] part A launches a timed step per rank "
              f"{per_step} (want {want}); fused "
              f"{[{k: v for k, v in r['launches'].items() if k not in want} for r in closing['ranks']]}"
              f"; driver during the fit {ddp_driver}")
        check(all(p == want for p in per_step),
              f"launches a step per rank {per_step}, want {want}")
        check(not any(v for r in closing["ranks"]
                      for k, v in r["launches"].items() if k not in want),
              "a DDP rank launched a fused kernel")
        check(not any(ddp_driver.values()),
              f"the driver launched {ddp_driver} during the fit")
        ctl = {}
        for mode in (DDP_SKIP_CONTROL, DDP_HALF_CONTROL):
            _, m = runs[mode]
            rs = m["ranks"]
            ctl[mode] = dict(
                ranks_equal=len({r["final_digest"] for r in rs}) == 1,
                loss_err=rs[0]["loss_err"], grad0_err=rs[0]["grad0_err"],
                param_err=rs[0]["param_err"])
            print(f"[{label}] part A control '{mode}' against the "
                  f"reference: {ctl[mode]}")
            fails = (not ctl[mode]["ranks_equal"]
                     or ctl[mode]["loss_err"] > TOL_DDP_LOSS
                     or ctl[mode]["grad0_err"] > TOL_DDP_GRAD
                     or ctl[mode]["param_err"] > TOL_DDP_PARAM)
            check(fails, f"control '{mode}' passes the checks")
        ddp_walls = [r["walls"][DDP_WARMUP:] for r in closing["ranks"]]
        step_p50 = statistics.median(ddp_walls[0])
        ref_p50 = statistics.median(ref_walls[DDP_WARMUP:])
        reduce_ms = [statistics.median(r["reduce_ms"][DDP_WARMUP:])
                     for r in closing["ranks"]]
        up_s = max(r["t_enter"] for r in closing["ranks"]) - ddp_t0
        peaks = [r["peak_bytes"] for r in closing["ranks"]]

        def gib(b):
            return None if b is None else round(b / 2**30, 2)

        print(f"[{label}] part A {card}: step wall per rank "
              f"{[[round(t * 1e3, 2) for t in w] for w in ddp_walls]} ms "
              f"(rank 0 p50 {step_p50 * 1e3:.2f}) against the reference's "
              f"{[round(t * 1e3, 2) for t in ref_walls]} ms (p50 "
              f"{ref_p50 * 1e3:.2f}: both shards in turn); the gradient "
              f"mean (to the host, gloo all-reduce, back) p50 "
              f"{[round(x, 2) for x in reduce_ms]} ms a step per rank for "
              f"{r0['reduce_bytes']} B; gang up {up_s:.1f} s after fit(); "
              f"peak allocated per rank {[gib(p) for p in peaks]} GiB; "
              f"fit {ddp_s:.1f} s (in the ranks, s: "
              f"{[r['seconds'] for r in closing['ranks']]}; controls "
              f"{[runs[m][1]['ranks'][0]['seconds'] for m in ctl]}); the "
              f"reference and its file {ref_s:.1f} s; the checkpoint read "
              f"back {ckpt_s:.1f} s")
        gc.collect()
        if device is None:
            torch.cuda.empty_cache()
        # ---- part B: ResNet-18/CIFAR by TorchTrainer ---------------------
        rc = ResNetConfig.resnet18_cifar()
        rmodel = ResNet(rc)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 3)
        rparams0, rstate0 = rmodel.init(gen)
        images = torch.randn((RESNET_BATCH, 32, 32, 3), generator=gen,
                             device=dev)
        labels = torch.randint(0, rc.num_classes, (RESNET_BATCH,),
                               generator=gen, device=dev)
        cudnn = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            rref, rref_walls = resnet_reference(rmodel, rparams0, rstate0,
                                                images, labels)
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = cudnn
        rreference = os.path.join(storage, "resnet_reference.pt")
        torch.save(rref, rreference)
        for f in wrappers:              # the train resnet path starts here
            f.launches = 0
        rn, rn_s, rn_t0 = _train_fit(
            TorchTrainer, resnet_ddp_loop,
            {"runs": ["sound", RESNET_DDP_CONTROL],
             "reference": rreference},
            {"train": list(zip(images.cpu(), labels.cpu()))}, device_type,
            storage)
        rn_driver = {f.__name__: f.launches for f in wrappers}
        rruns = _runs(rn)
        rsteps, rclosing = rruns["sound"]
        rlosses = [m["loss"] for m in rsteps]
        rparam_err = rclosing["ranks"][0]["param_err"]
        rbitwise = rclosing["ranks"][0]["bitwise"]
        moved = [r["state_moved"] for r in rclosing["ranks"]]
        states_equal = len({r["state_digest"]
                            for r in rclosing["ranks"]}) == 1
        _, rctl = rruns[RESNET_DDP_CONTROL]
        rlaunches = [r["launches"] for r in rclosing["ranks"]]
        print(f"[{label}] part B: ResNet-18/CIFAR by TorchTrainer, "
              f"{TRAIN_WORKERS} workers, {RESNET_BATCH // TRAIN_WORKERS} "
              f"images a rank: mean losses {rlosses}; ranks' params "
              f"bitwise equal after each step {rclosing['ranks_equal']}; "
              f"worst final param off the reference's {rparam_err} (limit "
              f"{TOL_RESNET_DDP_PARAM}; bit for bit: {rbitwise}); "
              f"batch-norm buffers moved per rank {moved} of "
              f"{len(rstate0)}; the ranks' batch-norm state equal after "
              f"the last step: {states_equal} (DDP's broadcast_buffers "
              f"hands every rank rank 0's buffers before each forward; "
              f"each forward then updates them from its own shard); "
              f"launches per rank {rlaunches}; driver during the fit "
              f"{rn_driver}; control '{RESNET_DDP_CONTROL}': ranks equal "
              f"{rctl['ranks_equal']}, worst param off the reference's "
              f"{rctl['ranks'][0]['param_err']}")
        check(all(math.isfinite(x) for x in rlosses), f"losses {rlosses}")
        check(rlosses[-1] < rlosses[0], f"loss did not fall: {rlosses}")
        check(all(rclosing["ranks_equal"]),
              "the ResNet ranks are not bitwise equal after every step")
        check(rparam_err <= TOL_RESNET_DDP_PARAM,
              f"a ResNet param is off the reference's by {rparam_err}")
        check(all(m == len(rstate0) for m in moved),
              f"batch-norm buffers did not move: {moved}")
        check(not any(v for r in rlaunches for v in r.values()),
              f"a ResNet rank launched {rlaunches}")
        check(not any(rn_driver.values()),
              f"the driver launched {rn_driver} during the fit")
        check(not all(rctl["ranks_equal"]),
              f"control '{RESNET_DDP_CONTROL}' passes the ranks check")
        rwalls = [r["walls"] for r in rclosing["ranks"]]
        rreduce = [statistics.median(r["reduce_ms"])
                   for r in rclosing["ranks"]]
        rup_s = max(r["t_enter"] for r in rclosing["ranks"]) - rn_t0
        rpeaks = [r["peak_bytes"] for r in rclosing["ranks"]]
        phase_s = time.perf_counter() - t_phase
        print(f"[{label}] part B {card}: step wall per rank "
              f"{[[round(t * 1e3, 2) for t in w] for w in rwalls]} ms "
              f"(rank 0 p50 {statistics.median(rwalls[0]) * 1e3:.2f}) "
              f"against the reference's "
              f"{[round(t * 1e3, 2) for t in rref_walls]} ms (p50 "
              f"{statistics.median(rref_walls) * 1e3:.2f}: both shards in "
              f"turn); one gloo all-reduce of the params' "
              f"{rclosing['ranks'][0]['reduce_bytes']} B, measured apart: "
              f"{[round(x, 2) for x in rreduce]} ms per rank; gang up "
              f"{rup_s:.1f} s after fit(); peak allocated per rank "
              f"{[gib(p) for p in rpeaks]} GiB; fit {rn_s:.1f} s (in the "
              f"ranks, s: {[r['seconds'] for r in rclosing['ranks']]}; "
              f"control {rctl['ranks'][0]['seconds']}); the phase took "
              f"{phase_s:.1f} s")
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    # each path's launches: its ranks' sound runs
    launches = {path: {f.__name__: sum(r["launches"][f.__name__]
                                       for r in ranks) for f in wrappers}
                for path, ranks in (("train_ddp", closing["ranks"]),
                                    ("train_resnet", rclosing["ranks"]))}
    return dict(
        ddp=dict(losses=losses, reference_losses=ref_losses,
                 ranks_equal=closing["ranks_equal"], bitwise=bitwise,
                 loss_err=loss_err, grad0_err=grad_err, param_err=param_err,
                 checkpoint_ok=ckpt_ok, controls=ctl,
                 launches_per_step=per_step, step_wall_s=ddp_walls,
                 step_p50_s=step_p50, reference_step_wall_s=ref_walls,
                 reference_step_p50_s=ref_p50, reduce_ms=reduce_ms,
                 reduce_bytes=r0["reduce_bytes"], up_s=up_s,
                 peak_bytes=peaks, fit_s=ddp_s),
        resnet=dict(losses=rlosses, ranks_equal=rclosing["ranks_equal"],
                    param_err=rparam_err, bitwise=rbitwise,
                    state_moved=moved, states_equal=states_equal,
                    control_ranks_equal=rctl["ranks_equal"],
                    control_param_err=rctl["ranks"][0]["param_err"],
                    launches=rlaunches, step_wall_s=rwalls,
                    reference_step_wall_s=rref_walls, reduce_ms=rreduce,
                    reduce_bytes=rclosing["ranks"][0]["reduce_bytes"],
                    up_s=rup_s, peak_bytes=rpeaks, fit_s=rn_s),
        phase_s=phase_s, launches=launches)


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
    # cuBLAS's workspace (its Hopper default), fixed before the first
    # cuBLAS call here and inherited by every worker process: phase 13
    # holds stage processes to this one bit for bit
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    from ray_tpu_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                   ln_matmul_fwd, matmul_partial_f32_fwd,
                                   matmul_residual_fwd)
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
            tp_ref = {}
            forward = phase_forward(server, tp_ref)
            serving = phase_serving(server, tp_ref)
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
        print(f"[tp] Llama-2-7B at tp=1 released: "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        tp_serving = phase_tp(tp_ref, card)
        del tp_ref
        gc.collect()
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
        remat_phase = phase_remat(wrappers)
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
        gc.collect()
        torch.cuda.empty_cache()
        pipeline = phase_pipeline(wrappers, card)
        gc.collect()
        torch.cuda.empty_cache()
        pp_spmd = phase_pp_spmd(wrappers, card)
        gc.collect()
        torch.cuda.empty_cache()
        tp_train = phase_tp_train(wrappers + (matmul_partial_f32_fwd,),
                                  card)
        gc.collect()
        torch.cuda.empty_cache()
        train_phase = phase_train(wrappers, card)
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

    def fsdp_launches(wrapper):
        # the driver's count and every rank's on the fsdp pipeline path
        f = pipeline["fsdp"]
        return f["driver_launches"][wrapper.__name__] + sum(
            counts[wrapper.__name__]
            for counts in f["stage_launches"] + f["peer_launches"])

    fwd_launches = dict(serving=serving_launches,
                        training=training["launches"]["flash_fwd"],
                        training_fused=training_fused["launches"]["flash_fwd"],
                        moe_training=moe_training["launches"]["flash_fwd"],
                        gpt_serving=gpt_serving["launches"][
                            flash_attention_fwd.__name__],
                        disagg=disagg_launches(flash_attention_fwd),
                        pipeline=pipeline["launches"]["flash_fwd"],
                        pipeline_fsdp=fsdp_launches(flash_attention_fwd),
                        tp=tp_serving["launches"],
                        pp_spmd=pp_spmd["launches"]["flash_fwd"],
                        remat=remat_phase["launches"][
                            flash_attention_fwd.__name__],
                        **{path: tp_train[path]["launches"][
                            flash_attention_fwd.__name__]
                           for path in TP_TRAIN_PATHS},
                        **{path: counts[flash_attention_fwd.__name__]
                           for path, counts in
                           train_phase["launches"].items()})
    bwd_launches = dict(training=training["launches"]["flash_bwd"],
                        training_fused=training_fused["launches"]["flash_bwd"],
                        moe_training=moe_training["launches"]["flash_bwd"],
                        disagg=disagg_launches(flash_attention_bwd),
                        pipeline=pipeline["launches"]["flash_bwd"],
                        pipeline_fsdp=fsdp_launches(flash_attention_bwd),
                        pp_spmd=pp_spmd["launches"]["flash_bwd"],
                        remat=remat_phase["launches"][
                            flash_attention_bwd.__name__],
                        **{path: tp_train[path]["launches"][
                            flash_attention_bwd.__name__]
                           for path in TP_TRAIN_PATHS},
                        **{path: counts[flash_attention_bwd.__name__]
                           for path, counts in
                           train_phase["launches"].items()})

    def pipeline_launches(wrapper):
        # the driver's count and every stage's on the pipeline path
        return pipeline["driver_launches"][wrapper.__name__] + sum(
            counts[wrapper.__name__]
            for counts in pipeline["stage_launches"])

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
        # the tp fused path's launches: ln_matmul, or both instances of
        # mm_res (its exits take the f32 one)
        tp_fused = tp_train["fused_tp"]["launches"]
        fused_tp = tp_fused[ln_matmul_fwd.__name__] if name == "ln_matmul" \
            else (tp_fused[matmul_residual_fwd.__name__]
                  + tp_fused[matmul_partial_f32_fwd.__name__])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": [replaces],
            "launches_by_path": {
                "fused_tp": fused_tp,
                "training_fused": training_fused["launches"][name],
                "disagg": disagg_launches(
                    ln_matmul_fwd if name == "ln_matmul"
                    else matmul_residual_fwd),
                "pipeline": pipeline_launches(
                    ln_matmul_fwd if name == "ln_matmul"
                    else matmul_residual_fwd),
                "pipeline_fsdp": fsdp_launches(
                    ln_matmul_fwd if name == "ln_matmul"
                    else matmul_residual_fwd),
                "pp_spmd": pp_spmd["fused_launches"][
                    (ln_matmul_fwd if name == "ln_matmul"
                     else matmul_residual_fwd).__name__],
                **{path: counts[(ln_matmul_fwd if name == "ln_matmul"
                                 else matmul_residual_fwd).__name__]
                   for path, counts in train_phase["launches"].items()}},
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
        kernels[-1]["launches"] = sum(
            kernels[-1]["launches_by_path"].values())
        if name == "mm_res":
            # the f32-output instance (the tp exits' partials), launched
            # on the fused_tp path only
            kernels[-1]["f32_partial_launches"] = tp_fused[
                matmul_partial_f32_fwd.__name__]
    summary = {"forward": forward, "serving": serving,
               "tp_serving": tp_serving, "training": training,
               "training_fused": training_fused,
               "moe_training": moe_training, "vit": vit, "resnet": resnet,
               "head_dims": head_dims, "gpt_serving": gpt_serving,
               "disagg": disagg, "pipeline": pipeline, "pp_spmd": pp_spmd,
               "train": train_phase, "remat": remat_phase,
               "tp_train": tp_train,
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
