#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build    — compile ray_tpu_torch/csrc/flash_fwd.cu with nvcc for
              sm_90a; print the card's name and power limit.
2. kernels  — each kernel against its plain PyTorch version on the same
              inputs at the main path's shapes, with the tolerances below,
              and a planted lower-precision control that must fail them;
              kernel, plain and library-call times with CUDA events, and the
              card's bound for the same work; then, untimed, at the shapes
              and types that reach the kernel's other instances.
3. forward  — Llama-2-7B at full width (32 layers, d_model 4096, 32 heads,
              bf16, random weights from seed 0): `apply` on [1, 1024] and
              [1, 4096] tokens must launch the flash kernel once per layer
              and match the same forward through mha_reference; three
              planted faults in that reference forward must not.
4. serving  — LLMServer("llama2-7b") answers 8 concurrent requests; every
              request finishes by length, no KV block leaks, and each
              prompt's paged-prefill logits match the dense flash forward.

The launch counts are zeroed just before phase 3 and read after phase 4;
the kernel comparisons of phase 2 do not count. The last three lines are
the card (as nvidia-smi prints it), the kernels JSON line and the result
JSON line. Without a CUDA device, or without the ray_tpu_torch package
beside this file, the script fails before printing any result.
"""
from __future__ import annotations

import dataclasses
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

KERNEL_CASES = [  # (label, [B, S, H, D], dtype, causal)
    ("main path S=1024", (1, 1024, 32, 128), "bfloat16", True),
    ("main path S=4096", (1, 4096, 32, 128), "bfloat16", True),
    ("non-causal", (2, 256, 12, 64), "bfloat16", False),
    ("f32", (2, 256, 4, 32), "float32", True),
]
# Checked against the plain version but not timed: the kernel's other
# template instances (bf16 hd 32, f32 hd 64 and 128), a length that is a
# multiple of 64 but not of 128, and non-causal attention with seq_q !=
# seq_k. (label, [B, Sq, H, D], Sk, dtype, causal)
CHECK_CASES = [
    ("bf16 hd32 S=192", (2, 192, 8, 32), 192, "bfloat16", True),
    ("bf16 Sq!=Sk", (1, 128, 4, 64), 320, "bfloat16", False),
    ("f32 hd64 Sq!=Sk", (1, 64, 2, 64), 256, "float32", False),
    ("f32 hd128", (1, 256, 2, 128), 256, "float32", True),
]
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
    report = _build.build("flash_fwd")
    build_s = time.perf_counter() - t0
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] flash_fwd: {line.strip()}")
    print(f"[build] flash_fwd built in {build_s:.2f} s")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[build] card: {card}")
    return card


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention_fwd, flash_attention_fwd_plain

    rows = []
    for i, (label, shape, dtype, causal) in enumerate(KERNEL_CASES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + i)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=getattr(torch, dtype)) for _ in range(3))
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
        long = shape[1] >= 4096
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal),
                     reps=10 if long else 30)
        plain_ms = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, causal),
                           reps=2 if long else 10, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=10 if long else 30)
        bound_ms, bound_by = flash_bound(shape, dtype, causal)
        row = dict(label=label, shape=list(shape), dtype=dtype, causal=causal,
                   max_abs_err=err_out, row_scaled_err=err_row,
                   lse_max_abs_err=err_lse, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        print(f"[kernels] flash_fwd {label} {list(shape)} {dtype} "
              f"causal={causal}: out err {err_out:.3e} (tol "
              f"{TOL_OUT[dtype]}), row-scaled {err_row:.3e} (tol "
              f"{TOL_OUT_ROW[dtype]}), lse err {err_lse:.3e} (tol "
              f"{TOL_LSE[dtype]}){control}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
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
    for i, (label, shape, sk, dtype, causal) in enumerate(CHECK_CASES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + len(KERNEL_CASES) + i)
        b, sq, h, d = shape
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda",
                               dtype=getattr(torch, dtype))
                   for n in (sq, sk, sk))
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
    from ray_tpu_torch.ops import flash_attention_fwd
    from ray_tpu_torch.serve.llm import LLMServer

    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}")
    server = None
    try:
        with torch.no_grad():
            card = phase_build()
            rows = phase_kernels()
            t0 = time.perf_counter()
            server = LLMServer("llama2-7b", engine_config=ENGINE_CONFIG,
                               seed=SEED)
            torch.cuda.synchronize()
            print(f"[serving] LLMServer('llama2-7b') built in "
                  f"{time.perf_counter() - t0:.1f} s, "
                  f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB "
                  f"allocated")
            flash_attention_fwd.launches = 0      # the main path starts here
            forward = phase_forward(server)
            serving = phase_serving(server)
            launches = flash_attention_fwd.launches
            check(launches > 0, "the main path never launched flash_fwd")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if server is not None:
            server.shutdown()
    print(f"[memory] peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    main_row = next(r for r in rows if r["shape"][1] == 4096)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        # one CUDA kernel computes the function of both forward kernels:
        # the tiled one (S > 1024) and the single-block one (S <= 1024)
        "replaces": ["ray_tpu/ops/flash_attention.py:59",
                     "ray_tpu/ops/flash_attention.py:110"],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "bfloat16"),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "[1, 4096, 32, 128] bf16 causal",
        "by_shape": rows,
    }]
    summary = {"forward": forward, "serving": serving}
    print(f"[summary] {json.dumps(summary)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
