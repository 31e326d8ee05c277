"""Disaggregated prefill/decode — stage actors wired by a compiled graph
(counterpart of ray_tpu/serve/llm/disagg.py).

Prefill (compute-bound, batch-1 bucketed forward) and decode
(bandwidth-bound, iteration-batched) have opposite hardware profiles;
serving systems split them across accelerator pools. Here the split is a
two-stage cgraph pipeline: a PrefillStage actor computes a prompt's KV
into block-shaped tensors and ships them over the pre-allocated cgraph
channel to a DecodeStage actor, whose engine adopts the blocks
(`LLMEngine.add_prefilled`) and streams out the completion — the decode
loop never pays a prefill pass.

    llm = DisaggLLM(model="gpt-tiny", device="cpu")
    try:
        out = llm.generate([1, 5, 9], max_tokens=16)
    finally:
        llm.shutdown()

Each stage builds its model in its own worker process on ``device``
(None = the CUDA card; workers start by exec, never by fork, so each
opens its own CUDA context). The KV leaves the card as host tensors in
the cache's dtype: the channel carries bytes, never a device tensor.

Both stage methods are pure compute (no dynamic .remote()/get inside the
bound methods — the contract for compiled-graph actors).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .engine import EngineConfig, LLMEngine
from .kv_cache import blocks_for_tokens


def _placement(device: torch.device) -> Dict[str, Any]:
    """Where a stage runs: its worker's pid, its device, the bytes it
    holds there, the envelope bytes this process has written to
    compiled-graph channels (``ray_tpu_cgraph_channel_bytes_total``; for
    the prefill stage, the KV shipments), and the launches of each
    hand-written kernel in this process since it started (the paged path
    launches none)."""
    from ...cgraph.channel import _C_CHAN_BYTES
    from ...ops import (flash_attention_bwd, flash_attention_fwd,
                        ln_matmul_fwd, matmul_residual_fwd)

    held = (torch.cuda.memory_allocated(device)
            if device.type == "cuda" else 0)
    return {"pid": os.getpid(), "device": str(device),
            "memory_allocated": int(held),
            "channel_bytes_sent": int(_C_CHAN_BYTES.total()),
            "kernel_launches": {f.__name__: f.launches for f in (
                flash_attention_fwd, flash_attention_bwd, ln_matmul_fwd,
                matmul_residual_fwd)}}


class PrefillStage:
    """Computes prompt KV as pool-block-shaped tensors. Bound into the
    cgraph as stage 1. ``model`` is what ``build_model`` takes, or an
    already built ``(model, params)`` pair (then ``seed`` and ``device``
    are unused)."""

    def __init__(self, model: Any = "gpt-tiny", block_size: int = 16,
                 buckets: tuple = (16, 32, 64, 128), seed: int = 0,
                 device: Optional[str] = None):
        from .deployment import build_model

        if isinstance(model, tuple):
            self.model, self.params = model
        else:
            self.model, self.params = build_model(model, seed=seed,
                                                  device=device)
        self.device = self.params["wte"].device
        self.block_size = int(block_size)
        self.buckets = tuple(sorted(buckets))

    def prefill(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """payload {"tokens": [...], ...} -> the wire record for
        DecodeStage.ingest: prompt, first token, and the KV blocks."""
        prompt = [int(t) for t in payload["tokens"]]
        p = len(prompt)
        bucket = next(b for b in self.buckets if b >= p)
        nb = blocks_for_tokens(p, self.block_size)
        dev = self.device
        # a throwaway pool sized exactly for this prompt: blocks 0..nb-1
        cache = self.model.init_paged_cache(nb, self.block_size, dev)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :p] = prompt
        row = np.full((max(nb, 1),), -1, np.int64)
        row[:nb] = np.arange(nb)
        with torch.no_grad():
            logits, cache = self.model.paged_prefill(
                self.params, cache, torch.from_numpy(toks).to(dev), p,
                torch.from_numpy(row).to(dev))
        return {
            "prompt": prompt,
            "first_token": int(logits.argmax()),
            "kv": {"k": cache["k"].cpu(), "v": cache["v"].cpu()},
            "max_tokens": int(payload.get("max_tokens", 16)),
            "eos_id": payload.get("eos_id", "__default__"),
        }

    def placement(self) -> Dict[str, Any]:
        return _placement(self.device)


class DecodeStage:
    """Adopts shipped KV blocks and decodes to completion. Bound into
    the cgraph as stage 2."""

    def __init__(self, model: Any = "gpt-tiny",
                 engine_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0, device: Optional[str] = None):
        from .deployment import build_model

        m, params = build_model(model, seed=seed, device=device)
        self.engine = LLMEngine(m, params,
                                EngineConfig(**(engine_config or {})),
                                name="disagg-decode")
        self.engine.start()

    def ingest(self, shipped: Dict[str, Any]) -> Dict[str, Any]:
        stream = self.engine.add_prefilled(
            shipped["prompt"], shipped["kv"], shipped["first_token"],
            max_tokens=shipped["max_tokens"], eos_id=shipped["eos_id"])
        toks = stream.tokens()
        return {"tokens": toks, "finish_reason": stream.finish_reason}

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def placement(self) -> Dict[str, Any]:
        return _placement(self.engine.device)


class DisaggLLM:
    """Driver-side convenience: two stage actors + the compiled 2-stage
    pipeline. `generate()` pushes one request through the channel.

    ``codec`` ("int8"/"e4m3") block-quantizes the prefill→decode KV
    shipment on the wire; the decode engine adopts the dequantized
    blocks, so decode runs on a KV image with per-block quantization
    error. None = exact, byte-identical to the in-process engine's KV.
    ``device`` is passed to both stages as a string (None = the card).
    """

    def __init__(self, model: Any = "gpt-tiny", block_size: int = 16,
                 engine_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0, codec: Optional[str] = None,
                 device: Optional[str] = None):
        import ray_tpu_torch

        device = None if device is None else str(device)
        eng_cfg = dict(engine_config or {})
        eng_cfg.setdefault("block_size", block_size)
        prefill_cls = ray_tpu_torch.remote(PrefillStage)
        decode_cls = ray_tpu_torch.remote(DecodeStage)
        self._prefill = prefill_cls.remote(model, block_size, seed=seed,
                                           device=device)
        self._decode = decode_cls.remote(model, eng_cfg, seed=seed,
                                         device=device)
        self._compiled = None
        self.compile(codec)

    def compile(self, codec: Optional[str] = None) -> None:
        """Compile the two-stage graph over the stage actors, the KV
        block-quantized on the wire by ``codec``. The constructor calls
        it; calling it again tears the graph down and compiles it anew
        with another codec, on the same two stages."""
        from ray_tpu_torch.cgraph import InputNode

        if self._compiled is not None:
            self._compiled.teardown()
            self._compiled = None
        with InputNode() as inp:
            dag = self._decode.ingest.bind(self._prefill.prefill.bind(inp))
        self._compiled = dag.experimental_compile(codec=codec)

    def generate(self, tokens: List[int], max_tokens: int = 16,
                 eos_id: Any = "__default__",
                 timeout: float = 120.0) -> Dict[str, Any]:
        return self._compiled.execute(
            {"tokens": tokens, "max_tokens": max_tokens,
             "eos_id": eos_id}).get(timeout=timeout)

    def stats(self, timeout: float = 30.0) -> Dict[str, Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._decode.stats.remote(),
                                 timeout=timeout)

    def placement(self, timeout: float = 30.0) -> Dict[str, Dict]:
        """{"prefill": ..., "decode": ...}: each stage's worker pid,
        device, device bytes held and hand-written kernel launches."""
        import ray_tpu_torch

        return dict(zip(("prefill", "decode"), ray_tpu_torch.get(
            [self._prefill.placement.remote(),
             self._decode.placement.remote()], timeout=timeout)))

    def shutdown(self) -> None:
        import ray_tpu_torch

        try:
            self._compiled.teardown()
        except Exception:
            pass
        for actor in (self._prefill, self._decode):
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
