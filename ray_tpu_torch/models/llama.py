"""Llama-family decoder (counterpart of ray_tpu/models/llama.py):
rmsnorm + rope + swiglu + grouped-query attention.

Functional like the JAX model: ``init`` returns a dict of tensors with the
JAX package's names, shapes and stacked ``[L, ...]`` layout (f32), and
``apply`` / ``paged_prefill`` / ``paged_decode_step`` take that dict.
Matmul weights are cast to ``config.dtype`` at each use, as in the JAX
model; ``cast_matmul_weights`` stores that cast once (numerically the
same, without re-casting 6.5 B parameters every step), which is what
``build_model`` serves from. The paged programs write the KV cache in
place and return it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import (apply_rope, flash_attention, mha_reference,
                   paged_attention_decode, paged_write_prefill,
                   paged_write_step, rmsnorm, rope_cache)

Params = Dict[str, torch.Tensor]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32
    d_model: int = 4096
    d_ff: int = 11008
    max_seq: int = 4096
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_flash: bool = True

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 128)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=512, n_layer=2, n_head=4, n_kv_head=2,
                    d_model=64, d_ff=128, max_seq=128)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(n_layer=40, n_head=40, n_kv_head=40, d_model=5120,
                           d_ff=13824, **kw)


class Llama:
    LAYER_PARAMS = ("attn_norm", "w_q", "w_k", "w_v", "w_o", "mlp_norm",
                    "w_gate", "w_up", "w_down")
    MATMUL_PARAMS = ("w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down")

    def __init__(self, config: LlamaConfig):
        self.config = config

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        c = self.config
        L, D, F, V = c.n_layer, c.d_model, c.d_ff, c.padded_vocab
        hd, H, KH = c.head_dim, c.n_head, c.n_kv_head
        return {
            "wte": (V, D), "attn_norm": (L, D),
            "w_q": (L, D, H * hd), "w_k": (L, D, KH * hd),
            "w_v": (L, D, KH * hd), "w_o": (L, H * hd, D),
            "mlp_norm": (L, D), "w_gate": (L, D, F), "w_up": (L, D, F),
            "w_down": (L, F, D), "out_norm": (D,), "lm_head": (V, D),
        }

    def init(self, generator: torch.Generator) -> Params:
        """Parameters on ``generator.device``: normals of std 0.02 (the
        residual projections w_o / w_down 0.02 / sqrt(2L)), norms at one.
        Same distribution as the JAX init; not the same numbers."""
        c = self.config
        res_std = 0.02 / math.sqrt(2 * c.n_layer)
        out = {}
        for name, shape in self.param_shapes().items():
            if name.endswith("norm"):
                out[name] = torch.ones(shape, dtype=c.param_dtype,
                                       device=generator.device)
                continue
            t = torch.randn(shape, generator=generator, dtype=c.param_dtype,
                            device=generator.device)
            out[name] = t.mul_(res_std if name in ("w_o", "w_down") else 0.02)
        return out

    def cast_matmul_weights(self, params: Params) -> Params:
        """Params with the matmul weights stored in ``config.dtype`` (the
        cast each forward would do, done once). Embedding, norms and the
        f32 LM head keep their dtype."""
        c = self.config
        return {n: (p.to(c.dtype) if n in self.MATMUL_PARAMS else p)
                for n, p in params.items()}

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    # ---- dense forward ---------------------------------------------------

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.to(self.config.dtype)

    def _mlp(self, x: torch.Tensor, lp: Params) -> torch.Tensor:
        c = self.config
        h = rmsnorm(x, lp["mlp_norm"], c.rms_eps)
        gate = F.silu(self._mm(h, lp["w_gate"]))
        up = self._mm(h, lp["w_up"])
        return x + self._mm(gate * up, lp["w_down"])

    def _qkv(self, x: torch.Tensor, lp: Params):
        c = self.config
        lead = x.shape[:-1]
        h = rmsnorm(x, lp["attn_norm"], c.rms_eps)
        q = self._mm(h, lp["w_q"]).reshape(*lead, c.n_head, c.head_dim)
        k = self._mm(h, lp["w_k"]).reshape(*lead, c.n_kv_head, c.head_dim)
        v = self._mm(h, lp["w_v"]).reshape(*lead, c.n_kv_head, c.head_dim)
        return q, k, v

    def _repeat_kv(self, k: torch.Tensor, v: torch.Tensor):
        """GQA: each KV head serves n_head / n_kv_head consecutive query
        heads (jnp.repeat semantics, i.e. repeat_interleave)."""
        c = self.config
        if c.n_kv_head == c.n_head:
            return k, v
        rep = c.n_head // c.n_kv_head
        return (k.repeat_interleave(rep, dim=2),
                v.repeat_interleave(rep, dim=2))

    def _layer(self, params: Params, li: int) -> Params:
        return {n: params[n][li] for n in self.LAYER_PARAMS}

    def _block(self, x, lp, cos, sin, positions):
        c = self.config
        B, S, _ = x.shape
        q, k, v = self._qkv(x, lp)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        k, v = self._repeat_kv(k, v)
        if c.use_flash:
            attn = flash_attention(q, k, v, causal=True)
        else:
            attn = mha_reference(q, k, v, causal=True)
        x = x + self._mm(attn.reshape(B, S, c.n_head * c.head_dim), lp["w_o"])
        return self._mlp(x, lp)

    def _head(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        """Final norm and the f32 LM head on f32 weights."""
        x = rmsnorm(x, params["out_norm"], self.config.rms_eps)
        return x.float() @ params["lm_head"].float().T

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        # gather then cast: the same values as casting the whole table
        return params["wte"][tokens].to(self.config.dtype)

    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] (f32)."""
        c = self.config
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        x = self._embed(params, tokens)
        cos, sin = rope_cache(c.max_seq, c.head_dim, c.rope_base,
                              device=x.device)
        for li in range(c.n_layer):
            x = self._block(x, self._layer(params, li), cos, sin, positions)
        return self._head(x, params)

    # ---- paged-KV serving path (ray_tpu_torch.serve.llm) ------------------

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         device: torch.device) -> Params:
        """Block-pool KV cache: k/v [L, num_blocks, block_size, KH, hd]."""
        c = self.config
        shape = (c.n_layer, num_blocks, block_size, c.n_kv_head, c.head_dim)
        return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
                "v": torch.zeros(shape, dtype=c.dtype, device=device)}

    def paged_prefill(self, params: Params, cache: Params,
                      tokens: torch.Tensor, length: int,
                      block_row: torch.Tensor):
        """Prompt pass at a bucket shape: tokens [1, S] (positions >=
        length are padding), block_row [M] -> (last-token logits [V] f32,
        cache written in place)."""
        c = self.config
        S = tokens.shape[1]
        x = self._embed(params, tokens)                       # [1, S, D]
        cos, sin = rope_cache(c.max_seq, c.head_dim, c.rope_base,
                              device=x.device)
        for li in range(c.n_layer):
            lp = self._layer(params, li)
            q, k, v = self._qkv(x, lp)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            paged_write_prefill(cache["k"][li], block_row, k[0], length)
            paged_write_prefill(cache["v"][li], block_row, v[0], length)
            k, v = self._repeat_kv(k, v)
            attn = mha_reference(q, k, v, causal=True)
            x = x + self._mm(attn.reshape(1, S, c.n_head * c.head_dim),
                             lp["w_o"])
            x = self._mlp(x, lp)
        last = x[0, max(int(length) - 1, 0)]
        return self._head(last, params), cache

    def paged_decode_step(self, params: Params, cache: Params,
                          tokens: torch.Tensor, positions: torch.Tensor,
                          block_rows: torch.Tensor, active: torch.Tensor):
        """One continuous-batching iteration at a fixed batch: tokens [B],
        positions [B], block_rows [B, M], active [B] bool -> (logits
        [B, V] f32, cache written in place)."""
        c = self.config
        B = tokens.shape[0]
        x = self._embed(params, tokens)                       # [B, D]
        cos, sin = rope_cache(c.max_seq, c.head_dim, c.rope_base,
                              device=x.device)
        lengths = positions + 1
        for li in range(c.n_layer):
            lp = self._layer(params, li)
            q, k, v = self._qkv(x[:, None], lp)               # [B, 1, H, hd]
            q = apply_rope(q, cos, sin, positions[:, None])
            k = apply_rope(k, cos, sin, positions[:, None])
            kl = paged_write_step(cache["k"][li], block_rows, positions,
                                  k[:, 0], active)
            vl = paged_write_step(cache["v"][li], block_rows, positions,
                                  v[:, 0], active)
            attn = paged_attention_decode(q[:, 0], kl, vl, block_rows,
                                          lengths)
            x = x + self._mm(attn.reshape(B, c.n_head * c.head_dim),
                             lp["w_o"])
            x = self._mlp(x, lp)
        return self._head(x, params), cache
