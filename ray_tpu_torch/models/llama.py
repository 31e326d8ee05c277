"""Llama-family decoder (counterpart of ray_tpu/models/llama.py):
rmsnorm + rope + swiglu + grouped-query attention.

Functional like the JAX model: ``init`` returns a dict of tensors with the
JAX package's names, shapes and stacked ``[L, ...]`` layout (f32), and
``apply`` / ``loss`` / ``paged_prefill`` / ``paged_prefill_extend`` /
``paged_decode_step`` / ``decode_step`` take that dict.
Matmul weights are cast to ``config.dtype`` at each use, as in the JAX
model; ``cast_matmul_weights`` stores that cast once (numerically the
same, without re-casting 6.5 B parameters every step), which is what
``build_model`` serves from. The paged programs write the KV cache in
place and return it.

``Llama(config, tp=TensorParallel(...))`` (or ``tensor_parallel(tp)``) is
one rank of the tensor-parallel split (parallel/sharding/
tensor_parallel.py): ``shard_params`` cuts the full params into this
rank's, and ``apply`` and the paged programs run on them, with the
query/KV heads and FFN columns of this rank, one f32 all-reduce after
``w_o`` and after ``w_down``, the vocabulary-split embedding and the
logits gathered over the group, on the host (where gloo's all-gather
leaves them: the paged programs return them there, ``apply`` and
``decode_step`` move them to the device).

``remat`` (on by default, as in the JAX model) recomputes each block of
``apply`` (and so ``loss``) in the backward, the reference's bare
``jax.checkpoint``: nothing is saved but the block's input, so the
backward launches the flash forward kernel again. Under tp the
all-reduces' outputs are kept (``ops.remat.COLLECTIVES``): a recompute
runs no collective.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import (apply_rope, cross_entropy_loss, flash_attention,
                   mha_reference, paged_attention_decode,
                   paged_attention_prefill, paged_write_prefill,
                   paged_write_step, rmsnorm, rope_cache)
from ..ops.remat import COLLECTIVES, remat
from ..parallel.sharding.tensor_parallel import (TensorParallel,
                                                 head_layout, matmul_f32)

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
    # each block of apply recomputed in the backward; on by default, as
    # in the JAX model
    remat: bool = True

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

    def __init__(self, config: LlamaConfig,
                 tp: Optional[TensorParallel] = None):
        self.config = config
        self.tp = tp if tp is not None and tp.size > 1 else None
        if self.tp is None:
            self._layout = None
            self._heads, self._kv_heads = config.n_head, config.n_kv_head
        else:
            self._layout = head_layout(config.n_head, config.n_kv_head,
                                       tp.size, tp.rank)
            self._heads = len(self._layout.q_heads)
            self._kv_heads = len(self._layout.kv_heads)

    def tensor_parallel(self, tp: TensorParallel) -> "Llama":
        """This model as rank ``tp.rank`` of a tensor-parallel group."""
        return Llama(self.config, tp)

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
        return dict(self.init_items(generator))

    def init_items(self, generator: torch.Generator):
        """``init`` one full tensor at a time: (name, tensor) in
        ``param_shapes`` order, the same draws."""
        c = self.config
        res_std = 0.02 / math.sqrt(2 * c.n_layer)
        for name, shape in self.param_shapes().items():
            if name.endswith("norm"):
                yield name, torch.ones(shape, dtype=c.param_dtype,
                                       device=generator.device)
                continue
            t = torch.randn(shape, generator=generator, dtype=c.param_dtype,
                            device=generator.device)
            yield name, t.mul_(res_std if name in ("w_o", "w_down")
                               else 0.02)

    def shard_param(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full parameter ``x`` (``x`` itself on
        the unsplit model and for the replicated norms)."""
        tp, lay, hd = self.tp, self._layout, self.config.head_dim
        if tp is None:
            return x
        if name in ("wte", "lm_head"):
            return tp.take_block(x, 0)                  # vocabulary rows
        if name == "w_q":
            return tp.take_heads(x, 2, lay.q_heads, hd)
        if name in ("w_k", "w_v"):
            return tp.take_heads(x, 2, lay.kv_heads, hd)
        if name == "w_o":
            return tp.take_heads(x, 1, lay.q_heads, hd)
        if name in ("w_gate", "w_up"):
            return tp.take_block(x, 2)                  # FFN columns
        if name == "w_down":
            return tp.take_block(x, 1)                  # FFN rows
        return x

    def shard_params(self, params) -> Params:
        """This rank's params from full ones: a dict, or (name, tensor)
        pairs such as ``init_items`` yields (each full tensor can then be
        freed as soon as it is cut)."""
        items = params.items() if isinstance(params, dict) else params
        return {n: self.shard_param(n, t) for n, t in items}

    @staticmethod
    def logical_axes() -> Dict[str, Tuple[Optional[str], ...]]:
        return {
            "wte": ("vocab", "embed"),
            "attn_norm": (None, None),
            "w_q": (None, "embed", "heads"),
            "w_k": (None, "embed", "heads"),
            "w_v": (None, "embed", "heads"),
            "w_o": (None, "heads", "embed"),
            "mlp_norm": (None, None),
            "w_gate": (None, "embed", "mlp"),
            "w_up": (None, "embed", "mlp"),
            "w_down": (None, "mlp", "embed"),
            "out_norm": (None,),
            "lm_head": ("vocab", "embed"),
        }

    def param_shardings(self, mesh, rules=None):
        from ..parallel.mesh import AxisRules, NamedSharding

        rules = rules or AxisRules()
        return {n: NamedSharding(mesh, rules.mesh_axes(a))
                for n, a in self.logical_axes().items()}

    def cast_matmul_weights(self, params: Params) -> Params:
        """Params with the matmul weights stored in ``config.dtype`` (the
        cast each forward would do, done once). Embedding, norms and the
        f32 LM head keep their dtype."""
        c = self.config
        return {n: (p.to(c.dtype) if n in self.MATMUL_PARAMS else p)
                for n, p in params.items()}

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    def flops_per_token(self, seq: Optional[int] = None) -> int:
        """Forward+backward matmul FLOPs per token: 6N plus attention at
        the full head count (GQA broadcasts k/v before QK^T and PV),
        6 * L * S * H * hd, already halved by the causal mask. The same
        formula as the JAX model's."""
        c = self.config
        s = c.max_seq if seq is None else seq
        return 6 * self.num_params() + \
            6 * c.n_layer * c.n_head * c.head_dim * s

    # ---- dense forward ---------------------------------------------------

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.to(self.config.dtype)

    def _mm_row(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``_mm`` of a row-parallel weight (w_o, w_down): under tp the
        partial products are summed over the group in f32 and rounded
        once."""
        if self.tp is None:
            return self._mm(x, w)
        dtype = self.config.dtype
        return self.tp.all_reduce_f32(matmul_f32(x, w.to(dtype))).to(dtype)

    def _mlp(self, x: torch.Tensor, lp: Params) -> torch.Tensor:
        c = self.config
        h = rmsnorm(x, lp["mlp_norm"], c.rms_eps)
        gate = F.silu(self._mm(h, lp["w_gate"]))
        up = self._mm(h, lp["w_up"])
        return x + self._mm_row(gate * up, lp["w_down"])

    def _qkv(self, x: torch.Tensor, lp: Params):
        c = self.config
        lead = x.shape[:-1]
        h = rmsnorm(x, lp["attn_norm"], c.rms_eps)
        q = self._mm(h, lp["w_q"]).reshape(*lead, self._heads, c.head_dim)
        k = self._mm(h, lp["w_k"]).reshape(*lead, self._kv_heads, c.head_dim)
        v = self._mm(h, lp["w_v"]).reshape(*lead, self._kv_heads, c.head_dim)
        return q, k, v

    def _repeat_kv(self, k: torch.Tensor, v: torch.Tensor):
        """GQA: each KV head serves n_head / n_kv_head consecutive query
        heads (jnp.repeat semantics, i.e. repeat_interleave)."""
        if self._kv_heads == self._heads:
            return k, v
        rep = self._heads // self._kv_heads
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
        x = x + self._mm_row(attn.reshape(B, S, self._heads * c.head_dim),
                             lp["w_o"])
        return self._mlp(x, lp)

    def _head(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        """Final norm and the f32 LM head on f32 weights (under tp each
        rank's vocabulary rows, the logits gathered over the group on the
        host: the paged programs return them there, ``apply`` moves them
        to the device)."""
        x = rmsnorm(x, params["out_norm"], self.config.rms_eps)
        logits = x.float() @ params["lm_head"].float().T
        if self.tp is None:
            return logits
        return self.tp.gather_last(logits, self.config.padded_vocab)

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        # gather then cast: the same values as casting the whole table
        if self.tp is None:
            return params["wte"][tokens].to(self.config.dtype)
        return self.tp.embed(params["wte"], tokens, self.config.padded_vocab
                             ).to(self.config.dtype)

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
            lp = self._layer(params, li)
            if c.remat:
                x = remat(self._block, x, lp, cos, sin, positions,
                          saved=COLLECTIVES)
            else:
                x = self._block(x, lp, cos, sin, positions)
        return self._head(x, params).to(x.device)

    def loss(self, params: Params, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        return cross_entropy_loss(self.apply(params, tokens), targets)

    # ---- paged-KV serving path (ray_tpu_torch.serve.llm) ------------------

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         device: torch.device) -> Params:
        """Block-pool KV cache: k/v [L, num_blocks, block_size, KH, hd]."""
        c = self.config
        shape = (c.n_layer, num_blocks, block_size, self._kv_heads,
                 c.head_dim)
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
            x = x + self._mm_row(
                attn.reshape(1, S, self._heads * c.head_dim), lp["w_o"])
            x = self._mlp(x, lp)
        last = x[0, max(int(length) - 1, 0)]
        return self._head(last, params), cache

    def paged_prefill_extend(self, params: Params, cache: Params,
                             tokens: torch.Tensor, start: int, length: int,
                             block_row: torch.Tensor):
        """Suffix prefill over a cached prefix (the contract of
        GPT.paged_prefill_extend): tokens [1, S] are the suffix only,
        RoPE'd at absolute positions start.., written into ``block_row``
        at start.. and attended over the full paged context, the reused
        [0, start) KV included. Pad positions past max_seq take its last
        rotation, as the JAX gather clamps them; their rows are dropped."""
        c = self.config
        S = tokens.shape[1]
        x = self._embed(params, tokens)                       # [1, S, D]
        cos, sin = rope_cache(c.max_seq, c.head_dim, c.rope_base,
                              device=x.device)
        positions = (start + torch.arange(S, device=x.device)).clamp(
            max=c.max_seq - 1)[None]                           # [1, S]
        for li in range(c.n_layer):
            lp = self._layer(params, li)
            q, k, v = self._qkv(x, lp)
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            kl = paged_write_prefill(cache["k"][li], block_row, k[0], length,
                                     start)
            vl = paged_write_prefill(cache["v"][li], block_row, v[0], length,
                                     start)
            attn = paged_attention_prefill(q[0], kl, vl, block_row, start,
                                           length)
            x = x + self._mm_row(
                attn.reshape(1, S, self._heads * c.head_dim), lp["w_o"])
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
            x = x + self._mm_row(attn.reshape(B, self._heads * c.head_dim),
                                 lp["w_o"])
            x = self._mlp(x, lp)
        return self._head(x, params), cache

    # ---- dense-cache decode path --------------------------------------------

    def init_cache(self, batch: int, device: torch.device) -> Params:
        """Dense KV cache: k/v [L, batch, max_seq, KH, hd] and the next
        write position of each row, pos [batch]."""
        c = self.config
        shape = (c.n_layer, batch, c.max_seq, self._kv_heads, c.head_dim)
        return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
                "v": torch.zeros(shape, dtype=c.dtype, device=device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor):
        """One autoregressive step: tokens [B, 1] -> (logits [B, V] f32,
        a new cache). Each row's K/V lands at its own position by a
        one-hot blend, and attention is masked to positions <= pos, as in
        the JAX model."""
        c = self.config
        B = tokens.shape[0]
        H, hd = self._heads, c.head_dim
        pos = cache["pos"].long()                              # [B]
        x = self._embed(params, tokens)                        # [B, 1, D]
        cos, sin = rope_cache(c.max_seq, hd, c.rope_base, device=x.device)
        onehot = F.one_hot(pos, c.max_seq).to(c.dtype)[:, :, None, None]
        mask = torch.arange(c.max_seq, device=x.device)[None, :] \
            <= pos[:, None]                                    # [B, S]
        new_k, new_v = [], []
        for li in range(c.n_layer):
            lp = self._layer(params, li)
            q, k, v = self._qkv(x, lp)                         # [B, 1, H, hd]
            q = apply_rope(q, cos, sin, pos[:, None])
            k = apply_rope(k, cos, sin, pos[:, None])
            ck = cache["k"][li] * (1 - onehot) + onehot * k
            cv = cache["v"][li] * (1 - onehot) + onehot * v
            new_k.append(ck)
            new_v.append(cv)
            kk, vv = self._repeat_kv(ck, cv)
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  kk.float()) / math.sqrt(hd)
            scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
            probs = torch.softmax(scores, dim=-1)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs,
                                vv.float()).to(c.dtype)
            x = x + self._mm_row(attn.reshape(B, 1, H * hd), lp["w_o"])
            x = self._mlp(x, lp)
        logits = self._head(x, params)[:, 0].to(x.device)
        return logits, {"k": torch.stack(new_k), "v": torch.stack(new_v),
                        "pos": cache["pos"] + 1}
