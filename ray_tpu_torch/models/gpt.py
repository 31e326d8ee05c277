"""GPT-2 family (counterpart of ray_tpu/models/gpt.py): training and the
paged serving path.

Functional like the JAX model: ``init`` returns a dict of tensors with the
JAX package's names, shapes and stacked ``[L, ...]`` layout (f32, the
vocabulary padded to a multiple of 128), and ``apply`` / ``loss`` /
``loss_chunked`` take that dict, so ``torch.autograd`` differentiates them
with respect to it. ``paged_prefill`` / ``paged_prefill_extend`` /
``paged_decode_step`` serve from a block-pool KV cache
(``init_paged_cache``), which they write in place and return. Matmul weights are cast to ``config.dtype`` at each
use, as in the JAX model. Attention goes through ``flash_attention`` (the
CUDA forward and backward kernels on the card) or, with
``use_flash=False``, through ``mha_reference``. With
``fused_entry_exit=True`` each block's LN1 + QKV projection goes through
``ln_matmul`` and, without dropout, its exit (projection + residual, LN2 +
FC, MLP out + residual) through ``matmul_residual`` and ``ln_matmul``
(the ops/fused.py kernels), as in the JAX model.

``GPT.pipeline_stages`` / ``gpt_pipeline_stages`` split the model into
chunk functions for the actor-hosted pipeline engine
(``ray_tpu_torch.train.pipeline_cgraph``).

``GPT(config, tp=TensorParallel(...))`` (or ``tensor_parallel(tp)``) is
one rank of the tensor-parallel split (parallel/sharding/
tensor_parallel.py): this rank's heads of the fused ``w_qkv`` (taken out
of each of q, k and v, so not the reference spec's contiguous column
chunk) and FFN columns, one f32 all-reduce after ``w_proj`` and after
``w_out`` (their biases added once, after it), and the vocabulary-split
embedding and tied head. ``apply`` and the paged programs gather the
logits (on the host, where gloo's all-gather leaves them: the paged
programs return them there, ``apply`` moves them to the device).
``loss``, ``loss_chunked`` and ``loss_pp`` train the split: the inputs
of the QKV and FC products and of the head sum their cotangents over the
group, and the cross entropy runs on each rank's vocabulary block of the
logits, whose row max, sum of exponentials and gold logit are
all-reduced, so no rank gathers a [T, V] row. Each rank's gradient of a
split parameter is its shard (``shard_param``) of the full gradient, and
of a replicated one the full gradient. ``fused_entry_exit`` under tp
raises (ROADMAP A4.5): ``matmul_residual`` would add the residual into
every rank's partial sum and round it to bf16 before the f32 all-reduce.

``GPT.loss_pp`` runs the layer stack as the in-program pipeline
(``parallel.pipeline.pipeline_spmd``) over a mesh's pp axis of gang
ranks, the embedding and the head replicated on every rank; on a tp
model each stage runs its layers' tp split over the mesh's tp axis.

``remat`` (on by default, as in the JAX model) runs each block under
``ops.remat`` with the reference's ``_remat_policy``: the four
projections' outputs and flash's out and lse are saved, and the
elementwise chain (layernorms, bias adds, gelu, residual adds, dropout;
with ``use_flash=False`` also ``mha_reference``'s batched products) runs
again in the backward. Under tp the row-parallel all-reduces' outputs are
saved too, so a recompute runs no collective. Dropout draws one seed for
the embedding and one per layer from the caller's generator, and each
block draws its masks from a generator seeded anew, so the recompute
draws the same masks and remat never changes a result.

Not here until a slice reads them: the XLA compile knobs ``scan_layers``
and ``flash_block_q/k`` (the CUDA kernels choose their own tiles), and
``seq_axis`` (ring attention).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import (cross_entropy_loss, flash_attention, gelu, layernorm,
                   ln_matmul, matmul_residual, mha_reference,
                   paged_attention_decode, paged_attention_prefill,
                   paged_write_prefill, paged_write_step)
from ..ops.remat import COLLECTIVES, FLASH, MATMULS, remat
from ..parallel.sharding.tensor_parallel import TensorParallel, head_layout

Params = Dict[str, torch.Tensor]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _bf16_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T of two matrices in a 16-bit dtype, accumulated and returned
    in f32, never rounded to the operands' dtype: a cuBLAS product with an
    f32 output on CUDA, the f32 product of the upcast operands on the CPU
    (the same function: products of 16-bit values are exact in f32)."""
    if a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T


def _seeded(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class _LMHead(torch.autograd.Function):
    """x [T, D] @ w [V, D].T -> f32 logits [T, V], as the JAX head
    computes them (``preferred_element_type=f32``); also the f32 partial
    product of a row-parallel weight under tp. The backward is JAX's
    transpose: the f32 cotangent g goes into both products, accumulated in
    f32 and rounded to x's dtype once. In a 16-bit dtype g is split into
    hi = g in that dtype and lo = (g - hi) in that dtype: 16-bit products
    whose f32 sum is g's product to about 2^-16 relative, far inside one
    ulp of the rounded result, at the 16-bit rate."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.dtype == torch.float32:
            return x @ w.T
        return _bf16_mm_f32(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.dtype == torch.float32:
            return g @ w, g.T @ x
        # [hi; lo] stacked: dw is one product over 2T rows, accumulated in
        # f32 across both halves; dx the sum of its two halves
        t = g.shape[0]
        hl = torch.empty((2 * t, g.shape[1]), dtype=x.dtype, device=g.device)
        hl[:t].copy_(g)
        torch.sub(g, hl[:t], out=hl[t:])   # in f32, rounded on the store
        dx2 = _bf16_mm_f32(hl, w.T)
        dx = dx2[:t] + dx2[t:]
        dw = _bf16_mm_f32(hl.T, torch.cat([x, x]).T)
        return dx.to(x.dtype), dw.to(w.dtype)


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 1024
    dropout: float = 0.0          # inference/bench default; train sets >0
    dtype: torch.dtype = torch.bfloat16      # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    use_flash: bool = True
    # LN + matmul fused at the block entry, matmul + residual at the exit
    # (the ops/fused.py kernels); off by default, as in the JAX model
    fused_entry_exit: bool = False
    # each block recomputed in the backward but for the saved set of
    # GPT.REMAT_SAVED; on by default, as in the JAX model
    remat: bool = True

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 128)

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        base = dict(vocab_size=512, n_layer=2, n_head=2, d_model=64,
                    d_ff=256, max_seq=128)
        base.update(kw)
        return GPTConfig(**base)

    @staticmethod
    def small(**kw) -> "GPTConfig":      # GPT-2 124M
        return GPTConfig(**kw)

    @staticmethod
    def medium(**kw) -> "GPTConfig":     # 350M
        return GPTConfig(n_layer=24, n_head=16, d_model=1024, d_ff=4096, **kw)

    @staticmethod
    def large(**kw) -> "GPTConfig":      # 774M
        return GPTConfig(n_layer=36, n_head=20, d_model=1280, d_ff=5120, **kw)

    @staticmethod
    def xl(**kw) -> "GPTConfig":         # 1.5B
        return GPTConfig(n_layer=48, n_head=25, d_model=1600, d_ff=6400, **kw)


class GPT:
    LAYER_PARAMS = ("ln1_g", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj",
                    "ln2_g", "ln2_b", "w_fc", "b_fc", "w_out", "b_out")
    _NORMAL = ("wte", "wpe", "w_qkv", "w_proj", "w_fc", "w_out")
    _RESIDUAL = ("w_proj", "w_out")    # GPT-2's 1/sqrt(2L) init scale
    # the reference's _remat_policy: products without batch dims and
    # flash's out and lse saved (and, under tp, the all-reduced outputs)
    REMAT_SAVED = MATMULS + FLASH + COLLECTIVES

    def __init__(self, config: GPTConfig,
                 tp: Optional[TensorParallel] = None):
        self.config = config
        self.tp = tp if tp is not None and tp.size > 1 else None
        if self.tp is not None and config.fused_entry_exit:
            raise NotImplementedError(
                "GPTConfig.fused_entry_exit under tensor parallelism is not "
                "ported (ROADMAP A4.5): the fused exit would need an f32 "
                "partial product with the residual on one rank")
        self._layout = None if self.tp is None else head_layout(
            config.n_head, config.n_head, tp.size, tp.rank)
        self._heads = config.n_head if self.tp is None else \
            len(self._layout.q_heads)

    def tensor_parallel(self, tp: TensorParallel) -> "GPT":
        """This model as rank ``tp.rank`` of a tensor-parallel group."""
        return GPT(self.config, tp)

    # ---- parameters ------------------------------------------------------

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        c = self.config
        L, D, F_, V, S = (c.n_layer, c.d_model, c.d_ff, c.padded_vocab,
                          c.max_seq)
        return {
            "wte": (V, D), "wpe": (S, D),
            "ln1_g": (L, D), "ln1_b": (L, D),
            "w_qkv": (L, D, 3 * D), "b_qkv": (L, 3 * D),
            "w_proj": (L, D, D), "b_proj": (L, D),
            "ln2_g": (L, D), "ln2_b": (L, D),
            "w_fc": (L, D, F_), "b_fc": (L, F_),
            "w_out": (L, F_, D), "b_out": (L, D),
            "lnf_g": (D,), "lnf_b": (D,),
        }

    def init(self, generator: torch.Generator) -> Params:
        """Parameters on ``generator.device``: normals of std 0.02 (the
        residual projections w_proj / w_out 0.02 / sqrt(2L)), layernorm
        gains one, biases zero. Same distribution as the JAX init; not the
        same numbers."""
        return dict(self.init_items(generator))

    def init_items(self, generator: torch.Generator):
        """``init`` one full tensor at a time: (name, tensor) in
        ``param_shapes`` order, the same draws."""
        c = self.config
        res_std = 0.02 / math.sqrt(2 * c.n_layer)
        dev = generator.device
        for name, shape in self.param_shapes().items():
            if name in self._NORMAL:
                t = torch.randn(shape, generator=generator,
                                dtype=c.param_dtype, device=dev)
                yield name, t.mul_(res_std if name in self._RESIDUAL
                                   else 0.02)
            elif name.endswith("_g"):
                yield name, torch.ones(shape, dtype=c.param_dtype,
                                       device=dev)
            else:
                yield name, torch.zeros(shape, dtype=c.param_dtype,
                                        device=dev)

    def shard_param(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full parameter ``x`` (``x`` itself on
        the unsplit model and for the replicated ones)."""
        tp, c = self.tp, self.config
        if tp is None:
            return x
        heads, hd = self._layout.q_heads, c.head_dim
        if name == "wte":
            return tp.take_block(x, 0)                  # vocabulary rows
        if name in ("w_qkv", "b_qkv"):
            # [..., 3D] as [..., 3, H * hd]: this rank's heads of each
            d = x.dim() - 1
            return tp.take_heads(x.unflatten(d, (3, c.d_model)), d + 1,
                                 heads, hd).flatten(d, d + 1)
        if name == "w_proj":
            return tp.take_heads(x, 1, heads, hd)
        if name in ("w_fc", "b_fc"):
            return tp.take_block(x, x.dim() - 1)        # FFN columns
        if name == "w_out":
            return tp.take_block(x, 1)                  # FFN rows
        return x

    def shard_params(self, params) -> Params:
        """This rank's params from full ones: a dict, or (name, tensor)
        pairs such as ``init_items`` yields."""
        items = params.items() if isinstance(params, dict) else params
        return {n: self.shard_param(n, t) for n, t in items}

    @staticmethod
    def logical_axes() -> Dict[str, Tuple[Optional[str], ...]]:
        """Per-param logical axes; the leading layer-stack axis is
        unsharded. Mapped to mesh axes by AxisRules."""
        return {
            "wte": ("vocab", "embed"),
            "wpe": (None, "embed"),
            "ln1_g": (None, None), "ln1_b": (None, None),
            "w_qkv": (None, "embed", "heads"),
            "b_qkv": (None, "heads"),
            "w_proj": (None, "heads", "embed"),
            "b_proj": (None, "embed"),
            "ln2_g": (None, None), "ln2_b": (None, None),
            "w_fc": (None, "embed", "mlp"),
            "b_fc": (None, "mlp"),
            "w_out": (None, "mlp", "embed"),
            "b_out": (None, "embed"),
            "lnf_g": (None,), "lnf_b": (None,),
        }

    def param_shardings(self, mesh, rules=None):
        from ..parallel.mesh import AxisRules, NamedSharding

        rules = rules or AxisRules()
        return {name: NamedSharding(mesh, rules.mesh_axes(axes))
                for name, axes in self.logical_axes().items()}

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    def flops_per_token(self, seq: Optional[int] = None) -> int:
        """Forward+backward matmul FLOPs per token: 6N plus attention,
        whose QK^T and PV are 4*S*D FLOPs per token per layer forward,
        x3 for forward+backward, halved by the causal mask -> 6*L*S*D.
        The same formula as the JAX model's."""
        c = self.config
        s = c.max_seq if seq is None else seq
        return 6 * self.num_params() + 6 * c.n_layer * c.d_model * s

    # ---- forward ---------------------------------------------------------

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.to(self.config.dtype)

    def _mm_row(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``_mm`` of a row-parallel weight (w_proj, w_out): under tp the
        f32 partial products (``_LMHead``, differentiable on the card) are
        summed over the group and rounded once."""
        if self.tp is None:
            return self._mm(x, w)
        dtype = self.config.dtype
        part = _LMHead.apply(x.reshape(-1, x.shape[-1]), w.to(dtype).T)
        return self.tp.all_reduce_f32(part).reshape(
            *x.shape[:-1], -1).to(dtype)

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel product: under tp its cotangent
        is summed over the group in the backward."""
        return x if self.tp is None else self.tp.enter(x)

    def _dropout(self, x: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        """Inverted dropout: keep each element with probability 1 - rate
        (a uniform draw from ``generator`` below 1 - rate) and divide the
        kept ones by 1 - rate in x's dtype, as the JAX model does."""
        keep_p = 1.0 - self.config.dropout
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_p
        scale = torch.tensor(keep_p, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / scale, torch.zeros_like(x))

    def _block(self, x: torch.Tensor, lp: Params,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        c = self.config
        B, S, D = x.shape
        H, hd = self._heads, c.head_dim
        drop = c.dropout > 0.0 and generator is not None
        if c.fused_entry_exit:
            qkv = ln_matmul(x.reshape(B * S, D), lp["ln1_g"], lp["ln1_b"],
                            lp["w_qkv"].to(c.dtype),
                            lp["b_qkv"].to(c.dtype)).reshape(B, S,
                                                             3 * H * hd)
        else:
            h = self._enter(layernorm(x, lp["ln1_g"], lp["ln1_b"]))
            qkv = self._mm(h, lp["w_qkv"]) + lp["b_qkv"].to(c.dtype)
        q, k, v = (t.reshape(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
        if c.use_flash:
            # the split views of qkv are strided; the kernels take
            # contiguous [B, S, H, D]
            attn = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
        else:
            attn = mha_reference(q, k, v, causal=True)
        if c.fused_entry_exit and not drop:
            x = matmul_residual(attn.reshape(B * S, D),
                                lp["w_proj"].to(c.dtype),
                                lp["b_proj"].to(c.dtype),
                                x.reshape(B * S, D))
            h = gelu(ln_matmul(x, lp["ln2_g"], lp["ln2_b"],
                               lp["w_fc"].to(c.dtype),
                               lp["b_fc"].to(c.dtype)))
            return matmul_residual(h, lp["w_out"].to(c.dtype),
                                   lp["b_out"].to(c.dtype),
                                   x).reshape(B, S, D)
        proj = self._mm_row(attn.reshape(B, S, H * hd), lp["w_proj"]) \
            + lp["b_proj"].to(c.dtype)
        if drop:
            proj = self._dropout(proj, generator)
        x = x + proj
        h = self._enter(layernorm(x, lp["ln2_g"], lp["ln2_b"]))
        h = gelu(self._mm(h, lp["w_fc"]) + lp["b_fc"].to(c.dtype))
        out = self._mm_row(h, lp["w_out"]) + lp["b_out"].to(c.dtype)
        if drop:
            out = self._dropout(out, generator)
        return x + out

    def _embed(self, wte: torch.Tensor, wpe: torch.Tensor,
               tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token + position embedding in the compute dtype (gather, then
        cast: the same values as casting the tables first). ``positions``
        [B, S] (or [1, S]) index ``wpe``; None means 0..S-1."""
        dtype = self.config.dtype
        pos = wpe[: tokens.shape[1]] if positions is None else wpe[positions]
        if self.tp is not None:
            tok = self.tp.embed(wte, tokens, self.config.padded_vocab)
            return tok.to(dtype) + pos.to(dtype)
        return F.embedding(tokens, wte).to(dtype) + pos.to(dtype)

    def _lm_head(self, head_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Tied LM head: the compute-dtype operands, the product accumulated
        and returned in f32 (``_LMHead``), as the JAX model's head."""
        w = head_w.to(self.config.dtype)
        logits = _LMHead.apply(x.reshape(-1, x.shape[-1]), w)
        logits = self._gather_vocab(logits).to(x.device)
        return logits.reshape(*x.shape[:-1], logits.shape[-1])

    def _gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Under tp, every rank's vocabulary slice of the logits, gathered
        on the host."""
        if self.tp is None:
            return logits
        return self.tp.gather_last(logits, self.config.padded_vocab)

    def pipeline_stages(self, params: Params, num_chunks: int):
        """Split this GPT into ``num_chunks`` pipeline chunks for the
        actor-hosted engine: chunk 0 carries the embedding, the last
        chunk the final LN + tied LM head + loss, layer blocks divide
        evenly. Returns ``(chunk_fns, chunk_params, tied)`` — with
        ``num_chunks = P * virtual_stages`` the same entry point feeds
        both the plain and the interleaved engine."""
        return gpt_pipeline_stages(self, params, num_chunks)

    def _dropout_seeds(self, generator: Optional[torch.Generator]):
        """With dropout > 0 and a generator: one seed for the embedding
        and one per layer, drawn from ``generator``; else None."""
        c = self.config
        if c.dropout <= 0.0 or generator is None:
            return None
        return torch.randint(0, 2 ** 62, (c.n_layer + 1,),
                             generator=generator,
                             device=generator.device).cpu()

    def _layer(self, x: torch.Tensor, lp: Params,
               seed: Optional[int]) -> torch.Tensor:
        """One block, its dropout masks drawn from a generator seeded with
        ``seed`` (None: no dropout), under ``remat`` when the config asks
        for it: the recompute seeds its generator anew, so it draws the
        forward's masks."""
        def block(x, lp):
            gen = None if seed is None else _seeded(seed, x.device)
            return self._block(x, lp, gen)

        if self.config.remat:
            return remat(block, x, lp, saved=self.REMAT_SAVED)
        return block(x, lp)

    def _backbone(self, params: Params, tokens: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  positions: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """Transformer stack up to the final layernorm ([B, S, D], no
        head). With dropout > 0 and a generator, GPT-2's dropout applies
        to the embeddings and to each residual branch, with the seeds of
        ``_dropout_seeds``."""
        c = self.config
        seeds = self._dropout_seeds(generator)
        x = self._embed(params["wte"], params["wpe"], tokens, positions)
        if seeds is not None:
            x = self._dropout(x, _seeded(int(seeds[0]), x.device))
        # one unbind per stacked parameter: its backward stacks the
        # per-layer gradients once, where indexing would add L full-size
        # gradients
        layers = {n: params[n].unbind(0) for n in self.LAYER_PARAMS}
        for li in range(c.n_layer):
            x = self._layer(x, {n: t[li] for n, t in layers.items()},
                            None if seeds is None else int(seeds[li + 1]))
        return layernorm(x, params["lnf_g"], params["lnf_b"])

    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, padded_vocab] (f32). ``positions``
        [B, S] (or [1, S]) are the tokens' sequence positions (0..S-1 when
        None)."""
        x = self._backbone(params, tokens, generator, positions)
        return self._lm_head(params["wte"], x)

    def loss(self, params: Params, tokens: torch.Tensor,
             targets: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.tp is not None:
            # each rank's vocabulary block of the logits, never gathered
            return self._chunked_head_nll(
                params["wte"], self._backbone(params, tokens, generator),
                targets, 1)
        logits = self.apply(params, tokens, generator=generator)
        return cross_entropy_loss(logits, targets)

    def loss_chunked(self, params: Params, tokens: torch.Tensor,
                     targets: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     num_chunks: int = 8) -> torch.Tensor:
        """Cross entropy without the full [B, S, V] f32 logits: the LM
        head and the logsumexp run per token chunk under
        ``torch.utils.checkpoint``, so only one chunk's logits exist at a
        time, in the forward and in the backward."""
        x = self._backbone(params, tokens, generator)
        return self._chunked_head_nll(params["wte"], x, targets, num_chunks)

    def loss_pp(self, params: Params, tokens: torch.Tensor,
                targets: torch.Tensor, mesh, num_microbatches: int = 0,
                pp_axis: str = "pp",
                generator: Optional[torch.Generator] = None,
                num_chunks: int = 0) -> torch.Tensor:
        """Pipeline-parallel loss: the layer stack runs as the collective
        microbatch pipeline over the mesh's ``pp_axis``
        (``parallel.pipeline.pipeline_spmd``), the embedding and the LM
        head replicated on every rank of it. Every rank of the axis calls
        it with the same arguments and gets the same loss; its backward
        runs the reverse pipeline and leaves the whole gradient of every
        parameter on every rank.

        With dropout > 0 and a generator, the seeds are
        ``_dropout_seeds``; each layer draws its masks from a generator
        seeded anew at each call, so every microbatch reuses its layer's
        masks (as the reference's stacked per-layer dropout keys do) and
        the masks do not depend on P.

        On a tp model (``params`` this rank's shards) the mesh also has
        the model's tp axis: each stage runs its layers' tp split, and
        the embedding and the head are the tp model's on every pp rank,
        so a rank ends with its tp shard's whole gradient."""
        from ..parallel.pipeline import axis_size, pipeline_spmd, stack_stages

        P_ = axis_size(mesh, pp_axis)
        M = num_microbatches or max(P_, 2)
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} microbatches")
        seeds = self._dropout_seeds(generator)
        x = self._embed(params["wte"], params["wpe"], tokens)
        D = x.shape[-1]
        layer_params = {n: params[n] for n in self.LAYER_PARAMS}
        if seeds is not None:
            x = self._dropout(x, _seeded(int(seeds[0]), x.device))
            # the per-layer seeds stage-split with the layer params
            layer_params["_dropout_seed"] = seeds[1:]
        stages = stack_stages(layer_params, P_)
        x_mb = x.reshape(M, B // M, S, D)

        def stage_fn(lp, xs):
            seeds = lp.get("_dropout_seed")
            layers = {n: lp[n].unbind(0) for n in self.LAYER_PARAMS}
            for li in range(len(layers["w_qkv"])):
                xs = self._layer(xs, {n: t[li] for n, t in layers.items()},
                                 None if seeds is None else int(seeds[li]))
            return xs

        y_mb = pipeline_spmd(stage_fn, stages, x_mb, mesh, pp_axis=pp_axis)
        x = layernorm(y_mb.reshape(B, S, D), params["lnf_g"],
                      params["lnf_b"])
        return self._chunked_head_nll(params["wte"], x, targets,
                                      num_chunks or M)

    def _chunked_head_nll(self, wte: torch.Tensor, x: torch.Tensor,
                          targets: torch.Tensor,
                          num_chunks: int) -> torch.Tensor:
        T = targets.numel()
        if T % num_chunks:
            raise ValueError(f"{T} tokens do not split into {num_chunks} "
                             "chunks")
        head = wte.to(self.config.dtype)
        xt = self._enter(x.reshape(T, -1)).chunk(num_chunks)
        tg = targets.reshape(T).chunk(num_chunks)
        # under tp a chunk's all-reduces are kept, not run again in the
        # backward
        saved = () if self.tp is None else COLLECTIVES
        total = x.new_zeros((), dtype=torch.float32)
        for xc, tc in zip(xt, tg):
            total = total + remat(self._head_nll, head, xc, tc, saved=saved)
        return total / T

    def _head_nll(self, head: torch.Tensor, xc: torch.Tensor,
                  tc: torch.Tensor) -> torch.Tensor:
        """The summed cross entropy of the tied head's f32 logits of rows
        ``xc`` [T, D] against ``tc`` [T]; under tp on each rank's
        vocabulary block (``TensorParallel.nll_sum``)."""
        if self.tp is not None:
            return self.tp.nll_sum(_LMHead.apply(xc, head), tc,
                                   self.config.padded_vocab)
        logits = self._lm_head(head, xc)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tc[:, None])[:, 0]
        return (lse - gold).sum()

    # ---- paged-KV serving path (ray_tpu_torch.serve.llm) ------------------

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         device: torch.device) -> Params:
        """Block-pool KV cache shared by every resident sequence:
        k/v [L, num_blocks, block_size, H, hd] (GPT has no GQA: KH = H)."""
        c = self.config
        shape = (c.n_layer, num_blocks, block_size, self._heads, c.head_dim)
        return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
                "v": torch.zeros(shape, dtype=c.dtype, device=device)}

    def _paged_layer_params(self, params: Params, li: int) -> Params:
        return {n: params[n][li] for n in self.LAYER_PARAMS}

    def _paged_qkv(self, x: torch.Tensor, lp: Params):
        """LN1 and the QKV projection: q, k, v [..., H, hd]."""
        c = self.config
        h = layernorm(x, lp["ln1_g"], lp["ln1_b"])
        qkv = self._mm(h, lp["w_qkv"]) + lp["b_qkv"].to(c.dtype)
        return (t.reshape(*x.shape[:-1], self._heads, c.head_dim)
                for t in qkv.split(self._heads * c.head_dim, dim=-1))

    def _paged_proj(self, x: torch.Tensor, attn: torch.Tensor,
                    lp: Params) -> torch.Tensor:
        """The attention projection's residual, then the MLP's."""
        c = self.config
        x = x + self._mm_row(attn.reshape(*x.shape[:-1], -1), lp["w_proj"]) \
            + lp["b_proj"].to(c.dtype)
        return self._paged_mlp(x, lp)

    def _paged_mlp(self, x: torch.Tensor, lp: Params) -> torch.Tensor:
        c = self.config
        h = layernorm(x, lp["ln2_g"], lp["ln2_b"])
        h = gelu(self._mm(h, lp["w_fc"]) + lp["b_fc"].to(c.dtype))
        return x + self._mm_row(h, lp["w_out"]) + lp["b_out"].to(c.dtype)

    def _paged_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Final layernorm and the tied head as an f32 product with wte."""
        x = layernorm(x, params["lnf_g"], params["lnf_b"])
        return self._gather_vocab(x.float() @ params["wte"].float().T)

    def paged_prefill(self, params: Params, cache: Params,
                      tokens: torch.Tensor, length: int,
                      block_row: torch.Tensor):
        """Prompt pass at a bucket shape: tokens [1, S] (positions >=
        length are padding), block_row [M] -> (last-token logits [V] f32,
        cache written in place)."""
        c = self.config
        x = self._embed(params["wte"], params["wpe"], tokens)   # [1, S, D]
        for li in range(c.n_layer):
            lp = self._paged_layer_params(params, li)
            q, k, v = self._paged_qkv(x, lp)                    # [1, S, H, hd]
            attn = mha_reference(q, k, v, causal=True)
            paged_write_prefill(cache["k"][li], block_row, k[0], length)
            paged_write_prefill(cache["v"][li], block_row, v[0], length)
            x = self._paged_proj(x, attn, lp)
        last = x[0, max(int(length) - 1, 0)]
        return self._paged_logits(params, last), cache

    def paged_prefill_extend(self, params: Params, cache: Params,
                             tokens: torch.Tensor, start: int, length: int,
                             block_row: torch.Tensor):
        """Suffix prefill over a cached prefix: positions [0, start)
        already sit in the blocks of ``block_row``; only the suffix
        ``tokens`` [1, S] (padded to the bucket, true length ``length``)
        is embedded at positions start.., written there, and attended
        causally over the full paged context. Returns (last-token logits
        [V] f32, cache written in place), as ``paged_prefill`` would for
        the whole prompt. Pad positions past max_seq embed its last row,
        as the JAX gather clamps them; their rows are dropped."""
        c = self.config
        S = tokens.shape[1]
        positions = (start + torch.arange(S, device=tokens.device)).clamp(
            max=c.max_seq - 1)[None]                             # [1, S]
        x = self._embed(params["wte"], params["wpe"], tokens, positions)
        for li in range(c.n_layer):
            lp = self._paged_layer_params(params, li)
            q, k, v = self._paged_qkv(x, lp)
            kl = paged_write_prefill(cache["k"][li], block_row, k[0], length,
                                     start)
            vl = paged_write_prefill(cache["v"][li], block_row, v[0], length,
                                     start)
            attn = paged_attention_prefill(q[0], kl, vl, block_row, start,
                                           length)
            x = self._paged_proj(x, attn, lp)
        last = x[0, max(int(length) - 1, 0)]
        return self._paged_logits(params, last), cache

    def paged_decode_step(self, params: Params, cache: Params,
                          tokens: torch.Tensor, positions: torch.Tensor,
                          block_rows: torch.Tensor, active: torch.Tensor):
        """One continuous-batching iteration at a fixed batch: tokens [B],
        positions [B] (the index each token is written at), block_rows
        [B, M], active [B] bool (inactive slots write nothing) -> (logits
        [B, V] f32, cache written in place)."""
        c = self.config
        x = self._embed(params["wte"], params["wpe"], tokens[:, None],
                        positions[:, None])[:, 0]               # [B, D]
        lengths = positions + 1          # attend over context incl. self
        for li in range(c.n_layer):
            lp = self._paged_layer_params(params, li)
            q, k, v = self._paged_qkv(x, lp)                    # [B, H, hd]
            kl = paged_write_step(cache["k"][li], block_rows, positions, k,
                                  active)
            vl = paged_write_step(cache["v"][li], block_rows, positions, v,
                                  active)
            attn = paged_attention_decode(q, kl, vl, block_rows, lengths)
            x = self._paged_proj(x, attn, lp)
        return self._paged_logits(params, x), cache


# ---------------------------------------------------------------------------
# pipeline-stage slicing — the model side of the actor-hosted pipeline
# engine (train/pipeline_cgraph.py). Lives with the model because the
# split points (embedding / layer blocks / LN+head) are model knowledge,
# not engine knowledge.
# ---------------------------------------------------------------------------


def gpt_pipeline_stages(model: GPT, params: Params, num_chunks: int):
    """Split a GPT into ``num_chunks`` pipeline chunks: chunk 0 carries
    the embedding, the last chunk carries the final LN + tied LM head +
    loss; layer blocks divide evenly. Returns
    ``(chunk_fns, chunk_params, tied)`` where chunk fns are
    ``fn(params, x) -> activation`` for every chunk but the last, which
    is ``fn(params, x, targets) -> scalar loss`` (the cross entropy over
    the full f32 logits, as ``GPT.loss`` computes it); ``tied`` names the
    embedding/LM-head grad-exchange pair in GLOBAL chunk indices. Chunk
    params hold views of ``params`` (each chunk's slice of the stacked
    ``[L, ...]`` layer tensors); the engine copies what it ships."""
    c = model.config
    L = c.n_layer
    if num_chunks < 2:
        raise ValueError("pipeline needs >= 2 chunks")
    if L % num_chunks:
        raise ValueError(
            f"{L} layers not divisible by {num_chunks} chunks")
    per = L // num_chunks

    def slice_layers(lo, hi):
        return {k: params[k][lo:hi] for k in GPT.LAYER_PARAMS}

    chunk_params = []
    for i in range(num_chunks):
        sp = {"layers": slice_layers(i * per, (i + 1) * per)}
        if i == 0:
            sp["wte"] = params["wte"]
            sp["wpe"] = params["wpe"]
        if i == num_chunks - 1:
            sp["lnf_g"] = params["lnf_g"]
            sp["lnf_b"] = params["lnf_b"]
            if "wte" not in sp:
                sp["head"] = params["wte"]  # tied head needs its own copy
        chunk_params.append(sp)

    def run_layers(model, sp, x):
        # one unbind per stacked parameter, as GPT._backbone does: its
        # backward stacks the per-layer gradients once
        layers = {n: t.unbind(0) for n, t in sp["layers"].items()}
        for li in range(len(layers["w_qkv"])):
            x = model._block(x, {n: t[li] for n, t in layers.items()}, None)
        return x

    def make_first(model):
        def fn(sp, tokens):
            x = model._embed(sp["wte"], sp["wpe"], tokens)
            return run_layers(model, sp, x)
        return fn

    def make_mid(model):
        def fn(sp, x):
            return run_layers(model, sp, x)
        return fn

    def make_last(model):
        def fn(sp, x, targets):
            h = run_layers(model, sp, x)
            h = layernorm(h, sp["lnf_g"], sp["lnf_b"])
            head = sp.get("head", sp.get("wte"))
            return cross_entropy_loss(model._lm_head(head, h), targets)
        return fn

    chunk_fns = [make_first(model)]
    for _ in range(num_chunks - 2):
        chunk_fns.append(make_mid(model))
    chunk_fns.append(make_last(model))
    # the tied embedding/head copies must exchange grads every step
    tied = [(0, "wte", num_chunks - 1, "head")]
    return chunk_fns, chunk_params, tied
