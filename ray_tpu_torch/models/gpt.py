"""GPT-2 family (counterpart of ray_tpu/models/gpt.py): the training path.

Functional like the JAX model: ``init`` returns a dict of tensors with the
JAX package's names, shapes and stacked ``[L, ...]`` layout (f32, the
vocabulary padded to a multiple of 128), and ``apply`` / ``loss`` /
``loss_chunked`` take that dict, so ``torch.autograd`` differentiates them
with respect to it. Matmul weights are cast to ``config.dtype`` at each
use, as in the JAX model. Attention goes through ``flash_attention`` (the
CUDA forward and backward kernels on the card) or, with
``use_flash=False``, through ``mha_reference``. With
``fused_entry_exit=True`` each block's LN1 + QKV projection goes through
``ln_matmul`` and, without dropout, its exit (projection + residual, LN2 +
FC, MLP out + residual) through ``matmul_residual`` and ``ln_matmul``
(the ops/fused.py kernels), as in the JAX model.

Not here until a slice reads them: the XLA compile knobs ``remat`` and
``scan_layers``, ``flash_block_q/k`` (the CUDA kernels choose their own
tiles), ``seq_axis`` (ring attention), the paged serving methods (and
with them the ``positions`` argument of ``apply``), ``loss_pp``, the
pipeline-stage slicing and the sharding tables.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import (cross_entropy_loss, flash_attention, gelu, layernorm,
                   ln_matmul, matmul_residual, mha_reference)

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


class _LMHead(torch.autograd.Function):
    """x [T, D] @ w [V, D].T -> f32 logits [T, V], as the JAX head
    computes them (``preferred_element_type=f32``). The backward is JAX's
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

    def __init__(self, config: GPTConfig):
        self.config = config

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
        c = self.config
        res_std = 0.02 / math.sqrt(2 * c.n_layer)
        dev = generator.device
        out = {}
        for name, shape in self.param_shapes().items():
            if name in self._NORMAL:
                t = torch.randn(shape, generator=generator,
                                dtype=c.param_dtype, device=dev)
                out[name] = t.mul_(res_std if name in self._RESIDUAL
                                   else 0.02)
            elif name.endswith("_g"):
                out[name] = torch.ones(shape, dtype=c.param_dtype, device=dev)
            else:
                out[name] = torch.zeros(shape, dtype=c.param_dtype,
                                        device=dev)
        return out

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
        H, hd = c.n_head, c.head_dim
        drop = c.dropout > 0.0 and generator is not None
        if c.fused_entry_exit:
            qkv = ln_matmul(x.reshape(B * S, D), lp["ln1_g"], lp["ln1_b"],
                            lp["w_qkv"].to(c.dtype),
                            lp["b_qkv"].to(c.dtype)).reshape(B, S, 3 * D)
        else:
            h = layernorm(x, lp["ln1_g"], lp["ln1_b"])
            qkv = self._mm(h, lp["w_qkv"]) + lp["b_qkv"].to(c.dtype)
        q, k, v = (t.reshape(B, S, H, hd) for t in qkv.split(D, dim=-1))
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
        proj = self._mm(attn.reshape(B, S, D), lp["w_proj"]) \
            + lp["b_proj"].to(c.dtype)
        if drop:
            proj = self._dropout(proj, generator)
        x = x + proj
        h = layernorm(x, lp["ln2_g"], lp["ln2_b"])
        h = gelu(self._mm(h, lp["w_fc"]) + lp["b_fc"].to(c.dtype))
        out = self._mm(h, lp["w_out"]) + lp["b_out"].to(c.dtype)
        if drop:
            out = self._dropout(out, generator)
        return x + out

    def _embed(self, wte: torch.Tensor, wpe: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
        """Token + position embedding in the compute dtype (gather, then
        cast: the same values as casting the tables first)."""
        dtype = self.config.dtype
        return F.embedding(tokens, wte).to(dtype) \
            + wpe[: tokens.shape[1]].to(dtype)

    def _lm_head(self, head_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Tied LM head: the compute-dtype operands, the product accumulated
        and returned in f32 (``_LMHead``), as the JAX model's head."""
        w = head_w.to(self.config.dtype)
        logits = _LMHead.apply(x.reshape(-1, x.shape[-1]), w)
        return logits.reshape(*x.shape[:-1], w.shape[0])

    def _backbone(self, params: Params, tokens: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """Transformer stack up to the final layernorm ([B, S, D], no
        head). With dropout > 0 and a generator, GPT-2's dropout applies
        to the embeddings and to each residual branch, drawn in order from
        ``generator``."""
        c = self.config
        x = self._embed(params["wte"], params["wpe"], tokens)
        if c.dropout > 0.0 and generator is not None:
            x = self._dropout(x, generator)
        # one unbind per stacked parameter: its backward stacks the
        # per-layer gradients once, where indexing would add L full-size
        # gradients
        layers = {n: params[n].unbind(0) for n in self.LAYER_PARAMS}
        for li in range(c.n_layer):
            x = self._block(x, {n: t[li] for n, t in layers.items()},
                            generator)
        return layernorm(x, params["lnf_g"], params["lnf_b"])

    def apply(self, params: Params, tokens: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, padded_vocab] (f32)."""
        x = self._backbone(params, tokens, generator)
        return self._lm_head(params["wte"], x)

    def loss(self, params: Params, tokens: torch.Tensor,
             targets: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
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

    def _chunked_head_nll(self, wte: torch.Tensor, x: torch.Tensor,
                          targets: torch.Tensor,
                          num_chunks: int) -> torch.Tensor:
        T = targets.numel()
        if T % num_chunks:
            raise ValueError(f"{T} tokens do not split into {num_chunks} "
                             "chunks")
        head = wte.to(self.config.dtype)
        xt = x.reshape(T, -1).chunk(num_chunks)
        tg = targets.reshape(T).chunk(num_chunks)
        total = x.new_zeros((), dtype=torch.float32)
        for xc, tc in zip(xt, tg):
            total = total + checkpoint(self._chunk_nll, head, xc, tc,
                                       use_reentrant=False)
        return total / T

    def _chunk_nll(self, head: torch.Tensor, xc: torch.Tensor,
                   tc: torch.Tensor) -> torch.Tensor:
        logits = self._lm_head(head, xc)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tc[:, None])[:, 0]
        return (lse - gold).sum()
