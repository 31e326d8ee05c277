"""Sparse Mixture-of-Experts transformer LM, Mixtral-style (counterpart
of ray_tpu/models/moe.py).

Functional like the JAX model: ``init`` returns a dict of tensors with
its names and stacked ``[L, ...]`` shapes (the experts' weights
``[L, E, ...]``), and ``apply`` / ``loss`` take that dict, so
``torch.autograd`` differentiates them with respect to it. Routing keeps
the reference's static dispatch/combine formulation (GShard): top-k
gating builds dense [T, E, C] dispatch and combine tensors and the
experts run as three batched products over fixed shapes; tokens past an
expert's capacity C are dropped (zero combine weight) and pass through
the residual. Attention goes through ``flash_attention`` (the CUDA
forward and backward kernels on the card) or, with ``use_flash=False``,
through ``mha_reference``. The LM head keeps f32 logits from
compute-dtype operands (``_LMHead``), as the JAX model's
``preferred_element_type=f32`` head.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import (cross_entropy_loss, flash_attention, gelu, layernorm,
                   mha_reference)
from .gpt import _LMHead, _round_up

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coeff: float = 0.01
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_flash: bool = True
    # accepted for parity with the JAX config; the CUDA kernels choose
    # their own tiles
    flash_block_q: int = 1024
    flash_block_k: int = 1024

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 128)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @staticmethod
    def tiny(**kw) -> "MoEConfig":
        return MoEConfig(vocab_size=512, n_layer=2, n_head=4, d_model=64,
                         d_ff=128, num_experts=4, max_seq=128, **kw)

    @staticmethod
    def small(**kw) -> "MoEConfig":
        return MoEConfig(**kw)


class Routes(NamedTuple):
    """One MoE layer's routing of T tokens to E experts of capacity C."""
    combine: torch.Tensor   # [T, E, C] f32: each kept route's weight
    aux: torch.Tensor       # scalar f32: the load-balancing loss
    top_e: torch.Tensor     # [T, K] int64: the chosen experts
    keep: torch.Tensor      # [T, K] bool: the routes inside capacity


class MoE:
    """init/apply dict model in the house style (gpt.py, llama.py)."""

    LAYER_PARAMS = ("ln1_g", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj",
                    "ln2_g", "ln2_b", "w_router", "w_up", "b_up", "w_down",
                    "b_down")
    _NORMAL = ("wte", "wpe", "w_qkv", "w_proj", "w_router", "w_up",
               "w_down")
    _RESIDUAL = ("w_proj", "w_down")    # the 1/sqrt(2L) init scale

    def __init__(self, config: MoEConfig):
        self.config = config

    # ---- parameters ------------------------------------------------------

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        c = self.config
        L, D, F_, V, E = (c.n_layer, c.d_model, c.d_ff, c.padded_vocab,
                          c.num_experts)
        return {
            "wte": (V, D), "wpe": (c.max_seq, D),
            "ln1_g": (L, D), "ln1_b": (L, D),
            "w_qkv": (L, D, 3 * D), "b_qkv": (L, 3 * D),
            "w_proj": (L, D, D), "b_proj": (L, D),
            "ln2_g": (L, D), "ln2_b": (L, D),
            "w_router": (L, D, E),
            "w_up": (L, E, D, F_), "b_up": (L, E, F_),
            "w_down": (L, E, F_, D), "b_down": (L, E, D),
            "lnf_g": (D,), "lnf_b": (D,),
        }

    def init(self, generator: torch.Generator) -> Params:
        """Parameters on ``generator.device``: normals of std 0.02 (w_proj
        and w_down 0.02 / sqrt(2L)), layernorm gains one, biases zero. Same
        distribution as the JAX init; not the same numbers."""
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

    @staticmethod
    def logical_axes() -> Dict[str, Tuple[Optional[str], ...]]:
        return {
            "wte": ("vocab", "embed"), "wpe": (None, "embed"),
            "ln1_g": (None, None), "ln1_b": (None, None),
            "w_qkv": (None, "embed", "heads"), "b_qkv": (None, "heads"),
            "w_proj": (None, "heads", "embed"), "b_proj": (None, None),
            "ln2_g": (None, None), "ln2_b": (None, None),
            "w_router": (None, "embed", None),
            "w_up": (None, "expert", "embed", "mlp"),
            "b_up": (None, "expert", "mlp"),
            "w_down": (None, "expert", "mlp", "embed"),
            "b_down": (None, "expert", "embed"),
            "lnf_g": (None,), "lnf_b": (None,),
        }

    def param_shardings(self, mesh, rules=None):
        from ..parallel.mesh import AxisRules, NamedSharding

        rules = rules or AxisRules()
        return {n: NamedSharding(mesh, rules.mesh_axes(a))
                for n, a in self.logical_axes().items()}

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    # ---- MoE layer -------------------------------------------------------

    def _route(self, xt: torch.Tensor, w_router: torch.Tensor) -> Routes:
        """Top-k gating of xt [T, D] as the reference computes it: an f32
        router and softmax; the Switch Transformer aux loss over the
        assignments before any drop; capacity positions counted
        token-major (token t's second choice queues before token t+1's
        first); kept weights renormalised to sum to one per token.
        ``torch.topk``'s order among equal probabilities is not specified
        (nor is ``lax.top_k``'s the same one); random inputs make exact
        ties vanishingly rare."""
        c = self.config
        T = xt.shape[0]
        E, K = c.num_experts, c.top_k
        cap = max(1, int(c.capacity_factor * T * K / E))
        logits = xt.float() @ w_router.float()                 # [T, E]
        probs = torch.softmax(logits, dim=-1)
        top_w, top_e = torch.topk(probs, K, dim=-1)             # [T, K]
        assign = F.one_hot(top_e, E).float()                    # [T, K, E]
        frac_tokens = assign.sum(1).mean(0)                     # [E]
        frac_probs = probs.mean(0)                              # [E]
        aux = c.aux_loss_coeff * E * (frac_tokens * frac_probs).sum()
        # the count runs along the last dim of [E, T*K]: on an H100 a
        # scan down the few columns of [T*K, E] was the MoE step's
        # largest kernel; the counts are the same integers
        flat = assign.reshape(T * K, E).T
        pos = (flat.cumsum(-1) - flat).T.reshape(T, K, E)
        pos = (pos * assign).sum(-1)                            # [T, K]
        keep = (pos < cap) & (top_w > 0)
        top_w = torch.where(keep, top_w, torch.zeros_like(top_w))
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        # one-hot of each kept route's slot, dropped routes in slot C
        slot = torch.where(keep, pos, torch.full_like(pos, cap)).long()
        pos_oh = torch.zeros((T, K, cap + 1), dtype=torch.float32,
                             device=xt.device)
        pos_oh.scatter_(-1, slot[..., None], 1.0)
        # combine[t, e, c] = sum_k w[t, k] [e_k = e] [slot_k = c]: the
        # reference's einsum("tke,tkc,tk->tec") as one batched product
        # over t, without the [T, K, E, C] product of its three operands
        combine = torch.bmm((assign * top_w[..., None]).transpose(1, 2),
                            pos_oh[..., :cap])
        return Routes(combine, aux, top_e, keep)

    def _moe_ffn(self, x: torch.Tensor, lp: Params
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, S, D] -> (out [B, S, D], aux_loss scalar): dispatch to
        each expert's C slots, the experts' FFNs, and the weighted combine,
        all dense products in the compute dtype."""
        c = self.config
        B, S, D = x.shape
        T, E = B * S, c.num_experts
        xt = x.reshape(T, D)
        r = self._route(xt, lp["w_router"])
        cap = r.combine.shape[-1]
        dispatch = (r.combine > 0).to(c.dtype).reshape(T, E * cap)
        ein = (dispatch.T @ xt.to(c.dtype)).reshape(E, cap, D)
        h = gelu(torch.bmm(ein, lp["w_up"].to(c.dtype))
                 + lp["b_up"].to(c.dtype)[:, None, :])
        eout = torch.bmm(h, lp["w_down"].to(c.dtype)) \
            + lp["b_down"].to(c.dtype)[:, None, :]
        out = r.combine.to(c.dtype).reshape(T, E * cap) \
            @ eout.reshape(E * cap, D)
        return out.reshape(B, S, D), r.aux

    def _block(self, x: torch.Tensor, lp: Params
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        B, S, D = x.shape
        H, hd = c.n_head, c.head_dim
        h = layernorm(x, lp["ln1_g"], lp["ln1_b"])
        qkv = h @ lp["w_qkv"].to(c.dtype) + lp["b_qkv"].to(c.dtype)
        q, k, v = (t.reshape(B, S, H, hd) for t in qkv.split(D, dim=-1))
        if c.use_flash:
            # the split views of qkv are strided; the kernels take
            # contiguous [B, S, H, D]
            attn = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True,
                                   block_q=c.flash_block_q,
                                   block_k=c.flash_block_k)
        else:
            attn = mha_reference(q, k, v, causal=True)
        x = x + attn.reshape(B, S, D) @ lp["w_proj"].to(c.dtype) \
            + lp["b_proj"].to(c.dtype)
        h = layernorm(x, lp["ln2_g"], lp["ln2_b"])
        ffn, aux = self._moe_ffn(h, lp)
        return x + ffn, aux

    def _lm_head(self, wte: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Tied head: compute-dtype operands, f32 logits (``_LMHead``)."""
        w = wte.to(self.config.dtype)
        logits = _LMHead.apply(x.reshape(-1, x.shape[-1]), w)
        return logits.reshape(*x.shape[:-1], w.shape[0])

    def apply(self, params: Params, tokens: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] -> (logits [B, S, padded_vocab] f32, aux_loss
        scalar f32 summed over the layers). Positions are 0..S-1."""
        c = self.config
        S = tokens.shape[1]
        x = F.embedding(tokens, params["wte"]).to(c.dtype) \
            + params["wpe"][:S].to(c.dtype)[None]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        # one unbind per stacked parameter (see GPT._backbone)
        layers = {n: params[n].unbind(0) for n in self.LAYER_PARAMS}
        for li in range(c.n_layer):
            x, aux = self._block(x, {n: t[li] for n, t in layers.items()})
            aux_total = aux_total + aux
        x = layernorm(x, params["lnf_g"], params["lnf_b"])
        return self._lm_head(params["wte"], x), aux_total

    def loss(self, params: Params, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        logits, aux = self.apply(params, tokens)
        return cross_entropy_loss(logits, targets) + aux
