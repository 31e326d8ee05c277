"""ViT (counterpart of ray_tpu/models/vit.py): ViT-B/16 and a tiny
config.

Params are a dict with the JAX model's names and shapes (``patch/w``
[p*p*3, D] over patch vectors in (py, px, channel) order, the encoder's
``[L, ...]`` stacks, ``head/w`` [D, classes]). Attention is
bidirectional: ``flash_attention`` when the sequence length is a
multiple of 8, as in the reference, else ``mha_reference``. With
N patches plus the CLS token the length is N + 1, and N is a square, so
it is never a multiple of 8 (a square is never 7 mod 8): ViT-B/16
(197 tokens) and the tiny config (17) both run ``mha_reference``. The
branch stays for parity. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention, gelu, layernorm, mha_reference

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    use_flash: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                         n_layer=2, n_head=2, d_model=64, d_ff=128, **kw)

    @staticmethod
    def b16(**kw) -> "ViTConfig":
        return ViTConfig(**kw)


class ViT:
    LAYER_PARAMS = ("ln1_g", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj",
                    "ln2_g", "ln2_b", "w_fc", "b_fc", "w_out", "b_out")

    def __init__(self, config: ViTConfig):
        self.config = config

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        c = self.config
        L, D, F_ = c.n_layer, c.d_model, c.d_ff
        P = c.patch_size * c.patch_size * 3
        return {
            "patch/w": (P, D), "patch/b": (D,),
            "cls": (1, 1, D), "pos": (1, c.num_patches + 1, D),
            "ln1_g": (L, D), "ln1_b": (L, D),
            "w_qkv": (L, D, 3 * D), "b_qkv": (L, 3 * D),
            "w_proj": (L, D, D), "b_proj": (L, D),
            "ln2_g": (L, D), "ln2_b": (L, D),
            "w_fc": (L, D, F_), "b_fc": (L, F_),
            "w_out": (L, F_, D), "b_out": (L, D),
            "lnf_g": (D,), "lnf_b": (D,),
            "head/w": (D, c.num_classes), "head/b": (c.num_classes,),
        }

    def init(self, generator: torch.Generator) -> Params:
        """Parameters on ``generator.device``, distributed as the JAX
        init's (not the same numbers): ``patch/w`` normal of std
        sqrt(1/(p*p*3)); ``pos``, w_qkv and w_fc std 0.02, w_proj and
        w_out 0.02 / sqrt(2L); layernorm gains one; the CLS token, the
        biases and the head zero."""
        c = self.config
        shapes = self.param_shapes()
        std = {"patch/w": math.sqrt(1.0 / shapes["patch/w"][0]),
               "pos": 0.02, "w_qkv": 0.02, "w_fc": 0.02,
               "w_proj": 0.02 / math.sqrt(2 * c.n_layer),
               "w_out": 0.02 / math.sqrt(2 * c.n_layer)}
        dev = generator.device
        out = {}
        for name, shape in shapes.items():
            if name in std:
                t = torch.randn(shape, generator=generator,
                                dtype=c.param_dtype, device=dev)
                out[name] = t.mul_(std[name])
            elif name.endswith("_g"):
                out[name] = torch.ones(shape, dtype=c.param_dtype, device=dev)
            else:
                out[name] = torch.zeros(shape, dtype=c.param_dtype,
                                        device=dev)
        return out

    @staticmethod
    def logical_axes() -> Dict[str, Tuple[Optional[str], ...]]:
        return {
            "patch/w": (None, "embed"), "patch/b": ("embed",),
            "cls": (None, None, "embed"), "pos": (None, None, "embed"),
            "ln1_g": (None, None), "ln1_b": (None, None),
            "w_qkv": (None, "embed", "heads"), "b_qkv": (None, "heads"),
            "w_proj": (None, "heads", "embed"), "b_proj": (None, "embed"),
            "ln2_g": (None, None), "ln2_b": (None, None),
            "w_fc": (None, "embed", "mlp"), "b_fc": (None, "mlp"),
            "w_out": (None, "mlp", "embed"), "b_out": (None, "embed"),
            "lnf_g": (None,), "lnf_b": (None,),
            "head/w": ("embed", None), "head/b": (None,),
        }

    def param_shardings(self, mesh, rules=None):
        from ..parallel.mesh import AxisRules, NamedSharding

        rules = rules or AxisRules()
        return {n: NamedSharding(mesh, rules.mesh_axes(a))
                for n, a in self.logical_axes().items()}

    def _patchify(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, (H/p)(W/p), p*p*C], patches in row-major
        order, each vector in (py, px, c) order."""
        p = self.config.patch_size
        B, H, W, C = images.shape
        x = images.reshape(B, H // p, p, W // p, p, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(
            B, (H // p) * (W // p), p * p * C)

    def _block(self, x: torch.Tensor, lp: Params) -> torch.Tensor:
        c = self.config
        B, S, D = x.shape
        H, hd = c.n_head, c.head_dim
        h = layernorm(x, lp["ln1_g"], lp["ln1_b"])
        qkv = h @ lp["w_qkv"].to(c.dtype) + lp["b_qkv"].to(c.dtype)
        q, k, v = (t.reshape(B, S, H, hd) for t in qkv.split(D, dim=-1))
        if c.use_flash and S % 8 == 0:
            attn = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=False,
                                   block_q=min(128, S), block_k=min(128, S))
        else:
            attn = mha_reference(q, k, v, causal=False)
        x = x + attn.reshape(B, S, D) @ lp["w_proj"].to(c.dtype) \
            + lp["b_proj"].to(c.dtype)
        h = layernorm(x, lp["ln2_g"], lp["ln2_b"])
        h = gelu(h @ lp["w_fc"].to(c.dtype) + lp["b_fc"].to(c.dtype))
        return x + h @ lp["w_out"].to(c.dtype) + lp["b_out"].to(c.dtype)

    def apply(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> logits [B, num_classes] f32 (the head in
        f32 on the f32 CLS token)."""
        c = self.config
        x = self._patchify(images.to(c.dtype)) \
            @ params["patch/w"].to(c.dtype) + params["patch/b"].to(c.dtype)
        B = x.shape[0]
        cls = params["cls"].to(c.dtype).expand(B, 1, c.d_model)
        x = torch.cat([cls, x], dim=1) + params["pos"].to(c.dtype)
        layers = {n: params[n].unbind(0) for n in self.LAYER_PARAMS}
        for li in range(c.n_layer):
            lp = {n: t[li] for n, t in layers.items()}
            if c.remat:
                x = checkpoint(self._block, x, lp, use_reentrant=False)
            else:
                x = self._block(x, lp)
        x = layernorm(x, params["lnf_g"], params["lnf_b"])
        cls_tok = x[:, 0].float()
        return cls_tok @ params["head/w"].float() + params["head/b"].float()

    def loss(self, params: Params, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Mean cross entropy of the logits against one-hot labels."""
        logits = self.apply(params, images)
        onehot = F.one_hot(labels, self.config.num_classes).float()
        return -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
