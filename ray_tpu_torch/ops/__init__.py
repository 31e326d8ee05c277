"""ray_tpu_torch.ops — counterpart of ray_tpu.ops.

- flash_attention (differentiable), flash_attention_fwd and
  flash_attention_bwd: the forward and the backward are CUDA kernels
  written for Hopper (csrc/flash_fwd.cu, csrc/flash_bwd.cu); CPU tensors
  run their plain versions, flash_attention_{fwd,bwd}_plain.
- ln_matmul and matmul_residual (differentiable), ln_matmul_fwd and
  matmul_residual_fwd: GPT's fused block entry and exit, CUDA kernels
  written for Hopper (csrc/ln_matmul.cu, csrc/mm_res.cu) with the JAX
  package's plain recompute backward; CPU tensors run their plain
  versions, ln_matmul_plain and matmul_residual_plain.
- mha_reference: the f32 oracle.
- layers: rmsnorm, layernorm, gelu, rope, cross entropy (plain PyTorch).
- paged_attention: the paged KV-cache primitives (plain PyTorch).
"""
from .attention import mha_reference
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain, flash_attention_fwd,
                              flash_attention_fwd_plain)
from .fused import (ln_matmul, ln_matmul_fwd, ln_matmul_plain,
                    matmul_residual, matmul_residual_fwd,
                    matmul_residual_plain)
from .layers import (apply_rope, cross_entropy_loss, gelu, layernorm,
                     rmsnorm, rope_cache)
from .paged_attention import (paged_attention_decode,
                              paged_attention_prefill, paged_gather_kv,
                              paged_write_prefill, paged_write_step)

__all__ = [
    "flash_attention", "flash_attention_fwd", "flash_attention_fwd_plain",
    "flash_attention_bwd", "flash_attention_bwd_plain",
    "ln_matmul", "ln_matmul_fwd", "ln_matmul_plain",
    "matmul_residual", "matmul_residual_fwd", "matmul_residual_plain",
    "mha_reference", "rmsnorm", "layernorm", "gelu", "rope_cache",
    "apply_rope", "cross_entropy_loss",
    "paged_attention_decode", "paged_attention_prefill",
    "paged_gather_kv", "paged_write_prefill", "paged_write_step",
]
