"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for one NVIDIA H100.

The JAX package ``ray_tpu`` stays beside this one as the reference; this
package keeps its module layout and names so each counterpart is easy to
find, and imports nothing of it (nor of JAX). What the port covers so far:

- ``ops``: the numeric layers, ``mha_reference``, the paged KV-cache
  primitives, ``flash_attention`` whose forward and backward are CUDA
  kernels written for Hopper (``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu``), and the fused ``ln_matmul`` and
  ``matmul_residual`` (``csrc/ln_matmul.cu``, ``csrc/mm_res.cu``);
- ``models``: the six families of ``ray_tpu.models`` (GPT, Llama, MoE,
  ViT, ResNet, MLP), with loaders of the JAX package's parameters;
- ``serve.llm``: the block pool, the continuous-batching engine and the
  ``LLMServer`` callable.

Entry points (``build_model``, ``LLMServer``) run on the CUDA card unless
the caller passes ``device="cpu"``; without a card they raise.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
