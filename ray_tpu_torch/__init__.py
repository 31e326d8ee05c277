"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for one NVIDIA H100.

The JAX package ``ray_tpu`` stays beside this one as the reference; this
package keeps its module layout and names so each counterpart is easy to
find, and imports nothing of it (nor of JAX). What the port covers so far:

- ``ops``: the numeric layers, ``mha_reference``, the paged KV-cache
  primitives, and ``flash_attention`` whose forward is a CUDA kernel
  written for Hopper (``csrc/flash_fwd.cu``);
- ``models.llama``: the Llama family with its dense forward and its paged
  serving programs;
- ``serve.llm``: the block pool, the continuous-batching engine and the
  ``LLMServer`` callable.

Entry points (``build_model``, ``LLMServer``) run on the CUDA card unless
the caller passes ``device="cpu"``; without a card they raise.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
