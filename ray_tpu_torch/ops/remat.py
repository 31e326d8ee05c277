"""Rematerialisation: the counterpart of ``jax.checkpoint`` with a policy.

``remat(fn, *args, saved=...)`` runs ``fn`` under non-reentrant
``torch.utils.checkpoint``: the backward runs ``fn`` again to rebuild
what its own backward reads, except the outputs of the ops named in
``saved``, which a selective checkpoint keeps from the forward and hands
to the recompute instead of running the op again. Ops are named as the
dispatcher names them (``aten::mm``, whatever its overload):

- ``MATMULS``: the products without batch dimensions (JAX's
  ``dots_with_no_batch_dims_saveable``); batched products (``bmm``) are
  recomputed.
- ``FLASH``: the flash forward's out and lse (JAX's ``flash_out`` and
  ``flash_lse`` names), so the backward never launches the forward
  kernel again.
- ``COLLECTIVES``: the all-reduce of ``parallel.sharding.lower``, so a
  recompute never runs a collective again: every rank's backward reaches
  the same collectives, in the same order, with remat on or off.

With ``saved`` empty nothing is kept (a bare ``jax.checkpoint``). Under
``no_grad`` ``fn`` just runs.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

MATMULS = ("aten::mm",)
FLASH = ("ray_tpu_torch::flash_fwd",)
COLLECTIVES = ("ray_tpu_torch::all_reduce",)


def _policy(saved: frozenset):
    def policy(ctx, func, *args, **kwargs):
        if func.name().split(".")[0] in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat(fn: Callable, *args, saved: Iterable[str] = ()):
    """``fn(*args)``, its activations recomputed in the backward but for
    the outputs of the ops ``saved`` names (module docstring)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    saved = frozenset(saved)
    if not saved:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_policy(saved))
