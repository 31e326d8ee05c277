"""Developer tooling for the ray_tpu_torch core.

The port copies one half of the JAX package's devtools: ``locks``. The
other, the ``graftcheck`` analyzer (ray_tpu/devtools/graftcheck), is a
source analyzer with no runtime role and is not copied.

- ``locks`` — a debug-mode instrumented lock (``RAY_TPU_DEBUG_LOCKS=1``)
  that the core runtime's hot locks are built from; it records per-thread
  acquisition stacks and reports lock-order inversions and over-long hold
  times through the observability path.
"""
from __future__ import annotations

from .locks import (LockReport, get_lock_reports, instrumented_lock,
                    reset_lock_state)

__all__ = [
    "instrumented_lock",
    "get_lock_reports",
    "reset_lock_state",
    "LockReport",
]
