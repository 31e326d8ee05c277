"""ray_tpu_torch.util — utility layer over the core API.

Parity with `ray.util` (ref: python/ray/util/__init__.py): ActorPool,
Queue, the multiprocessing.Pool shim, scheduling strategies, state API,
metrics, and the shared retry policy (util/retry.py — the one
backoff+jitter+deadline implementation graftcheck GC012 points at).
"""
from .actor_pool import ActorPool  # noqa: F401
from .queue import Queue  # noqa: F401
from .retry import RetryError, RetryPolicy, call_with_retry  # noqa: F401

__all__ = ["ActorPool", "Queue", "RetryPolicy", "RetryError",
           "call_with_retry"]
