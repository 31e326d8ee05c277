"""Unified retry policy: exponential backoff + jitter + deadline.

One policy object replaces the ad-hoc ``while True: try/except/sleep``
loops that had grown around every flaky boundary (dispatch fallback,
peer reconnect, agent registration, object-pull retry, serve routing).
The reference runtime centralizes the same way (ref:
src/ray/common/grpc_util.h ExponentialBackoff; python/ray/_private/
utils.py retry decorators) — one place owns the backoff curve, the
jitter, and the give-up rule, so graftcheck GC012 can flag every loop
that does not.

Two shapes:

- :func:`call_with_retry` — wrap one flaky callable::

      result = call_with_retry(
          lambda: connect(addr), policy=RetryPolicy(deadline_s=30),
          retry_on=(OSError,), description="agent->head connect")

- :meth:`RetryPolicy.sleeps` — migrate an existing loop without
  restructuring it: an iterator that sleeps the backoff schedule
  between iterations and stops when the deadline/attempt budget is
  spent (the loop body keeps its own success ``return``/``break``)::

      for attempt in policy.sleeps(interrupt=stop_event):
          try:
              return do_thing()
          except TransientError:
              continue
      raise TimeoutError(...)   # budget exhausted

Jitter is multiplicative-uniform (``sleep * uniform(1-j, 1+j)``) so
herds of retriers decorrelate without ever sleeping past
``max_backoff_s * (1+j)``. Policies are immutable and thread-safe;
every call gets its own attempt counter.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple, Type


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff curve + give-up rule.

    initial_backoff_s: first sleep.
    multiplier: backoff growth per attempt.
    max_backoff_s: backoff ceiling (pre-jitter).
    jitter: fraction of the sleep randomized (0.2 => +/-20%).
    deadline_s: total wall-clock budget from the first attempt
        (None = unbounded by time).
    max_attempts: attempt budget (None = unbounded by count). At least
        one of deadline_s / max_attempts should bound the loop —
        a policy with neither retries forever (GC012 flags callers
        that hand-roll that shape).
    """

    initial_backoff_s: float = 0.01
    multiplier: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.2
    deadline_s: Optional[float] = None
    max_attempts: Optional[int] = None

    def backoff(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """Jittered sleep before retry number ``attempt`` (0-based)."""
        base = min(self.max_backoff_s,
                   self.initial_backoff_s * (self.multiplier ** attempt))
        if self.jitter <= 0:
            return base
        r = (rng or _process_rng()).uniform(1.0 - self.jitter,
                                            1.0 + self.jitter)
        return max(0.0, base * r)

    def sleeps(self, interrupt: Optional[threading.Event] = None,
               deadline: Optional[float] = None) -> Iterator[int]:
        """Yield attempt indices, sleeping the backoff schedule BETWEEN
        attempts; stop (without raising) when the deadline or attempt
        budget is spent, or when ``interrupt`` is set. ``deadline`` is
        an absolute ``time.monotonic()`` override for callers that
        already carry one."""
        if deadline is None and self.deadline_s is not None:
            deadline = time.monotonic() + self.deadline_s
        attempt = 0
        while True:
            if interrupt is not None and interrupt.is_set():
                return
            yield attempt
            attempt += 1
            if self.max_attempts is not None \
                    and attempt >= self.max_attempts:
                return
            delay = self.backoff(attempt - 1)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                delay = min(delay, remaining)
            if interrupt is not None:
                if interrupt.wait(delay):
                    return
            elif delay > 0:
                time.sleep(delay)


class RetryError(Exception):
    """call_with_retry exhausted its budget; ``last`` holds the final
    attempt's exception."""

    def __init__(self, description: str, attempts: int,
                 last: BaseException):
        super().__init__(
            f"{description or 'retried call'} failed after {attempts} "
            f"attempt(s): {type(last).__name__}: {last}")
        self.attempts = attempts
        self.last = last


def call_with_retry(fn: Callable[[], Any], *,
                    policy: RetryPolicy,
                    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                    description: str = "",
                    interrupt: Optional[threading.Event] = None,
                    on_retry: Optional[Callable[[int, BaseException],
                                                None]] = None) -> Any:
    """Run ``fn`` under ``policy``; re-raise the last error wrapped in
    :class:`RetryError` when the budget is spent. ``on_retry(attempt,
    err)`` fires before each backoff sleep (logging hook)."""
    last: Optional[BaseException] = None
    attempts = 0
    for attempt in policy.sleeps(interrupt=interrupt):
        attempts = attempt + 1
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — the whole point
            last = e
            if on_retry is not None:
                try:
                    on_retry(attempt, e)
                except Exception:
                    pass
    if last is None:
        raise RetryError(description, attempts,
                         TimeoutError("interrupted before first attempt"))
    raise RetryError(description, attempts, last) from last


_RNG_LOCK = threading.Lock()
_RNG: Optional[random.Random] = None


def _process_rng() -> random.Random:
    """Process-wide jitter source. Deliberately NOT the chaos plan's
    seeded RNG — jitter must stay decorrelated across processes, while
    chaos draws must replay identically."""
    global _RNG
    with _RNG_LOCK:
        if _RNG is None:
            _RNG = random.Random()
        return _RNG
