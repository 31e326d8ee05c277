"""Execution context / tunables (ref: python/ray/data/context.py DataContext)."""
from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class DataContext:
    # backpressure: max blocks in flight per streaming stage
    # (ref: streaming_executor_state.py resource limits)
    max_in_flight_blocks: int = 16
    # byte-budget backpressure: per-segment admission stops once the
    # tracked bytes of outstanding blocks (completed-but-unemitted at
    # their store-reported size + in-flight tasks at the running average)
    # reach this budget. 0 disables; the block-count window above always
    # applies too (ref: ExecutionResources.object_store_memory)
    target_max_bytes_inflight: int = 0
    # emit blocks in plan order rather than completion order (ref:
    # execution_options.preserve_order — the reference defaults False for
    # throughput; here determinism wins by default; buffered out-of-order
    # refs count against max_in_flight_blocks so the stream stays bounded)
    preserve_order: bool = True
    default_parallelism: int = 8
    target_min_rows_per_block: int = 1000

    _current = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = cls()
            return cls._current
