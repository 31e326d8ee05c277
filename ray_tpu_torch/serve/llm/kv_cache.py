"""Block pool + block tables — the host-side half of the paged KV cache
(the port's own copy of ray_tpu/serve/llm/kv_cache.py).

The device tensors live in the engine (``model.init_paged_cache``); this
module owns the accounting: which pool blocks are free, which sequence
holds which blocks, and the alloc/free discipline whose failure path is
preemption-and-requeue (engine.py).

Blocks are refcounted: ``alloc`` grants fresh blocks at refcount 1,
``retain`` adds a reference, ``free`` drops one, and a block returns to
the free list when its last reference is released. ``used_count`` counts
every live block once, and ``check_leaks`` verifies that the free list
and the live refcounts partition the pool exactly. With ``shards > 1``
block ids ``[c*N/shards, (c+1)*N/shards)`` belong to shard ``c`` and
allocation balances across shards (most-free first).
"""
from __future__ import annotations

from typing import List, Optional


class BlockPool:
    """Fixed pool of refcounted KV blocks. alloc() is all-or-nothing: a
    partial grant would deadlock two growing sequences against each
    other."""

    def __init__(self, num_blocks: int, shards: int = 1):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if num_blocks % shards:
            raise ValueError(
                f"num_blocks {num_blocks} not divisible into {shards} "
                f"shards — the pool must tile the block-sharded cache "
                f"exactly")
        self.num_blocks = num_blocks
        self.shards = shards
        per = num_blocks // shards
        self._per_shard = per
        # per-shard LIFO free lists (ascending ids pop first)
        self._free_by_shard: List[List[int]] = [
            list(range((s + 1) * per - 1, s * per - 1, -1))
            for s in range(shards)]
        self._refcnt: List[int] = [0] * num_blocks
        self._used = 0                 # live blocks, each counted once

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._free_by_shard)

    @property
    def used_count(self) -> int:
        """Live blocks, shared blocks counted once."""
        return self._used

    def refcount(self, block: int) -> int:
        """Current reference count of a block (0 = free)."""
        if not 0 <= block < self.num_blocks:
            raise ValueError(f"unknown block {block}")
        return self._refcnt[block]

    def shard_of(self, block: int) -> int:
        return block // self._per_shard

    def used_per_shard(self) -> List[int]:
        return [self._per_shard - len(f) for f in self._free_by_shard]

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, or None when the pool can't
        satisfy the request. n == 0 returns []."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.free_count:
            return None
        out: List[int] = []
        for _ in range(n):
            s = max(range(self.shards),
                    key=lambda i: (len(self._free_by_shard[i]), -i))
            b = self._free_by_shard[s].pop()
            self._refcnt[b] = 1
            out.append(b)
        self._used += n
        return out

    def retain(self, blocks: List[int]) -> None:
        """Add one reference to each live block."""
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"retain of unknown block {b}")
            if self._refcnt[b] <= 0:
                raise ValueError(f"retain of free block {b}")
        for b in blocks:
            self._refcnt[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block; a block returns to the free list
        when its last holder releases it."""
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"free of unknown block {b}")
        # validate the whole batch before mutating: a double free must
        # not release the valid half of the list first
        counts = {}
        for b in blocks:
            counts[b] = counts.get(b, 0) + 1
        for b, n in counts.items():
            if self._refcnt[b] < n:
                raise ValueError(
                    f"double free: block {b} released {n}x with only "
                    f"{self._refcnt[b]} reference(s) held")
        for b in blocks:
            self._refcnt[b] -= 1
            if self._refcnt[b] == 0:
                self._used -= 1
                self._free_by_shard[self.shard_of(b)].append(b)

    def check_leaks(self) -> None:
        """Invariants: the free list and the live refcounts partition the
        pool exactly; no block appears twice in a free list; shard filing
        is consistent."""
        free = [b for f in self._free_by_shard for b in f]
        if len(free) + self._used != self.num_blocks:
            raise AssertionError(
                f"block leak: {len(free)} free + {self._used} used "
                f"!= {self.num_blocks}")
        if len(set(free)) != len(free):
            raise AssertionError("duplicate block in free list")
        free_set = set(free)
        for b in range(self.num_blocks):
            rc = self._refcnt[b]
            if rc < 0:
                raise AssertionError(f"block {b} refcount {rc} < 0")
            if rc == 0 and b not in free_set:
                raise AssertionError(
                    f"block {b} has refcount 0 but is not on the free "
                    f"list (leaked)")
            if rc > 0 and b in free_set:
                raise AssertionError(
                    f"block {b} is free AND holds {rc} reference(s)")
        for s, f in enumerate(self._free_by_shard):
            for b in f:
                if self.shard_of(b) != s:
                    raise AssertionError(
                        f"block {b} filed under shard {s}, belongs to "
                        f"{self.shard_of(b)}")


def blocks_for_tokens(num_tokens: int, block_size: int) -> int:
    """Blocks needed to hold positions [0, num_tokens)."""
    if num_tokens <= 0:
        return 0
    return (num_tokens - 1) // block_size + 1
