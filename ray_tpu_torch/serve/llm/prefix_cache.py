"""Radix prefix cache over the paged KV block pool (the port's own copy
of ray_tpu/serve/llm/prefix_cache.py, with its names and behaviour).

Shared system-prompt / few-shot prefixes and multi-turn session contexts
dominate chat traffic, and their KV is identical across requests under
greedy decode. This module owns the host-side index that makes those
tokens free: a radix tree over token sequences whose nodes own
refcounted :class:`~.kv_cache.BlockPool` block ranges (SGLang's
RadixAttention is the published shape).

- **Block-aligned nodes.** Every node covers ``len(blocks) *
  block_size`` tokens — only FULL blocks are cached, so a cached block
  is immutable by construction: decode writes always land in a
  sequence's private tail block, never a shared one. Node edges split
  only at block boundaries; two siblings may share up to
  ``block_size - 1`` leading tokens (they own distinct blocks), so
  children are bucketed by first token and disambiguated by longest
  common prefix.
- **Copy-on-write at the divergence point.** A lookup that diverges
  mid-block still reports the partially-shared block
  (:attr:`PrefixMatch.partial_block` + how many of its tokens match):
  the engine duplicates that block into a fresh allocation before the
  new writer extends it, so ``partial_len`` tokens of prefill are saved
  without ever mutating shared state.
- **Refcounted sharing.** The cache holds ONE pool reference on every
  block it indexes (taken at insert); each sequence reusing a prefix
  holds its own reference (``pool.retain``). Retiring or preempting a
  sequence releases only its references — the cached prefix stays
  resident, which is exactly "preempted sequences release only their
  private tail".
- **LRU eviction under pool pressure.** ``evict(n)`` walks leaves in
  least-recently-matched order and releases nodes whose blocks have no
  holder besides the cache (pool refcount 1) until ``n`` blocks came
  free — blocks still referenced by a running sequence are never
  reclaimed, and interior nodes become evictable as their children go.

The tree never touches the device: it indexes block IDS; the engine owns
the cache tensors and the COW copies.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .kv_cache import BlockPool


class _RadixNode:
    __slots__ = ("tokens", "blocks", "children", "parent", "last_used")

    def __init__(self, tokens: List[int], blocks: List[int],
                 parent: Optional["_RadixNode"]):
        self.tokens = tokens           # edge label; len == len(blocks)*Bs
        self.blocks = blocks           # pool block ids, table order
        self.children: Dict[int, List["_RadixNode"]] = {}
        self.parent = parent
        self.last_used = 0             # cache clock at last match/insert


@dataclass
class PrefixMatch:
    """Result of :meth:`PrefixCache.match`.

    ``blocks`` covers ``num_tokens`` tokens of fully-shared full blocks
    (``num_tokens == len(blocks) * block_size``). When the lookup
    diverged mid-block, ``partial_block`` names the cached block whose
    first ``partial_len`` tokens also match — the COW candidate. Total
    reusable tokens = ``num_tokens + partial_len``.
    """
    num_tokens: int = 0
    blocks: List[int] = field(default_factory=list)
    partial_block: Optional[int] = None
    partial_len: int = 0


class PrefixCache:
    """Radix tree mapping token-sequence prefixes to resident KV blocks.

    NOT thread-safe on its own — the engine serializes every call under
    its scheduler lock, the same discipline the BlockPool gets.
    """

    def __init__(self, pool: BlockPool, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.pool = pool
        self.block_size = block_size
        self._root = _RadixNode([], [], None)
        self._clock = 0                # monotonic LRU stamp
        self._nodes = 0
        self._resident_blocks = 0
        self.evictions = 0

    # -- introspection -------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return self._nodes

    @property
    def resident_blocks(self) -> int:
        """Blocks the cache currently indexes (and holds one pool
        reference each on) — the ``prefix_blocks_resident`` surface."""
        return self._resident_blocks

    # -- lookup --------------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _lcp(a: List[int], b: List[int], start: int) -> int:
        """Longest common prefix of a[start:] and b."""
        n = min(len(a) - start, len(b))
        i = 0
        while i < n and a[start + i] == b[i]:
            i += 1
        return i

    def _best_child(self, node: _RadixNode, tokens: List[int],
                    pos: int) -> tuple:
        """(child, lcp) with the longest common prefix at tokens[pos:],
        or (None, 0). Siblings sharing a first token are disambiguated
        here — divergence inside the first block keeps them distinct
        nodes rather than splitting below block granularity."""
        if pos >= len(tokens):
            return None, 0
        best, best_l = None, 0
        for child in node.children.get(tokens[pos], ()):
            l = self._lcp(tokens, child.tokens, pos)
            if l > best_l:
                best, best_l = child, l
        return best, best_l

    def match(self, tokens: List[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens``. Fully-matched FULL
        blocks come back in table order; a mid-block divergence is
        reported as the COW candidate. Touches every matched node's LRU
        stamp. The caller retains ``blocks`` (and copies
        ``partial_block``) before using them."""
        m = PrefixMatch()
        node, pos = self._root, 0
        now = self._tick()
        while True:
            child, l = self._best_child(node, tokens, pos)
            if child is None or l == 0:
                return m
            child.last_used = now
            if l == len(child.tokens):
                # full edge match: every block is reusable as-is
                m.blocks.extend(child.blocks)
                m.num_tokens += len(child.tokens)
                node, pos = child, pos + l
                continue
            # partial edge match: whole blocks first, then the COW block
            fb = l // self.block_size
            m.blocks.extend(child.blocks[:fb])
            m.num_tokens += fb * self.block_size
            rem = l - fb * self.block_size
            if rem:
                m.partial_block = child.blocks[fb]
                m.partial_len = rem
            return m

    # -- insert --------------------------------------------------------------

    def insert(self, tokens: List[int], blocks: List[int]) -> int:
        """Index the full-block prefix of ``tokens`` (held in
        ``blocks``, table order). Only ``len(tokens) // block_size``
        blocks are cached — the partial tail stays the sequence's
        private property. Already-cached spans are skipped (idempotent;
        re-inserting a reused prefix never double-retains). Returns the
        number of NEWLY indexed blocks, each now holding one cache
        reference."""
        bs = self.block_size
        n_full = len(tokens) // bs
        if n_full == 0:
            return 0
        if len(blocks) < n_full:
            raise ValueError(
                f"{len(tokens)} tokens need {n_full} full blocks; got "
                f"{len(blocks)}")
        tokens = [int(t) for t in tokens[:n_full * bs]]
        blocks = list(blocks[:n_full])
        node, pos = self._root, 0
        now = self._tick()
        while pos < len(tokens):
            child, l = self._best_child(node, tokens, pos)
            fb = (l // bs) * bs        # block-aligned shared span
            if child is None or fb == 0:
                # nothing block-aligned in common: new sibling edge with
                # the remaining chain (divergence inside the first block
                # keeps both nodes whole — they own distinct blocks)
                new_tokens = tokens[pos:]
                new_blocks = blocks[pos // bs:]
                self.pool.retain(new_blocks)
                n = _RadixNode(new_tokens, new_blocks, node)
                n.last_used = now
                node.children.setdefault(tokens[pos], []).append(n)
                self._nodes += 1
                self._resident_blocks += len(new_blocks)
                return len(new_blocks)
            child.last_used = now
            if fb < len(child.tokens):
                # shared span ends inside this edge: split it at the
                # block boundary so the tail becomes its own node
                child = self._split(child, fb)
                child.last_used = now
            node, pos = child, pos + fb
        return 0

    def _split(self, node: _RadixNode, at: int) -> _RadixNode:
        """Split an edge at block-aligned token offset ``at`` (> 0,
        < len(node.tokens)): ``node`` keeps the head span, a new child
        takes the tail (tokens, blocks, and grandchildren). Returns the
        head node."""
        bs = self.block_size
        assert 0 < at < len(node.tokens) and at % bs == 0, at
        tail = _RadixNode(node.tokens[at:], node.blocks[at // bs:], node)
        tail.children = node.children
        for bucket in tail.children.values():
            for gc in bucket:
                gc.parent = tail
        tail.last_used = node.last_used
        node.tokens = node.tokens[:at]
        node.blocks = node.blocks[:at // bs]
        node.children = {tail.tokens[0]: [tail]}
        self._nodes += 1
        return node

    # -- eviction ------------------------------------------------------------

    def evict(self, num_blocks: int) -> int:
        """Release least-recently-used leaf nodes until ``num_blocks``
        pool blocks came free or nothing more is evictable. Only nodes
        whose every block has refcount 1 (the cache's own reference) are
        candidates — blocks shared with a running sequence stay. Parents
        whose last child went become leaves and join the heap. One tree
        walk total: O(nodes + victims·log nodes), not a re-scan per
        victim (this runs on the engine's allocation hot path)."""
        import heapq

        heap = [(leaf.last_used, id(leaf), leaf) for leaf in self._leaves()]
        heapq.heapify(heap)
        freed = 0
        while freed < num_blocks and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.children or victim.parent is None:
                continue               # stale entry: re-parented/removed
            if any(self.pool.refcount(b) != 1 for b in victim.blocks):
                continue               # shared with a live sequence
            parent = victim.parent
            freed += len(victim.blocks)
            self._remove(victim)
            self.evictions += 1
            if parent is not self._root and not parent.children:
                heapq.heappush(heap,
                               (parent.last_used, id(parent), parent))
        return freed

    def _leaves(self):
        stack = [self._root]
        while stack:
            n = stack.pop()
            had_child = False
            for bucket in n.children.values():
                for c in bucket:
                    had_child = True
                    stack.append(c)
            if not had_child and n is not self._root:
                yield n

    def _remove(self, node: _RadixNode) -> None:
        parent = node.parent
        key = node.tokens[0]
        bucket = parent.children.get(key, [])
        if node in bucket:
            bucket.remove(node)
            if not bucket:
                del parent.children[key]
        self.pool.free(node.blocks)
        self._nodes -= 1
        self._resident_blocks -= len(node.blocks)
        node.parent = None             # marks the node as removed

    def clear(self) -> int:
        """Drop every cached prefix (drain / pool-rescue hook); returns
        blocks whose cache reference was released. Iterative post-order
        (children removed before parents) — a long-context chain is one
        node per block and would blow Python's recursion limit."""
        released = 0
        stack = [(self._root, False)]
        while stack:
            node, expanded = stack.pop()
            if not expanded:
                stack.append((node, True))
                for bucket in node.children.values():
                    for c in bucket:
                        stack.append((c, False))
            elif node is not self._root:
                released += len(node.blocks)
                self._remove(node)
        return released

    # -- invariants ----------------------------------------------------------

    def check_invariants(self) -> None:
        """Structural + shared-block invariants: every node is whole
        blocks, block-count matches token-count, no block indexed twice,
        every indexed block live in the pool, resident accounting
        exact."""
        seen: Dict[int, bool] = {}
        nodes = 0
        stack = [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root:
                nodes += 1
                if not n.tokens:
                    raise AssertionError("empty cache node")
                if len(n.tokens) != len(n.blocks) * self.block_size:
                    raise AssertionError(
                        f"node covers {len(n.tokens)} tokens with "
                        f"{len(n.blocks)} blocks (block_size "
                        f"{self.block_size}) — nodes must be whole blocks")
                for b in n.blocks:
                    if b in seen:
                        raise AssertionError(f"block {b} indexed twice")
                    seen[b] = True
                    if self.pool.refcount(b) < 1:
                        raise AssertionError(
                            f"cached block {b} is free in the pool — "
                            f"the cache reference leaked")
            for key, bucket in n.children.items():
                for c in bucket:
                    if c.parent is not n:
                        raise AssertionError("parent pointer corrupt")
                    if c.tokens[0] != key:
                        raise AssertionError("child filed under wrong key")
                    stack.append(c)
        if nodes != self._nodes:
            raise AssertionError(
                f"node accounting: counted {nodes}, tracked {self._nodes}")
        if len(seen) != self._resident_blocks:
            raise AssertionError(
                f"resident accounting: counted {len(seen)}, tracked "
                f"{self._resident_blocks}")
