"""LLMEngine — continuous (iteration-level) batching over a paged KV cache
(counterpart of ray_tpu/serve/llm/engine.py).

One engine owns a block-pool KV cache (``model.init_paged_cache``) and a
scheduler whose every iteration (a) admits waiting prompts into the
running batch under a prefill-token budget and the block budget, (b) runs
one fixed-shape decode step for every resident sequence, (c) retires
finished sequences (EOS / max_tokens / context limit) and frees their
blocks, and (d) preempts the latest-admitted sequence back to the waiting
queue when the pool cannot grow a running one — greedy decode makes the
requeued continuation produce exactly the tokens the unpreempted run
would have.

With ``EngineConfig(prefix_cache=True)`` retired and preempted sequences
leave the full-block KV of their prompt and completion indexed in a radix
tree (prefix_cache.py); a new request reuses the longest cached prefix
(refcounted block sharing, a copy-on-write of the block where it diverges
mid-block) and prefills only its suffix (``model.paged_prefill_extend``).
Cached blocks are LRU-evicted under pool pressure. Greedy decode keeps the
tokens identical to the cache-off engine's.

PyTorch runs the model's programs eagerly; prompts are still padded to
the next ``prefill_buckets`` entry and decode always runs ``max_batch``
slots, because those shapes are part of what the JAX engine computes.

With ``EngineConfig(tp=n)``, n > 1, the engine forms a gang of n rank
actors (``parallel.mesh_group.MeshGroup``, a gloo process group; the
runtime must be started, ``ray_tpu_torch.init()``). Each rank holds its
shard of the params and of the KV cache (the model's tensor-parallel
split, ``parallel/sharding/tensor_parallel.py``: by heads, FFN columns
and vocabulary rows; the device cache by KV head, every block on every
rank). The scheduler and the ``BlockPool(shards=tp)`` accounting stay
here, as in the JAX engine, so admission, preemption, the prefix cache
and ``stats()["kv_blocks_per_chip"]`` are the same; each step sends its
host inputs (tokens, positions, block rows, the active mask, a
copy-on-write pair) to every rank, and rank 0 returns the full
vocabulary's logits. ``params`` is then either the full params (each
rank cuts its shard out of one shipped copy) or a callable
``params(tp_model)`` with a ``device`` attribute, which each rank runs on
that device to build its own shard (``deployment.SeededShards``), so the
full weights never cross the object store.

    engine = LLMEngine(model, params, EngineConfig(max_batch=8))
    engine.start()                       # background scheduler thread
    stream = engine.add_request([1, 5, 9], max_tokens=32)
    for tok in stream: ...               # sync; `async for` also works

Disaggregated intake (``add_prefilled``) adopts KV blocks that a prefill
stage computed elsewhere (disagg.py). Not ported yet (absent): metrics,
tracing, the flight recorder and ``profile()``.
"""
from __future__ import annotations

import asyncio
import collections
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...parallel.mesh_group import MeshWorkerMixin
from .kv_cache import BlockPool, blocks_for_tokens
from .prefix_cache import PrefixCache


@dataclass
class EngineConfig:
    """Scheduler + cache knobs (as in the JAX engine)."""
    block_size: int = 16
    num_blocks: int = 128
    max_batch: int = 8                 # decode batch (slots)
    max_blocks_per_seq: int = 16       # block-table width (M)
    # tensor parallelism: one engine = a gang of tp rank actors, heads,
    # FFN hidden and vocabulary split over them; num_blocks must be a
    # multiple of tp (the pool's per-chip accounting)
    tp: int = 1
    # prefill-token admission budget per scheduler iteration; at least
    # one waiting request is always admitted so a long prompt can't starve
    max_prefill_tokens_per_step: int = 256
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256)
    eos_id: Optional[int] = None       # engine-wide default EOS
    idle_sleep_s: float = 0.002        # background-loop sleep when idle
    # radix prefix cache (prefix_cache.py): a new request reuses the
    # longest cached prefix of retired/preempted/running sequences and
    # prefills only its suffix; LRU-evicted under pool pressure
    prefix_cache: bool = False

    @property
    def max_context(self) -> int:
        """Longest context a sequence can hold in its block table."""
        return self.max_blocks_per_seq * self.block_size


class TokenStream:
    """Per-request token iterator — sync (`for tok in stream`) and async
    (`async for tok in stream`) views over the same queue. The engine
    pushes tokens as the scheduler emits them; a sentinel closes the
    stream with `finish_reason` in {"eos", "length", "error"}."""

    _DONE = object()

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue()
        self._consumed_done = False

    # engine side ----------------------------------------------------------
    def _put(self, tok: int) -> None:
        self._q.put(tok)

    def _finish(self, reason: str,
                error: Optional[BaseException] = None) -> None:
        self.finish_reason = reason
        self.error = error
        self._q.put(self._DONE)

    # consumer side --------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> int:
        return self.next()

    def next(self, timeout: Optional[float] = 300.0) -> int:
        if self._consumed_done:
            raise StopIteration
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"{self.request_id}: no token within {timeout}s") from None
        if item is self._DONE:
            self._consumed_done = True
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        # the blocking pull hops to the default executor so the caller's
        # event loop stays free
        def pull():
            try:
                return False, self.next()
            except StopIteration:
                return True, None

        done, item = await asyncio.get_running_loop().run_in_executor(
            None, pull)
        if done:
            raise StopAsyncIteration
        return item

    def tokens(self, timeout: Optional[float] = 300.0) -> List[int]:
        """Drain to completion -> the full completion, in order."""
        out = []
        while True:
            try:
                out.append(self.next(timeout=timeout))
            except StopIteration:
                return out


@dataclass
class Request:
    request_id: str
    prompt: List[int]                  # context to (re-)prefill
    max_tokens: int
    eos_id: Optional[int]
    stream: TokenStream
    submitted_at: float
    generated: List[int] = field(default_factory=list)
    first_token_at: Optional[float] = None
    preemptions: int = 0
    cache_hit_tokens: int = 0          # prompt tokens served from cache
    cache_miss_tokens: int = 0         # prompt tokens that were prefilled


class _Sequence:
    """A running request's batch-slot state."""

    __slots__ = ("req", "slot", "blocks", "seq_len", "pending", "tokens")

    def __init__(self, req: Request, slot: int, blocks: List[int],
                 seq_len: int, pending: int):
        self.req = req
        self.slot = slot
        self.blocks = blocks           # pool block ids, table order
        self.seq_len = seq_len         # tokens whose KV is in cache
        self.pending = pending         # emitted token awaiting its KV write
        # the token identity of the resident KV, position by position —
        # what the prefix cache indexes
        self.tokens: List[int] = list(req.prompt)


def _copy_block(cache: Dict[str, torch.Tensor], src: int,
                dst: int) -> Dict[str, torch.Tensor]:
    """Copy-on-write: duplicate pool block ``src`` into ``dst`` in every
    layer of k and v (the block axis is axis 1 of [L, N, Bs, KH, hd]),
    in place."""
    for t in cache.values():
        t[:, dst].copy_(t[:, src])
    return cache


def _write_blocks(cache: Dict[str, torch.Tensor], blocks: List[int],
                  kv_blocks: Dict[str, Any]) -> None:
    """Copy shipped KV blocks k/v [L, nb, block_size, KH, hd] into pool
    blocks ``blocks`` of ``cache``, in the cache's dtype."""
    idx = torch.tensor(blocks, device=next(iter(cache.values())).device)
    for name, pool in cache.items():
        src = kv_blocks[name]
        if not isinstance(src, torch.Tensor):
            src = torch.tensor(np.asarray(src))  # a copy
        pool[:, idx] = src.to(pool.device, pool.dtype)


def _cache_bytes(cache: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


class _EngineRank(MeshWorkerMixin):
    """One rank of a tensor-parallel engine: its shard of the params and
    of the KV cache on its device, and the model's programs on them. Every
    rank runs each call (the programs' collectives need all of them);
    rank 0 returns the logits."""

    def load(self, model, params, num_blocks: int, block_size: int,
             device: str) -> Dict[str, Any]:
        import os

        from ..._device import resolve_device
        from ...parallel.sharding.tensor_parallel import TensorParallel

        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        tp = TensorParallel.from_owner(self.mesh_owner)
        if self.device.type == "cpu":
            # CPU ranks share their host's cores: each takes its share of
            # intra-op threads (every rank defaulting to all of them
            # oversubscribes the host several times over)
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // tp.size))
        self._check_collectives(tp)
        self.rank = tp.rank
        self.model = model.tensor_parallel(tp)
        with torch.no_grad():
            if callable(params):
                self.params = params(self.model)
            else:
                self.params = {n: t.to(self.device) for n, t in
                               self.model.shard_params(params).items()}
        self.cache = self.model.init_paged_cache(num_blocks, block_size,
                                                 self.device)
        return {"rank": tp.rank, "pid": os.getpid(),
                "device": str(self.device),
                "param_bytes": _cache_bytes(self.params),
                "kv_bytes": _cache_bytes(self.cache)}

    def _check_collectives(self, tp) -> None:
        """The group's all-reduce on this rank's device and its host
        all-gather give the sums and rows they must, before any weight
        is trusted to them: a failed collective fails the engine."""
        x = torch.full((4,), float(tp.rank + 1), device=self.device)
        total = tp.all_reduce_f32(x)
        want = tp.size * (tp.size + 1) / 2
        rows = tp.gather_last(torch.full((1, 2), float(tp.rank),
                                         device=self.device))
        if total.device != self.device or not bool((total == want).all()) \
                or rows.flatten().tolist() != [float(r) for r in range(
                    tp.size) for _ in range(2)]:
            raise RuntimeError(
                f"tp rank {tp.rank}: collectives on {self.device} gave "
                f"{total.tolist()} and {rows.tolist()}")

    def _out(self, logits):
        return logits.cpu() if self.rank == 0 else None

    def prefill(self, tokens, length, block_row):
        with torch.no_grad():
            logits, self.cache = self.model.paged_prefill(
                self.params, self.cache, tokens.to(self.device), length,
                block_row.to(self.device))
        return self._out(logits)

    def extend(self, tokens, start, length, block_row):
        with torch.no_grad():
            logits, self.cache = self.model.paged_prefill_extend(
                self.params, self.cache, tokens.to(self.device), start,
                length, block_row.to(self.device))
        return self._out(logits)

    def decode(self, tokens, positions, rows, active):
        dev = self.device
        with torch.no_grad():
            logits, self.cache = self.model.paged_decode_step(
                self.params, self.cache, tokens.to(dev), positions.to(dev),
                rows.to(dev), active.to(dev))
        return self._out(logits)

    def cow(self, src: int, dst: int) -> bool:
        with torch.no_grad():
            _copy_block(self.cache, src, dst)
        return True

    def write_blocks(self, blocks: List[int], kv_blocks) -> bool:
        """Shipped full-head KV blocks, cut to this rank's KV heads."""
        heads, hd = self.model._layout.kv_heads, self.model.config.head_dim
        local = {}
        for name, v in kv_blocks.items():                # [L, nb, bs, KH, hd]
            flat = v.flatten(-2)
            local[name] = self.model.tp.take_heads(
                flat, flat.dim() - 1, heads, hd).unflatten(-1, (-1, hd))
        with torch.no_grad():
            _write_blocks(self.cache, blocks, local)
        return True

    def kv_bytes(self) -> int:
        return _cache_bytes(self.cache)


class LLMEngine:
    """One replica's inference engine. Thread-safe: `add_request` may be
    called from any thread; the scheduler runs either on the background
    thread (`start()`) or driven explicitly (`step()` /
    `run_until_idle()` — never both)."""

    _ids = itertools.count()

    def __init__(self, model: Any, params: Any,
                 config: Optional[EngineConfig] = None, name: str = ""):
        cfg = config or EngineConfig()
        buckets = tuple(sorted(set(
            min(b, cfg.max_context, model.config.max_seq)
            for b in cfg.prefill_buckets)))
        if not buckets:
            raise ValueError("prefill_buckets must be non-empty")
        self.model = model
        self.params = params
        self.config = cfg
        self.buckets = buckets
        self.max_prompt = buckets[-1]
        # hard context ceiling: the block table AND the model's positions
        self.max_seq_len = min(cfg.max_context, model.config.max_seq)
        self.name = name or f"llm-{next(self._ids)}"
        self.tp = int(cfg.tp)
        self.pool = BlockPool(cfg.num_blocks, shards=self.tp)
        self.mesh_group = None
        if self.tp > 1:
            self._start_ranks(model, params, cfg)
        else:
            self.device = params["wte"].device
            self._cache = model.init_paged_cache(
                cfg.num_blocks, cfg.block_size, self.device)
            # the model's programs, as attributes so a caller can
            # observe them
            self._prefill_fn = model.paged_prefill
            self._extend_fn = model.paged_prefill_extend
            self._decode_fn = model.paged_decode_step
            self._cow_fn = _copy_block
        self._lock = threading.RLock()
        self._waiting: "collections.deque[Request]" = collections.deque()
        self._running: List[_Sequence] = []
        self._free_slots = list(range(cfg.max_batch - 1, -1, -1))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._total_generated = 0
        self._total_preemptions = 0
        self._peak_blocks = 0
        self._peak_per_chip: List[int] = [0] * self.tp
        self._tok_events: "collections.deque" = collections.deque()
        self.prefix_cache: Optional[PrefixCache] = None
        self._prefix_hits = 0          # tokens served from cached KV
        self._prefix_misses = 0        # tokens that paid prefill compute
        if cfg.prefix_cache:
            self.prefix_cache = PrefixCache(self.pool, cfg.block_size)

    def _start_ranks(self, model, params, cfg: EngineConfig) -> None:
        """Form the gang of tp rank actors and load each rank's shard.
        The programs below send a step's host inputs to every rank and
        take rank 0's logits; ``self._cache`` stays None (the cache lives
        on the ranks)."""
        import ray_tpu_torch

        from ...parallel.mesh import MeshSpec
        from ...parallel.mesh_group import MeshGroup

        if not ray_tpu_torch.is_initialized():
            raise RuntimeError(
                f"EngineConfig(tp={self.tp}) runs its ranks as actors of "
                "the port's runtime: call ray_tpu_torch.init() first")
        device = str(params["wte"].device if isinstance(params, dict)
                     else params.device)
        dev_type = torch.device(device).type
        # the driver sends host tensors; the ranks hold the device ones
        self.device = torch.device("cpu")
        self._cache = None
        if isinstance(params, dict):
            # one copy into the object store, read by every rank
            params = ray_tpu_torch.put({n: t.detach().cpu()
                                        for n, t in params.items()})
        self.mesh_group = MeshGroup(
            self.tp, spec=MeshSpec(dp=1, tp=self.tp),
            worker_cls=_EngineRank, device_type=dev_type)
        try:
            self.ranks = ray_tpu_torch.get([
                w.load.remote(model, params, cfg.num_blocks,
                              cfg.block_size, device)
                for w in self.mesh_group.workers])
        except BaseException:
            self.mesh_group.shutdown()
            raise

        def call(method):
            def run(*args):
                return ray_tpu_torch.get(
                    [getattr(w, method).remote(*args)
                     for w in self.mesh_group.workers])[0]
            return run

        prefill, extend, decode = (call("prefill"), call("extend"),
                                   call("decode"))
        self._prefill_fn = lambda params, cache, *a: (prefill(*a), cache)
        self._extend_fn = lambda params, cache, *a: (extend(*a), cache)
        self._decode_fn = lambda params, cache, *a: (decode(*a), cache)
        cow = call("cow")
        self._cow_fn = lambda cache, src, dst: (cow(src, dst), cache)[1]
        self._write_ranks = call("write_blocks")

    # -- request intake -------------------------------------------------------

    def add_request(self, prompt: Sequence[int], max_tokens: int = 16,
                    eos_id: Any = "__default__",
                    request_id: Optional[str] = None) -> TokenStream:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds engine capacity "
                f"{self.max_prompt} (largest prefill bucket)")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        rid = request_id or f"req-{next(self._ids)}"
        stream = TokenStream(rid)
        req = Request(rid, prompt, int(max_tokens),
                      self.config.eos_id if eos_id == "__default__"
                      else eos_id,
                      stream, time.perf_counter())
        with self._lock:
            self._waiting.append(req)
        return stream

    def add_prefilled(self, prompt: Sequence[int], kv_blocks: Dict[str, Any],
                      first_token: int, max_tokens: int = 16,
                      eos_id: Any = "__default__",
                      timeout: float = 60.0) -> TokenStream:
        """Disaggregated-prefill intake: the prompt's KV was computed by a
        prefill stage (disagg.py) and arrives as block-shaped host arrays
        or tensors k/v [L, nb, block_size, KH, hd]; this engine copies
        them into freshly allocated pool blocks on its device, in the
        cache's dtype, and the sequence enters decode directly with
        ``first_token`` emitted — no local prefill pass."""
        prompt = [int(t) for t in prompt]
        nb = int(kv_blocks["k"].shape[1])
        if nb != blocks_for_tokens(len(prompt), self.config.block_size):
            raise ValueError(
                f"shipped {nb} blocks for a {len(prompt)}-token prompt "
                f"(block_size {self.config.block_size})")
        rid = f"req-{next(self._ids)}"
        stream = TokenStream(rid)
        req = Request(rid, prompt, int(max_tokens),
                      self.config.eos_id if eos_id == "__default__"
                      else eos_id,
                      stream, time.perf_counter())
        deadline = time.monotonic() + timeout
        while True:
            with self._lock, torch.no_grad():
                # evicting alloc: a prefix-cached decode stage would
                # otherwise wedge once cache residency drains the free
                # list (nothing here runs _admit's eviction path)
                blocks = self._alloc_with_evict(nb)
                slot = self._free_slots.pop() if (
                    blocks is not None and self._free_slots) else None
                if blocks is not None and slot is None:
                    self.pool.free(blocks)
                    blocks = None
                if blocks is not None:
                    if self.mesh_group is None:
                        _write_blocks(self._cache, blocks, kv_blocks)
                    else:
                        self._write_ranks(blocks, {
                            n: torch.as_tensor(np.asarray(v)) if not
                            isinstance(v, torch.Tensor) else v.cpu()
                            for n, v in kv_blocks.items()})
                    seq = _Sequence(req, slot, blocks, len(prompt),
                                    int(first_token))
                    self._running.append(seq)
                    # TTFT ends at intake: the first token came with
                    # the shipment
                    req.first_token_at = time.perf_counter()
                    self._emit(seq, int(first_token))
                    return stream
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.name}: no capacity for prefilled sequence "
                    f"({nb} blocks) after {timeout}s")
            time.sleep(0.005)

    # -- scheduler ------------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: admit, decode, retire. Returns True if
        any work was done (callers can sleep when False)."""
        with self._lock, torch.no_grad():
            admitted = self._admit()
            decoded = self._decode_iteration()
            self._peak_blocks = max(self._peak_blocks, self.pool.used_count)
            for chip, used in enumerate(self.pool.used_per_shard()):
                self._peak_per_chip[chip] = max(self._peak_per_chip[chip],
                                                used)
            return admitted or decoded

    def _alloc_with_evict(self, n: int) -> Optional[List[int]]:
        """Pool alloc that spends cached prefixes under pressure: when
        the free list can't cover ``n``, LRU-evict refcount-1 cache
        nodes until it can (cache residency is a best-effort use of idle
        blocks, never a reason to preempt live work)."""
        blocks = self.pool.alloc(n)
        if blocks is None and self.prefix_cache is not None:
            short = n - self.pool.free_count
            if short > 0:
                self.prefix_cache.evict(short)
            blocks = self.pool.alloc(n)
        return blocks

    def _admit(self) -> bool:
        cfg = self.config
        budget = cfg.max_prefill_tokens_per_step
        admitted = False
        while self._waiting and self._free_slots:
            req = self._waiting[0]
            p = len(req.prompt)
            if p > self.max_prompt:
                # grew past capacity through preemption requeues
                self._waiting.popleft()
                req.stream._finish("error", RuntimeError(
                    f"{req.request_id}: context {p} exceeds engine "
                    f"capacity {self.max_prompt}"))
                continue
            # longest cached prefix (at most p-1: the last prompt token
            # always prefills so its logits pick the first new token)
            match = None
            cached = 0
            if self.prefix_cache is not None:
                match = self.prefix_cache.match(req.prompt[:-1])
                cached = match.num_tokens + match.partial_len
            if admitted and p - cached > budget:
                break                     # token budget for this iteration
            nb = blocks_for_tokens(p, cfg.block_size)
            reused = list(match.blocks) if match else []
            # pin the matched blocks (and the COW source) before any
            # eviction the alloc below may trigger can free them; the
            # pin rides match.blocks into the sequence's table and is
            # freed at retire/preempt through seq.blocks
            if reused:
                self.pool.retain(reused)  # graftcheck: disable=GC030
            if match is not None and match.partial_block is not None:
                self.pool.retain([match.partial_block])
            blocks = self._alloc_with_evict(nb - len(reused))
            if blocks is None:
                if reused:
                    self.pool.free(reused)
                if match is not None and match.partial_block is not None:
                    self.pool.free([match.partial_block])
                if not self._running and nb > self.pool.num_blocks:
                    self._waiting.popleft()
                    req.stream._finish("error", RuntimeError(
                        f"{req.request_id}: prompt needs {nb} blocks; "
                        f"pool holds {self.pool.num_blocks}"))
                    continue
                if not self._running and self.prefix_cache is not None \
                        and self.prefix_cache.resident_blocks:
                    # nothing running will ever free blocks, and partial
                    # matches can pin nodes eviction must skip: drop the
                    # whole cache and retry cold — progress beats warmth
                    self.prefix_cache.clear()
                    continue
                break                     # wait for decode frees/preemption
            self._waiting.popleft()
            budget -= p - cached
            admitted = True
            if cached:
                self._prefill_cached(req, match, blocks)
            else:
                self._prefill_into(req, blocks)
        return admitted

    def _prefill_into(self, req: Request, blocks: List[int]) -> None:
        cfg = self.config
        p = len(req.prompt)
        bucket = next(b for b in self.buckets if b >= p)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :p] = req.prompt
        row = np.full((cfg.max_blocks_per_seq,), -1, np.int64)
        row[:len(blocks)] = blocks
        logits, self._cache = self._prefill_fn(
            self.params, self._cache,
            torch.from_numpy(toks).to(self.device), p,
            torch.from_numpy(row).to(self.device))
        first = int(logits.argmax())
        self._count_prefix(0, p)
        req.cache_hit_tokens, req.cache_miss_tokens = 0, p
        self._start_sequence(req, blocks, p, first)

    def _prefill_cached(self, req: Request, match, blocks: List[int]) -> None:
        """Suffix-only prefill over a matched cached prefix: the
        sequence's table is [reused full blocks | fresh blocks]; a
        mid-block divergence first duplicates the partially-shared block
        into the first fresh one (COW), then only prompt[cached:] runs
        through the extend program."""
        cfg = self.config
        p = len(req.prompt)
        cached = match.num_tokens + match.partial_len
        table = list(match.blocks) + blocks
        if match.partial_len:
            # COW at the divergence point: blocks[0] becomes this
            # sequence's private copy of the partially-shared block
            self._cache = self._cow_fn(self._cache, match.partial_block,
                                       blocks[0])
            # the pin taken at match time was only for the copy
            self.pool.free([match.partial_block])
        suffix = req.prompt[cached:]
        s = len(suffix)
        bucket = next(b for b in self.buckets if b >= s)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :s] = suffix
        row = np.full((cfg.max_blocks_per_seq,), -1, np.int64)
        row[:len(table)] = table
        logits, self._cache = self._extend_fn(
            self.params, self._cache,
            torch.from_numpy(toks).to(self.device), cached, s,
            torch.from_numpy(row).to(self.device))
        first = int(logits.argmax())
        self._count_prefix(cached, s)
        req.cache_hit_tokens, req.cache_miss_tokens = cached, s
        self._start_sequence(req, table, p, first)

    def _start_sequence(self, req: Request, blocks: List[int], p: int,
                        first: int) -> None:
        slot = self._free_slots.pop()
        seq = _Sequence(req, slot, blocks, p, first)
        self._running.append(seq)
        if self.prefix_cache is not None:
            # index the prompt's full blocks NOW so concurrent requests
            # sharing the prefix hit before this sequence even retires
            self.prefix_cache.insert(seq.tokens, seq.blocks)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        self._emit(seq, first)

    def _count_prefix(self, hit: int, miss: int) -> None:
        if self.prefix_cache is not None:
            self._prefix_hits += hit
            self._prefix_misses += miss

    def _decode_iteration(self) -> bool:
        cfg = self.config
        if not self._running:
            return False
        # grow block tables for this iteration's writes; preempt the
        # latest-admitted sequence when the pool is out of blocks
        i = 0
        while i < len(self._running):
            seq = self._running[i]
            # this iteration writes the pending token at position
            # seq_len, so the context must still have room for it
            if seq.seq_len >= self.max_seq_len:
                self._retire(seq, "length")
                continue
            need = seq.seq_len // cfg.block_size + 1
            if need > cfg.max_blocks_per_seq:
                self._retire(seq, "length")
                continue
            grow = need - len(seq.blocks)
            # a shared block under the write position must be
            # duplicated before this sequence extends it (COW): decode
            # structurally writes only private tail blocks, but a
            # refcount > 1 here — however it arose — would corrupt
            # every other holder's context
            wi = seq.seq_len // cfg.block_size
            cow = (grow <= 0 and self.prefix_cache is not None
                   and self.pool.refcount(seq.blocks[wi]) > 1)
            if grow > 0 or cow:
                got = self._alloc_with_evict(max(grow, 0) + int(cow))
                if got is None:
                    victim = self._running[-1]
                    if victim is seq and len(self._running) == 1:
                        if self.prefix_cache is not None and \
                                self.prefix_cache.resident_blocks:
                            # partially-shared nodes can pin blocks LRU
                            # eviction must skip — drop the whole cache
                            # before declaring the pool exhausted, and
                            # recompute cow: clearing may have dropped
                            # the only other reference on the write block
                            self.prefix_cache.clear()
                            cow = (grow <= 0 and self.pool.refcount(
                                seq.blocks[wi]) > 1)
                            got = self.pool.alloc(max(grow, 0) + int(cow))
                        if got is None:
                            # sole runner and the pool still can't grow
                            # it: blocks are held outside this engine —
                            # fail loud
                            self._retire(seq, "error", RuntimeError(
                                f"{seq.req.request_id}: KV pool exhausted "
                                f"with no preemptible sequence"))
                            continue
                    else:
                        self._preempt(victim)
                        continue          # retry (or skip the victim)
                if cow:
                    self._cow_block(seq, wi, got.pop())
                seq.blocks.extend(got)
            i += 1
        if not self._running:
            return False
        b, m = cfg.max_batch, cfg.max_blocks_per_seq
        tokens = np.zeros((b,), np.int64)
        positions = np.zeros((b,), np.int64)
        rows = np.full((b, m), -1, np.int64)
        active = np.zeros((b,), bool)
        for seq in self._running:
            tokens[seq.slot] = seq.pending
            positions[seq.slot] = seq.seq_len
            rows[seq.slot, :len(seq.blocks)] = seq.blocks
            active[seq.slot] = True
        dev = self.device
        logits, self._cache = self._decode_fn(
            self.params, self._cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(rows).to(dev), torch.from_numpy(active).to(dev))
        next_tok = logits.argmax(dim=-1).cpu().numpy()
        emitted = 0
        for seq in list(self._running):
            seq.seq_len += 1              # pending's KV landed this step
            seq.tokens.append(seq.pending)
            seq.pending = int(next_tok[seq.slot])
            self._emit(seq, seq.pending)
            emitted += 1
        now = time.perf_counter()
        self._tok_events.append((now, emitted))
        self._trim_tok_events(now)
        self._total_generated += emitted
        return True

    def _emit(self, seq: _Sequence, tok: int) -> None:
        req = seq.req
        req.generated.append(tok)
        req.stream._put(tok)
        if req.eos_id is not None and tok == req.eos_id:
            self._retire(seq, "eos")
        elif len(req.generated) >= req.max_tokens:
            self._retire(seq, "length")

    def _cow_block(self, seq: _Sequence, wi: int, fresh: int) -> None:
        """Copy-on-write: duplicate seq.blocks[wi] into ``fresh`` on the
        device, swap the table entry, release this sequence's reference
        on the shared original."""
        self._cache = self._cow_fn(self._cache, seq.blocks[wi], fresh)
        self.pool.free([seq.blocks[wi]])
        seq.blocks[wi] = fresh

    def _retire(self, seq: _Sequence, reason: str,
                error: Optional[BaseException] = None) -> None:
        self._running.remove(seq)
        if self.prefix_cache is not None and error is None:
            # leave the full-block KV of prompt+completion behind for
            # followers; the cache takes its own references, so the free
            # below releases only this sequence's claim
            self.prefix_cache.insert(seq.tokens, seq.blocks)
        self.pool.free(seq.blocks)
        self._free_slots.append(seq.slot)
        seq.req.stream._finish(reason, error)

    def _preempt(self, seq: _Sequence) -> None:
        """Free everything the sequence holds and requeue it at the front
        of the waiting queue with prompt = full context so far; greedy
        re-prefill continues the exact token sequence (and, with the
        prefix cache on, mostly re-uses its own still-cached KV — the
        private tail is the only real loss)."""
        self._running.remove(seq)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(seq.tokens, seq.blocks)
        self.pool.free(seq.blocks)
        self._free_slots.append(seq.slot)
        req = seq.req
        # full context to re-prefill = what this run prefilled plus every
        # token it generated (seq_len - prefill_len KV writes + pending)
        n_new = seq.seq_len - len(req.prompt) + 1
        req.prompt = list(req.prompt) + req.generated[-n_new:]
        req.preemptions += 1
        self._total_preemptions += 1
        self._waiting.appendleft(req)

    # -- scheduler loop -------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"llm-engine-{self.name}")
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                worked = self.step()
            except Exception as e:  # noqa: BLE001 — fail every stream loud
                self._fail_all(e)
                worked = False
            if not worked:
                self._stop.wait(self.config.idle_sleep_s)

    def _fail_all(self, error: BaseException) -> None:
        with self._lock:
            for seq in list(self._running):
                self._retire(seq, "error", error)
            while self._waiting:
                self._waiting.popleft().stream._finish("error", error)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the scheduler and, at tp > 1, the rank actors
        (idempotent)."""
        self.stop(timeout)
        if self.mesh_group is not None:
            self.mesh_group.shutdown()
            self.mesh_group = None

    def run_until_idle(self, timeout: float = 300.0) -> None:
        """Drive the scheduler inline until no request is waiting or
        running (test mode; don't mix with start())."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                idle = not self._waiting and not self._running
            if idle:
                return
            self.step()
            if time.monotonic() > deadline:
                raise TimeoutError(f"{self.name}: not idle after {timeout}s")

    # -- introspection --------------------------------------------------------

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiting) + len(self._running)

    _TOKPS_WINDOW_S = 10.0

    def _trim_tok_events(self, now: float) -> None:
        while self._tok_events and \
                now - self._tok_events[0][0] > self._TOKPS_WINDOW_S:
            self._tok_events.popleft()

    def _tokens_per_s(self) -> float:
        """Generated tokens/s over the trailing window."""
        now = time.perf_counter()
        self._trim_tok_events(now)
        if len(self._tok_events) < 2:
            return 0.0
        span = now - self._tok_events[0][0]
        return sum(n for _, n in self._tok_events) / max(span, 1e-6)

    def kv_bytes_per_chip(self) -> Dict[int, int]:
        """Resident KV-cache bytes per chip, keyed 0..tp-1 as the pool's
        shard accounting: at tp > 1 read from each rank's own cache
        tensors (by KV head, so each is total / tp where the KV heads
        divide by tp)."""
        if self.mesh_group is None:
            with self._lock:  # the step loop may replace _cache
                return {0: _cache_bytes(self._cache)}
        import ray_tpu_torch

        return dict(enumerate(ray_tpu_torch.get(
            [w.kv_bytes.remote() for w in self.mesh_group.workers])))

    def cache_stats(self) -> Dict[str, Any]:
        """Prefix-cache health: hit rate over prompt tokens, hit and miss
        token counts, resident blocks, nodes and evictions. All zeros
        with the cache disabled."""
        with self._lock:
            hit, miss = self._prefix_hits, self._prefix_misses
            pc = self.prefix_cache
            return {
                "cache_hit_rate": round(hit / (hit + miss), 4)
                if hit + miss else 0.0,
                "prefix_hit_tokens": hit,
                "prefix_miss_tokens": miss,
                "prefix_blocks_resident": pc.resident_blocks if pc else 0,
                "prefix_nodes": pc.num_nodes if pc else 0,
                "prefix_evictions": pc.evictions if pc else 0,
            }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "engine": self.name,
                "waiting": len(self._waiting),
                "running": len(self._running),
                "queue_depth": len(self._waiting) + len(self._running),
                "kv_blocks_used": self.pool.used_count,
                "kv_blocks_total": self.pool.num_blocks,
                "kv_occupancy": round(
                    self.pool.used_count / self.pool.num_blocks, 4),
                "tokens_per_s": round(self._tokens_per_s(), 1),
                "total_generated": self._total_generated,
                "preemptions": self._total_preemptions,
                "tp": self.tp,
                "kv_blocks_peak": self._peak_blocks,
            }
            if self.prefix_cache is not None:
                out.update(self.cache_stats())
            if self.tp > 1:
                out["kv_blocks_per_chip"] = self.pool.used_per_shard()
                out["kv_blocks_peak_per_chip"] = list(self._peak_per_chip)
                out["kv_bytes_per_chip"] = {
                    str(d): b for d, b in self.kv_bytes_per_chip().items()}
            return out
