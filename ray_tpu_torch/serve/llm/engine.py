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

PyTorch runs the model's programs eagerly; prompts are still padded to
the next ``prefill_buckets`` entry and decode always runs ``max_batch``
slots, because those shapes are part of what the JAX engine computes.

    engine = LLMEngine(model, params, EngineConfig(max_batch=8))
    engine.start()                       # background scheduler thread
    stream = engine.add_request([1, 5, 9], max_tokens=32)
    for tok in stream: ...               # sync; `async for` also works

Not ported yet (each raises or is absent): tensor parallelism (``tp``),
the radix prefix cache (``prefix_cache``), disaggregated intake
(``add_prefilled``), metrics, tracing, the flight recorder and
``profile()``.
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

from .kv_cache import BlockPool, blocks_for_tokens


@dataclass
class EngineConfig:
    """Scheduler + cache knobs (as in the JAX engine)."""
    block_size: int = 16
    num_blocks: int = 128
    max_batch: int = 8                 # decode batch (slots)
    max_blocks_per_seq: int = 16       # block-table width (M)
    tp: int = 1                        # only 1 is ported
    # prefill-token admission budget per scheduler iteration; at least
    # one waiting request is always admitted so a long prompt can't starve
    max_prefill_tokens_per_step: int = 256
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256)
    eos_id: Optional[int] = None       # engine-wide default EOS
    idle_sleep_s: float = 0.002        # background-loop sleep when idle
    prefix_cache: bool = False         # only False is ported

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


class _Sequence:
    """A running request's batch-slot state."""

    __slots__ = ("req", "slot", "blocks", "seq_len", "pending")

    def __init__(self, req: Request, slot: int, blocks: List[int],
                 seq_len: int, pending: int):
        self.req = req
        self.slot = slot
        self.blocks = blocks           # pool block ids, table order
        self.seq_len = seq_len         # tokens whose KV is in cache
        self.pending = pending         # emitted token awaiting its KV write


class LLMEngine:
    """One replica's inference engine. Thread-safe: `add_request` may be
    called from any thread; the scheduler runs either on the background
    thread (`start()`) or driven explicitly (`step()` /
    `run_until_idle()` — never both)."""

    _ids = itertools.count()

    def __init__(self, model: Any, params: Dict[str, torch.Tensor],
                 config: Optional[EngineConfig] = None, name: str = ""):
        cfg = config or EngineConfig()
        if cfg.tp != 1:
            raise NotImplementedError("tensor-parallel serving (tp > 1) is "
                                      "not ported yet")
        if cfg.prefix_cache:
            raise NotImplementedError("the prefix cache is not ported yet")
        buckets = tuple(sorted(set(
            min(b, cfg.max_context, model.config.max_seq)
            for b in cfg.prefill_buckets)))
        if not buckets:
            raise ValueError("prefill_buckets must be non-empty")
        self.model = model
        self.params = params
        self.device = params["wte"].device
        self.config = cfg
        self.buckets = buckets
        self.max_prompt = buckets[-1]
        # hard context ceiling: the block table AND the model's positions
        self.max_seq_len = min(cfg.max_context, model.config.max_seq)
        self.name = name or f"llm-{next(self._ids)}"
        self.pool = BlockPool(cfg.num_blocks)
        self._cache = model.init_paged_cache(cfg.num_blocks, cfg.block_size,
                                             self.device)
        # the model's programs, as attributes so a caller can observe them
        self._prefill_fn = model.paged_prefill
        self._decode_fn = model.paged_decode_step
        self._lock = threading.RLock()
        self._waiting: "collections.deque[Request]" = collections.deque()
        self._running: List[_Sequence] = []
        self._free_slots = list(range(cfg.max_batch - 1, -1, -1))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._total_generated = 0
        self._total_preemptions = 0
        self._peak_blocks = 0
        self._tok_events: "collections.deque" = collections.deque()

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

    def add_prefilled(self, *args, **kwargs) -> TokenStream:
        raise NotImplementedError("disaggregated prefill intake is not "
                                  "ported yet")

    # -- scheduler ------------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: admit, decode, retire. Returns True if
        any work was done (callers can sleep when False)."""
        with self._lock, torch.no_grad():
            admitted = self._admit()
            decoded = self._decode_iteration()
            self._peak_blocks = max(self._peak_blocks, self.pool.used_count)
            return admitted or decoded

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
            if admitted and p > budget:
                break                     # token budget for this iteration
            nb = blocks_for_tokens(p, cfg.block_size)
            blocks = self.pool.alloc(nb)
            if blocks is None:
                if not self._running and nb > self.pool.num_blocks:
                    self._waiting.popleft()
                    req.stream._finish("error", RuntimeError(
                        f"{req.request_id}: prompt needs {nb} blocks; "
                        f"pool holds {self.pool.num_blocks}"))
                    continue
                break                     # wait for decode frees/preemption
            self._waiting.popleft()
            budget -= p
            admitted = True
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
        self._start_sequence(req, blocks, p, first)

    def _start_sequence(self, req: Request, blocks: List[int], p: int,
                        first: int) -> None:
        slot = self._free_slots.pop()
        seq = _Sequence(req, slot, blocks, p, first)
        self._running.append(seq)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        self._emit(seq, first)

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
            if grow > 0:
                got = self.pool.alloc(grow)
                if got is None:
                    victim = self._running[-1]
                    if victim is seq and len(self._running) == 1:
                        # sole runner and the pool still can't grow it:
                        # blocks are held outside this engine — fail loud
                        self._retire(seq, "error", RuntimeError(
                            f"{seq.req.request_id}: KV pool exhausted "
                            f"with no preemptible sequence"))
                        continue
                    self._preempt(victim)
                    continue              # retry (or skip the victim)
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

    def _retire(self, seq: _Sequence, reason: str,
                error: Optional[BaseException] = None) -> None:
        self._running.remove(seq)
        self.pool.free(seq.blocks)
        self._free_slots.append(seq.slot)
        seq.req.stream._finish(reason, error)

    def _preempt(self, seq: _Sequence) -> None:
        """Free everything the sequence holds and requeue it at the front
        of the waiting queue with prompt = full context so far; greedy
        re-prefill continues the exact token sequence."""
        self._running.remove(seq)
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

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
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
                "tp": 1,
                "kv_blocks_peak": self._peak_blocks,
            }
