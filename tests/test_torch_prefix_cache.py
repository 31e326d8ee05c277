"""The port's radix prefix cache (ray_tpu_torch.serve.llm.prefix_cache) and
the engine's prefix-cache paths, on the CPU.

The accounting cases mirror tests/test_prefix_cache.py:30-223 against the
port's copies of the block pool and the radix tree. The engine cases run
gpt-tiny and llama-tiny (f32, mha_reference attention) on the JAX init's
weights carried over through numpy, and hold the port's greedy tokens,
with the cache on and off, to the JAX engine's, token for token, on the
prompts of tests/test_prefix_cache.py:277-302 (full-block reuse, a
block-boundary divergence, a mid-block divergence that takes the
copy-on-write path, and a full replay). Preemption with a shared prefix,
eviction under pool pressure, shared blocks counted once and concurrent
hit/miss streams mirror :304-430 at tp=1, each against the port's own
cache-off run.
"""
import threading

import numpy as np
import pytest
import torch

from ray_tpu.serve.llm import EngineConfig as JEngineConfig
from ray_tpu.serve.llm import LLMEngine as JLLMEngine
from ray_tpu.serve.llm import build_model as jbuild_model
from ray_tpu_torch.models import (GPT, GPTConfig, Llama, LlamaConfig,
                                  gpt_params_from_numpy,
                                  llama_params_from_numpy)
from ray_tpu_torch.serve.llm import (BlockPool, EngineConfig, LLMEngine,
                                     PrefixCache)

BS = 4  # block size used throughout the accounting tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and it
    leaves the machine's cores to the test files running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# refcounted block pool


class TestRefcountedPool:
    def test_retain_release_roundtrip(self):
        pool = BlockPool(8)
        a = pool.alloc(3)
        pool.retain(a)                       # second holder
        assert pool.used_count == 3          # shared counted ONCE
        pool.free(a)                         # first holder releases
        assert pool.used_count == 3          # still live via second
        pool.check_leaks()
        pool.free(a)
        assert pool.used_count == 0 and pool.free_count == 8
        pool.check_leaks()

    def test_refcount_introspection(self):
        pool = BlockPool(4)
        (b,) = pool.alloc(1)
        assert pool.refcount(b) == 1
        pool.retain([b])
        assert pool.refcount(b) == 2
        pool.free([b])
        pool.free([b])
        assert pool.refcount(b) == 0
        with pytest.raises(ValueError, match="unknown"):
            pool.refcount(99)

    @pytest.mark.parametrize("case", ["retain_free_block", "over_release"])
    def test_bad_reference_ops_rejected(self, case):
        pool = BlockPool(8)
        a = pool.alloc(2)
        if case == "retain_free_block":
            pool.free(a)
            with pytest.raises(ValueError, match="free block"):
                pool.retain(a)
            pool.check_leaks()
            return
        with pytest.raises(ValueError, match="double free"):
            pool.free(a + a)                 # 2 releases of 1 reference
        # the failed call must not have released the valid half
        assert pool.used_count == 2
        pool.free(a)
        pool.check_leaks()

    def test_used_never_exceeds_capacity_under_sharing(self):
        pool = BlockPool(4)
        # rc stress: 5 retains balanced by 6 frees across loop
        # iterations — beyond static counting, verified by check_leaks
        a = pool.alloc(4)  # graftcheck: disable=GC030
        for _ in range(5):
            pool.retain(a)  # graftcheck: disable=GC030
        assert pool.used_count == 4 == pool.num_blocks
        for _ in range(6):
            pool.free(a)  # graftcheck: disable=GC031
        assert pool.used_count == 0
        pool.check_leaks()

    def test_shared_block_leak_invariant(self):
        pool = BlockPool(4)
        a = pool.alloc(2)
        # corrupt: a LIVE block replaces a free one on the free list
        pool._free_by_shard[0][-1] = a[0]
        with pytest.raises(AssertionError, match="free AND holds"):
            pool.check_leaks()

    def test_sharded_pool_counts_shared_once_per_shard(self):
        pool = BlockPool(8, shards=2)
        a = pool.alloc(4)                    # balanced 2+2
        pool.retain(a)
        per = pool.used_per_shard()
        assert per == [2, 2] and sum(per) == pool.used_count
        pool.free(a)
        assert pool.used_per_shard() == [2, 2]   # second holder remains
        pool.free(a)
        assert pool.used_per_shard() == [0, 0]
        pool.check_leaks()


# ---------------------------------------------------------------------------
# radix tree


def _mk(n_blocks=64):
    pool = BlockPool(n_blocks)
    return pool, PrefixCache(pool, BS)


class TestRadixTree:
    @pytest.mark.parametrize("n_tokens,want_blocks", [(12, 3), (10, 2)],
                             ids=["full_blocks", "partial_tail"])
    def test_insert_match_indexes_full_blocks_only(self, n_tokens,
                                                   want_blocks):
        pool, pc = _mk()
        toks = list(range(100, 100 + n_tokens))
        blocks = pool.alloc(3)
        assert pc.insert(toks, blocks) == want_blocks
        m = pc.match(toks)
        assert (m.num_tokens, m.blocks, m.partial_len) == \
            (want_blocks * BS, blocks[:want_blocks], 0)
        pc.check_invariants()

    def test_mid_block_divergence_reports_cow_candidate(self):
        pool, pc = _mk()
        toks = list(range(100, 112))
        blocks = pool.alloc(3)
        pc.insert(toks, blocks)
        m = pc.match(toks[:9] + [7, 7])      # diverges 1 token into b2
        assert m.num_tokens == 8 and m.blocks == blocks[:2]
        assert m.partial_block == blocks[2] and m.partial_len == 1

    def test_block_aligned_split_and_sibling(self):
        pool, pc = _mk()
        a_toks = list(range(100, 112))
        a = pool.alloc(3)
        pc.insert(a_toks, a)
        # shares exactly 1 block, then diverges at the boundary
        b_toks = a_toks[:BS] + [7] * (2 * BS)
        b = pool.alloc(3)
        pc.insert(b_toks, b)
        pc.check_invariants()
        ma, mb = pc.match(a_toks), pc.match(b_toks)
        assert ma.blocks == a
        assert mb.blocks == a[:1] + b[1:]    # shared head, own tail
        # the duplicate head block b[0] was NOT indexed
        assert pc.resident_blocks == 5

    def test_insert_idempotent_no_double_retain(self):
        pool, pc = _mk()
        toks = list(range(8))
        blocks = pool.alloc(2)
        assert pc.insert(toks, blocks) == 2
        assert pc.insert(toks, blocks) == 0  # re-insert indexes nothing
        assert pool.refcount(blocks[0]) == 2  # alloc + ONE cache ref
        pool.free(blocks)
        assert pc.evict(10) == 2
        pool.check_leaks()

    def test_lru_eviction_order_and_refcount_guard(self):
        pool, pc = _mk(8)
        old = pool.alloc(2)
        pc.insert(list(range(0, 8)), old)
        pool.free(old)                       # cache-only now
        busy = pool.alloc(2)
        pc.insert(list(range(50, 58)), busy)  # busy: alloc ref still held
        fresh = pool.alloc(2)
        pc.insert(list(range(80, 88)), fresh)
        pool.free(fresh)
        pc.match(list(range(0, 8)))          # touch old -> fresh is LRU
        assert pc.evict(2) == 2
        assert pc.match(list(range(80, 88))).num_tokens == 0  # fresh gone
        assert pc.match(list(range(0, 8))).num_tokens == 8    # old kept
        # busy blocks are never reclaimed while a sequence holds them
        assert pc.evict(10) == 2             # evicts 'old' only
        assert pc.match(list(range(50, 58))).num_tokens == 8
        pool.free(busy)
        assert pc.evict(10) == 2
        assert pc.resident_blocks == 0 and pool.used_count == 0
        pool.check_leaks()

    def test_interior_nodes_evicted_after_children(self):
        pool, pc = _mk()
        head = list(range(100, 108))
        a = pool.alloc(4)
        pc.insert(head + [1] * 8, a)
        b = pool.alloc(4)
        pc.insert(head + [2] * 8, b)         # splits: head is interior
        pool.free(a)
        pool.free(b)
        # two leaf tails (2 blocks each) + the shared interior head (2)
        assert pc.evict(100) == 6
        assert pc.resident_blocks == 0 and pc.num_nodes == 0
        assert pool.used_count == 0
        pc.check_invariants()
        pool.check_leaks()

    @pytest.mark.parametrize("depth,block_size", [(4, BS), (1500, 1)],
                             ids=["shallow", "deep_chain"])
    def test_clear_releases_everything(self, depth, block_size):
        """clear() releases every cache reference; a long-context
        session's one-node-per-block chain is walked iteratively."""
        pool = BlockPool(depth + 100)
        pc = PrefixCache(pool, block_size)
        if block_size == BS:
            blocks = pool.alloc(depth)
            pc.insert(list(range(depth * BS)), blocks)
        else:
            toks, blocks = [], []
            for i in range(depth):
                toks.append(i % 7)
                blocks.extend(pool.alloc(1))
                pc.insert(toks, blocks)
        pool.free(blocks)
        assert pc.clear() == depth
        assert pc.resident_blocks == 0 and pc.num_nodes == 0
        assert pool.used_count == 0
        pool.check_leaks()
        pc.check_invariants()


# ---------------------------------------------------------------------------
# engine: the JAX engine's weights, module-scoped


def _port_pair(name):
    """((jax model, jax params), (port model, port params)) for a registry
    name, on the JAX init's weights."""
    jm, jp = jbuild_model(name)
    arrays = {n: np.asarray(a) for n, a in jp.items()}
    cpu = torch.device("cpu")
    if name == "gpt-tiny":
        tm = GPT(GPTConfig.tiny(dtype=torch.float32, use_flash=False))
        tp = gpt_params_from_numpy(arrays, tm.config, cpu)
    else:
        tm = Llama(LlamaConfig.tiny(dtype=torch.float32, use_flash=False))
        tp = llama_params_from_numpy(arrays, tm.config, cpu)
    return (jm, jp), (tm, tp)


@pytest.fixture(scope="module")
def gpt_tiny():
    return _port_pair("gpt-tiny")


@pytest.fixture(scope="module")
def llama_tiny():
    return _port_pair("llama-tiny")


ENGINE_KW = dict(block_size=4, num_blocks=32, max_batch=4,
                 max_blocks_per_seq=8, prefill_buckets=(8, 16),
                 max_prefill_tokens_per_step=32)


def mk_engine(pair, jax=False, **over):
    m, params = pair[0] if jax else pair[1]
    cls, cfg = (JLLMEngine, JEngineConfig) if jax else \
        (LLMEngine, EngineConfig)
    return cls(m, params, cfg(**{**ENGINE_KW, **over}))


def run_one(eng, prompt, n=8):
    st = eng.add_request(prompt, max_tokens=n)
    eng.run_until_idle(timeout=300)
    return st.tokens()


def record_first_logits(eng):
    """Wrap the port engine's prefill and extend programs: each call's
    last-token logits are appended to the returned list."""
    seen = []
    for attr in ("_prefill_fn", "_extend_fn"):
        def run(*args, _fn=getattr(eng, attr)):
            logits, cache = _fn(*args)
            seen.append(logits.clone())
            return logits, cache
        setattr(eng, attr, run)
    return seen


def assert_cache_sound(eng):
    """Every block not resident in the cache came back; sharing never
    overcounts; the pool and the tree are consistent."""
    assert eng.pool.used_count == eng.prefix_cache.resident_blocks
    assert eng.pool.used_count <= eng.pool.num_blocks
    eng.pool.check_leaks()
    eng.prefix_cache.check_invariants()


COMMON = [1, 5, 9, 2, 6, 4, 3, 7]            # 2 full blocks at BS=4
PROMPTS = [COMMON + [11, 13],                # cold
           COMMON + [12, 14],                # full-block + boundary hit
           COMMON[:5] + [99, 98],            # mid-block divergence (COW)
           COMMON + [11, 13]]                # deep replay incl. own tail


@pytest.mark.parametrize("model_name", ["gpt-tiny", "llama-tiny"])
def test_cached_prefill_token_identity_with_jax(model_name, gpt_tiny,
                                                llama_tiny):
    """The port's engine with the cache off and on emits the JAX engine's
    tokens with the cache off and on, for GPT and GQA llama, over
    full-block reuse, a block-boundary divergence, the mid-block COW path
    and a full replay; the two caches count the same hit and miss
    tokens. The first-token logits that the cache-on engine computes by
    suffix extend equal the cache-off engine's full prefill to 2e-5 (f32:
    summation order only), which a block left uncopied would break."""
    pair = gpt_tiny if model_name == "gpt-tiny" else llama_tiny
    runs, first = {}, {}
    for jax_side in (True, False):
        for cached in (False, True):
            eng = mk_engine(pair, jax=jax_side, prefix_cache=cached)
            if not jax_side:
                first[cached] = record_first_logits(eng)
            if cached and not jax_side:
                copies = []
                cow = eng._cow_fn
                eng._cow_fn = lambda c, s, d: (copies.append((s, d)),
                                               cow(c, s, d))[1]
            runs[jax_side, cached] = ([run_one(eng, p) for p in PROMPTS],
                                      eng)
    assert len(first[True]) == len(first[False]) == len(PROMPTS)
    for warm, cold in zip(first[True], first[False]):
        np.testing.assert_allclose(warm.numpy(), cold.numpy(), atol=2e-5,
                                   rtol=0)
    want = runs[True, False][0]
    assert runs[True, True][0] == want
    assert runs[False, False][0] == want
    assert runs[False, True][0] == want
    port = runs[False, True][1]
    cs = port.cache_stats()
    assert cs["prefix_hit_tokens"] > 0, cs
    assert 0.0 < cs["cache_hit_rate"] < 1.0, cs
    assert cs == runs[True, True][1].cache_stats()
    assert len(copies) >= 1, "the mid-block divergence never copied"
    assert_cache_sound(port)
    runs[False, False][1].pool.check_leaks()


def test_preemption_with_shared_prefix_equivalence(gpt_tiny):
    """Two sequences sharing a prefix under a pool too small for both:
    the victim preempts, requeues and re-prefills through its own
    still-cached prefix, with the tokens of the unconstrained run, and
    releases only its private tail."""
    pa, pb = COMMON + [11], COMMON + [12]
    want = {tuple(p): run_one(mk_engine(gpt_tiny, prefill_buckets=(8, 32)),
                              p, 12)
            for p in (pa, pb)}
    eng = mk_engine(gpt_tiny, prefix_cache=True, num_blocks=7,
                    prefill_buckets=(8, 32))
    sa = eng.add_request(pa, max_tokens=12)
    sb = eng.add_request(pb, max_tokens=12)
    eng.run_until_idle(timeout=300)
    assert eng._total_preemptions >= 1, "scenario must actually preempt"
    assert sa.tokens() == want[tuple(pa)]
    assert sb.tokens() == want[tuple(pb)]
    assert_cache_sound(eng)


def test_eviction_under_pool_pressure(gpt_tiny):
    """Requests with disjoint prefixes cycle through a pool smaller than
    their combined footprint: later admissions LRU-evict earlier
    residents instead of failing or preempting live work."""
    eng = mk_engine(gpt_tiny, prefix_cache=True, num_blocks=8)
    cold = mk_engine(gpt_tiny)
    for i in range(4):                       # each needs 3 blocks
        prompt = [10 * i + 1, 10 * i + 2, 3, 4, 5, 6]
        assert run_one(eng, prompt, 4) == run_one(cold, prompt, 4)
    assert eng.prefix_cache.evictions > 0, "pressure never evicted"
    assert eng.cache_stats()["prefix_evictions"] == \
        eng.prefix_cache.evictions
    assert_cache_sound(eng)


def test_kv_blocks_used_counts_shared_once(gpt_tiny):
    """stats()["kv_blocks_used"] tracks unique live blocks while the
    cache and running sequences share them."""
    eng = mk_engine(gpt_tiny, prefix_cache=True)
    run_one(eng, COMMON + [11], 4)
    st = eng.add_request(COMMON + [12], max_tokens=4)
    eng.step()                               # admitted: shares 2 blocks
    used = eng.stats()["kv_blocks_used"]
    assert used == eng.pool.used_count <= eng.pool.num_blocks
    assert eng.pool.refcount(eng._running[0].blocks[0]) >= 2
    eng.run_until_idle(timeout=300)
    st.tokens()
    stats = eng.stats()
    assert stats["kv_blocks_used"] == eng.pool.used_count \
        == stats["prefix_blocks_resident"]
    assert_cache_sound(eng)


def test_concurrent_hit_miss_streams_no_leakage(gpt_tiny):
    """8 client threads — half sharing one prefix, half unique — stream
    concurrently against one cached engine on its scheduler thread;
    every client sees exactly its cache-off completion, and the pool
    drains to cache-resident blocks only."""
    prompts = [(COMMON + [20 + i]) if i % 2 == 0
               else [30 + i, 40 + i, 7, 8, 9]
               for i in range(8)]
    cold = mk_engine(gpt_tiny, max_batch=8, num_blocks=64)
    want = [run_one(cold, p, 10) for p in prompts]

    eng = mk_engine(gpt_tiny, prefix_cache=True, max_batch=4,
                    num_blocks=64)           # max_batch 4 forces queuing
    eng.start()
    try:
        got = [None] * len(prompts)

        def client(i):
            st = eng.add_request(prompts[i], max_tokens=10)
            got[i] = [tok for tok in st]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert got == want
    finally:
        eng.stop()
    assert eng._thread is None
    assert eng.cache_stats()["prefix_hit_tokens"] > 0
    assert_cache_sound(eng)
