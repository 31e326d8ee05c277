"""The port's serving engine (ray_tpu_torch.serve.llm) on the CPU.

The block pool cases mirror tests/test_llm_engine.py:25-67. The engine
runs llama-tiny (f32, mha_reference attention) with the JAX init's
weights carried over through numpy, so the port's greedy tokens can be
held to the JAX engine's token for token, and to the port's own dense
forward, as tests/test_llm_engine.py:278-305 does for the JAX engine.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from ray_tpu.serve.llm import EngineConfig as JEngineConfig
from ray_tpu.serve.llm import LLMEngine as JLLMEngine
from ray_tpu.serve.llm import build_model as jbuild_model
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_numpy
from ray_tpu_torch.serve.llm import (BlockPool, EngineConfig, LLMEngine,
                                     LLMServer, blocks_for_tokens,
                                     build_model)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and it
    leaves the machine's cores to the test files running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# block pool — pure accounting


class TestBlockPool:
    def test_alloc_free_roundtrip(self):
        pool = BlockPool(8)
        got = pool.alloc(3)
        assert len(got) == 3 and len(set(got)) == 3
        assert pool.used_count == 3 and pool.free_count == 5
        pool.free(got)
        assert pool.used_count == 0 and pool.free_count == 8
        pool.check_leaks()

    def test_alloc_is_all_or_nothing(self):
        pool = BlockPool(4)
        assert pool.alloc(5) is None
        assert pool.used_count == 0 and pool.free_count == 4
        a = pool.alloc(3)
        assert pool.alloc(2) is None
        assert pool.free_count == 1
        pool.free(a)
        pool.check_leaks()

    def test_alloc_zero_and_negative(self):
        pool = BlockPool(2)
        assert pool.alloc(0) == []
        with pytest.raises(ValueError):
            pool.alloc(-1)

    def test_free_validates(self):
        pool = BlockPool(4)
        with pytest.raises(ValueError):
            pool.free([99])
        got = pool.alloc(2)
        pool.free(got)
        with pytest.raises(ValueError):
            pool.free(got)

    def test_leak_detection(self):
        pool = BlockPool(4)
        # intentional leak: this test exists to prove check_leaks sees it
        pool.alloc(2)  # graftcheck: disable=GC030
        pool._used -= 1                       # simulate lost accounting
        with pytest.raises(AssertionError, match="leak"):
            pool.check_leaks()

    @pytest.mark.parametrize("tokens,want", [(0, 0), (1, 1), (16, 1),
                                             (17, 2), (33, 3)])
    def test_blocks_for_tokens(self, tokens, want):
        assert blocks_for_tokens(tokens, 16) == want


# ---------------------------------------------------------------------------
# engine


@pytest.fixture(scope="module")
def tiny():
    """((jax model, jax params), (port model, port params)): llama-tiny
    on the same weights."""
    jm, jp = jbuild_model("llama-tiny")
    tm = Llama(LlamaConfig.tiny(dtype=torch.float32, use_flash=False))
    tp = llama_params_from_numpy({n: np.asarray(a) for n, a in jp.items()},
                                 tm.config, torch.device("cpu"))
    return (jm, jp), (tm, tp)


ENGINE_KW = dict(block_size=4, num_blocks=32, max_batch=4,
                 max_blocks_per_seq=8, prefill_buckets=(8, 16),
                 max_prefill_tokens_per_step=32)


def mk_engine(tiny, **over) -> LLMEngine:
    m, params = tiny[1]
    return LLMEngine(m, params, EngineConfig(**{**ENGINE_KW, **over}))


def reference_tokens(tiny, prompt, max_tokens, **over):
    """The unconstrained (no-preemption, solo) greedy completion."""
    eng = mk_engine(tiny, **over)
    st = eng.add_request(prompt, max_tokens=max_tokens)
    eng.run_until_idle(timeout=120)
    eng.pool.check_leaks()
    return st.tokens()


@pytest.mark.parametrize("over,prompts", [
    ({}, ([1, 5, 9], [2, 6, 4, 8, 3], [7] * 12, [300, 2, 511, 64, 9, 1, 1])),
    # 9 blocks of 4 cannot hold three 15-token contexts: sequences are
    # preempted, requeued and re-prefilled (contexts stay within the
    # 16-token bucket)
    ({"num_blocks": 9, "max_batch": 3},
     ([1, 5, 9], [2, 6, 4, 8, 3], [7, 7, 7], [300, 2, 511, 64])),
], ids=["batched", "preempting"])
def test_greedy_tokens_identical_to_jax_engine(tiny, over, prompts):
    """Same requests, same scheduler config, same weights: the port's
    engine emits exactly the JAX engine's tokens."""
    (jm, jp), (tm, tp) = tiny
    cfg = {**ENGINE_KW, **over}
    jeng = JLLMEngine(jm, jp, JEngineConfig(**cfg))
    teng = LLMEngine(tm, tp, EngineConfig(**cfg))
    streams = []
    for eng in (jeng, teng):
        streams.append([eng.add_request(p, max_tokens=10) for p in prompts])
        eng.run_until_idle(timeout=120)
        eng.pool.check_leaks()
    want = [s.tokens() for s in streams[0]]
    got = [s.tokens() for s in streams[1]]
    assert got == want
    assert [s.finish_reason for s in streams[1]] == \
        [s.finish_reason for s in streams[0]]
    assert teng._total_preemptions == jeng._total_preemptions
    if over:
        assert teng._total_preemptions >= 1, "scenario must preempt"


def test_paged_path_matches_dense_forward(tiny):
    """The paged prefill+decode pipeline reproduces greedy decode under
    the model's dense forward (full-context recompute each token)."""
    m, params = tiny[1]
    prompt, steps = [1, 5, 9], 6
    ctx, dense = list(prompt), []
    for _ in range(steps):
        logits = m.apply(params, torch.tensor([ctx]))
        dense.append(int(logits[0, -1].argmax()))
        ctx.append(dense[-1])
    eng = mk_engine(tiny, num_blocks=16, max_batch=2, max_blocks_per_seq=4,
                    prefill_buckets=(8,))
    st = eng.add_request(prompt, max_tokens=steps)
    eng.run_until_idle(timeout=120)
    assert st.tokens() == dense
    eng.pool.check_leaks()


def test_preemption_requeue_equivalence(tiny):
    """Under a pool too small for both sequences to grow, the victim is
    preempted, requeued, re-prefilled — and still produces exactly the
    unpreempted run's tokens."""
    want = {p: reference_tokens(tiny, list(p), 12)
            for p in ((1, 5, 9), (2, 6, 4))}
    eng = mk_engine(tiny, num_blocks=7)
    sa = eng.add_request([1, 5, 9], max_tokens=12)
    sb = eng.add_request([2, 6, 4], max_tokens=12)
    eng.run_until_idle(timeout=120)
    assert eng._total_preemptions >= 1, "scenario must actually preempt"
    assert sa.tokens() == want[(1, 5, 9)]
    assert sb.tokens() == want[(2, 6, 4)]
    assert sa.finish_reason == sb.finish_reason == "length"
    assert eng.pool.used_count == 0
    eng.pool.check_leaks()


def test_eos_retirement(tiny):
    ref = reference_tokens(tiny, [1, 5, 9], 8)
    k = next((i for i in range(len(ref)) if ref[i] not in ref[:i]), 0)
    eng = mk_engine(tiny)
    st = eng.add_request([1, 5, 9], max_tokens=8, eos_id=ref[k])
    eng.run_until_idle(timeout=120)
    assert st.tokens() == ref[:k + 1]         # EOS token itself is emitted
    assert st.finish_reason == "eos"
    assert eng.pool.used_count == 0


def test_model_max_seq_caps_context():
    """Decode retires at the model's max_seq even when the block table
    has room for more."""
    m = Llama(LlamaConfig.tiny(max_seq=12, dtype=torch.float32,
                               use_flash=False))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    eng = LLMEngine(m, m.init(gen), EngineConfig(
        block_size=4, num_blocks=16, max_batch=2, max_blocks_per_seq=8,
        prefill_buckets=(8,)))
    assert eng.max_seq_len == 12
    st = eng.add_request([1, 5, 9], max_tokens=30)
    eng.run_until_idle(timeout=120)
    # prompt 3 + prefill emit 1 + decode writes at positions 3..11
    assert len(st.tokens()) == 10 and st.finish_reason == "length"
    eng.pool.check_leaks()


@pytest.mark.parametrize("case", ["oversize", "empty", "unsatisfiable",
                                  "sole_runner_exhausted"])
def test_requests_that_cannot_run_fail_loud(tiny, case):
    if case in ("oversize", "empty"):
        eng = mk_engine(tiny)
        with pytest.raises(ValueError, match="exceeds engine capacity"
                           if case == "oversize" else "empty prompt"):
            eng.add_request(list(range(1, 40)) if case == "oversize" else [],
                            max_tokens=2)
        return
    if case == "unsatisfiable":       # fits the bucket, not the pool
        eng = mk_engine(tiny, num_blocks=2)
        st = eng.add_request(list(range(1, 16)), max_tokens=2)
        match = "pool holds"
    else:                             # one sequence the pool can't grow
        eng = mk_engine(tiny, num_blocks=2, prefill_buckets=(8,))
        st = eng.add_request([1, 5, 9, 2, 6, 4, 3, 7], max_tokens=16)
        match = "exhausted"
    eng.run_until_idle(timeout=120)
    with pytest.raises(RuntimeError, match=match):
        st.tokens()
    assert st.finish_reason == "error"
    eng.pool.check_leaks()


@pytest.mark.parametrize("over", [{"tp": 2}, {"prefix_cache": True}])
def test_unported_engine_options_raise(tiny, over):
    with pytest.raises(NotImplementedError):
        mk_engine(tiny, **over)


# ---------------------------------------------------------------------------
# entry points


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("llama-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMServer("llama-tiny")
    m, params = build_model("llama-tiny", device="cpu")
    assert params["wte"].device.type == "cpu"
    with pytest.raises(ValueError, match="unknown model"):
        build_model("gpt2-small", device="cpu")    # not ported yet


def test_server_answers_concurrent_clients_in_order():
    """LLMServer on the CPU under more client threads than cores and a
    short interpreter switch interval: each client gets its own full
    completion (the solo greedy one), the streaming form yields the same
    tokens, and every block comes back."""
    server = LLMServer("llama-tiny", engine_config=dict(ENGINE_KW),
                       device="cpu")
    prompts = [[1 + i, 5, 9] for i in range(12)]
    got = [None] * len(prompts)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(i):
            got[i] = server({"tokens": prompts[i], "max_tokens": 6})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        streamed = list(server({"tokens": prompts[0], "max_tokens": 6,
                                "stream": True}))
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
    assert all(r["finish_reason"] == "length" and len(r["tokens"]) == 6
               for r in got)
    assert streamed == got[0]["tokens"]
    eng = server.engine
    solo = LLMEngine(eng.model, eng.params, EngineConfig(**ENGINE_KW))
    for p, r in zip(prompts, got):
        st = solo.add_request(p, max_tokens=6)
        solo.run_until_idle(timeout=120)
        assert st.tokens() == r["tokens"]
    assert eng.pool.used_count == 0
    eng.pool.check_leaks()
    # each request: one token from its prefill, five from decode steps
    assert eng.stats()["total_generated"] == 5 * (len(prompts) + 1)
