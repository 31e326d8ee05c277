"""The port's disaggregated prefill/decode (ray_tpu_torch.serve.llm.disagg)
and ``LLMEngine.add_prefilled``, on the CPU.

The in-process cases run gpt-tiny (f32, mha_reference attention) on the
JAX init's weights carried over through numpy, and again with the
layers' matmul weights times 4: at the init's scale the residual stream
is the token embedding and every prompt's last token repeats, so the
streams would not show the KV. The port's PrefillStage gives the JAX
stage's first token and KV at both scales, and the port engine fed the
JAX stage's KV decodes the JAX engine's tokens. The DisaggLLM cases run
the two stages as actors of the port's own runtime (one per module) and
mirror tests/test_llm_engine.py:312-341 and, for the wire codecs,
tests/test_collective_codec.py:478-498, against the in-process port
engine.
"""
import functools

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import GPT, GPTConfig, gpt_params_from_numpy
from ray_tpu_torch.serve.llm import (DecodeStage, DisaggLLM, EngineConfig,
                                     LLMEngine, PrefillStage, build_model)

BS = 4
BUCKETS = (8, 16)
ENGINE = dict(block_size=BS, num_blocks=32, max_batch=4,
              max_blocks_per_seq=8, prefill_buckets=BUCKETS)
# 3 tokens (a partial block), 4 (exactly one), 9 and 13 (several)
PROMPTS = [[1, 5, 9], [3, 1, 4, 1], [7, 2, 200, 31, 9, 9, 4, 100, 17],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23]]
STEPS = 10
SCALED = ("w_qkv", "w_proj", "w_fc", "w_out")


@functools.lru_cache(maxsize=None)
def _jax_tiny(scale):
    """(JAX model, JAX params, the same params as port tensors), the
    layers' matmul weights times ``scale``."""
    import jax.numpy as jnp

    from ray_tpu.serve.llm import build_model as jbuild_model

    jm, jp = jbuild_model("gpt-tiny")
    arrays = {n: np.asarray(a) * (scale if n in SCALED else 1)
              for n, a in jp.items()}
    cfg = GPTConfig.tiny(dtype=torch.float32, use_flash=False)
    return (jm, {n: jnp.asarray(a) for n, a in arrays.items()},
            gpt_params_from_numpy(arrays, cfg, torch.device("cpu")))


@functools.lru_cache(maxsize=None)
def _jax_shipments(scale):
    """The JAX PrefillStage's wire records for PROMPTS."""
    from ray_tpu.serve.llm.disagg import PrefillStage as JPrefillStage

    stage = JPrefillStage("gpt-tiny", block_size=BS, buckets=BUCKETS)
    stage.params = _jax_tiny(scale)[1]
    return [stage.prefill({"tokens": p, "max_tokens": STEPS})
            for p in PROMPTS]


@pytest.fixture(scope="module")
def jax_tiny():
    return _jax_tiny(4)


@pytest.fixture(scope="module")
def jax_shipments():
    return _jax_shipments(4)


def _jax_engine_tokens(jax_tiny, shipments):
    from ray_tpu.serve.llm import EngineConfig as JEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JLLMEngine

    jm, jp, _ = jax_tiny
    eng = JLLMEngine(jm, jp, JEngineConfig(**ENGINE))
    streams = [eng.add_prefilled(s["prompt"], s["kv"], s["first_token"],
                                 max_tokens=STEPS) for s in shipments]
    eng.run_until_idle(timeout=300)
    return [st.tokens() for st in streams]


def _port_engine(params):
    model = GPT(GPTConfig.tiny(dtype=torch.float32, use_flash=False))
    return LLMEngine(model, params, EngineConfig(**ENGINE))


# ---------------------------------------------------------------------------
# in process, against the JAX package


@pytest.mark.parametrize("scale", [1, 4])
def test_prefill_stage_matches_jax(scale):
    stage = PrefillStage("gpt-tiny", block_size=BS, buckets=BUCKETS,
                         device="cpu")
    stage.params = _jax_tiny(scale)[2]
    for prompt, want in zip(PROMPTS, _jax_shipments(scale)):
        got = stage.prefill({"tokens": prompt, "max_tokens": STEPS})
        assert got["prompt"] == want["prompt"]
        assert got["first_token"] == want["first_token"], prompt
        assert (got["max_tokens"], got["eos_id"]) == (STEPS, "__default__")
        for name in ("k", "v"):
            kv = got["kv"][name]
            assert isinstance(kv, torch.Tensor) and kv.device.type == "cpu"
            assert kv.dtype == torch.float32
            ref = np.asarray(want["kv"][name])
            assert kv.shape == ref.shape     # [L, nb, BS, KH, hd]
            np.testing.assert_allclose(kv.numpy(), ref, rtol=0, atol=2e-5)


def test_add_prefilled_matches_jax_engine(jax_tiny, jax_shipments):
    want = _jax_engine_tokens(jax_tiny, jax_shipments)
    assert len({tuple(w) for w in want}) == len(want)  # distinct streams
    eng = _port_engine(jax_tiny[2])
    streams = [eng.add_prefilled(s["prompt"], s["kv"], s["first_token"],
                                 max_tokens=STEPS) for s in jax_shipments]
    eng.run_until_idle(timeout=300)
    got = [st.tokens() for st in streams]
    assert got == want
    for st, s in zip(streams, jax_shipments):
        assert st.finish_reason == "length"
        assert got[streams.index(st)][0] == s["first_token"]
    # the shipped first token is emitted once: STEPS tokens in all, of
    # which STEPS - 1 came from decode steps
    assert all(len(g) == STEPS for g in got)
    assert eng.stats()["total_generated"] == len(PROMPTS) * (STEPS - 1)
    eng.pool.check_leaks()
    assert eng.pool.used_count == 0


def test_add_prefilled_reversed_blocks_changes_the_stream(jax_tiny,
                                                          jax_shipments):
    """Planted control: the 13-token prompt's blocks in reverse order
    must not decode the JAX engine's tokens."""
    want = _jax_engine_tokens(jax_tiny, jax_shipments[-1:])[0]
    s = jax_shipments[-1]
    flipped = {n: np.ascontiguousarray(np.asarray(a)[:, ::-1])
               for n, a in s["kv"].items()}
    eng = _port_engine(jax_tiny[2])
    st = eng.add_prefilled(s["prompt"], flipped, s["first_token"],
                           max_tokens=STEPS)
    eng.run_until_idle(timeout=300)
    assert st.tokens() != want


def test_add_prefilled_checks_and_waits(jax_tiny, jax_shipments):
    eng = _port_engine(jax_tiny[2])
    s = jax_shipments[0]
    short = {n: np.asarray(a)[:, :0] for n, a in s["kv"].items()}
    with pytest.raises(ValueError, match="blocks"):
        eng.add_prefilled(s["prompt"], short, s["first_token"])
    # every batch slot taken by sequences nobody steps: no free slot
    held = [eng.add_prefilled(s["prompt"], s["kv"], s["first_token"],
                              max_tokens=STEPS)
            for _ in range(ENGINE["max_batch"])]
    with pytest.raises(TimeoutError, match="no capacity"):
        eng.add_prefilled(s["prompt"], s["kv"], s["first_token"],
                          timeout=0.05)
    eng.run_until_idle(timeout=300)
    assert [len(h.tokens()) for h in held] == [STEPS] * len(held)
    eng.pool.check_leaks()


# ---------------------------------------------------------------------------
# two actors and a compiled graph, on the port's runtime


@pytest.fixture(scope="module")
def rt():
    runtime = ray_tpu_torch.init(num_cpus=4)
    yield runtime
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def local_tokens():
    """The in-process port engine's streams on build_model's weights."""
    m, params = build_model("gpt-tiny", device="cpu")
    eng = LLMEngine(m, params, EngineConfig(**ENGINE))
    streams = [eng.add_request(p, max_tokens=STEPS) for p in PROMPTS]
    eng.run_until_idle(timeout=300)
    return [st.tokens() for st in streams]


def _disagg(codec=None):
    return DisaggLLM("gpt-tiny", block_size=BS,
                     engine_config={k: v for k, v in ENGINE.items()
                                    if k != "block_size"},
                     codec=codec, device="cpu")


def _sent(llm):
    return llm.placement()["prefill"]["channel_bytes_sent"]


def test_disagg_matches_in_process_engine(rt, local_tokens):
    """The raw run's streams, and the KV envelopes the prefill stage
    writes: each at least the f32 KV it carries, and under int8 (the
    graph compiled again on the same stages) about a quarter of it, with
    the same first token."""
    cfg = GPTConfig.tiny(dtype=torch.float32, use_flash=False)
    kv_bytes = [cfg.n_layer * 2 * -(-len(p) // BS) * BS * cfg.d_model * 4
                for p in PROMPTS]
    llm = _disagg()
    try:
        where = llm.placement()
        assert where["prefill"]["pid"] != where["decode"]["pid"]
        assert {w["device"] for w in where.values()} == {"cpu"}
        sent = [_sent(llm)]
        for prompt, want in zip(PROMPTS, local_tokens):
            out = llm.generate(prompt, max_tokens=STEPS, timeout=120)
            assert out["tokens"] == want, prompt
            assert out["finish_reason"] == "length"
            sent.append(_sent(llm))
        envelopes = np.diff(sent)
        assert all(kv <= e < kv + 4096
                   for kv, e in zip(kv_bytes, envelopes)), envelopes
        stats = llm.stats()
        assert stats["kv_blocks_used"] == 0        # blocks returned
        assert stats["total_generated"] == len(PROMPTS) * (STEPS - 1)

        llm.compile("int8")
        out = llm.generate(PROMPTS[-1], max_tokens=STEPS, timeout=120)
        assert out["tokens"][0] == local_tokens[-1][0]
        assert _sent(llm) - sent[-1] < kv_bytes[-1] / 3
    finally:
        llm.shutdown()


@pytest.mark.parametrize("codec", ["int8", "e4m3"])
def test_disagg_kv_codec(rt, local_tokens, codec):
    """With the KV block-quantized on the wire, the first token (taken
    before the wire) is the raw run's and the stream finishes alike."""
    llm = _disagg(codec)
    try:
        for prompt, want in zip(PROMPTS, local_tokens):
            out = llm.generate(prompt, max_tokens=STEPS, timeout=120)
            assert out["tokens"][0] == want[0]
            assert out["tokens"] == want, prompt
            assert out["finish_reason"] == "length"
        assert llm.stats()["kv_blocks_used"] == 0
    finally:
        llm.shutdown()


def test_decode_stage_in_process():
    """DecodeStage.ingest on a PrefillStage record, without actors."""
    pre = PrefillStage("gpt-tiny", block_size=BS, buckets=BUCKETS,
                       device="cpu")
    dec = DecodeStage("gpt-tiny", dict(ENGINE), device="cpu")
    try:
        out = dec.ingest(pre.prefill({"tokens": PROMPTS[2],
                                      "max_tokens": 3}))
        assert len(out["tokens"]) == 3 and out["finish_reason"] == "length"
        assert dec.placement()["device"] == "cpu"
    finally:
        dec.engine.stop()
