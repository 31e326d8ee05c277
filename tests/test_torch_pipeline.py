"""The port's pipeline-parallel training (ray_tpu_torch.train.pipeline_cgraph,
ray_tpu_torch.parallel.pipeline and GPT's stage slicing) on the CPU.

Held against the JAX package where the two compute the same thing:
- the 1F1B and interleaved schedules equal the JAX package's lists over
  the reference's (P, M, V) grid (tests/test_pipeline_cgraph.py:65-73);
- each GPT chunk's output and the last chunk's loss equal the JAX chunk
  functions' at 2e-5, and the chunk gradients at 2e-4 of each
  parameter's largest |gradient| (the f32 and gradient tolerances of
  tests/test_ops.py), on the JAX init's weights through numpy;
- the port's run_reference_1f1b under torch.optim.Adam against the JAX
  package's under optax.adam over 3 steps: losses within 1e-4 relative;
  parameters within 2 * lr * steps, with at most 0.1% of a parameter's
  entries beyond lr / 100 (the AdamW rule of tests/test_torch_gpt.py).

And against itself, as tests/test_pipeline_cgraph.py holds the JAX
engine: the engine's trajectory equals the single-process reference bit
for bit, interleaved equals plain, remat equals saved residuals, and the
fault, lifecycle and checkpoint contracts. The ZeRO dp update is in
tests/test_torch_zero.py.

The JAX package is imported only inside the tests that compare with it;
the chunk functions are closures, so they travel to the stage workers by
value and no worker imports this module.
"""
import functools
import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch.models import GPT, GPTConfig, gpt_params_from_numpy
from ray_tpu_torch.models.gpt import gpt_pipeline_stages
from ray_tpu_torch.parallel.zero import tree_flatten, tree_unflatten
from ray_tpu_torch.train import CompiledPipelineEngine, run_reference_1f1b

CPU = "cpu"
SMALL_CHANNEL = 1 << 18


@pytest.fixture(scope="module")
def rt():
    # one intra-op thread here and in every worker the runtime starts
    # (they inherit OMP_NUM_THREADS): the shapes are tiny, and the cores
    # go to the test files running beside this one
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        runtime = ray_tpu_torch.init(num_cpus=4)
        yield runtime
        ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


def _mlp_chunks(num_chunks, width=8, seed=0):
    """num_chunks tanh-MLP chunk fns + params (closures, sent to the stage
    actors by value). The last chunk computes an MSE loss."""
    rng = np.random.RandomState(seed)

    def mk_mid():
        def fn(p, x):
            return torch.tanh(x @ p["w"] + p["b"])
        return fn

    def mk_last():
        def fn(p, x, targets):
            return ((x @ p["w"] + p["b"] - targets) ** 2).mean()
        return fn

    fns = [mk_mid() for _ in range(num_chunks - 1)] + [mk_last()]
    params = [{"w": torch.from_numpy(
                   (rng.randn(width, width) * 0.3).astype(np.float32)),
               "b": torch.zeros(width)} for _ in range(num_chunks)]
    return fns, params


def _mlp_batches(M, width=8, mb_size=2, seed=7):
    rng = np.random.RandomState(seed)
    xs = torch.from_numpy(rng.randn(M * mb_size, width).astype(np.float32))
    ys = torch.from_numpy(rng.randn(M * mb_size, width).astype(np.float32))
    return list(xs.split(mb_size)), list(ys.split(mb_size))


def _adam(lr):
    return functools.partial(torch.optim.Adam, lr=lr)


def _sgd(lr):
    return functools.partial(torch.optim.SGD, lr=lr)


def _assert_trees_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y), (x - y).abs().max()


def _num_channels(rt):
    return rt.nodes[rt.head_node_id].store.stats()["num_channels"]


# ---------------------------------------------------------------------------
# schedules: the JAX package's lists exactly


@pytest.mark.parametrize("P,M,V", [(2, 4, 1), (3, 8, 1), (4, 4, 1),
                                   (2, 4, 2), (2, 8, 2), (3, 6, 2),
                                   (2, 4, 3), (4, 8, 2)])
def test_schedules_equal_jax(P, M, V):
    from ray_tpu.parallel import pipeline as jpipe

    from ray_tpu_torch.parallel.pipeline import (schedule_1f1b,
                                                 schedule_interleaved_1f1b)

    assert schedule_interleaved_1f1b(P, M, V) == \
        jpipe.schedule_interleaved_1f1b(P, M, V)
    if V == 1:
        assert schedule_1f1b(P, M) == jpipe.schedule_1f1b(P, M)


# ---------------------------------------------------------------------------
# GPT chunks against the JAX chunk functions


@functools.lru_cache(maxsize=None)
def _gpt_pair(n_layer=2):
    """(jax model, jax params, port model, port params) on the same
    weights, GPTConfig.tiny in f32 without flash. Cached: no test
    changes them (the engines and the reference copy what they train)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import GPT as JGPT
    from ray_tpu.models import GPTConfig as JConfig

    jm = JGPT(JConfig.tiny(dtype=jnp.float32, use_flash=False, remat=False,
                           n_layer=n_layer))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = GPT(GPTConfig.tiny(dtype=torch.float32, use_flash=False,
                            n_layer=n_layer, remat=False))
    tp = gpt_params_from_numpy({n: np.asarray(a) for n, a in jp.items()},
                               tm.config, torch.device(CPU))
    return jm, jp, tm, tp


def _gpt_tokens(cfg, batch=8, seq=16, seed=1):
    tokens = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    return tokens, np.roll(tokens, -1, axis=1)


def test_gpt_stage_split_layout():
    _, _, tm, tp = _gpt_pair(n_layer=4)
    fns, sp, tied = gpt_pipeline_stages(tm, tp, 4)
    assert len(fns) == 4 and tied == [(0, "wte", 3, "head")]
    assert set(sp[0]) == {"layers", "wte", "wpe"}
    assert set(sp[1]) == set(sp[2]) == {"layers"}
    assert set(sp[3]) == {"layers", "lnf_g", "lnf_b", "head"}
    for i, chunk in enumerate(sp):
        for n, t in chunk["layers"].items():
            assert torch.equal(t, tp[n][i:i + 1])
    assert torch.equal(sp[3]["head"], tp["wte"])
    assert tm.pipeline_stages(tp, 4)[2] == tied
    with pytest.raises(ValueError, match="divisible"):
        gpt_pipeline_stages(tm, tp, 3)
    with pytest.raises(ValueError, match=">= 2"):
        gpt_pipeline_stages(tm, tp, 1)


def test_gpt_chunks_match_jax():
    """Each chunk's output (the last chunk's loss) and its gradients with
    respect to its params and its input, fed the JAX chunk chain's own
    activations, against jax.vjp of the JAX chunk: four chunks, so the
    first, a middle and the last chunk function are all held."""
    num_chunks = 4
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.gpt import gpt_pipeline_stages as jstages

    jm, jp, tm, tp = _gpt_pair(n_layer=4)
    tokens, targets = _gpt_tokens(tm.config, batch=2)
    jfns, jsp, _ = jstages(jm, jp, num_chunks)
    tfns, tsp, _ = gpt_pipeline_stages(tm, tp, num_chunks)
    rng = np.random.RandomState(3)
    x_j, x_t = jnp.asarray(tokens), torch.from_numpy(tokens)
    for g in range(num_chunks):
        last = g == num_chunks - 1
        if last:
            out_j, pull = jax.vjp(
                lambda p, x: jfns[g](p, x, jnp.asarray(targets)), jsp[g], x_j)
            cot = np.float32(1.0)
        else:
            out_j, pull = jax.vjp(jfns[g], jsp[g], x_j) if g else \
                jax.vjp(lambda p: jfns[g](p, x_j), jsp[g])
            cot = rng.randn(*out_j.shape).astype(np.float32)
        grads_j = pull(jnp.asarray(cot))
        leaves, treedef = tree_flatten(tsp[g])
        leaves = [t.clone().requires_grad_() for t in leaves]
        pp = tree_unflatten(treedef, leaves)
        xx = x_t.clone().requires_grad_() if g else x_t
        out_t = tfns[g](pp, xx, torch.from_numpy(targets)) if last \
            else tfns[g](pp, xx)
        np.testing.assert_allclose(out_t.detach().numpy(),
                                   np.asarray(out_j), atol=2e-5, rtol=2e-5)
        wrt = leaves + ([xx] if g else [])
        got = torch.autograd.grad(out_t, wrt, torch.from_numpy(
            np.asarray(cot)))
        want = jax.tree.leaves(grads_j[0]) + \
            ([np.asarray(grads_j[1])] if g else [])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            scale = max(float(np.abs(b).max()), 1e-12)
            np.testing.assert_allclose(a.numpy(), b, atol=2e-4 * scale,
                                       rtol=2e-4)
        # the next chunk runs on the JAX chain's activation
        x_j = out_j
        x_t = torch.from_numpy(np.array(out_j))


def test_reference_1f1b_matches_jax_adam():
    """The port's single-process 1F1B under torch.optim.Adam against the
    JAX package's under optax.adam: 3 steps of GPT tiny split in 2
    chunks with the tied head, M=4 microbatches of 2."""
    import jax.numpy as jnp
    import optax

    from ray_tpu.models.gpt import gpt_pipeline_stages as jstages
    from ray_tpu.train.pipeline_cgraph import \
        run_reference_1f1b as jreference

    lr, steps = 1e-3, 3
    jm, jp, tm, tp = _gpt_pair()
    tokens, targets = _gpt_tokens(tm.config)
    jfns, jsp, jtied = jstages(jm, jp, 2)
    tfns, tsp, ttied = gpt_pipeline_stages(tm, tp, 2)
    jsteps = [([jnp.asarray(tokens[i:i + 2]) for i in range(0, 8, 2)],
               [jnp.asarray(targets[i:i + 2]) for i in range(0, 8, 2)])]
    tsteps = [([torch.from_numpy(tokens[i:i + 2]) for i in range(0, 8, 2)],
               [torch.from_numpy(targets[i:i + 2])
                for i in range(0, 8, 2)])]
    jl, jparams = jreference(jfns, jsp, optax.adam(lr), jsteps * steps,
                             tied=jtied)
    tl, tparams = run_reference_1f1b(tfns, tsp, _adam(lr), tsteps * steps,
                                     tied=ttied, device=CPU)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    import jax

    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            tree_flatten(tparams)[0]):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b, a, atol=2 * lr * steps, err_msg=path)
        beyond = np.mean(np.abs(b - a) > lr / 100)
        assert beyond <= 1e-3, (path, beyond)


def test_reference_defaults_to_the_card():
    fns, params = _mlp_chunks(2)
    mbs, tgts = _mlp_batches(2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_reference_1f1b(fns, params, _sgd(1e-2), [(mbs, tgts)])


# ---------------------------------------------------------------------------
# numeric equivalence of the engine


def test_mlp_matches_reference_bit_for_bit(rt):
    """3-step loss trajectory AND final params equal the single-process
    reference exactly — the channels move bytes, the stages run the same
    programs in the same order. The same engine then shows the lifecycle
    contract: 7 channel segments while it lives, input validation, the
    step histogram, profile() and placement(), and a shutdown that is
    idempotent, releases every segment and closes the engine."""
    from ray_tpu_torch.util import metrics

    before = _num_channels(rt)
    fns, params = _mlp_chunks(2)
    mbs, tgts = _mlp_batches(4)
    tx = _adam(1e-2)
    eng = CompiledPipelineEngine(fns, params, tx, num_microbatches=4,
                                 channel_bytes=SMALL_CHANNEL, device=CPU)
    try:
        # in + targets + loss + fwd + bwd + 2 reports = 7 segments
        assert _num_channels(rt) - before == 7
        with pytest.raises(ValueError, match="num_microbatches"):
            eng.step(mbs[:2], tgts[:2])
        losses = [eng.step(mbs, tgts) for _ in range(3)]
        new_params = eng.get_params()
        assert eng.last_reports and all(
            r["in_flight_residuals"] == 0 for r in eng.last_reports)
        report = eng.profile(steps=2, tokens_per_step=8)
        where = eng.placement()
    finally:
        eng.shutdown()
    eng.shutdown()  # idempotent
    assert _num_channels(rt) == before
    with pytest.raises(exceptions.CompiledGraphClosedError):
        eng.step(mbs, tgts)
    ref_losses, ref_params = run_reference_1f1b(
        fns, params, tx, [(mbs, tgts)] * 3, device=CPU)
    assert losses == ref_losses
    assert losses[-1] < losses[0]
    _assert_trees_equal(new_params, ref_params)
    assert "ray_tpu_pipeline_step_seconds" in metrics._render()
    assert report.steps == 2 and len(report.step_ms) == 2
    assert [st["stage"] for st in report.stages] == ["0.0", "0.1"]
    assert all(st["exec_ms"] > 0 for st in report.stages)
    assert {op["method"] for st in report.stages for op in st["ops"]} >= {
        "forward", "backward", "update"}
    assert [w["device"] for w in where[0]] == [CPU, CPU]
    assert all(w["param_bytes"] == 8 * 8 * 4 + 8 * 4 for w in where[0])


def test_gpt_matches_reference_bit_for_bit(rt):
    """GPT tiny in two stage actors with the tied head: the engine's
    3-step trajectory and final params equal run_reference_1f1b exactly,
    the step-0 loss matches the single-program GPT.loss, and a reference
    without the tied exchange does not match (the exchange is real)."""
    _, _, tm, tp = _gpt_pair()
    tokens, targets = (torch.from_numpy(a) for a in _gpt_tokens(tm.config))
    mbs, tgts = list(tokens.split(2)), list(targets.split(2))
    fns, sp, tied = gpt_pipeline_stages(tm, tp, 2)
    tx = _adam(1e-3)
    eng = CompiledPipelineEngine(fns, sp, tx, num_microbatches=4,
                                 tied=tied, channel_bytes=1 << 19,
                                 device=CPU)
    try:
        losses = [eng.step(mbs, tgts) for _ in range(3)]
        new_params = eng.get_params()
        where = eng.placement()[0]
    finally:
        eng.shutdown()
    ref_losses, ref_params = run_reference_1f1b(
        fns, sp, tx, [(mbs, tgts)] * 3, tied=tied, device=CPU)
    assert losses == ref_losses
    _assert_trees_equal(new_params, ref_params)
    full_loss = float(tm.loss(tp, tokens, targets))
    assert abs(losses[0] - full_loss) < 1e-3
    untied, _ = run_reference_1f1b(fns, sp, tx, [(mbs, tgts)] * 2,
                                   device=CPU)
    assert untied[0] == losses[0] and untied[1] != losses[1]
    assert {w["device"] for w in where} == {CPU}
    assert len({w["pid"] for w in where}) == 2
    assert os.getpid() not in {w["pid"] for w in where}
    # the activation and cotangent edges carry 4 hops of [2, 16, 64] f32
    # a step, plus each envelope's header
    assert 3 * 4 * 2 * 16 * 64 * 4 <= where[0]["channel_bytes"][
        "r0:c0->c1"] < 3 * 4 * (2 * 16 * 64 * 4 + 512)
    assert where[0]["channel_bytes"]["r0:tied:c0->c1"] >= 3 * 512 * 64 * 4


def test_interleaved_matches_non_interleaved(rt):
    """4 chunks on 2 actors (virtual_stages=2, interleaved 1F1B) produce
    the trajectory of the plain order: the reference runs the chunks
    stage by stage, as 4 plain stage actors do bit for bit (the test
    above)."""
    fns, params = _mlp_chunks(4)
    mbs, tgts = _mlp_batches(4)
    tx = _adam(1e-2)
    eng = CompiledPipelineEngine(
        fns, params, tx, num_microbatches=4, virtual_stages=2,
        channel_bytes=SMALL_CHANNEL, device=CPU)
    try:
        assert eng.num_stages == 2 and len(eng.actor_grid[0]) == 2
        interleaved = [eng.step(mbs, tgts) for _ in range(3)]
        new_params = eng.get_params()
    finally:
        eng.shutdown()
    plain, ref_params = run_reference_1f1b(fns, params, tx,
                                           [(mbs, tgts)] * 3, device=CPU)
    assert interleaved == plain
    _assert_trees_equal(new_params, ref_params)


def test_remat_matches_saved_residuals(rt):
    """Activation rematerialization recomputes the same values: the
    remat=True engine's trajectory equals the saved-residual (remat=False)
    reference bit-for-bit, and the remat reference's."""
    fns, params = _mlp_chunks(2)
    mbs, tgts = _mlp_batches(4)
    tx = _sgd(1e-2)
    eng = CompiledPipelineEngine(
        fns, params, tx, num_microbatches=4, remat=True,
        channel_bytes=SMALL_CHANNEL, device=CPU)
    try:
        remat = [eng.step(mbs, tgts) for _ in range(2)]
    finally:
        eng.shutdown()
    saved, _ = run_reference_1f1b(fns, params, tx, [(mbs, tgts)] * 2,
                                  device=CPU)
    ref_remat, _ = run_reference_1f1b(fns, params, tx, [(mbs, tgts)] * 2,
                                      remat=True, device=CPU)
    assert remat == saved == ref_remat


# ---------------------------------------------------------------------------
# faults + lifecycle


def test_stage_death_mid_step_raises_typed_error(rt):
    """Killing a MIDDLE stage while a step is in flight aborts the
    engine: step() raises CompiledGraphClosedError. With no
    checkpoint_dir, recover() respawns the stages with the construction
    params — a step-0 restart whose first step equals the reference's —
    and shutdown() releases every channel segment."""
    before = _num_channels(rt)

    def mk_slow_mid():
        def fn(p, x):
            import time as _t

            _t.sleep(0.25)
            return torch.tanh(x @ p["w"] + p["b"])
        return fn

    fns, params = _mlp_chunks(3)
    fns[1] = mk_slow_mid()
    mbs, tgts = _mlp_batches(4)
    eng = CompiledPipelineEngine(fns, params, _sgd(1e-2),
                                 num_microbatches=4,
                                 channel_bytes=SMALL_CHANNEL,
                                 resources_per_stage={"CPU": 0.5},
                                 device=CPU)
    assert _num_channels(rt) > before
    result = {}

    def drive():
        try:
            eng.step(mbs, tgts, timeout=60)
            result["ok"] = True
        except BaseException as e:  # noqa: BLE001 — asserted below
            result["err"] = e

    t = threading.Thread(target=drive)
    t.start()
    time.sleep(0.4)  # the slow middle stage is inside the step
    ray_tpu_torch.kill(eng.actor_grid[0][1])
    t.join(timeout=60)
    assert not t.is_alive(), "step() wedged after stage death"
    assert isinstance(result.get("err"),
                      exceptions.CompiledGraphClosedError), result
    with pytest.raises(exceptions.CompiledGraphClosedError):
        eng.step(mbs, tgts)
    try:
        assert eng.recover() == 0
        restarted = eng.step(mbs, tgts, timeout=60)
    finally:
        eng.shutdown()
    assert _num_channels(rt) == before
    ref, _ = run_reference_1f1b(fns, params, _sgd(1e-2), [(mbs, tgts)],
                                device=CPU)
    assert [restarted] == ref


def test_stage_exception_propagates_and_poisons(rt):
    """A raising stage fn surfaces as the original TaskError; the engine
    refuses further steps (state is indeterminate) but shuts down
    leak-free."""
    before = _num_channels(rt)

    def mk_boom():
        def fn(p, x, targets):
            raise ValueError("stage exploded")
        return fn

    fns, params = _mlp_chunks(2)
    fns[1] = mk_boom()
    mbs, tgts = _mlp_batches(2)
    eng = CompiledPipelineEngine(fns, params, _sgd(1e-2),
                                 num_microbatches=2,
                                 channel_bytes=SMALL_CHANNEL, device=CPU)
    try:
        with pytest.raises(exceptions.TaskError, match="stage exploded"):
            eng.step(mbs, tgts, timeout=60)
        with pytest.raises(exceptions.CompiledGraphError, match="poisoned"):
            eng.step(mbs, tgts)
    finally:
        eng.shutdown()
    assert _num_channels(rt) == before


def test_backward_error_on_middle_chunk_not_swallowed(rt):
    """An error raised in a NON-last chunk's backward propagates only
    upstream, where chunk 0's backward has no outgoing channel — it
    reaches the driver through the stage report instead of step()
    returning a clean-looking loss over corrupted gradients."""
    def mk_bwd_boom():
        class Poison(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.clone()

            @staticmethod
            def backward(ctx, g):
                raise RuntimeError("backward exploded")

        def fn(p, x):
            return torch.tanh(Poison.apply(x) @ p["w"] + p["b"])
        return fn

    fns, params = _mlp_chunks(3)
    fns[1] = mk_bwd_boom()
    mbs, tgts = _mlp_batches(2)
    eng = CompiledPipelineEngine(fns, params, _sgd(1e-2),
                                 num_microbatches=2,
                                 channel_bytes=SMALL_CHANNEL,
                                 resources_per_stage={"CPU": 0.5},
                                 device=CPU)
    try:
        with pytest.raises(exceptions.TaskError, match="backward exploded"):
            eng.step(mbs, tgts, timeout=60)
        with pytest.raises(exceptions.CompiledGraphError, match="poisoned"):
            eng.step(mbs, tgts)
    finally:
        eng.shutdown()


def test_activation_over_the_channel_raises(rt):
    """A hop larger than the channel raises ChannelFullError from step()
    (it never hangs), and the engine is poisoned."""
    fns, params = _mlp_chunks(2, width=64)
    mbs, tgts = _mlp_batches(2, width=64, mb_size=64)   # 16 KiB a hop
    eng = CompiledPipelineEngine(fns, params, _sgd(1e-2),
                                 num_microbatches=2, channel_bytes=4096,
                                 device=CPU)
    try:
        t0 = time.monotonic()
        with pytest.raises(exceptions.ChannelFullError):
            eng.step(mbs, tgts, timeout=60)
        assert time.monotonic() - t0 < 30
        with pytest.raises(exceptions.CompiledGraphError, match="poisoned"):
            eng.step(mbs, tgts)
    finally:
        eng.shutdown()


def test_construction_validation_unported_paths_and_no_optimizer(rt):
    """Bad shapes raise; a data feed sharded for another dp raises
    ValueError (the feed itself: tests/test_torch_data_feed.py); elastic
    capacity raises NotImplementedError naming its ROADMAP item; an
    engine with tx=None runs forward and backward and keeps its params.
    (fsdp > 1 is ported: tests/test_torch_fsdp.py.)"""
    fns, params = _mlp_chunks(2)
    mbs, tgts = _mlp_batches(2)
    with pytest.raises(ValueError, match="one param tree"):
        CompiledPipelineEngine(fns, params[:1], num_microbatches=2,
                               device=CPU)
    with pytest.raises(ValueError, match="virtual_stages"):
        CompiledPipelineEngine(fns, params, num_microbatches=2,
                               virtual_stages=3, device=CPU)
    eng = CompiledPipelineEngine(fns, params, None, num_microbatches=2,
                                 channel_bytes=SMALL_CHANNEL, device=CPU)
    try:
        assert eng.step(mbs, tgts) == eng.step(mbs, tgts)
        _assert_trees_equal(eng.get_params(), params)
        assert eng.opt_state_bytes() == [0, 0]
        from ray_tpu_torch.data import DataFeed

        with pytest.raises(ValueError, match="sharded 2-wide"):
            eng.attach_feed(DataFeed([list, list]))
        assert eng.feed_stats() == [] and eng._feed is None
        eng.detach_feed()               # no feed: nothing to hand back
        for call in (eng.enable_elastic, lambda: eng.resize(2)):
            with pytest.raises(NotImplementedError, match="A7"):
                call()
    finally:
        eng.shutdown()


def test_stage_without_cuda_raises_unless_cpu_asked(rt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fns, params = _mlp_chunks(1)
    with pytest.raises(Exception, match="device='cpu'"):
        CompiledPipelineEngine(fns, params, _sgd(1e-2), num_microbatches=2,
                               channel_bytes=SMALL_CHANNEL,
                               setup_timeout=60)


def test_checkpoint_commit_is_atomic_and_latest_points_at_it(rt, tmp_path):
    """Step-0 and per-step commits with a LATEST pointer and no temp
    litter; the payload holds each stage's params and Adam's state
    tensors; restore() rejects a checkpoint of another engine shape."""
    from ray_tpu_torch._vendor import cloudpickle

    fns, params = _mlp_chunks(2)
    mbs, tgts = _mlp_batches(2)
    d = str(tmp_path / "ck")
    eng = CompiledPipelineEngine(fns, params, _adam(1e-2),
                                 num_microbatches=2,
                                 channel_bytes=SMALL_CHANNEL,
                                 checkpoint_dir=d, checkpoint_every=1,
                                 device=CPU)
    try:
        eng.step(mbs, tgts)
        eng.step(mbs, tgts)
        eng.wait_for_checkpoints()
        names = sorted(os.listdir(d))
        # step-0 commit at construction + one per step, no tmp litter
        assert names == ["LATEST", "ckpt-00000000.pkl",
                         "ckpt-00000001.pkl", "ckpt-00000002.pkl"]
        latest = CompiledPipelineEngine.latest_checkpoint(d)
        assert latest.endswith("ckpt-00000002.pkl")
        ckpt = CompiledPipelineEngine.load_checkpoint(latest)
        assert ckpt["step"] == 2
        assert len(ckpt["states"]) == 1          # dp rows
        assert len(ckpt["states"][0]) == 2       # stages
        st = ckpt["states"][0][0]
        assert st["kind"] == "full"
        # Adam's state tensors, one entry per parameter leaf
        assert sorted(st["opt"]["state"]) == [0, 1]
        assert float(st["opt"]["state"][0]["step"]) == 2.0
        other = dict(ckpt, engine=dict(ckpt["engine"], num_chunks=3))
        bad = str(tmp_path / "other-shape.pkl")
        with open(bad, "wb") as f:
            cloudpickle.dump(other, f)
        with pytest.raises(ValueError, match="shape"):
            eng.restore(bad)
    finally:
        eng.shutdown()


def test_recover_after_stage_kill_resumes_bitwise(rt, tmp_path):
    """Kill a stage after the step-2 commit, recover, and the resumed
    loss trajectory + final params are bit-identical to an uninterrupted
    run (the reference's steps 3-4): the checkpoint restores params and
    Adam's state exactly."""
    fns, params = _mlp_chunks(2)
    mbs, tgts = _mlp_batches(4)
    tx = _adam(1e-2)
    d = str(tmp_path / "ck")
    eng = CompiledPipelineEngine(fns, params, tx, num_microbatches=4,
                                 channel_bytes=SMALL_CHANNEL,
                                 checkpoint_dir=d, checkpoint_every=2,
                                 device=CPU)
    try:
        eng.step(mbs, tgts)
        eng.step(mbs, tgts)                      # checkpoint at step 2
        eng.wait_for_checkpoints()
        ray_tpu_torch.kill(eng.actor_grid[0][1])       # stage death
        with pytest.raises((exceptions.CompiledGraphClosedError,
                            exceptions.CompiledGraphError)):
            # the death may abort before or during the next step
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                eng.step(mbs, tgts, timeout=30)
        assert eng.recover() == 2
        resumed = [eng.step(mbs, tgts) for _ in range(2)]
        params_a = eng.get_params()
    finally:
        eng.shutdown()
    ref, ref_params = run_reference_1f1b(fns, params, tx,
                                         [(mbs, tgts)] * 4, device=CPU)
    assert resumed == ref[2:]
    _assert_trees_equal(params_a, ref_params)


# ---------------------------------------------------------------------------
# the dynamic engine (one .remote() call per op)


def test_dynamic_engine_matches_reference_and_single_program(rt):
    """PipelineEngine on GPT tiny in 2 stages with the tied head: its
    2-step trajectory and params equal run_reference_1f1b bit for bit (the
    same programs in the same order), its first loss is GPT.loss's and its
    first Adam step the single program's (the bounds of
    tests/test_train.py:160-181), and the 1F1B bound on in-flight
    residuals holds (stage i keeps at most P - i)."""
    from ray_tpu_torch.train import PipelineEngine

    _, _, tm, tp = _gpt_pair()
    tokens, targets = (torch.from_numpy(a) for a in _gpt_tokens(tm.config))
    mbs, tgts = list(tokens.split(2)), list(targets.split(2))
    fns, sp, tied = gpt_pipeline_stages(tm, tp, 2)
    tx = _adam(1e-3)
    eng = PipelineEngine(fns, sp, tx=tx, tied=tied, device=CPU)
    try:
        first = eng.step(mbs, tgts)
        after_one = eng.get_params()
        second = eng.step(mbs, tgts)
        final = eng.get_params()
        in_flight = ray_tpu_torch.get(
            [s.in_flight.remote() for s in eng.stages], timeout=60)
        peaks = ray_tpu_torch.get(
            [s.max_in_flight.remote() for s in eng.stages], timeout=60)
    finally:
        eng.shutdown()
    ref, ref_params = run_reference_1f1b(fns, sp, tx, [(mbs, tgts)] * 2,
                                         tied=tied, device=CPU)
    assert [first, second] == ref
    _assert_trees_equal(final, ref_params)
    assert in_flight == [0, 0] and peaks[0] <= 2 and peaks[1] <= 1, peaks
    params = {n: t.clone().requires_grad_() for n, t in tp.items()}
    loss = tm.loss(params, tokens, targets)
    loss.backward()
    assert abs(first - loss.item()) < 1e-4
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    opt.step()
    half = tm.config.n_layer // 2
    for got, want in ((after_one[0]["wte"], params["wte"]),
                      (after_one[1]["head"], params["wte"]),
                      (after_one[0]["layers"]["w_qkv"],
                       params["w_qkv"][:half]),
                      (after_one[1]["layers"]["w_qkv"],
                       params["w_qkv"][half:]),
                      (after_one[1]["lnf_g"], params["lnf_g"])):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
