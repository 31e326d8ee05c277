"""The data plane's feed into the port's pipeline engine
(ray_tpu_torch/data/feed.py and CompiledPipelineEngine.attach_feed), and a
trainer fed from a port Dataset, on the CPU.

Held to what tests/test_data_feed.py asserts of the JAX package: a fed
engine's loss trajectory is bit for bit the hand-fed one's, steady-state
fed steps make zero driver dispatches (``dispatch_counts``), an undrained
detach raises, a drained detach hands the rings back (the next hand-fed
step continues the trajectory), a pump's death aborts with
``DataFeedError`` and ``recover()`` re-attaches the feed, and shutdown
with a live feed leaks no channel segment. The feed's microbatches come
through the data plane (``from_numpy`` -> ``split_shards`` ->
``DataFeed.from_shards``), and the fed losses are within 2e-5 of the JAX
package's ``run_reference_1f1b`` on the same params and microbatches.

Then a ``JaxTrainer`` loop on ``GPTConfig.tiny``, each rank reading its
``split_shards`` rows of a port Dataset through ``iter_torch_batches``,
against the JAX model's full-batch ``value_and_grad`` and ``optax.sgd``:
losses within 2e-5, the step-0 mean gradient within 2e-4 of each
parameter's largest |gradient| (tests/test_torch_train.py's bounds).

Two engines in all: one for attach, detach and re-attach, one for the
pump's death, ``recover()`` and shutdown with a live feed. The JAX
package is imported only inside the tests that compare with it; feed
factories are closures, so they travel to the pump actors by value.
"""
import functools
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as pdata
from ray_tpu_torch import exceptions
from ray_tpu_torch.core.runtime import dispatch_counts
from ray_tpu_torch.data import DataFeed
from ray_tpu_torch.parallel.zero import tree_flatten
from ray_tpu_torch.train import CompiledPipelineEngine, run_reference_1f1b

CPU = "cpu"
SMALL_CHANNEL = 1 << 18
WIDTH, MB_SIZE, M = 8, 2, 4
FED_STEPS = 4       # the first fed run: one warm step, then steady state
REF_STEPS = 8       # every step either engine takes replays this list
LR = 0.05


@pytest.fixture(scope="module")
def rt():
    # one intra-op thread here and in every worker the runtime starts
    # (they inherit OMP_NUM_THREADS): the shapes are tiny, and the cores
    # go to the test files running beside this one
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        runtime = ray_tpu_torch.init(num_cpus=8)
        yield runtime
        ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


def _mlp_numpy(num_chunks=2, seed=0):
    """Each chunk's tanh-MLP params as numpy (the last chunk's loss is an
    MSE), and M microbatches of inputs and targets as numpy rows."""
    rng = np.random.RandomState(seed)
    params = [{"w": (rng.randn(WIDTH, WIDTH) * 0.3).astype(np.float32),
               "b": np.zeros(WIDTH, np.float32)} for _ in range(num_chunks)]
    rows = np.random.RandomState(7)
    xs = rows.randn(M * MB_SIZE, WIDTH).astype(np.float32)
    ys = rows.randn(M * MB_SIZE, WIDTH).astype(np.float32)
    return params, xs, ys


def _torch_chunks(params):
    def mid(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def last(p, x, targets):
        return ((x @ p["w"] + p["b"] - targets) ** 2).mean()

    fns = [mid] * (len(params) - 1) + [last]
    return fns, [{k: torch.from_numpy(v.copy()) for k, v in p.items()}
                 for p in params]


def _split(rows):
    return [torch.from_numpy(rows[i * MB_SIZE:(i + 1) * MB_SIZE].copy())
            for i in range(M)]


def _dataset_feed(xs, ys, steps, dp=1, name="feed"):
    """A DataFeed over a port Dataset of the rows: each pump takes its
    ``split_shards`` shard and yields (inputs, targets) microbatches of
    MB_SIZE rows, ``steps`` passes over it."""
    ds = pdata.from_numpy({"x": xs, "y": ys}, parallelism=2)

    def to_microbatches(shard, steps=steps, size=MB_SIZE):
        for _ in range(steps):
            for b in shard.iter_batches(batch_size=size):
                yield b["x"], b["y"]

    return DataFeed.from_shards(ds.split_shards(dp), to_microbatches,
                                name=name)


def _repeat_feed(mbs, tgts, steps):
    """A one-replica DataFeed yielding the microbatches ``steps`` times."""
    mbs = [m.numpy() for m in mbs]
    tgts = [t.numpy() for t in tgts]

    def factory():
        for _ in range(steps):
            yield from zip(mbs, tgts)

    return DataFeed([factory])


def _sgd():
    return functools.partial(torch.optim.SGD, lr=LR)


def _assert_trees_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y), (x - y).abs().max()


@functools.lru_cache(maxsize=None)
def _reference():
    """The port's single-process reference over REF_STEPS steps of the
    same microbatches: (losses, params after FED_STEPS + 1 steps)."""
    params, xs, ys = _mlp_numpy()
    fns, tparams = _torch_chunks(params)
    mbs, tgts = _split(xs), _split(ys)
    losses, _ = run_reference_1f1b(fns, tparams, _sgd(),
                                   [(mbs, tgts)] * REF_STEPS, device=CPU)
    _, after = run_reference_1f1b(fns, tparams, _sgd(),
                                  [(mbs, tgts)] * (FED_STEPS + 1),
                                  device=CPU)
    return losses, after


def _jax_losses(steps):
    """The JAX package's run_reference_1f1b on the same params and
    microbatches under optax.sgd."""
    import jax.numpy as jnp
    import optax

    from ray_tpu.train.pipeline_cgraph import \
        run_reference_1f1b as jax_reference

    params, xs, ys = _mlp_numpy()

    def mid(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def last(p, x, targets):
        return jnp.mean((x @ p["w"] + p["b"] - targets) ** 2)

    jparams = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    mbs = [jnp.asarray(xs[i * MB_SIZE:(i + 1) * MB_SIZE]) for i in range(M)]
    tgts = [jnp.asarray(ys[i * MB_SIZE:(i + 1) * MB_SIZE]) for i in range(M)]
    losses, _ = jax_reference([mid, last], jparams, optax.sgd(LR),
                              [(mbs, tgts)] * steps)
    return [float(x) for x in losses]


def _engine():
    params, xs, ys = _mlp_numpy()
    fns, tparams = _torch_chunks(params)
    return CompiledPipelineEngine(fns, tparams, _sgd(), num_microbatches=M,
                                  channel_bytes=SMALL_CHANNEL, device=CPU)


def test_pump_values_leave_as_step_sends_them():
    """A pump serializes what the engine's hand-fed step() serializes for
    the same value: tensors detached onto the host through dicts, lists
    and tuples, numpy arrays and scalars unchanged."""
    from ray_tpu_torch.data.feed import _host_value
    from ray_tpu_torch.train.pipeline_cgraph import _host

    leaf = torch.arange(6.0).reshape(2, 3).requires_grad_()
    value = {"x": leaf * 2, "pair": (np.arange(3), [leaf, 5]), "n": 1.5}
    got, want = _host_value(value), _host(value)
    assert type(got["pair"]) is tuple and type(got["pair"][1]) is list
    for a, b in ((got["x"], want["x"]), (got["pair"][1][0],
                                         want["pair"][1][0])):
        assert not a.requires_grad and a.device.type == "cpu"
        assert torch.equal(a, b)
    assert got["pair"][0] is value["pair"][0] and got["n"] == 1.5
    assert got["pair"][1][1] == 5


# ---------------------------------------------------------------------------
# attach, detach and re-attach on one engine


class TestHandOff:
    @pytest.fixture(scope="class")
    def engine(self, rt):
        eng = _engine()
        yield eng
        eng.shutdown()

    def test_fed_matches_handfed_bit_identical_zero_dispatch(self, engine):
        """FED_STEPS fed steps through the data plane: the losses are the
        hand-fed reference's bit for bit and within 2e-5 of the JAX
        package's; the steady-state steps make zero driver dispatches; a
        detach before the last fed step is read raises; the drained
        detach hands the rings back and the next hand-fed step continues
        the trajectory, with the params the reference's bit for bit."""
        ref_losses, ref_after = _reference()
        params, xs, ys = _mlp_numpy()
        mbs, tgts = _split(xs), _split(ys)
        assert engine._step_count == 0
        engine.attach_feed(_dataset_feed(xs, ys, FED_STEPS))
        losses = [engine.step()]
        d0 = dispatch_counts()
        losses += [engine.step() for _ in range(FED_STEPS - 2)]
        d1 = dispatch_counts()
        assert (d1[0] - d0[0], d1[1] - d0[1]) == (0, 0), \
            "steady-state fed steps must make zero driver dispatches"
        with pytest.raises(exceptions.CompiledGraphError, match="undrained"):
            engine.detach_feed(timeout=1.0)
        losses.append(engine.step())
        assert losses == ref_losses[:FED_STEPS]
        # the pump's counts land a beat after its last send, as
        # detach_feed allows for
        stats, deadline = engine.feed_stats(), time.monotonic() + 5.0
        while not all(s["exhausted"] for s in stats) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
            stats = engine.feed_stats()
        assert [(s["sent"], s["exhausted"], s["error"]) for s in stats] == \
            [(FED_STEPS * M, True, None)]
        np.testing.assert_allclose(losses, _jax_losses(FED_STEPS),
                                   atol=2e-5, rtol=0)
        engine.detach_feed()
        assert engine.feed_stats() == []
        assert engine.step(mbs, tgts) == ref_losses[FED_STEPS]
        _assert_trees_equal(engine.get_params(), ref_after)

    def test_step_arg_discipline(self, engine):
        """Unfed engines require a batch and fed ones refuse it; a feed
        sharded for another dp and a second feed are refused; a re-attach
        continues the trajectory."""
        ref_losses, _ = _reference()
        params, xs, ys = _mlp_numpy()
        mbs, tgts = _split(xs), _split(ys)
        with pytest.raises(ValueError, match="needs microbatches"):
            engine.step()
        with pytest.raises(ValueError, match="sharded 2-wide"):
            engine.attach_feed(_dataset_feed(xs, ys, 1, dp=2))
        engine.attach_feed(_repeat_feed(mbs, tgts, 1))
        with pytest.raises(exceptions.CompiledGraphError, match="already"):
            engine.attach_feed(_repeat_feed(mbs, tgts, 1))
        with pytest.raises(ValueError, match="feed is attached"):
            engine.step(mbs, tgts)
        k = engine._step_count
        assert engine.step() == ref_losses[k]
        engine.detach_feed()
        assert engine.step(mbs, tgts) == ref_losses[k + 1]


# ---------------------------------------------------------------------------
# a pump's death, recover() and shutdown with a live feed on one engine


class TestFaults:
    @pytest.fixture(scope="class")
    def engine(self, rt):
        before = rt.nodes[rt.head_node_id].store.stats()["num_channels"]
        eng = _engine()
        yield eng, before
        eng.shutdown()

    def test_pump_death_typed_error_and_recover_reattaches(self, engine):
        """With a live (unfinished) feed a detach raises; killing the pump
        aborts the engine with DataFeedError; recover() respawns the
        stages and re-attaches the feed from its factory, so the next fed
        step is step 0 again."""
        eng, _ = engine
        ref_losses, _ = _reference()
        params, xs, ys = _mlp_numpy()
        eng.attach_feed(_repeat_feed(_split(xs), _split(ys), 1000))
        assert eng.step() == ref_losses[0]
        with pytest.raises(exceptions.CompiledGraphError, match="undrained"):
            eng.detach_feed(timeout=0.5)
        ray_tpu_torch.kill(eng._feed_actors[0])
        deadline = time.monotonic() + 30
        while eng._closed_error is None:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert isinstance(eng._closed_error, exceptions.DataFeedError)
        with pytest.raises(exceptions.DataFeedError):
            eng.step()
        assert eng.recover() == 0
        assert len(eng._feed_actors) == 1
        assert eng.step() == ref_losses[0]

    def test_shutdown_with_live_feed_leaks_nothing(self, engine, rt):
        """shutdown() with a pump still attached kills it without a
        spurious DataFeedError and releases every channel segment."""
        eng, before = engine
        if eng._feed is None:
            params, xs, ys = _mlp_numpy()
            eng.attach_feed(_repeat_feed(_split(xs), _split(ys), 1000))
            eng.step()
        pumps = list(eng._feed_actors)
        eng.shutdown()
        assert not isinstance(eng._closed_error, exceptions.DataFeedError)
        assert rt.nodes[rt.head_node_id].store.stats()["num_channels"] \
            == before
        assert all(rt.actor_state(a._actor_id) == "DEAD" for a in pumps)


# ---------------------------------------------------------------------------
# a trainer fed from a port Dataset, against the JAX package

GPT_TOKENS, GPT_STEPS, GPT_LR = (4, 32), 2, 0.5


def test_jax_trainer_on_dataset_shards_matches_jax(rt, tmp_path):
    """JaxTrainer with datasets={"train": a port Dataset}: each of two
    ranks reads its split_shards rows through iter_torch_batches, steps
    GPT tiny on the dp mean of the gradients; the losses are within 2e-5
    and the step-0 mean gradient within 2e-4 of the JAX model's on the
    whole batch (the shards are equal, so the mean of their mean losses
    is the batch's)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import GPT as JGPT
    from ray_tpu.models import GPTConfig as JGPTConfig

    from ray_tpu_torch.train import JaxTrainer, RunConfig, ScalingConfig

    jmodel = JGPT(JGPTConfig.tiny(dtype=jnp.float32, use_flash=False,
                                  remat=False))
    params = {k: np.asarray(v) for k, v in
              jax.jit(jmodel.init)(jax.random.PRNGKey(0)).items()}
    tokens = np.random.default_rng(1).integers(
        0, jmodel.config.vocab_size, GPT_TOKENS).astype(np.int64)
    tx = optax.sgd(GPT_LR)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.loss))
    p, state, want_losses = params, tx.init(params), []
    for step in range(GPT_STEPS):
        loss, grads = grad_fn(p, tokens, np.roll(tokens, -1, axis=1))
        if step == 0:
            want_grads = {k: np.asarray(v) for k, v in grads.items()}
        updates, state = tx.update(grads, state, p)
        p = optax.apply_updates(p, updates)
        want_losses.append(float(loss))

    def loop(config):
        import torch as t
        import torch.distributed as dist

        from ray_tpu_torch import train as tr
        from ray_tpu_torch.models import GPT, GPTConfig, gpt_params_from_numpy

        t.set_num_threads(1)
        dp = tr.get_mesh().get_group("dp")
        n = dist.get_world_size(dp)
        shard = tr.get_dataset_shard("train")
        tokens = t.cat([b["tokens"] for b in shard.iter_torch_batches(
            batch_size=None, device="cpu")])
        targets = t.roll(tokens, -1, dims=1)
        model = GPT(GPTConfig.tiny(dtype=t.float32, use_flash=False,
                                   remat=False))
        params = gpt_params_from_numpy(config["params"], model.config,
                                       t.device("cpu"))
        for q in params.values():
            q.requires_grad_()
        opt = t.optim.SGD(list(params.values()), lr=config["lr"])
        for step in range(config["steps"]):
            opt.zero_grad(set_to_none=True)
            loss = model.loss(params, tokens, targets)
            loss.backward()
            flat = t.cat([q.grad.reshape(-1) for q in params.values()] +
                         [loss.detach().reshape(1)])
            dist.all_reduce(flat, group=dp)
            flat /= n
            off = 0
            for q in params.values():
                q.grad.copy_(flat[off:off + q.numel()].view_as(q))
                off += q.numel()
            metrics = {"loss": float(flat[-1]), "rows": tokens.shape[0],
                       "type": type(shard).__name__}
            if step == 0:
                metrics["grads"] = {k: q.grad.numpy().copy()
                                    for k, q in params.items()}
            tr.report(metrics)
            opt.step()

    ds = pdata.from_numpy({"tokens": tokens}, parallelism=2)
    result = JaxTrainer(
        loop, datasets={"train": ds},
        train_loop_config={"params": params, "lr": GPT_LR,
                           "steps": GPT_STEPS},
        scaling_config=ScalingConfig(num_workers=2, device_type=CPU),
        run_config=RunConfig(name="fed", storage_path=str(tmp_path))).fit()
    assert result.error is None
    rows = result.metrics_history
    assert [(r["rows"], r["type"]) for r in rows] == \
        [(GPT_TOKENS[0] // 2, "DataShard")] * GPT_STEPS
    np.testing.assert_allclose([r["loss"] for r in rows], want_losses,
                               atol=2e-5, rtol=0)
    got = rows[0]["grads"]
    assert set(got) == set(want_grads)
    for k, b in want_grads.items():
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(got[k], b, atol=2e-4 * scale, rtol=2e-4,
                                   err_msg=k)
