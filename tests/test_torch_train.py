"""The port's train package (ray_tpu_torch.train: the trainers, the
session, the backend executor, Checkpoint and train.torch) on gloo CPU
ranks, held to the behaviours of tests/test_train.py and to the JAX
package's train package.

On a gang of 2 CPU ranks (``ScalingConfig(device_type="cpu")``):
- fit, report and checkpoint (tests/test_train.py:22), the mesh in the
  loop (:47: the sum over the gang's ``dp`` axis, with ``devices`` the
  world size) and dataset shards (:70), from the ``fit`` that also runs
  the slice below;
- the restart from a checkpoint after a worker's hard exit (:86), and an
  exhausted failure budget (:118);
- TorchTrainer (:224-304): the gang is a gloo world of 2 in the loop, DDP
  (``train.torch.prepare_model``) leaves the ranks' params bitwise equal
  from different inits and data, and equal to one process stepping SGD on
  the mean of the two ranks' gradients (to 1e-6);
- the slice against the JAX package: GPTConfig.tiny in f32 without flash,
  tokens (4, 32) dealt to the ranks as a dataset, under JaxTrainer with
  the gradient mean over ``dp``: the step-0 loss against JAX
  ``value_and_grad(model.loss)`` on the whole batch to 2e-5 and the
  all-reduced gradient to 2e-4 (of each parameter's largest |gradient|,
  and relative); then 3 SGD steps (AdamW's normalisation would turn
  rounding noise in a near-zero gradient into a full step of either
  sign): the losses to 2e-5 and the final params to 2e-4 against
  ``optax.sgd``, and the ranks' params bitwise equal.

In process, with no runtime:
- a Checkpoint directory the port writes reads back in
  ``ray_tpu.train.Checkpoint`` to the same dict, and one the JAX package
  writes reads back in the port's (nested f32 and integer arrays,
  scalars); a bf16 and an f32 tensor round-trip bitwise;
- ``prune_checkpoints`` keeps the directories the JAX package's keeps;
- ``_dataset_shards`` equals the JAX package's for a list, a tuple and a
  plain object at n = 1, 2 and 3;
- the errors: ``devices_per_worker=4`` and a ``Shardable`` or
  ``DatasetPipeline`` input each name their ROADMAP item.

One runtime serves the module and four ``fit`` calls start gangs. The
loops are defined inside the fixtures and tests (pickled by value) and
take what they need through ``train_loop_config``. The JAX package is
imported only inside the tests and fixtures that compare with it.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch._vendor import cloudpickle
from ray_tpu_torch.train import (Checkpoint, DataParallelTrainer,
                                 FailureConfig, JaxTrainer, RunConfig,
                                 ScalingConfig, TorchTrainer)
from ray_tpu_torch.train.checkpoint import prune_checkpoints

CPU = "cpu"
GPT_TOKENS, GPT_STEPS, GPT_LR = (4, 32), 3, 0.5
DDP_STEPS, DDP_LR = 2, 0.05


def _scaling(n=2):
    return ScalingConfig(num_workers=n, device_type=CPU)


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


# ---------------------------------------------------------------------------
# the JAX package's side of the slice: GPT tiny in one process


def _gpt_inputs():
    """The JAX tiny GPT (f32, no flash) and its seed-0 init as numpy, and
    tokens from a numpy seed with their next-token targets."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import GPT as JGPT
    from ray_tpu.models import GPTConfig as JGPTConfig

    model = JGPT(JGPTConfig.tiny(dtype=jnp.float32, use_flash=False,
                                 remat=False))
    params = {k: np.asarray(v) for k, v in
              jax.jit(model.init)(jax.random.PRNGKey(0)).items()}
    tokens = np.random.default_rng(1).integers(
        0, model.config.vocab_size, GPT_TOKENS).astype(np.int64)
    return model, params, tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_gpt():
    """JAX ``value_and_grad(model.loss)`` on the whole batch, then
    GPT_STEPS ``optax.sgd`` steps: their losses and the final params."""
    import jax
    import optax

    model, params, tokens, targets = _gpt_inputs()
    tx = optax.sgd(GPT_LR)
    grad_fn = jax.jit(jax.value_and_grad(model.loss))
    p, state, losses = params, tx.init(params), []
    for step in range(GPT_STEPS):
        loss, grads = grad_fn(p, tokens, targets)
        if step == 0:
            grads0 = {k: np.asarray(v) for k, v in grads.items()}
        updates, state = tx.update(grads, state, p)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
    return dict(params=params, tokens=tokens, losses=losses, grads0=grads0,
                final={k: np.asarray(v) for k, v in p.items()})


# ---------------------------------------------------------------------------
# one JaxTrainer.fit: the trainer's behaviours (tests/test_train.py) and
# the slice against the JAX package


@pytest.fixture(scope="module")
def jax_trainer_fit(rt, jax_gpt, tmp_path_factory):
    """One JaxTrainer.fit at 2 ranks, whose loop runs two parts.

    The behaviours: each rank reports 3 iterations (rank 0 with a
    checkpoint), the sum of arange(8) * 2 over the gang's dp axis, the
    mesh's devices and its shard of the "train" dataset.

    The slice: each rank takes its rows of the GPT batch (the "tokens"
    dataset), and each of GPT_STEPS steps runs GPT.loss, backward, the
    mean of the gradients (one flat f32 buffer) and of the losses over the
    mesh's dp axis, and SGD; rank 0's step-0 report holds the gradient.
    After the last step every rank reports its params and whether the
    ranks' are bitwise equal.

    Returns (result, storage path, the behaviours' rows, the slice's step
    rows, the slice's last row)."""
    storage = str(tmp_path_factory.mktemp("jax_trainer"))

    def loop(config):
        import hashlib

        import numpy as _np
        import torch as t
        import torch.distributed as dist

        from ray_tpu_torch import train as tr
        from ray_tpu_torch.models import GPT, GPTConfig, gpt_params_from_numpy

        t.set_num_threads(1)
        ctx = tr.get_context()
        mesh = tr.get_mesh()
        dp = mesh.get_group("dp")
        n = dist.get_world_size(dp)
        # this rank's shard of arange(8) along dp, summed over the axis
        total = (t.arange(8.0).chunk(n)[dist.get_rank(dp)] * 2).sum()
        dist.all_reduce(total, group=dp)
        shard = tr.get_dataset_shard("train")
        for i in range(3):
            ckpt = None
            if ctx.get_world_rank() == 0:
                ckpt = tr.Checkpoint.from_dict({"step": i,
                                                "w": t.ones(4) * i})
            tr.report({"loss": 1.0 / (i + 1), "rank": ctx.get_world_rank(),
                       "total": float(total), "devices": mesh.size(),
                       "n": len(shard), "first": shard[0]},
                      checkpoint=ckpt)

        model = GPT(GPTConfig.tiny(dtype=t.float32, use_flash=False,
                                   remat=False))
        params = gpt_params_from_numpy(config["params"], model.config,
                                       t.device("cpu"))
        for p in params.values():
            p.requires_grad_()
        opt = t.optim.SGD(list(params.values()), lr=config["lr"])
        tokens = t.as_tensor(_np.stack(tr.get_dataset_shard("tokens")))
        targets = t.roll(tokens, -1, dims=1)
        for step in range(config["steps"]):
            opt.zero_grad(set_to_none=True)
            loss = model.loss(params, tokens, targets)
            loss.backward()
            flat = t.cat([p.grad.reshape(-1) for p in params.values()] +
                         [loss.detach().reshape(1)])
            dist.all_reduce(flat, group=dp)
            flat /= n
            off = 0
            for p in params.values():
                p.grad.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
            metrics = {"loss": float(flat[-1]), "step": step}
            if step == 0:
                metrics["grads"] = {k: p.grad.numpy().copy()
                                    for k, p in params.items()}
            tr.report(metrics)
            opt.step()
        digest = hashlib.sha256(b"".join(
            p.detach().numpy().tobytes() for p in params.values())
        ).hexdigest()
        digests = [None] * n
        dist.all_gather_object(digests, digest, group=dp)
        tr.report({"params": {k: p.detach().numpy().copy()
                              for k, p in params.items()},
                   "ranks_equal": len(set(digests)) == 1})

    result = JaxTrainer(
        loop, datasets={"train": list(range(10)),
                        "tokens": list(jax_gpt["tokens"])},
        train_loop_config={"params": jax_gpt["params"], "lr": GPT_LR,
                           "steps": GPT_STEPS},
        scaling_config=_scaling(),
        run_config=RunConfig(name="t1", storage_path=storage)).fit()
    rows = result.metrics_history
    return (result, storage, rows[:3], rows[3:3 + GPT_STEPS],
            rows[3 + GPT_STEPS:])


def test_basic_fit_reports_and_checkpoints(jax_trainer_fit):
    result, storage, rows, _, last = jax_trainer_fit
    assert result.error is None
    assert len(result.metrics_history) == 3 + GPT_STEPS + 1
    assert result.metrics == last[0]
    assert rows[-1]["loss"] == pytest.approx(1.0 / 3)
    assert [r["rank"] for r in rows] == [0, 0, 0]
    assert [r["iteration"] for r in rows] == [1, 2, 3]
    data = result.checkpoint.to_dict()
    assert data["step"] == 2
    np.testing.assert_allclose(data["w"], 2.0)
    assert isinstance(data["w"], np.ndarray) and data["w"].dtype == np.float32
    assert os.path.isdir(os.path.join(storage, "t1", "checkpoint_000003"))


def test_mesh_spans_the_gang(jax_trainer_fit):
    rows = jax_trainer_fit[2]
    assert rows[-1]["total"] == 56.0
    assert rows[-1]["devices"] == 2


def test_dataset_shards(jax_trainer_fit):
    rows = jax_trainer_fit[2]
    assert (rows[-1]["n"], rows[-1]["first"]) == (5, 0)


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for k, b in want.items():
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(got[k], b, atol=2e-4 * scale, rtol=2e-4,
                                   err_msg=k)


def test_gpt_step0_loss_and_grads_match_jax(jax_trainer_fit, jax_gpt):
    assert jax_trainer_fit[0].error is None
    first = jax_trainer_fit[3][0]
    assert abs(first["loss"] - jax_gpt["losses"][0]) <= 2e-5
    _assert_grads_close(first["grads"], jax_gpt["grads0"])


def test_gpt_sgd_steps_match_jax(jax_trainer_fit, jax_gpt):
    _, _, _, steps, (final,) = jax_trainer_fit
    losses = [m["loss"] for m in steps]
    np.testing.assert_allclose(losses, jax_gpt["losses"], atol=2e-5, rtol=0)
    assert losses[-1] < losses[0]
    assert final["ranks_equal"] is True
    assert set(final["params"]) == set(jax_gpt["final"])
    for k, want in jax_gpt["final"].items():
        np.testing.assert_allclose(final["params"][k], want, atol=2e-4,
                                   rtol=0, err_msg=k)


def test_failure_restart_from_checkpoint(rt, tmp_path):
    def loop(config):
        import os as _os

        from ray_tpu_torch import train as tr

        ctx = tr.get_context()
        ckpt = tr.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt is not None else 0
        for i in range(start, 4):
            if i == 2 and not _os.path.exists(config["marker"]) \
                    and ctx.get_world_rank() == 0:
                open(config["marker"], "w").close()
                _os._exit(1)  # hard-kill this worker process
            c = None
            if ctx.get_world_rank() == 0:
                c = tr.Checkpoint.from_dict({"step": i})
            tr.report({"step": i}, checkpoint=c)

    result = JaxTrainer(
        loop, train_loop_config={"marker": str(tmp_path / "fail_once")},
        scaling_config=_scaling(),
        run_config=RunConfig(name="t4", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2))
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    # the restart resumed from the step-1 checkpoint, not from scratch
    steps = [m["step"] for m in result.metrics_history]
    assert steps == [0, 1, 2, 3]


def test_failure_exhausts_budget(rt, tmp_path):
    def loop(config):
        import os as _os

        _os._exit(1)

    result = JaxTrainer(
        loop, scaling_config=_scaling(1),
        run_config=RunConfig(name="t5", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=0))
    ).fit()
    assert isinstance(result.error, train.TrainWorkerError)


# ---------------------------------------------------------------------------
# TorchTrainer: DDP over the gang's gloo world


@pytest.fixture(scope="module")
def ddp_fit(rt, tmp_path_factory):
    """TorchTrainer.fit at 2 ranks: each builds Linear(3, 2) from its own
    seed, wraps it with prepare_model and takes DDP_STEPS SGD steps on
    its own data; reports its params, whether both ranks' are bitwise
    equal (all_gather) and the world it saw."""
    def loop(config):
        import torch as t
        import torch.distributed as dist

        from ray_tpu_torch import train as tr
        from ray_tpu_torch.train import torch as train_torch

        t.set_num_threads(1)
        rank = tr.get_context().get_world_rank()
        t.manual_seed(rank * 7 + 1)  # a different init per rank: DDP's
        # constructor broadcast must erase the difference
        model = train_torch.prepare_model(t.nn.Linear(3, 2))
        opt = t.optim.SGD(model.parameters(), lr=config["lr"])
        g = t.Generator().manual_seed(rank)
        for _ in range(config["steps"]):
            x = t.randn(8, 3, generator=g)
            opt.zero_grad()
            model(x).sum().backward()
            opt.step()
        flat = t.cat([p.detach().flatten() for p in model.parameters()])
        gathered = [t.zeros_like(flat) for _ in range(2)]
        dist.all_gather(gathered, flat)
        tr.report({"w": flat.numpy().copy(), "rank": rank,
                   "same": bool(t.equal(gathered[0], gathered[1])),
                   "ddp": type(model).__name__,
                   "initialized": dist.is_initialized(),
                   "world": dist.get_world_size()})

    return TorchTrainer(
        loop, train_loop_config={"lr": DDP_LR, "steps": DDP_STEPS},
        scaling_config=_scaling(),
        run_config=RunConfig(name="ddp", storage_path=str(
            tmp_path_factory.mktemp("ddp")))).fit()


def test_torch_trainer_forms_a_gloo_world_and_ddp(ddp_fit):
    assert ddp_fit.error is None
    final = ddp_fit.metrics_history[-1]
    assert final["initialized"] is True and final["world"] == 2
    assert final["ddp"] == "DistributedDataParallel"


def test_ddp_params_identical_across_ranks(ddp_fit):
    assert ddp_fit.metrics_history[-1]["same"] is True


def test_ddp_steps_on_the_mean_gradient(ddp_fit):
    """One process: rank 0's init (DDP broadcasts it), SGD on the mean of
    the two ranks' gradients."""
    torch.manual_seed(1)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=DDP_LR)
    gens = [torch.Generator().manual_seed(r) for r in range(2)]
    for _ in range(DDP_STEPS):
        xs = [torch.randn(8, 3, generator=g) for g in gens]
        grads = [torch.autograd.grad(model(x).sum(),
                                     list(model.parameters())) for x in xs]
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
    want = torch.cat([p.detach().flatten() for p in model.parameters()])
    np.testing.assert_allclose(ddp_fit.metrics_history[-1]["w"],
                               want.numpy(), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# Checkpoint, prune_checkpoints and dataset shards against the JAX package


def _nested():
    rng = np.random.default_rng(0)
    return {"step": 7, "lr": 0.25, "name": "run", "scale": np.float32(1.5),
            "params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "layers": {"b": np.arange(5, dtype=np.int64),
                                  "idx": np.arange(6, dtype=np.int32
                                                   ).reshape(2, 3)}}}


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _assert_same(got, want):
    """Equal structure, values, types and dtypes; arrays bit for bit."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert got == want


def test_port_checkpoint_directory_reads_back_in_jax_package(tmp_path):
    from ray_tpu.train import Checkpoint as JCheckpoint

    path = Checkpoint.from_dict(_as_tensors(_nested())).to_directory(
        str(tmp_path / "port"))
    _assert_same(JCheckpoint.from_directory(path).to_dict(), _nested())
    _assert_same(Checkpoint.from_directory(path).to_dict(), _nested())


def test_jax_package_checkpoint_directory_reads_back_in_port(tmp_path):
    from ray_tpu.train import Checkpoint as JCheckpoint

    path = JCheckpoint.from_dict(_nested()).to_directory(
        str(tmp_path / "jax"))
    got = Checkpoint.from_directory(path).to_dict()
    _assert_same(got, JCheckpoint.from_directory(path).to_dict())
    _assert_same(got, _nested())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_round_trips_bitwise(dtype, tmp_path):
    """Through a pickled dict checkpoint (what train.report ships) and a
    directory: f32 comes back a numpy array, bf16 a CPU torch tensor, bit
    for bit."""
    gen = torch.Generator().manual_seed(0)
    t = (torch.randn(4, 5, generator=gen) * 3).to(dtype)
    shipped = pickle.loads(cloudpickle.dumps(
        Checkpoint.from_dict({"a": {"t": t}, "step": 1})))
    path = shipped.to_directory(str(tmp_path / "ckpt"))
    back = Checkpoint.from_directory(path).to_dict()
    assert back["step"] == 1
    got = back["a"]["t"]
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    if dtype == torch.float32:
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        got = torch.from_numpy(got)
    assert isinstance(got, torch.Tensor) and got.dtype == dtype
    assert got.device.type == CPU
    assert torch.equal(got.view(bits), t.view(bits))


@pytest.mark.parametrize("num_to_keep", [None, 2])
def test_prune_checkpoints_keeps_what_jax_package_keeps(num_to_keep,
                                                         tmp_path):
    from ray_tpu.train.checkpoint import prune_checkpoints as jprune

    kept = []
    for side, prune in (("port", prune_checkpoints), ("jax", jprune)):
        base = tmp_path / side
        for name in ("checkpoint_000003", "checkpoint_000001", "other",
                     "checkpoint_000010", "checkpoint_000002"):
            (base / name).mkdir(parents=True)
        prune(str(base), num_to_keep)
        kept.append(sorted(os.listdir(base)))
    assert kept[0] == kept[1]
    assert len(kept[0]) == (5 if num_to_keep is None else 3)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("kind", ["list", "tuple", "object"])
def test_dataset_shards_equal_jax_package(kind, n):
    from ray_tpu.train import DataParallelTrainer as JTrainer
    from ray_tpu.train import ScalingConfig as JScaling

    ds = {"list": list(range(7)), "tuple": tuple("abcdefg"),
          "object": {"rows": 7}}[kind]
    datasets = {"train": ds, "eval": [10, 11]}
    got = DataParallelTrainer(
        lambda c: None, datasets=datasets,
        scaling_config=ScalingConfig(num_workers=n))._dataset_shards()
    want = JTrainer(lambda c: None, datasets=datasets,
                    scaling_config=JScaling(num_workers=n))._dataset_shards()
    assert got == want and len(got) == n


def test_unported_inputs_name_their_roadmap_item(rt):
    """devices_per_worker other than 1 raises naming ROADMAP C. A port
    Dataset and a DatasetPipeline (windows of one block) shard into the
    rows the JAX package's _dataset_shards gives its own Dataset and
    pipeline of the same rows, at n = 1, 2 and 3."""
    import ray_tpu
    import ray_tpu.data as jdata
    from ray_tpu.train import DataParallelTrainer as JTrainer
    from ray_tpu.train import ScalingConfig as JScaling

    import ray_tpu_torch.data as pdata

    with pytest.raises(ValueError, match="ROADMAP C"):
        ScalingConfig(num_workers=2, devices_per_worker=4)
    assert ScalingConfig(devices_per_worker=1).devices_per_worker == 1

    def make(data, kind):
        ds = data.range(11, parallelism=4).map(
            lambda r: {"id": r["id"], "sq": r["id"] ** 2})
        return ds if kind == "DataShard" else ds.window(blocks_per_window=1)

    ray_tpu.init(num_cpus=2)
    try:
        for n in (1, 2, 3):
            for kind in ("DataShard", "DatasetPipeline"):
                got = DataParallelTrainer(
                    lambda c: None, datasets={"train": make(pdata, kind)},
                    scaling_config=_scaling(n))._dataset_shards()
                want = JTrainer(
                    lambda c: None, datasets={"train": make(jdata, kind)},
                    scaling_config=JScaling(num_workers=n))._dataset_shards()
                assert len(got) == len(want) == n
                assert {type(s["train"]).__name__ for s in got} == {kind}
                got_rows = [list(s["train"].iter_rows()) for s in got]
                assert got_rows == [list(s["train"].iter_rows())
                                    for s in want]
                assert sorted(r["id"] for part in got_rows
                              for r in part) == list(range(11))
    finally:
        ray_tpu.shutdown()
