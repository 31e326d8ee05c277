"""The port's in-program pipeline (ray_tpu_torch.parallel.pipeline's
``pipeline_spmd`` and ``stack_stages``, the differentiable ``psum``,
``ppermute`` and ``pvary`` of ray_tpu_torch.parallel.sharding.lower, and
``GPT.loss_pp``), on gloo CPU ranks, held against the JAX package's
functions on the same numpy inputs (its virtual 8-device CPU mesh):

- ``stack_stages`` equals JAX's, with the same ValueError;
- the collectives' transposes: ppermute (a ring and a chain), psum into a
  replicated output and pvary of a replicated input, inside a shard_map
  over 4 ranks, their gradients equal to ``jax.grad``'s to 1e-6
  (relative and absolute);
- the toy of tests/test_parallel.py:200-227 (L=8, D=16, tanh) at pp=4:
  every rank's output equals JAX ``pipeline_spmd`` and the sequential
  loop to 1e-5;
- the gradient case of :229-261 at pp=2 x dp=2: the gradients of the
  weights and of the microbatches equal ``jax.grad`` of JAX
  ``pipeline_spmd`` (pp=2, dp=2, tp=2) to 1e-5;
- ``GPTConfig.tiny`` in f32 with mha_reference, tokens (4, 32), M=2, at
  pp=2 x dp=2 against JAX ``value_and_grad(loss_pp)`` (pp=2, dp=2, tp=2,
  as :263-278): the loss to 2e-5, every gradient to 2e-4, and every
  rank's loss and gradients bitwise equal to each other;
- at n_layer=4, the port's ``loss_pp`` at pp=4 equals its pp=1 within
  1e-6, loss and gradients, with and without dropout (one generator
  seed); with dropout the loss differs from the loss without it;
- the errors: a batch that does not split into M, and layers that do not
  split into P;
- a tensor-parallel GPT trains: ``GPT(tp=2)`` ``loss`` and
  ``loss_chunked`` (remat on) at tp=2 x dp=2 equal JAX
  ``value_and_grad(loss)`` on the unsplit model (the loss to 2e-5, each
  rank's gradient to 2e-4 of its ``shard_param`` of JAX's), and
  ``loss_pp`` at pp=2 x tp=2, remat off and on, equals the JAX
  ``value_and_grad(loss_pp)`` above likewise, every rank of a pp group
  bitwise equal to the others;
- with dropout and one generator seed, ``loss_pp`` at pp=2 x tp=2 equals
  pp=1 x tp=1 within 1e-6, remat on equals remat off bitwise, and a
  step calls each collective as often with remat on as off;
- the fused entry and exit under tp: ``GPT(tp=2, fused_entry_exit=True)``
  ``loss`` and ``loss_chunked`` at tp=2 x dp=2, remat off and on, equal
  JAX ``value_and_grad(loss)`` of the unsplit fused model (its Pallas
  kernels in interpret mode; biases and layernorm parameters moved off
  their init by a numpy draw, so that a bias or residual added on more
  than one rank would show): the loss to 2e-5 and each rank's gradient
  shard, ``ln*``, ``b_proj`` and ``b_out`` whole on every rank, to 2e-4;
  remat on calls every collective as often as remat off; and
  ``loss_pp`` at pp=2 x tp=2 fused equals the port's pp=1 x tp=1 fused
  ``loss_pp`` within 1e-6.

One runtime and one gang of four rank actors serve the module, with a
mesh built per case; the functions the gang runs are defined inside the
tests (pickled by value). Each JAX program is compiled once, in a
module-scoped fixture. The JAX package is imported only inside the
fixtures and tests that compare with it.
"""
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel.mesh import MeshSpec

CPU = "cpu"
HALF_CPU = {"CPU": 0.5}
GANG_TIMEOUT_S = 180
TOY_L, TOY_D, TOY_M, TOY_ROWS = 8, 16, 4, 6
GRAD_L, GRAD_D, GRAD_M, GRAD_ROWS = 4, 8, 2, 4
GPT_TOKENS, GPT_M = (4, 32), 2


@pytest.fixture(scope="module")
def rt():
    runtime = ray_tpu_torch.init(num_cpus=8)
    yield runtime
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def gang(rt):
    from ray_tpu_torch.parallel.mesh_group import MeshGroup

    group = MeshGroup(4, spec=MeshSpec(dp=-1), device_type=CPU,
                      resources_per_worker=HALF_CPU)

    def one_thread(w):
        import torch as t

        # tiny shapes: four ranks on a few cores run faster on one
        # intra-op thread each
        t.set_num_threads(1)

    run_on(group, one_thread)
    yield group
    group.shutdown()


def run_on(gang, fn, *args):
    """``fn(worker, *args)`` on every rank of the gang, within the
    module's timeout."""
    return ray_tpu_torch.get(gang.run_async(fn, *args),
                             timeout=GANG_TIMEOUT_S)


def _toy_inputs(L, D, M, rows, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    x_mb = rng.normal(size=(M, rows, D)).astype(np.float32)
    return w, x_mb


def _gpt_inputs():
    """The JAX tiny GPT's init (seed 0) as numpy, and tokens from a numpy
    seed, with their next-token targets."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import GPT as JGPT
    from ray_tpu.models import GPTConfig as JGPTConfig

    model = JGPT(JGPTConfig.tiny(dtype=jnp.float32, use_flash=False,
                                 remat=False))
    params = {k: np.asarray(v) for k, v in
              jax.jit(model.init)(jax.random.PRNGKey(0)).items()}
    tokens = np.random.default_rng(1).integers(
        0, model.config.vocab_size, GPT_TOKENS).astype(np.int32)
    return model, params, tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_toy():
    """JAX ``pipeline_spmd`` on the toy: the forward at pp=4 x dp=2 and
    ``jax.grad`` of sum(y^2) (weights and microbatches) at pp=2 x dp=2 x
    tp=2, each compiled once."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import virtual_mesh
    from ray_tpu.parallel.pipeline import pipeline_spmd, stack_stages

    def stage_fn(lp, x):
        def blk(h, wl):
            return jnp.tanh(h @ wl), None
        h, _ = jax.lax.scan(blk, x, lp["w"])
        return h

    w, x_mb = _toy_inputs(TOY_L, TOY_D, TOY_M, TOY_ROWS, 0)
    mesh4 = virtual_mesh(8, JMeshSpec(pp=4, dp=2))
    y = jax.jit(lambda w, x: pipeline_spmd(
        stage_fn, stack_stages({"w": w}, 4), x, mesh4))(w, x_mb)

    gw, gx_mb = _toy_inputs(GRAD_L, GRAD_D, GRAD_M, GRAD_ROWS, 1)
    mesh2 = virtual_mesh(8, JMeshSpec(pp=2, dp=2, tp=2))

    def loss(w, x):
        y = pipeline_spmd(stage_fn, stack_stages({"w": w}, 2), x, mesh2)
        return jnp.sum(y ** 2)

    dw, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(gw, gx_mb)
    return dict(w=w, x_mb=x_mb, y=np.asarray(y), gw=gw, gx_mb=gx_mb,
                dw=np.asarray(dw), dx=np.asarray(dx))


@pytest.fixture(scope="module")
def jax_gpt_loss():
    """JAX ``value_and_grad(loss)`` of the tiny GPT on ``_gpt_inputs``,
    compiled once."""
    import jax

    model, params, tokens, targets = _gpt_inputs()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, tokens, targets)))(params)
    return dict(params=params, tokens=tokens, targets=targets,
                loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def jax_gpt_fused_loss():
    """JAX ``value_and_grad(loss)`` of the unsplit fused tiny GPT (f32, its
    Pallas kernels in interpret mode) on ``_gpt_inputs``' tokens, with the
    biases and layernorm parameters drawn off their init (numpy seed 5),
    compiled once."""
    import dataclasses

    import jax

    from ray_tpu.models import GPT as JGPT

    model, params, tokens, targets = _gpt_inputs()
    model = JGPT(dataclasses.replace(model.config, fused_entry_exit=True))
    rng = np.random.default_rng(5)
    params = {k: v + (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
              if k.startswith(("b_", "ln")) else v
              for k, v in params.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, tokens, targets)))(params)
    return dict(params=params, tokens=tokens, targets=targets,
                loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def jax_gpt():
    """JAX ``value_and_grad(loss_pp)`` of the tiny GPT at pp=2 x dp=2 x
    tp=2, compiled once."""
    import jax

    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import virtual_mesh

    model, params, tokens, targets = _gpt_inputs()
    mesh = virtual_mesh(8, JMeshSpec(pp=2, dp=2, tp=2))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: model.loss_pp(
        p, tokens, targets, mesh, num_microbatches=GPT_M)))(params)
    return dict(params=params, tokens=tokens, targets=targets,
                loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})


# ---------------------------------------------------------------------------
# no processes


def test_stack_stages_equals_jax():
    """[L, ...] -> [P, L/P, ...] as JAX's, and the same ValueError when
    P does not divide L."""
    import jax.numpy as jnp

    from ray_tpu.parallel.pipeline import stack_stages as jstack
    from ray_tpu_torch.parallel.pipeline import stack_stages

    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(6, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(6, 5)).astype(np.float32)}
    for p in (1, 2, 3, 6):
        got = stack_stages({k: torch.from_numpy(v) for k, v in tree.items()},
                           p)
        want = jstack({k: jnp.asarray(v) for k, v in tree.items()}, p)
        for k in tree:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError) as jerr:
        jstack({"w": jnp.asarray(tree["w"])}, 4)
    with pytest.raises(ValueError) as err:
        stack_stages({"w": torch.from_numpy(tree["w"])}, 4)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the collectives' transposes, against jax.grad through a shard_map


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "chain"])
def test_collective_transposes_equal_jax(gang, ring):
    """A 4-rank pp axis: each rank's row a of a [4, 3] array, a replicated
    b [3] entering through pvary, z = a * b sent by ppermute (the ring, or
    the chain without the wrap, whose first rank receives zeros), and
    the psum of s^2 * c into a replicated output. The loss on every rank
    and the gradients of a (each rank its row) and of b (whole, on every
    rank) equal jax.grad's to 1e-6, relative and absolute."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.jax_compat import pvary as jpvary
    from ray_tpu.jax_compat import shard_map
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import build_mesh

    rng = np.random.default_rng(4)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    c = rng.normal(size=(3,)).astype(np.float32)
    perm = [(i, (i + 1) % 4) for i in range(4 if ring else 3)]

    def body(w, a, b, c, perm):
        import torch as t

        from ray_tpu_torch.parallel.mesh import PartitionSpec as Spec
        from ray_tpu_torch.parallel.sharding import MeshOwner, lower
        from ray_tpu_torch.parallel.sharding import lower_shard_map

        owner = MeshOwner({"pp": 4}, device_type="cpu")
        me = owner.coordinate()["pp"]
        a_row = t.tensor(a[me], requires_grad=True)
        b_full = t.tensor(b, requires_grad=True)

        def f(a_row, b_full):
            z = a_row * lower.pvary(b_full, "pp")
            s = lower.ppermute(z, "pp", perm)
            return lower.psum(s * s * t.from_numpy(c), "pp")

        out = lower_shard_map(f, owner, in_specs=(Spec("pp"), Spec()),
                              out_specs=Spec(),
                              axis_names=frozenset({"pp"}))(a_row, b_full)
        loss = out.sum()
        loss.backward()
        return (float(loss.detach()), a_row.grad.numpy(),
                b_full.grad.numpy())

    res = run_on(gang, body, a, b, c, perm)
    mesh = build_mesh(JMeshSpec(dp=1, pp=4), devices=jax.devices()[:4])

    def jloss(a, b):
        def f(a_loc, b):
            z = a_loc[0] * jpvary(b, ("pp",))
            s = jax.lax.ppermute(z, "pp", perm)
            return jax.lax.psum(s * s * c, "pp")
        out = shard_map(f, mesh=mesh, in_specs=(JP("pp"), JP()),
                        out_specs=JP(), axis_names=frozenset({"pp"}))(a, b)
        return jnp.sum(out)

    want, (da, db) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    for rank, (loss, ga, gb) in enumerate(res):
        np.testing.assert_allclose(loss, float(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ga, np.asarray(da)[rank], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gb, np.asarray(db), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# pipeline_spmd


def _toy_stage():
    """The toy's stage: tanh(h @ w_l) over the stage's layers."""
    def stage_fn(lp, x):
        for wl in lp["w"].unbind(0):
            x = torch.tanh(x @ wl)
        return x
    return stage_fn


def test_toy_pipeline_pp4_matches_jax_and_sequential(gang, jax_toy):
    """L=8, D=16 at pp=4 over 4 microbatches: every rank returns the last
    stage's outputs, equal to JAX pipeline_spmd's and to the sequential
    loop's to 1e-5."""
    def body(w, wt, x_mb, stage_fn):
        import torch as t

        from ray_tpu_torch.parallel.pipeline import (pipeline_spmd,
                                                     stack_stages)
        from ray_tpu_torch.parallel.sharding import MeshOwner

        owner = MeshOwner({"pp": 4}, device_type="cpu")
        stages = stack_stages({"w": t.from_numpy(wt)}, 4)
        return pipeline_spmd(stage_fn, stages, t.from_numpy(x_mb),
                             owner).numpy()

    w, x_mb = jax_toy["w"], jax_toy["x_mb"]
    res = run_on(gang, body, w, x_mb, _toy_stage())
    seq = torch.from_numpy(x_mb)
    for wl in torch.from_numpy(w):
        seq = torch.tanh(seq @ wl)
    for y in res:
        assert y.shape == (TOY_M, TOY_ROWS, TOY_D)
        np.testing.assert_allclose(y, jax_toy["y"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y, seq.numpy(), rtol=1e-5, atol=1e-5)


def test_toy_pipeline_grad_pp2_dp2_matches_jax(gang, jax_toy):
    """The gradient of sum(y^2) through pipeline_spmd at pp=2 x dp=2,
    with respect to the [L, D, D] weights before stack_stages and to the
    microbatches: the whole gradient on every rank, equal to jax.grad of
    JAX pipeline_spmd to 1e-5."""
    def body(w, wt, x_mb, stage_fn):
        import torch as t

        from ray_tpu_torch.parallel.pipeline import (pipeline_spmd,
                                                     stack_stages)
        from ray_tpu_torch.parallel.sharding import MeshOwner

        owner = MeshOwner({"pp": 2, "dp": 2}, device_type="cpu")
        wt = t.from_numpy(wt).requires_grad_()
        xt = t.from_numpy(x_mb).requires_grad_()
        y = pipeline_spmd(stage_fn, stack_stages({"w": wt}, 2), xt, owner)
        (y ** 2).sum().backward()
        return wt.grad.numpy(), xt.grad.numpy()

    res = run_on(gang, body, jax_toy["gw"], jax_toy["gx_mb"], _toy_stage())
    for dw, dx in res:
        np.testing.assert_allclose(dw, jax_toy["dw"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx, jax_toy["dx"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# GPT.loss_pp


def test_gpt_loss_pp_matches_jax_value_and_grad(gang, jax_gpt):
    """The tiny GPT (f32, mha_reference) at pp=2 x dp=2, M=2: the loss to
    2e-5 and every gradient to 2e-4 of JAX value_and_grad(loss_pp); every
    rank's loss and gradients bitwise equal to rank 0's."""
    def body(w, np_params, tokens, targets, m):
        import torch as t

        from ray_tpu_torch.models import GPT, GPTConfig
        from ray_tpu_torch.models.convert import gpt_params_from_numpy
        from ray_tpu_torch.parallel.sharding import MeshOwner

        owner = MeshOwner({"pp": 2, "dp": 2}, device_type="cpu")
        cfg = GPTConfig.tiny(dtype=t.float32, use_flash=False, remat=False)
        params = gpt_params_from_numpy(np_params, cfg, t.device("cpu"))
        for p in params.values():
            p.requires_grad_()
        loss = GPT(cfg).loss_pp(params, t.from_numpy(tokens).long(),
                                t.from_numpy(targets).long(), owner,
                                num_microbatches=m)
        loss.backward()
        return (loss.detach().numpy(),
                {k: p.grad.numpy() for k, p in params.items()})

    res = run_on(gang, body, jax_gpt["params"], jax_gpt["tokens"],
                 jax_gpt["targets"], GPT_M)
    loss0, grads0 = res[0]
    for loss, grads in res[1:]:
        assert np.array_equal(loss, loss0)
        assert grads.keys() == grads0.keys()
        for k in grads0:
            assert np.array_equal(grads[k], grads0[k]), k
    np.testing.assert_allclose(float(loss0), jax_gpt["loss"], rtol=0,
                               atol=2e-5)
    assert grads0.keys() == jax_gpt["grads"].keys()
    for k, want in jax_gpt["grads"].items():
        np.testing.assert_allclose(grads0[k], want, rtol=2e-4, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_gpt_loss_pp_at_pp4_equals_pp1(gang, dropout):
    """n_layer=4, tokens (4, 32), M=2: the port's loss_pp at pp=4 and at
    pp=1 (a pp=1 x dp=4 mesh) within 1e-6, loss and every gradient, with
    one generator seed for both; with dropout the loss differs from the
    same call without a generator (no dropout)."""
    def body(w, dropout, tokens, m):
        import torch as t

        from ray_tpu_torch.models import GPT, GPTConfig
        from ray_tpu_torch.parallel.sharding import MeshOwner

        cfg = GPTConfig.tiny(dtype=t.float32, use_flash=False, n_layer=4,
                             dropout=dropout)
        model = GPT(cfg)
        tok = t.from_numpy(tokens).long()
        tgt = t.roll(tok, -1, dims=1)
        out = {}
        for name, spec in (("pp4", {"pp": 4}), ("pp1", {"pp": 1, "dp": 4})):
            owner = MeshOwner(spec, device_type="cpu")
            init = t.Generator()
            init.manual_seed(0)
            params = model.init(init)
            for p in params.values():
                p.requires_grad_()
            gen = t.Generator()
            gen.manual_seed(7)
            loss = model.loss_pp(params, tok, tgt, owner,
                                 num_microbatches=m, generator=gen)
            loss.backward()
            out[name] = (float(loss.detach()),
                         {k: p.grad.numpy() for k, p in params.items()})
            if name == "pp1":
                with t.no_grad():
                    out["plain"] = float(model.loss_pp(
                        params, tok, tgt, owner, num_microbatches=m))
        return out

    tokens = np.random.default_rng(3).integers(0, 512, GPT_TOKENS)
    res = run_on(gang, body, dropout, tokens, GPT_M)
    for out in res:
        (l4, g4), (l1, g1) = out["pp4"], out["pp1"]
        assert np.isfinite(l4)
        np.testing.assert_allclose(l4, l1, rtol=0, atol=1e-6)
        for k in g1:
            np.testing.assert_allclose(g4[k], g1[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        if dropout:
            assert abs(l1 - out["plain"]) > 1e-3
        else:
            assert l1 == out["plain"]


@pytest.mark.parametrize("case", ["batch", "layers"])
def test_gpt_loss_pp_errors_equal_jax(gang, jax_gpt, case):
    """A batch of 4 into 3 microbatches, and 2 layers into 4 stages, raise
    the ValueError of JAX loss_pp on the same call at pp=4 (the layers'
    message names the first parameter in each package's own order)."""
    import jax.numpy as jnp

    from ray_tpu.models import GPT as JGPT
    from ray_tpu.models import GPTConfig as JGPTConfig
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import virtual_mesh

    m = 3 if case == "batch" else 4

    def body(w, case, m):
        import torch as t

        from ray_tpu_torch.models import GPT, GPTConfig
        from ray_tpu_torch.parallel.sharding import MeshOwner

        owner = MeshOwner({"pp": 4}, device_type="cpu")
        model = GPT(GPTConfig.tiny(dtype=t.float32, use_flash=False,
                                   remat=False))
        g = t.Generator()
        g.manual_seed(0)
        params = model.init(g)
        tok = t.zeros((4, 8), dtype=t.int64)
        try:
            model.loss_pp(params, tok, tok, owner, num_microbatches=m)
        except ValueError as e:
            return str(e)
        return None

    res = run_on(gang, body, case, m)
    jmodel = JGPT(JGPTConfig.tiny(dtype=jnp.float32, use_flash=False,
                                  remat=False))
    jparams = {k: jnp.asarray(v) for k, v in jax_gpt["params"].items()}
    tok = jnp.zeros((4, 8), jnp.int32)
    with pytest.raises(ValueError) as jerr:
        jmodel.loss_pp(jparams, tok, tok,
                       virtual_mesh(8, JMeshSpec(pp=4, dp=2)),
                       num_microbatches=m)
    want = str(jerr.value)
    if case == "batch":
        assert res == [want] * 4
    else:
        tail = want.split(": ", 1)[1]
        assert tail == "2 layers not divisible into 4 stages"
        assert all(r is not None and r.split(": ", 1)[1] == tail
                   for r in res), res


# ---------------------------------------------------------------------------
# training a tensor-parallel GPT


def _tp_rank_grads():
    """A function to run on a rank, made here so that it is pickled by
    value: ``grads(w, spec, np_params, tokens, targets, fn, remat,
    dropout=0.0, seed=None, fused=False)`` builds the tiny GPT (f32,
    mha_reference; ``fused``: with fused_entry_exit) on ``spec``'s mesh
    with this rank's tp shards of ``np_params`` and runs ``fn`` ("loss",
    "loss_chunked" or "loss_pp", over GPT_M microbatches or chunks) and
    its backward. It returns the loss, this rank's gradients, its mesh
    coordinate and the step's collective calls by name."""
    m = GPT_M

    def grads(w, spec, np_params, tokens, targets, fn, remat, dropout=0.0,
              seed=None, fused=False):
        import torch as t

        from ray_tpu_torch.models import GPT, GPTConfig
        from ray_tpu_torch.models.convert import gpt_params_from_numpy
        from ray_tpu_torch.parallel.sharding import MeshOwner, lower
        from ray_tpu_torch.parallel.sharding.tensor_parallel import (
            TensorParallel)

        owner = MeshOwner(spec, device_type="cpu")
        cfg = GPTConfig.tiny(dtype=t.float32, use_flash=False, remat=remat,
                             dropout=dropout, fused_entry_exit=fused)
        model = GPT(cfg, tp=TensorParallel.from_owner(owner, "tp"))
        params = model.shard_params(gpt_params_from_numpy(
            np_params, cfg, t.device("cpu")))
        for p in params.values():
            p.requires_grad_()
        gen = None
        if seed is not None:
            gen = t.Generator()
            gen.manual_seed(seed)
        tok = t.from_numpy(tokens).long()
        tgt = t.from_numpy(targets).long()
        lower.collective_stats(reset=True)
        if fn == "loss_pp":
            loss = model.loss_pp(params, tok, tgt, owner,
                                 num_microbatches=m, generator=gen)
        elif fn == "loss_chunked":
            loss = model.loss_chunked(params, tok, tgt, generator=gen,
                                      num_chunks=m)
        else:
            loss = model.loss(params, tok, tgt, generator=gen)
        loss.backward()
        calls = {k: v["calls"] for k, v in lower.collective_stats().items()}
        return (float(loss.detach()),
                {k: p.grad.numpy() for k, p in params.items()},
                owner.coordinate(), calls)
    return grads


def _shards_of(full_grads, coord):
    """Rank ``coord``'s tp shards (GPT.shard_param) of full gradients."""
    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.parallel.sharding.tensor_parallel import (
        TensorParallel)

    model = GPT(GPTConfig.tiny(dtype=torch.float32, use_flash=False),
                tp=TensorParallel(coord["tp"], 2, group=object()))
    return {k: model.shard_param(k, torch.tensor(v)).numpy()
            for k, v in full_grads.items()}


def _assert_tp_matches(res, want):
    """Every rank's loss within 2e-5 and gradients within 2e-4 of the JAX
    reference's, split through shard_param."""
    for loss, grads, coord, _ in res:
        np.testing.assert_allclose(loss, want["loss"], rtol=0, atol=2e-5)
        shards = _shards_of(want["grads"], coord)
        assert grads.keys() == shards.keys()
        for k, g in grads.items():
            np.testing.assert_allclose(g, shards[k], rtol=2e-4, atol=2e-4,
                                       err_msg=f"{k} at {coord}")


@pytest.mark.parametrize("fn", ["loss", "loss_chunked"])
def test_tp_gpt_loss_and_grads_match_jax(gang, jax_gpt_loss, fn):
    """GPT(tp=2) at tp=2 x dp=2, remat on: ``loss`` (the vocabulary-split
    cross entropy over the full logits) and ``loss_chunked`` (over M
    chunks) equal JAX value_and_grad(loss) of the unsplit model."""
    j = jax_gpt_loss
    res = run_on(gang, _tp_rank_grads(), {"tp": 2, "dp": 2}, j["params"],
                 j["tokens"], j["targets"], fn, True)
    assert sorted(c["tp"] for *_, c, _ in res) == [0, 0, 1, 1]
    _assert_tp_matches(res, j)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
def test_loss_pp_on_a_tp_gpt_matches_jax(gang, jax_gpt, remat):
    """loss_pp at pp=2 x tp=2 (dp -1), M=2: every rank's loss and tp
    shard's gradients equal JAX value_and_grad(loss_pp) (pp=2, dp=2,
    tp=2) to 2e-5 and 2e-4; the two ranks of each pp group (one tp
    coordinate) are bitwise equal."""
    j = jax_gpt
    res = run_on(gang, _tp_rank_grads(), {"pp": 2, "tp": 2, "dp": -1},
                 j["params"], j["tokens"], j["targets"], "loss_pp", remat)
    _assert_tp_matches(res, j)
    for tp in (0, 1):
        (l0, g0, *_), (l1, g1, *_) = [r for r in res if r[2]["tp"] == tp]
        assert l0 == l1
        for k in g0:
            assert np.array_equal(g0[k], g1[k]), (tp, k)


def test_loss_pp_tp_dropout_equals_pp1_tp1_and_remat_off(gang, jax_gpt):
    """Dropout 0.1 with one generator seed: loss_pp at pp=2 x tp=2 (remat
    on) equals the unsplit loss_pp at pp=1 (a pp=1 x dp=4 mesh) within
    1e-6, loss and every gradient's shard; remat on equals remat off
    bitwise, and calls every collective as often."""
    def body(w, grads, np_params, tokens, targets, m):
        import torch as t

        from ray_tpu_torch.models import GPT, GPTConfig
        from ray_tpu_torch.models.convert import gpt_params_from_numpy
        from ray_tpu_torch.parallel.sharding import MeshOwner

        spec = {"pp": 2, "tp": 2}
        on = grads(w, spec, np_params, tokens, targets, "loss_pp", True,
                   0.1, 7)
        off = grads(w, spec, np_params, tokens, targets, "loss_pp", False,
                    0.1, 7)
        cfg = GPTConfig.tiny(dtype=t.float32, use_flash=False, dropout=0.1,
                             remat=False)
        params = gpt_params_from_numpy(np_params, cfg, t.device("cpu"))
        for p in params.values():
            p.requires_grad_()
        gen = t.Generator()
        gen.manual_seed(7)
        owner = MeshOwner({"pp": 1, "dp": 4}, device_type="cpu")
        loss = GPT(cfg).loss_pp(params, t.from_numpy(tokens).long(),
                                t.from_numpy(targets).long(), owner,
                                num_microbatches=m, generator=gen)
        loss.backward()
        return on, off, (float(loss.detach()),
                         {k: p.grad.numpy() for k, p in params.items()})

    j = jax_gpt
    res = run_on(gang, body, _tp_rank_grads(), j["params"], j["tokens"],
                 j["targets"], GPT_M)
    for on, off, (loss1, grads1) in res:
        (l_on, g_on, coord, calls_on), (l_off, g_off, _, calls_off) = on, off
        assert l_on == l_off and calls_on == calls_off
        assert calls_on["tp.psum"] > 0 and calls_on["tp.enter.T"] > 0
        for k in g_on:
            assert np.array_equal(g_on[k], g_off[k]), k
        np.testing.assert_allclose(l_on, loss1, rtol=0, atol=1e-6)
        shards = _shards_of(grads1, coord)
        for k, g in g_on.items():
            np.testing.assert_allclose(g, shards[k], rtol=0, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the fused entry and exit under tp


@pytest.mark.parametrize("fn", ["loss", "loss_chunked"])
def test_tp_fused_gpt_matches_jax(gang, jax_gpt_fused_loss, fn):
    """GPT(tp=2, fused_entry_exit=True) at tp=2 x dp=2, remat off and on:
    every rank's loss within 2e-5 and gradient shards within 2e-4 of JAX
    value_and_grad(loss) on the unsplit fused model (the ln*, b_proj and
    b_out gradients whole on every rank, as shard_param leaves them);
    remat on calls every collective as often as remat off, and the fused
    exit's f32 sums and the fused entry's cotangent sums are among
    them."""
    def body(w, grads, np_params, tokens, targets, fn):
        spec = {"tp": 2, "dp": 2}
        return [grads(w, spec, np_params, tokens, targets, fn, remat,
                      fused=True) for remat in (False, True)]

    j = jax_gpt_fused_loss
    res = run_on(gang, body, _tp_rank_grads(), j["params"], j["tokens"],
                 j["targets"], fn)
    off, on = zip(*res)
    for runs in (off, on):
        _assert_tp_matches(runs, j)
    for (*_, calls_off), (*_, calls_on) in zip(off, on):
        assert calls_on == calls_off
        assert calls_on["tp.psum"] == 2 * 2 and calls_on["tp.enter.T"] > 0


def test_loss_pp_tp_fused_equals_pp1_tp1(gang, jax_gpt_fused_loss):
    """loss_pp at pp=2 x tp=2 with fused_entry_exit (remat on) equals the
    port's unsplit fused loss_pp at pp=1 (a pp=1 x dp=4 mesh) within 1e-6,
    the loss and every gradient's shard; the two ranks of each pp group
    are bitwise equal."""
    def body(w, grads, np_params, tokens, targets, m):
        import torch as t

        from ray_tpu_torch.models import GPT, GPTConfig
        from ray_tpu_torch.models.convert import gpt_params_from_numpy
        from ray_tpu_torch.parallel.sharding import MeshOwner

        split = grads(w, {"pp": 2, "tp": 2}, np_params, tokens, targets,
                      "loss_pp", True, fused=True)
        cfg = GPTConfig.tiny(dtype=t.float32, use_flash=False,
                             fused_entry_exit=True)
        params = gpt_params_from_numpy(np_params, cfg, t.device("cpu"))
        for p in params.values():
            p.requires_grad_()
        owner = MeshOwner({"pp": 1, "dp": 4}, device_type="cpu")
        loss = GPT(cfg).loss_pp(params, t.from_numpy(tokens).long(),
                                t.from_numpy(targets).long(), owner,
                                num_microbatches=m)
        loss.backward()
        return split, (float(loss.detach()),
                       {k: p.grad.numpy() for k, p in params.items()})

    j = jax_gpt_fused_loss
    res = run_on(gang, body, _tp_rank_grads(), j["params"], j["tokens"],
                 j["targets"], GPT_M)
    for (loss, grads, coord, _), (loss1, grads1) in res:
        np.testing.assert_allclose(loss, loss1, rtol=0, atol=1e-6)
        shards = _shards_of(grads1, coord)
        for k, g in grads.items():
            np.testing.assert_allclose(g, shards[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    for tp in (0, 1):
        (l0, g0, *_), (l1, g1, *_) = [r[0] for r in res
                                      if r[0][2]["tp"] == tp]
        assert l0 == l1
        for k in g0:
            assert np.array_equal(g0[k], g1[k]), (tp, k)
