"""The port's ring attention (ray_tpu_torch.ops.ring_attention) and GPT's
sequence-parallel path (``GPTConfig.seq_axis``, ``gpt_sp_loss``), on gloo
CPU ranks, held against the JAX package on the same numpy inputs (its
virtual 8-device CPU mesh):

- ``ring_attention`` at sp=4, causal and not, against JAX
  ``ring_attention`` under shard_map at sp=4 x tp=2 and against
  ``mha_reference`` (tests/test_ops.py:64-83): every rank's shard of the
  output to 2e-5;
- its gradients at sp=4 against ``jax.grad`` of JAX ``ring_attention``
  at dp=2 x sp=4 (tests/test_ops.py:85-100) and of ``mha_reference``:
  every rank's shard of dq, dk and dv to 2e-4;
- ``ring_attention_sharded`` over a dp=2 x sp=2 MeshOwner against
  ``mha_reference``, its causal mask left out by the planted control,
  which then differs;
- ``gpt_sp_loss`` (the sp training step of ``__graft_entry__.py``:
  params replicated, batch over dp, sequence over sp, positions global,
  the loss a mean over dp and sp) on the tiny GPT (f32, seq_axis "sp")
  at dp=2 x sp=2 against JAX ``value_and_grad`` of that program: the
  loss to 2e-5 and every parameter's gradient, whole and bitwise equal
  on every rank, to 2e-4;
- remat on equals remat off bit for bit, loss and gradients, and calls
  every collective as often: the ring's ppermutes (2 a ring step a
  layer), their transposes, the loss psum and the params' pvary sums;
- ``gpt_sp_loss`` without a seq axis raises.

One runtime and one gang of four rank actors serve the module; the
functions the gang runs are defined inside the tests (pickled by value).
Each JAX program is compiled once, in a module-scoped fixture, and the
JAX package is imported only inside the fixtures and tests that compare
with it.
"""
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel.mesh import MeshSpec

CPU = "cpu"
HALF_CPU = {"CPU": 0.5}
GANG_TIMEOUT_S = 180
# tests/test_ops.py's shapes: (B, S, H, D) forward and gradients
FWD_SHAPE, GRAD_SHAPE = (2, 64, 4, 16), (2, 32, 2, 8)
SP_TOKENS = (4, 64)            # __graft_entry__.py's sp pass


@pytest.fixture(scope="module")
def gang():
    from ray_tpu_torch.parallel.mesh_group import MeshGroup

    ray_tpu_torch.init(num_cpus=8)
    group = MeshGroup(4, spec=MeshSpec(dp=-1), device_type=CPU,
                      resources_per_worker=HALF_CPU)

    def one_thread(w):
        import torch as t

        t.set_num_threads(1)

    run_on(group, one_thread)
    yield group
    group.shutdown()
    ray_tpu_torch.shutdown()


def run_on(gang, fn, *args):
    """``fn(worker, *args)`` on every rank of the gang, within the
    module's timeout."""
    return ray_tpu_torch.get(gang.run_async(fn, *args),
                             timeout=GANG_TIMEOUT_S)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_ring():
    """JAX ring_attention under shard_map: the forward at sp=4 x tp=2,
    causal and not, and jax.grad of its sum at dp=2 x sp=4; the same of
    mha_reference; each compiled once."""
    import jax
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.jax_compat import shard_map
    from ray_tpu.ops import mha_reference
    from ray_tpu.ops.ring_attention import ring_attention
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import virtual_mesh

    spec = JP(("dp", "fsdp"), "sp", "tp", None)
    out = {}
    q, k, v = _qkv(4, FWD_SHAPE)
    mesh = virtual_mesh(8, JMeshSpec(dp=1, sp=4, tp=2))
    for causal in (True, False):
        fn = shard_map(lambda q, k, v, c=causal: ring_attention(
            q, k, v, axis_name="sp", causal=c), mesh=mesh,
            in_specs=(spec, spec, spec), out_specs=spec)
        out[causal] = np.asarray(jax.jit(fn)(q, k, v))
        out[("ref", causal)] = np.asarray(mha_reference(q, k, v,
                                                        causal=causal))
    gq, gk, gv = _qkv(5, GRAD_SHAPE)
    gmesh = virtual_mesh(8, JMeshSpec(dp=2, sp=4))
    ring = shard_map(lambda q, k, v: ring_attention(q, k, v, axis_name="sp"),
                     mesh=gmesh, in_specs=(spec, spec, spec), out_specs=spec)
    out["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda q, k, v: ring(q, k, v).sum(), argnums=(0, 1, 2)))(gq, gk, gv)]
    out["ref_grads"] = [np.asarray(g) for g in jax.grad(
        lambda q, k, v: mha_reference(q, k, v).sum(),
        argnums=(0, 1, 2))(gq, gk, gv)]
    return dict(out, qkv=(q, k, v), grad_qkv=(gq, gk, gv))


def _ring_body():
    """A rank function, made here so that it is pickled by value:
    ``body(w, q, k, v, causal, grads)`` runs the port's ring_attention at
    sp=4 on this rank's sequence shard of q, k, v and returns (rank index,
    output shard) or, with ``grads``, (rank index, [dq, dk, dv] of the
    sum of every rank's output, this rank's shards)."""
    def body(w, q, k, v, causal, grads):
        import torch as t

        from ray_tpu_torch.ops import ring_attention
        from ray_tpu_torch.parallel.mesh import PartitionSpec as Spec
        from ray_tpu_torch.parallel.sharding import (MeshOwner,
                                                     lower_shard_map)

        owner = MeshOwner({"sp": 4}, device_type="cpu")
        me = owner.coordinate()["sp"]
        n = q.shape[1] // 4
        xs = [t.from_numpy(a[:, me * n:(me + 1) * n]).requires_grad_(grads)
              for a in (q, k, v)]
        spec = Spec(None, "sp")
        fn = lower_shard_map(
            lambda q, k, v: ring_attention(q, k, v, "sp", causal), owner,
            in_specs=(spec, spec, spec), out_specs=spec)
        out = fn(*xs)
        if not grads:
            return me, out.detach().numpy()
        out.sum().backward()
        return me, [x.grad.numpy() for x in xs]
    return body


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax_and_dense(gang, jax_ring, causal):
    res = run_on(gang, _ring_body(), *jax_ring["qkv"], causal, False)
    n = FWD_SHAPE[1] // 4
    assert sorted(me for me, _ in res) == [0, 1, 2, 3]
    for me, out in res:
        rows = slice(me * n, (me + 1) * n)
        np.testing.assert_allclose(out, jax_ring[causal][:, rows],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out, jax_ring[("ref", causal)][:, rows],
                                   rtol=2e-5, atol=2e-5)


def test_ring_attention_grads_match_jax_and_dense(gang, jax_ring):
    res = run_on(gang, _ring_body(), *jax_ring["grad_qkv"], True, True)
    n = GRAD_SHAPE[1] // 4
    for me, grads in res:
        rows = slice(me * n, (me + 1) * n)
        for name, g, want, ref in zip("qkv", grads, jax_ring["grads"],
                                      jax_ring["ref_grads"]):
            np.testing.assert_allclose(g, want[:, rows], rtol=2e-4,
                                       atol=2e-4, err_msg=f"d{name}")
            np.testing.assert_allclose(g, ref[:, rows], rtol=2e-4,
                                       atol=2e-4, err_msg=f"d{name}")


def test_ring_attention_sharded_over_dp_and_sp(gang):
    """ring_attention_sharded over a dp=2 x sp=2 MeshOwner (each rank its
    batch half's sequence half) equals mha_reference to 2e-5; with the
    wrapped shards' mask left out (the planted control: future keys
    leak into the first half) it does not."""
    q, k, v = _qkv(6, FWD_SHAPE)

    def body(w, q, k, v):
        from unittest import mock

        import torch as t

        from ray_tpu_torch.ops import ring_attention_sharded
        from ray_tpu_torch.parallel.sharding import MeshOwner

        owner = MeshOwner({"dp": 2, "sp": 2}, device_type="cpu")
        c = owner.coordinate()
        b, s = q.shape[0] // 2, q.shape[1] // 2
        xs = [t.from_numpy(a[c["dp"] * b:(c["dp"] + 1) * b,
                             c["sp"] * s:(c["sp"] + 1) * s])
              for a in (q, k, v)]
        out = ring_attention_sharded(*xs, owner).numpy()
        # the control: every wrapped shard counted as valid (the ring's
        # mask is its one torch.where on a 0-dim condition)
        where = t.where
        with mock.patch("torch.where", lambda cond, a, b: a
                        if cond.dim() == 0 else where(cond, a, b)):
            leak = ring_attention_sharded(*xs, owner).numpy()
        return c, out, leak

    from ray_tpu_torch.ops import mha_reference

    ref = mha_reference(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    b, s = FWD_SHAPE[0] // 2, FWD_SHAPE[1] // 2
    for c, out, leak in run_on(gang, body, q, k, v):
        want = ref[c["dp"] * b:(c["dp"] + 1) * b,
                   c["sp"] * s:(c["sp"] + 1) * s]
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
        if c["sp"] == 0:
            assert np.abs(leak - want).max() > 1e-2
        else:
            np.testing.assert_allclose(leak, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# GPT's sequence-parallel training step


def _sp_inputs():
    """The JAX tiny GPT's init (seed 6, as __graft_entry__.py's sp pass)
    as numpy, and tokens from a numpy seed with their next-token
    targets."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import GPT as JGPT
    from ray_tpu.models import GPTConfig as JGPTConfig

    model = JGPT(JGPTConfig.tiny(dtype=jnp.float32, use_flash=False,
                                 remat=False, seq_axis="sp"))
    params = {k: np.asarray(v) for k, v in
              jax.jit(model.init)(jax.random.PRNGKey(6)).items()}
    tokens = np.random.default_rng(7).integers(
        0, model.config.vocab_size, SP_TOKENS).astype(np.int32)
    return model, params, tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_sp_step():
    """JAX value_and_grad of __graft_entry__.py's sp_loss (shard_map at
    MeshSpec(dp=2, sp=2), params replicated, positions global, pmean
    over dp and sp), compiled once."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.jax_compat import shard_map
    from ray_tpu.ops import cross_entropy_loss
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import build_mesh

    model, params, tokens, targets = _sp_inputs()
    mesh = build_mesh(JMeshSpec(dp=2, sp=2), devices=jax.devices()[:4])

    def sp_loss(params, tokens, targets):
        s_loc = tokens.shape[1]
        positions = jax.lax.axis_index("sp") * s_loc + jnp.arange(
            s_loc)[None, :]
        logits = model.apply(params, tokens, positions=positions)
        return jax.lax.pmean(cross_entropy_loss(logits, targets),
                             ("dp", "sp"))

    data = JP("dp", "sp")
    sharded = shard_map(sp_loss, mesh=mesh,
                        in_specs=(jax.tree.map(lambda _: JP(), params),
                                  data, data), out_specs=JP())
    loss, grads = jax.jit(jax.value_and_grad(sharded))(params, tokens,
                                                       targets)
    return dict(params=params, tokens=tokens, targets=targets,
                loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})


def _sp_body():
    """A rank function, made here so that it is pickled by value:
    ``body(w, np_params, tokens, targets, remats)`` runs gpt_sp_loss on
    the tiny GPT (f32, seq_axis "sp") at dp=2 x sp=2 with this rank's
    shard of the batch, once for each of ``remats``, and returns
    [(loss, gradients, collective calls)] in that order."""
    def body(w, np_params, tokens, targets, remats):
        import torch as t

        from ray_tpu_torch.models import GPT, GPTConfig
        from ray_tpu_torch.models.convert import gpt_params_from_numpy
        from ray_tpu_torch.models.gpt import gpt_sp_loss
        from ray_tpu_torch.parallel.sharding import MeshOwner, lower

        owner = MeshOwner({"dp": 2, "sp": 2}, device_type="cpu")
        c = owner.coordinate()
        b, s = tokens.shape[0] // 2, tokens.shape[1] // 2
        rows = slice(c["dp"] * b, (c["dp"] + 1) * b)
        cols = slice(c["sp"] * s, (c["sp"] + 1) * s)
        tok = t.from_numpy(tokens[rows, cols]).long()
        tgt = t.from_numpy(targets[rows, cols]).long()
        out = []
        for remat in remats:
            cfg = GPTConfig.tiny(dtype=t.float32, use_flash=False,
                                 remat=remat, seq_axis="sp")
            params = gpt_params_from_numpy(np_params, cfg, t.device("cpu"))
            for p in params.values():
                p.requires_grad_()
            lower.collective_stats(reset=True)
            loss = gpt_sp_loss(GPT(cfg), params, tok, tgt, owner,
                               num_chunks=2)
            loss.backward()
            calls = {k: v["calls"] for k, v in
                     lower.collective_stats().items()}
            out.append((float(loss.detach()),
                        {k: p.grad.numpy() for k, p in params.items()},
                        calls))
        return out
    return body


def test_gpt_sp_step_matches_jax(gang, jax_sp_step):
    j = jax_sp_step
    res = run_on(gang, _sp_body(), j["params"], j["tokens"], j["targets"],
                 (False,))
    loss0, grads0, _ = res[0][0]
    for (loss, grads, _), in res:
        assert loss == loss0
        for k in grads0:
            assert np.array_equal(grads[k], grads0[k]), k
    np.testing.assert_allclose(loss0, j["loss"], rtol=0, atol=2e-5)
    assert grads0.keys() == j["grads"].keys()
    for k, want in j["grads"].items():
        np.testing.assert_allclose(grads0[k], want, rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_gpt_sp_remat_on_equals_off(gang, jax_sp_step):
    """Remat on (the ring's received keys and values saved, as the
    all-reduce is) equals remat off bit for bit and calls each collective
    as often: 2 ring ppermutes a layer (n - 1 = 1 step of k and v) and
    their transposes, one loss psum and one params pvary sum a mesh
    axis."""
    j = jax_sp_step
    res = run_on(gang, _sp_body(), j["params"], j["tokens"], j["targets"],
                 (False, True))
    n_layer = len(j["params"]["w_qkv"])
    for (l_off, g_off, calls_off), (l_on, g_on, calls_on) in res:
        assert l_on == l_off
        for k in g_off:
            assert np.array_equal(g_on[k], g_off[k]), k
        assert calls_on == calls_off == {
            "ring": 2 * n_layer, "ring.T": 2 * n_layer, "loss": 2,
            "params.T": 2}


def test_gpt_sp_loss_needs_a_seq_axis():
    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.models.gpt import gpt_sp_loss

    model = GPT(GPTConfig.tiny(dtype=torch.float32))
    with pytest.raises(ValueError, match="seq_axis"):
        gpt_sp_loss(model, {}, torch.zeros(1, 4, dtype=torch.long),
                    torch.zeros(1, 4, dtype=torch.long), None)
