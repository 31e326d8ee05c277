"""The port's fsdp plane, its in-program ZeRO and quantized scatter, and
fsdp stages in the compiled pipeline (ray_tpu_torch.parallel.sharding.fsdp,
.codec and .lower, ray_tpu_torch.parallel.zero.make_zero_update_spmd,
CompiledPipelineEngine(fsdp > 1)), on gloo CPU ranks.

The JAX package's ``FsdpPlane.gather``/``update`` and
``make_zero_update_spmd`` raise on JAX 0.9.0 (ROADMAP A4.2), so
the port is held to what the reference's own tests compare them with, and
to the JAX functions that do run:
- the plane (tests/test_sharding.py:198-281): a shard/gather round trip
  of the 561-element tree (16 x 33 + 33: pad 1 at world 2) bitwise with
  an even split; 3 chained Adam updates at world 2 and 4, every rank
  passing the gradients or rank 0 scattering them, bitwise equal to the
  port's replicated update, with per-rank bytes at most total/world + 64,
  and within 2 * lr * steps of JAX's replicated ``optax.adam`` on the
  same numpy tree and gradients (the tolerance of
  tests/test_torch_pipeline.py:246-253); a to_host/from_host resume,
  bitwise; a tp mesh rejected;
- the codec: ``quantize_blocks`` payloads and scales bitwise equal to
  JAX's for int8 and e4m3 at blocks 128 and 256 (all-zero blocks, odd
  row counts), and ``quantized_scatter_mean`` / ``lower_quantized_scatter``
  over a 4-rank gang equal to JAX's on the virtual CPU mesh, on the
  inputs of tests/test_collective_codec.py:200-242, to 1e-6;
- ``make_zero_update_spmd`` over a dp axis of 4 ranks: without a codec,
  two chained AdamW steps bitwise equal to the replicated update on the
  mean gradient (summed in rank order), and within rtol 1e-5 / atol 1e-6
  of JAX's replicated ``optax.adamw`` (tests/test_pipeline_cgraph.py:
  273-307); with int8 and e4m3, within 5e-2 of the replicated update
  (tests/test_collective_codec.py:245-292);
- the engine (tests/test_sharding.py:451-548, tests/test_elastic.py:
  244-280): fsdp=2 over 2 stages bitwise equal to run_reference_1f1b (3
  steps: losses and params) with an even split of each stage's bytes;
  save under fsdp=2 and restore into a fresh fsdp=2 engine, bitwise; a
  restore into fsdp=1 raises; the checkpoint resharded to dp=2 restores
  into a dp=2 x fsdp=2 engine, which, both replicas on the same
  microbatches, steps bitwise as the dp=1 run.

One runtime and one gang of four rank actors serve the module; the
functions the gang runs are defined inside the tests (pickled by value)
and import what they need, so no worker imports this module. The JAX
package is imported only inside the tests that compare with it.
"""
import functools

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.parallel.zero import tree_flatten
from ray_tpu_torch.train import CompiledPipelineEngine, run_reference_1f1b

CPU = "cpu"
SMALL_CHANNEL = 1 << 18
HALF_CPU = {"CPU": 0.5}


@pytest.fixture(scope="module")
def rt():
    # logical CPUs: the gang and the largest engine (8 ranks) side by side
    # one intra-op thread here and in every worker the runtime starts
    # (they inherit OMP_NUM_THREADS): the shapes are tiny, and the cores
    # go to the test files running beside this one
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        runtime = ray_tpu_torch.init(num_cpus=16)
        yield runtime
        ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gang(rt):
    from ray_tpu_torch.parallel.mesh_group import MeshGroup

    group = MeshGroup(4, spec=MeshSpec(dp=-1), device_type=CPU,
                      resources_per_worker=HALF_CPU)
    yield group
    group.shutdown()


def _plane_tree(seed=0, n=33):
    """The reference's 16 x n + n tree (561 elements at n=33), numpy."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(16, n).astype(np.float32),
            "b": np.zeros((n,), np.float32)}


def _plane_grads(tree, steps=3):
    return [{k: np.random.RandomState(100 + i).randn(*v.shape)
             .astype(np.float32) for k, v in tree.items()}
            for i in range(steps)]


def _replicated(tx, tree, grads_list):
    """The port's replicated update: ``tx`` over the tree's leaves, one
    step per gradient tree. Returns the params after each step."""
    params = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    leaves = tree_flatten(params)[0]
    opt = tx(leaves)
    out = []
    for grads in grads_list:
        for leaf, g in zip(leaves, tree_flatten(grads)[0]):
            leaf.grad = torch.from_numpy(g)
        opt.step()
        out.append({k: v.clone() for k, v in params.items()})
    return out


def _assert_trees_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and torch.equal(x, y), \
            (x - y).abs().max()


# ---------------------------------------------------------------------------
# the plane on the gang


def test_plane_shard_gather_roundtrip_bitwise(gang):
    """World 2 over the gang's first two ranks: pad 1, every rank's gather
    and rank 0's gather reassemble the tree bitwise, the shards are even,
    and rank 1's shard can stand in from rank 0 (src=0)."""
    tree = _plane_tree()

    def body(w, tree):
        import torch as t

        from ray_tpu_torch.parallel.sharding import FsdpPlane, MeshOwner

        owner = MeshOwner.fsdp_mesh(2, device_type="cpu")
        if owner.coordinate() is None:
            return None
        plane = FsdpPlane(owner)
        full = {k: t.from_numpy(v) for k, v in tree.items()}
        fp = plane.shard(full)
        from_src = plane.shard(full if w._process_id == 0 else None, src=0)
        return dict(pad=fp.pad, shard=fp.flat.clone(),
                    same=t.equal(fp.flat, from_src.flat),
                    everyone=plane.gather(fp), on0=plane.gather(fp, dst=0),
                    per=fp.nbytes_per_device())

    out = gang.run(body, tree)
    assert out[2] is None and out[3] is None
    assert [o["pad"] for o in out[:2]] == [1, 1]
    assert all(o["same"] for o in out[:2])
    for o in out[:2]:
        _assert_trees_equal(o["everyone"], tree)
    _assert_trees_equal(out[0]["on0"], tree)
    assert out[1]["on0"] is None
    assert out[0]["per"] == {0: 281 * 4} and out[1]["per"] == {1: 281 * 4}
    assert not out[1]["shard"][-1:].any()          # the padding
    flat = np.concatenate([tree["b"], tree["w"].ravel()])
    assert np.array_equal(np.concatenate(
        [o["shard"].numpy() for o in out[:2]])[:561], flat)


@pytest.mark.parametrize("world,src", [(2, None), (2, 0), (4, None),
                                       (4, 0)])
def test_plane_updates_bitwise_vs_replicated(gang, world, src):
    """3 chained Adam updates on the plane (every rank passing the full
    gradients, or rank 0 scattering them) equal the port's replicated
    update bitwise; each rank's params + moments are at most total/world
    + 64 bytes; the result is within 2 * lr * steps of JAX's replicated
    optax.adam."""
    import jax
    import jax.numpy as jnp
    import optax

    lr, steps = 1e-3, 3
    tree = _plane_tree()
    grads = _plane_grads(tree, steps)
    tx = functools.partial(torch.optim.Adam, lr=lr)

    def body(w, tree, grads, world, src, tx):
        import torch as t

        from ray_tpu_torch.parallel.sharding import FsdpPlane, MeshOwner

        owner = MeshOwner.fsdp_mesh(world, device_type="cpu")
        if owner.coordinate() is None:
            return None
        plane = FsdpPlane(owner, tx)
        me = w._process_id
        fp = plane.shard({k: t.from_numpy(v) for k, v in tree.items()})
        opt = plane.init_opt(fp)
        got = []
        for g in grads:
            g = {k: t.from_numpy(v) for k, v in g.items()}
            fp, opt = plane.update(
                fp, g if src is None or me == src else None, opt, src=src)
            got.append(plane.gather(fp))
        return dict(got=got, per=plane.per_device_bytes(fp, opt),
                    opt_bytes=plane.opt_state_bytes(opt))

    out = [o for o in gang.run(body, tree, grads, world, src, tx) if o]
    assert len(out) == world
    want = _replicated(tx, tree, grads)
    for o in out:
        for i in range(steps):
            _assert_trees_equal(o["got"][i], want[i])
    per = out[0]["per"]
    assert sorted(per) == list(range(world))
    assert all(o["per"] == per for o in out)
    assert max(per.values()) <= sum(per.values()) / world + 64
    # Adam's two moments of the padded vector and a step count a rank
    pad = (-561) % world
    assert out[0]["opt_bytes"] == 2 * 4 * (561 + pad) + 4 * world

    jtx = optax.adam(lr)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    jopt = jtx.init(jp)
    for g in grads:
        upd, jopt = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                               jopt, jp)
        jp = optax.apply_updates(jp, upd)
    for k in tree:
        np.testing.assert_allclose(out[0]["got"][-1][k].numpy(),
                                   np.asarray(jax.device_get(jp[k])),
                                   rtol=0, atol=2 * lr * steps, err_msg=k)


@pytest.mark.parametrize("src", [None, 0])
def test_plane_host_roundtrip_resumes_bitwise(gang, src):
    """to_host then from_host (every rank, or through rank 0) resumes the
    trajectory bitwise; the payload is the full tree and the optimizer
    state over the whole padded vector."""
    tree = _plane_tree()
    tx = functools.partial(torch.optim.Adam, lr=1e-3)

    def body(w, tree, tx, src):
        import torch as t

        from ray_tpu_torch.parallel.sharding import FsdpPlane, MeshOwner

        owner = MeshOwner.fsdp_mesh(2, device_type="cpu")
        if owner.coordinate() is None:
            return None
        plane = FsdpPlane(owner, tx)
        me = w._process_id
        fp = plane.shard({k: t.from_numpy(v) for k, v in tree.items()})
        opt = plane.init_opt(fp)
        g = {k: t.ones(v.shape) for k, v in tree.items()}
        fp, opt = plane.update(fp, g, opt)
        params_h, opt_h = plane.to_host(fp, opt, dst=src)
        if src is not None and me != src:
            assert params_h is None and opt_h is None
        fp2, opt2 = plane.from_host(params_h, opt_h, src=src)
        a, _ = plane.update(fp, g, opt)
        b, _ = plane.update(fp2, g, opt2)
        return dict(a=plane.gather(a), b=plane.gather(b),
                    moments=None if opt_h is None else
                    opt_h["state"][0]["exp_avg"].shape)

    out = [o for o in gang.run(body, tree, tx, src) if o]
    assert len(out) == 2
    for o in out:
        _assert_trees_equal(o["a"], o["b"])
    assert out[0]["moments"] == (562,)


def test_plane_rejects_a_mesh_without_fsdp(gang):
    def body(w):
        from ray_tpu_torch.parallel.sharding import FsdpPlane, MeshOwner

        owner = MeshOwner.tp_mesh(2, device_type="cpu")
        if owner.coordinate() is None:
            return None
        try:
            FsdpPlane(owner)
        except ValueError as e:
            return str(e)
        return "built"

    out = gang.run(body)
    assert out[2:] == [None, None]
    assert all("fsdp" in o for o in out[:2])


# ---------------------------------------------------------------------------
# the collectives of lower.py


_COLLECTIVES = [("psum_scatter", dict(scatter_dimension=1, tiled=True)),
                ("psum_scatter", dict(scatter_dimension=0, tiled=False)),
                ("all_to_all", dict(split_axis=1, concat_axis=2,
                                    tiled=True)),
                ("all_to_all", dict(split_axis=0, concat_axis=1,
                                    tiled=False))]


@pytest.mark.parametrize("name,kw", _COLLECTIVES)
def test_lower_collectives_equal_jax_lax(gang, name, kw):
    """psum_scatter and all_to_all over a 4-rank dp axis against
    jax.lax's in a shard_map on 4 of the virtual CPU devices, each rank's
    [4, 8, 6] block its own: all_to_all exactly, psum_scatter to 1e-6
    (its sum runs in rank order)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.jax_compat import shard_map
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import build_mesh
    from jax.sharding import PartitionSpec as JP

    xs = np.random.default_rng(3).normal(size=(4, 4, 8, 6)).astype(
        np.float32)

    def body(w, xs, name, kw):
        import torch as t

        from ray_tpu_torch.parallel.mesh import PartitionSpec as P
        from ray_tpu_torch.parallel.sharding import MeshOwner, lower_shard_map
        from ray_tpu_torch.parallel.sharding import lower

        owner = MeshOwner({"dp": 4}, device_type="cpu")
        me = owner.coordinate()["dp"]
        fn = lower_shard_map(lambda x: getattr(lower, name)(x, "dp", **kw),
                             owner, in_specs=(P("dp"),), out_specs=P("dp"),
                             axis_names=frozenset({"dp"}))
        return fn(t.from_numpy(xs[me]))

    got = np.stack([o.numpy() for o in gang.run(body, xs, name, kw)])
    mesh = build_mesh(JMeshSpec(dp=4), devices=jax.devices()[:4])
    op = getattr(jax.lax, name)
    want = np.asarray(jax.jit(shard_map(
        lambda x: op(x[0], "dp", **kw)[None], mesh=mesh,
        in_specs=(JP("dp"),), out_specs=JP("dp"),
        axis_names=frozenset({"dp"})))(jnp.asarray(xs)))
    assert got.shape == want.shape
    if name == "all_to_all":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the codec


@pytest.mark.parametrize("codec", ["int8", "e4m3"])
@pytest.mark.parametrize("block", [128, 256])
def test_quantize_blocks_bitwise_equal_jax(codec, block):
    """Payloads and scales bitwise the JAX package's, on rows of mixed
    scale with all-zero blocks, at an odd row count; dequantization
    equal too."""
    import jax.numpy as jnp

    from ray_tpu.parallel.sharding import codec as jcodec

    from ray_tpu_torch.parallel.sharding import codec as tcodec

    rng = np.random.default_rng(block)
    x = (rng.normal(size=(3, 6 * block))
         * rng.uniform(1e-3, 1e2, size=(3, 1))).astype(np.float32)
    x[0, :block] = 0.0
    x[2, 2 * block:3 * block] = 0.0
    jp, js = jcodec.quantize_blocks(jnp.asarray(x), codec, block)
    tp, ts = tcodec.quantize_blocks(torch.from_numpy(x), codec, block)
    jp, js = np.asarray(jp), np.asarray(js)
    assert tp.shape == jp.shape == (3, 6, block)
    assert tp.dtype == (torch.int8 if codec == "int8" else torch.uint8)
    assert np.array_equal(tp.numpy().view(np.uint8), jp.view(np.uint8))
    assert np.array_equal(ts.numpy().view(np.uint32), js.view(np.uint32))
    assert not ts[0, 0] and not ts[2, 2]
    jd = np.asarray(jcodec.dequantize_blocks(jnp.asarray(jp),
                                             jnp.asarray(js), codec))
    td = tcodec.dequantize_blocks(tp, ts, codec)
    assert np.array_equal(td.numpy(), jd)
    assert not td[0, :block].any()


@pytest.mark.parametrize("codec", ["int8", "e4m3"])
def test_quantized_scatter_mean_equals_jax(gang, codec):
    """quantized_scatter_mean over the 4-rank gang (a shard_map body on a
    dp axis) and lower_quantized_scatter, each rank its own row, against
    the JAX package's on 4 of the virtual CPU devices: the inputs of
    tests/test_collective_codec.py:200-242, to 1e-6."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.jax_compat import shard_map
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import build_mesh
    from ray_tpu.parallel.sharding import MeshOwner as JMeshOwner
    from ray_tpu.parallel.sharding.codec import (
        lower_quantized_scatter as jlower,
        quantized_scatter_mean as jqsm)
    from jax.sharding import PartitionSpec as JP

    g1 = np.random.default_rng(1).normal(size=(4, 1024)).astype(np.float32)
    g2 = np.random.default_rng(2).normal(size=(4, 512)).astype(np.float32)

    def body(w, g1, g2, codec):
        import torch as t

        from ray_tpu_torch.parallel.mesh import PartitionSpec as P
        from ray_tpu_torch.parallel.sharding import MeshOwner, lower_shard_map
        from ray_tpu_torch.parallel.sharding.codec import (
            lower_quantized_scatter, quantized_scatter_mean)

        owner = MeshOwner({"dp": 4}, device_type="cpu")
        me = owner.coordinate()["dp"]
        fn = lower_shard_map(
            lambda gs: quantized_scatter_mean(gs[0], "dp", 4, codec=codec,
                                              block=128),
            owner, in_specs=(P("dp"),), out_specs=P("dp"),
            axis_names=frozenset({"dp"}))
        lowered = lower_quantized_scatter(owner, "dp", codec=codec)
        return (fn(t.from_numpy(g1[me:me + 1])),
                lowered(t.from_numpy(g2[me:me + 1])))

    out = gang.run(body, g1, g2, codec)
    got1 = torch.cat([o[0] for o in out]).numpy()
    got2 = torch.cat([o[1] for o in out]).numpy()
    mesh = build_mesh(JMeshSpec(dp=4), devices=jax.devices()[:4])
    jfn = jax.jit(shard_map(
        lambda gs: jqsm(gs[0], "dp", 4, codec=codec, block=128), mesh=mesh,
        in_specs=(JP("dp"),), out_specs=JP("dp"),
        axis_names=frozenset({"dp"})))
    want1 = np.asarray(jfn(jnp.asarray(g1)))
    owner = JMeshOwner({"dp": 4}, devices=jax.devices()[:4], name="codec")
    want2 = np.asarray(jlower(owner, "dp", codec=codec)(g2))
    np.testing.assert_allclose(got1, want1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got2, want2, rtol=0, atol=1e-6)
    # and it is the mean, within the codec's step
    assert np.abs(got1 - g1.mean(0)).max() < (0.02 if codec == "int8"
                                              else 0.1)


# ---------------------------------------------------------------------------
# make_zero_update_spmd on the gang


def _spmd_zero_run(gang, tx, params, per, grad_codec):
    """Two chained make_zero_update_spmd steps over a dp=4 MeshOwner of
    the gang, rank r passing ``per[r]``; every rank's result."""
    def body(w, tx, params, per, grad_codec):
        import torch as t

        from ray_tpu_torch.parallel.sharding import MeshOwner
        from ray_tpu_torch.parallel.zero import make_zero_update_spmd

        owner = MeshOwner({"dp": 4}, device_type="cpu")
        me = owner.coordinate()["dp"]
        init_fn, update_fn = make_zero_update_spmd(
            tx, owner, "dp", grad_codec=grad_codec)
        p = {k: t.from_numpy(v) for k, v in params.items()}
        g = {k: t.from_numpy(v) for k, v in per[me].items()}
        opt = init_fn(p)
        p1, opt = update_fn(p, g, opt)
        p2, opt = update_fn(p1, g, opt)
        return p2

    return gang.run(body, tx, params, per, grad_codec)


def test_zero_update_spmd_bitwise_vs_replicated(gang):
    """grad_codec=None: two chained steps bitwise equal to the replicated
    AdamW update on the mean gradient (summed in rank order, then / 4) on
    every rank, and within rtol 1e-5 / atol 1e-6 of JAX's replicated
    optax.adamw on the same numpy inputs."""
    import jax.numpy as jnp
    import optax

    params = {"w": np.arange(20, dtype=np.float32).reshape(4, 5) / 20.0,
              "b": np.ones((3,), np.float32)}
    rng = np.random.RandomState(0)
    per = [{k: rng.randn(*v.shape).astype(np.float32)
            for k, v in params.items()} for _ in range(4)]
    tx = functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-4)
    out = _spmd_zero_run(gang, tx, params, per, None)

    mean = {k: (torch.from_numpy(per[0][k]) + torch.from_numpy(per[1][k])
                + torch.from_numpy(per[2][k]) + torch.from_numpy(per[3][k]))
            / 4 for k in params}
    want = _replicated(tx, params, [{k: v.numpy() for k, v in mean.items()}]
                       * 2)[-1]
    for o in out:
        _assert_trees_equal(o, want)

    jtx = optax.adamw(1e-2)
    gmean = {k: jnp.asarray(np.stack([p[k] for p in per]).mean(0))
             for k in params}
    ref = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jtx.init(ref)
    for _ in range(2):
        upd, jopt = jtx.update(gmean, jopt, ref)
        ref = optax.apply_updates(ref, upd)
    for k in params:
        np.testing.assert_allclose(out[0][k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("codec", ["int8", "e4m3"])
def test_zero_update_spmd_codec_tracks_replicated(gang, codec):
    """With a codec the gradient scatter is quantized: two Adam steps
    within 5e-2 of the replicated update (Adam's step is about lr
    whatever the codec noise), on every rank alike."""
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(32, 32)).astype(np.float32),
              "b": np.zeros((7,), np.float32)}
    per = [{k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in params.items()} for _ in range(4)]
    tx = functools.partial(torch.optim.Adam, lr=1e-2)
    out = _spmd_zero_run(gang, tx, params, per, codec)
    mean = {k: np.stack([p[k] for p in per]).mean(0) for k in params}
    want = _replicated(tx, params, [mean] * 2)[-1]
    for o in out:
        _assert_trees_equal(o, out[0])
    for k in params:
        assert (out[0][k] - want[k]).abs().max() < 5e-2, k
    # the wire was quantized: not the exact update
    assert not torch.equal(out[0]["w"], want["w"])


# ---------------------------------------------------------------------------
# the engine: fsdp stages in the compiled pipeline


def _mlp_chunks(num_chunks, width=8, seed=0):
    """The reference's tanh-MLP chunks (closures: sent by value)."""
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


_TX = functools.partial(torch.optim.Adam, lr=1e-2)


def _engine(**kw):
    fns, params = _mlp_chunks(2)
    return CompiledPipelineEngine(fns, params, _TX, channel_bytes=SMALL_CHANNEL,
                                  resources_per_stage=HALF_CPU, device=CPU,
                                  **kw)


@pytest.fixture(scope="module")
def fsdp_run(rt, tmp_path_factory):
    """An fsdp=2 engine over 2 stages: 2 steps, a checkpoint, a third
    step; its losses, final params, reports and placement."""
    mbs, tgts = _mlp_batches(4)
    eng = _engine(num_microbatches=4, fsdp=2,
                  checkpoint_dir=str(tmp_path_factory.mktemp("fsdp_ck")))
    try:
        losses = [eng.step(mbs, tgts) for _ in range(2)]
        path = eng.save_checkpoint(blocking=True)
        losses.append(eng.step(mbs, tgts))
        out = dict(losses=losses, params=eng.get_params(), path=path,
                   reports=list(eng.last_reports),
                   placement=eng.placement(),
                   opt_bytes=eng.opt_state_bytes())
    finally:
        eng.shutdown()
    return out


def test_engine_fsdp2_matches_reference_bit_for_bit(fsdp_run):
    """3 steps: losses and final params equal run_reference_1f1b exactly;
    each stage's params + moments split evenly over its two ranks, two
    processes, each holding its shards and moments on the CPU and
    launching no kernel."""
    fns, params = _mlp_chunks(2)
    mbs, tgts = _mlp_batches(4)
    ref_losses, ref_params = run_reference_1f1b(
        fns, params, _TX, [(mbs, tgts)] * 3, device=CPU)
    assert fsdp_run["losses"] == ref_losses
    _assert_trees_equal(fsdp_run["params"], ref_params)
    for r in fsdp_run["reports"]:
        assert r["fsdp"] == 2
        per = list(r["fsdp_bytes_per_chip"].values())
        assert len(per) == 2
        assert max(per) <= sum(per) / 2 + 64
        assert r["sync_breakdown"]["gather_ms"] > 0
    # 72 params a stage: 36 a rank, Adam's two moments and a step each
    assert fsdp_run["opt_bytes"] == [2 * (2 * 36 * 4 + 4)] * 2
    for st in fsdp_run["placement"][0]:
        ranks = st["fsdp_ranks"]
        assert len({r["pid"] for r in ranks}) == 2
        assert st["pid"] == ranks[0]["pid"]
        assert all(r["tensor_devices"] == ["cpu"] for r in ranks)
        assert [r["shard_bytes"] for r in ranks] == [36 * 4] * 2
        assert not any(any(r["kernel_launches"].values()) for r in ranks)


def test_engine_fsdp2_restores_into_fresh_engine_bitwise(rt, fsdp_run):
    """The step-2 checkpoint (kind "fsdp") restored into a fresh fsdp=2
    engine: its third step and params equal the uninterrupted run's."""
    from ray_tpu_torch._vendor import cloudpickle

    with open(fsdp_run["path"], "rb") as f:
        ckpt = cloudpickle.load(f)
    assert {st["kind"] for row in ckpt["states"] for st in row} == {"fsdp"}
    mbs, tgts = _mlp_batches(4)
    eng = _engine(num_microbatches=4, fsdp=2)
    try:
        assert eng.restore(fsdp_run["path"]) == 2
        assert eng.step(mbs, tgts) == fsdp_run["losses"][2]
        _assert_trees_equal(eng.get_params(), fsdp_run["params"])
    finally:
        eng.shutdown()


def test_engine_restore_of_fsdp_into_fsdp1_raises(rt, fsdp_run):
    eng = _engine(num_microbatches=4)
    try:
        with pytest.raises(ValueError, match="fsdp"):
            eng.restore(fsdp_run["path"])
    finally:
        eng.shutdown()


def test_engine_dp2_fsdp2_bitwise_and_resharded_checkpoint(rt, fsdp_run,
                                                           tmp_path):
    """dp=2 x fsdp=2 over 2 stages (8 ranks), both replicas on the same
    microbatches: 2 steps from the start equal the reference's bitwise;
    then the fsdp checkpoint resharded to dp=2 (kind "fsdp" on every new
    row) restores and steps bitwise as the dp=1 run's third step."""
    from ray_tpu_torch._vendor import cloudpickle
    from ray_tpu_torch.train import reshard_checkpoint

    fns, params = _mlp_chunks(2)
    mbs, tgts = _mlp_batches(4)
    with open(fsdp_run["path"], "rb") as f:
        resharded = reshard_checkpoint(cloudpickle.load(f), 2)
    assert [[st["kind"] for st in row] for row in resharded["states"]] \
        == [["fsdp"] * 2] * 2
    path = str(tmp_path / "resharded.pkl")
    with open(path, "wb") as f:
        cloudpickle.dump(resharded, f)
    eng = _engine(num_microbatches=4, dp=2, fsdp=2)
    try:
        losses = [eng.step(mbs + mbs, tgts + tgts) for _ in range(2)]
        assert eng.restore(path) == 2
        third = eng.step(mbs + mbs, tgts + tgts)
        after = eng.get_params()
        pids = {r["pid"] for row in eng.placement() for st in row
                for r in st["fsdp_ranks"]}
    finally:
        eng.shutdown()
    assert len(pids) == 8
    ref_losses, _ = run_reference_1f1b(fns, params, _TX, [(mbs, tgts)] * 2,
                                       device=CPU)
    assert losses == ref_losses
    assert third == fsdp_run["losses"][2]
    _assert_trees_equal(after, fsdp_run["params"])
