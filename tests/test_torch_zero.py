"""The port's ZeRO-sharded dp update and host collectives
(ray_tpu_torch.parallel.zero, ray_tpu_torch.parallel.collective) on the
CPU.

Held against the JAX package where the two compute the same thing:
- ``shard_bounds`` gives the reference's bounds exactly, and
  ``flatten_tree`` lays a nested tree out in the JAX package's order;
- under the int8 and e4m3 codecs a collective's wire payloads equal the
  JAX package's ``_encode`` bytewise on the same values.

And against plain arithmetic and itself: the collectives on 2 ranks equal
numpy sums for numpy and torch contributions (each returning the kind it
was given); the flatten/unflatten, merge/split and opt-state
flatten/unflatten round-trips; the pipeline engine's ZeRO update at
dp=2 x P=2 matches its replicated update (rtol 1e-6, as
tests/test_pipeline_cgraph.py:262-267) with 0.4-0.62 of the optimizer
bytes; ZeRO shards round-trip through a checkpoint and reshard across dp
widths bit-exactly; and the codec path keeps its f32 master shard.

The JAX package is imported only inside the tests that compare with it;
the actors are defined inside the tests, so no worker imports this
module.
"""
import functools
import itertools
import os
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel import collective, zero

CPU = "cpu"


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


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"b": {"w": rng.randn(3, 4).astype(np.float32),
                  "v": rng.randn(5).astype(np.float32)},
            "a": [rng.randn(2, 2).astype(np.float32),
                  rng.randn(1).astype(np.float32)],
            "c": rng.randn(7).astype(np.float32)}


_GROUP_IDS = itertools.count()


def _torch_tree(tree):
    return zero.tree_map(torch.from_numpy, tree)


# ---------------------------------------------------------------------------
# flat-vector layout


@pytest.mark.parametrize("n,world", [(10, 3), (7, 7), (5, 8), (0, 2),
                                     (1_000_003, 4), (12, 1)])
def test_shard_bounds_equal_reference(n, world):
    from ray_tpu.parallel.zero import shard_bounds as jbounds

    assert zero.shard_bounds(n, world) == jbounds(n, world)
    splits = np.array_split(np.arange(n), world)
    assert [(int(s[0]), int(s[-1]) + 1) if len(s) else None
            for s in splits] == [
        (lo, hi) if hi > lo else None for lo, hi in zero.shard_bounds(
            n, world)]


def test_flatten_tree_order_equals_jax():
    import jax.numpy as jnp

    from ray_tpu.parallel.zero import flatten_tree as jflatten

    tree = _tree()
    flat, spec = zero.flatten_tree(_torch_tree(tree))
    jflat, jspec = jflatten(zero.tree_map(jnp.asarray, tree))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert spec.size == jspec.size
    assert [tuple(s) for s in spec.shapes] == [tuple(s)
                                               for s in jspec.shapes]


def test_flatten_unflatten_round_trip():
    tree = _torch_tree(_tree())
    flat, spec = zero.flatten_tree(tree)
    assert flat.shape == (12 + 5 + 4 + 1 + 7,) and spec.dtype == torch.float32
    back = zero.unflatten_tree(flat, spec)
    leaves, treedef = zero.tree_flatten(tree)
    got, got_def = zero.tree_flatten(back)
    assert got_def == treedef and isinstance(back["a"], list)
    for a, b in zip(leaves, got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="uniform"):
        zero.flatten_tree({"a": torch.zeros(2), "b": torch.zeros(
            2, dtype=torch.float64)})
    with pytest.raises(ValueError, match="empty"):
        zero.flatten_tree({})


def _adam_state(params, steps=2, seed=1):
    """An Adam optimizer over ``params``' leaves after ``steps`` steps of
    random gradients -> (optimizer, its leaves)."""
    leaves = [t.clone() for t in zero.tree_flatten(params)[0]]
    opt = torch.optim.Adam(leaves, lr=1e-2)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for leaf in leaves:
            leaf.grad = torch.randn(leaf.shape, generator=g)
        opt.step()
    return opt, leaves


def test_opt_state_flatten_split_merge_round_trip():
    """The replicated state_dict flattens onto the flat layout, splits
    into dp shards on shard_bounds, merges back and unflattens to the
    state it came from, bit for bit; a flat-plane Adam resumed from the
    flattened state steps exactly as the tree-plane one."""
    params = _torch_tree(_tree())
    opt, leaves = _adam_state(params)
    state = zero.host_state_dict(opt)
    flat_params = {"p": params}
    flat_state = zero.flatten_opt_state(state, flat_params)
    _, spec = zero.flatten_tree(flat_params)
    assert list(flat_state["state"]) == [0]
    assert flat_state["state"][0]["exp_avg"].shape == (spec.size,)
    for world in (1, 2, 3):
        shards = zero.split_opt_state(flat_state, world, spec.size)
        assert [s["state"][0]["exp_avg"].numel() for s in shards] == [
            hi - lo for lo, hi in zero.shard_bounds(spec.size, world)]
        merged = zero.merge_opt_shards(shards)
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(merged["state"][0][k], flat_state["state"][0][k])
    back = zero.unflatten_opt_state(flat_state, spec)
    for i in range(len(leaves)):
        for k, v in state["state"][i].items():
            assert torch.equal(back["state"][i][k], v)
    # the flat plane steps as the tree plane: one more step each
    flat_p, _ = zero.flatten_tree({"p": zero.tree_unflatten(
        zero.tree_flatten(params)[1], leaves)})
    flat_leaf = flat_p.clone()
    flat_opt = torch.optim.Adam([flat_leaf], lr=1e-2)
    flat_opt.load_state_dict(flat_state)
    g = torch.Generator().manual_seed(9)
    grads = [torch.randn(l.shape, generator=g) for l in leaves]
    for leaf, gr in zip(leaves, grads):
        leaf.grad = gr
    opt.step()
    flat_leaf.grad = torch.cat([gr.reshape(-1) for gr in grads])
    flat_opt.step()
    assert torch.equal(flat_leaf, torch.cat([l.detach().reshape(-1)
                                             for l in leaves]))
    assert zero.tree_bytes(state) == zero.optimizer_state_bytes(opt)


# ---------------------------------------------------------------------------
# host collectives on two ranks


def _two_ranks(rt, fn, *args):
    """Run ``fn(rank, group, *args)`` on two actor ranks of one collective
    group -> [result of rank 0, result of rank 1]. Each call has a group
    (and so a rendezvous store) of its own name."""
    @ray_tpu_torch.remote
    class Rank:
        def __init__(self, rank, group):
            from ray_tpu_torch.parallel import collective as coll

            self.rank, self.name = rank, group
            # held for the actor's life; close() releases it
            self.group = coll.create_collective_group(2, rank,
                                                      group_name=group)

        def run(self, fn, *a):
            return fn(self.rank, self.name, *a)

        def close(self):
            from ray_tpu_torch.parallel import collective as coll

            if self.rank == 0:
                coll.destroy_collective_group(self.name)
            return True

    group = f"g2-{os.getpid()}-{next(_GROUP_IDS)}"
    ranks = [Rank.options(num_cpus=0.5).remote(r, group) for r in range(2)]
    try:
        return ray_tpu_torch.get([r.run.remote(fn, *args) for r in ranks],
                                 timeout=120)
    finally:
        ray_tpu_torch.get([r.close.remote() for r in ranks], timeout=60)
        for r in ranks:
            ray_tpu_torch.kill(r)


def test_collectives_equal_numpy_sums(rt):
    """allreduce / reducescatter / allgather / broadcast / reduce / send
    and recv over numpy and torch contributions, without a codec and
    under int8 and e4m3: the sums equal numpy's over the contributions
    (the codecs' over the dequantized payloads), every result keeps the
    kind it was given, and reducescatter cuts where np.array_split
    does. Contributions of 1 MiB and more travel by reference; the
    "big" ones here do."""
    def body(rank, g2):
        import numpy as np_
        import torch as torch_

        from ray_tpu_torch.parallel import collective as coll
        from ray_tpu_torch.parallel import quant

        rng = np_.random.RandomState(rank)
        a = rng.randn(1001).astype(np_.float32)
        big = rng.randn(300_001).astype(np_.float32)     # 1.2 MB
        out = {"a": a, "big": big}
        for kind in ("numpy", "torch"):
            x = a if kind == "numpy" else torch_.from_numpy(a.copy())
            out[kind] = {
                "allreduce": coll.allreduce(x, g2),
                "max": coll.allreduce(x, g2, op="max"),
                "reducescatter": coll.reducescatter(x, g2),
                "allgather": coll.allgather(x, g2),
                "broadcast": coll.broadcast(x, 1, g2),
                "reduce": coll.reduce(x, 0, g2)}
            xb = big if kind == "numpy" else torch_.from_numpy(big.copy())
            out[kind]["big"] = {
                "allreduce": coll.allreduce(xb, g2),
                "reducescatter": coll.reducescatter(xb, g2),
                "allgather": coll.allgather(xb, g2)}
            for codec in ("int8", "e4m3"):
                out[kind][codec] = {
                    "allreduce": coll.allreduce(x, g2, codec=codec),
                    "reducescatter": coll.reducescatter(x, g2,
                                                        codec=codec),
                    "mine": quant.dequantize(quant.quantize(x, codec))}
        if rank == 0:
            coll.send(a * 2, 1, g2, tag=3)
        else:
            out["recv"] = coll.recv(0, g2, tag=3)
        coll.barrier(g2)
        return out

    r0, r1 = _two_ranks(rt, body)
    a0, a1 = r0["a"], r1["a"]
    total = a0 + a1
    bounds = zero.shard_bounds(total.size, 2)
    np.testing.assert_array_equal(r1["recv"], a0 * 2)
    for kind, is_tensor in (("numpy", False), ("torch", True)):
        def val(x):
            assert isinstance(x, torch.Tensor) == is_tensor, (kind, type(x))
            return x.numpy() if is_tensor else np.asarray(x)

        for rank, res in enumerate((r0[kind], r1[kind])):
            np.testing.assert_array_equal(val(res["allreduce"]), total)
            np.testing.assert_array_equal(val(res["max"]),
                                          np.maximum(a0, a1))
            lo, hi = bounds[rank]
            np.testing.assert_array_equal(val(res["reducescatter"]),
                                          total[lo:hi])
            np.testing.assert_array_equal(val(res["allgather"][0]), a0)
            np.testing.assert_array_equal(val(res["allgather"][1]), a1)
            np.testing.assert_array_equal(val(res["broadcast"]), a1)
            for codec in ("int8", "e4m3"):
                deq = val(r0[kind][codec]["mine"]) + \
                    val(r1[kind][codec]["mine"])
                np.testing.assert_array_equal(
                    val(res[codec]["allreduce"]), deq)
                np.testing.assert_array_equal(
                    val(res[codec]["reducescatter"]), deq[lo:hi])
                assert np.abs(deq - total).max() < 0.1 * np.abs(total).max()
        np.testing.assert_array_equal(val(r0[kind]["reduce"]), total)
        np.testing.assert_array_equal(val(r1[kind]["reduce"]), a1)
        big_total = r0["big"] + r1["big"]
        big_bounds = zero.shard_bounds(big_total.size, 2)
        for rank, res in enumerate((r0[kind]["big"], r1[kind]["big"])):
            np.testing.assert_array_equal(val(res["allreduce"]), big_total)
            lo, hi = big_bounds[rank]
            np.testing.assert_array_equal(val(res["reducescatter"]),
                                          big_total[lo:hi])
            np.testing.assert_array_equal(val(res["allgather"][0]),
                                          r0["big"])
            np.testing.assert_array_equal(val(res["allgather"][1]),
                                          r1["big"])


def test_serialization_while_another_thread_imports_torch(monkeypatch):
    """The rendezvous store of the collectives imports torch the first
    time a rank sends it a tensor (a worker starts without torch). While
    that import runs on one of its threads, torch sits in sys.modules
    without its ``Tensor``: serializing any value there (another rank's
    gather reply of int8/e4m3 payloads) raised AttributeError, the reply
    and even its error report were lost, and that rank waited forever —
    test_collectives_equal_numpy_sums's timeouts under load. A module
    without ``Tensor`` stands for the half-imported torch here: values
    still serialize and round-trip, and the tensor checks of the codecs
    say "not a tensor"."""
    import types

    from ray_tpu_torch.cgraph import codec as wire_codec
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.parallel import quant

    a = np.random.RandomState(0).randn(1001).astype(np.float32)
    row = [quant.quantize(a, "e4m3"), quant.quantize(a * 2, "int8"), a]
    monkeypatch.setitem(sys.modules, "torch", types.ModuleType("torch"))
    back = serialization.loads(serialization.dumps(row))
    assert not quant._is_tensor(a) and not wire_codec._quantizable(7)
    monkeypatch.undo()
    for got, want in zip(back[:2], row[:2]):
        np.testing.assert_array_equal(got.payload, want.payload)
        np.testing.assert_array_equal(got.scales, want.scales)
    np.testing.assert_array_equal(back[2], a)


@pytest.mark.parametrize("codec", ["int8", "e4m3"])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_codec_payloads_equal_reference(codec, kind):
    """The wire record a rank contributes: payload and scales bytewise the
    JAX package's ``_encode`` on the same f32 values."""
    from ray_tpu.parallel import collective as jcoll

    a = np.random.RandomState(5).randn(3, 700).astype(np.float32)
    x = a if kind == "numpy" else torch.from_numpy(a.copy())
    mine = collective._encode(x, codec)
    ref = jcoll._encode(a, codec)
    assert mine.payload.tobytes() == ref.payload.tobytes()
    assert mine.scales.tobytes() == ref.scales.tobytes()
    assert mine.shape == ref.shape and mine.block == ref.block
    assert mine.tensor == (kind == "torch")
    assert collective._encode(x, None) is x


# ---------------------------------------------------------------------------
# ZeRO in the pipeline engine (dp=2 x P=2)


def _mlp(num_chunks=2, width=16, seed=0):
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
    rng = np.random.RandomState(7)
    xs = torch.from_numpy(rng.randn(16, width).astype(np.float32))
    ys = torch.from_numpy(rng.randn(16, width).astype(np.float32))
    return fns, params, list(xs.split(2)), list(ys.split(2))


@pytest.fixture(scope="module")
def zero_run(rt, tmp_path_factory):
    """The ZeRO engine at dp=2 x P=2, M=4: 4 Adam steps, a commit every
    2 -> (losses, opt-state bytes per stage, checkpoint dir, the
    step-2 checkpoint's per-stage params)."""
    from ray_tpu_torch.train import CompiledPipelineEngine

    fns, params, mbs, tgts = _mlp()
    d = str(tmp_path_factory.mktemp("zero") / "ck")
    eng = CompiledPipelineEngine(
        fns, params, functools.partial(torch.optim.Adam, lr=1e-2),
        num_microbatches=4, dp=2, channel_bytes=1 << 18,
        resources_per_stage={"CPU": 0.5}, checkpoint_dir=d,
        checkpoint_every=2, device=CPU)
    try:
        losses = [eng.step(mbs, tgts) for _ in range(4)]
        opt_bytes = eng.opt_state_bytes()
        reports = eng.last_reports
        eng.wait_for_checkpoints()
    finally:
        eng.shutdown()
    return {"losses": losses, "opt_bytes": opt_bytes, "dir": d,
            "reports": reports}


def test_zero_matches_replicated_and_shards_opt_state(rt, zero_run):
    """dp=2 x P=2: the ZeRO reduce-scatter/shard-update/all-gather
    trajectory matches the replicated allreduce update, and each replica
    holds ~1/dp of the optimizer-state bytes."""
    from ray_tpu_torch.train import CompiledPipelineEngine

    fns, params, mbs, tgts = _mlp()
    eng = CompiledPipelineEngine(
        fns, params, functools.partial(torch.optim.Adam, lr=1e-2),
        num_microbatches=4, dp=2, zero_update=False,
        channel_bytes=1 << 18, resources_per_stage={"CPU": 0.5},
        device=CPU)
    try:
        losses = [eng.step(mbs, tgts) for _ in range(3)]
        full = eng.opt_state_bytes()
        reports = eng.last_reports
        pids = {w["pid"] for row in eng.placement() for w in row}
    finally:
        eng.shutdown()
    np.testing.assert_allclose(zero_run["losses"][:3], losses, rtol=1e-6,
                               atol=1e-7)
    assert losses[-1] < losses[0]
    for sharded, whole in zip(zero_run["opt_bytes"], full):
        assert 0.4 < sharded / whole < 0.62, (sharded, whole)
    assert all(r["sync_breakdown"]["rs_ms"] > 0
               and r["sync_breakdown"]["ag_ms"] > 0
               for r in zero_run["reports"])
    assert all(r["sync_breakdown"]["allreduce_ms"] > 0 for r in reports)
    assert len(pids) == 4


def test_zero_sharded_opt_state_roundtrips_through_checkpoint(rt,
                                                              zero_run):
    """dp=2 ZeRO: each rank's 1/dp opt-state shard is persisted and
    restored shard-for-shard — the restored trajectory matches the
    uninterrupted run exactly; resharding the commit to dp=1 and back to
    dp=2 moves the shards bit-exactly."""
    import os

    from ray_tpu_torch.train import (CompiledPipelineEngine,
                                     reshard_checkpoint)

    fns, params, mbs, tgts = _mlp()
    ck = os.path.join(zero_run["dir"], "ckpt-00000002.pkl")
    ckpt = CompiledPipelineEngine.load_checkpoint(ck)
    assert ckpt["states"][0][0]["kind"] == "zero"
    fresh = CompiledPipelineEngine(
        fns, params, functools.partial(torch.optim.Adam, lr=1e-2),
        num_microbatches=4, dp=2, channel_bytes=1 << 18,
        resources_per_stage={"CPU": 0.5}, device=CPU)
    try:
        assert fresh.restore(ck) == 2
        replay = [fresh.step(mbs, tgts) for _ in range(2)]
    finally:
        fresh.shutdown()
    assert replay == zero_run["losses"][2:]

    one = reshard_checkpoint(ckpt, 1)
    assert one["engine"]["num_microbatches"] == 8
    assert one["states"][0][0]["kind"] == "full"
    assert sorted(one["states"][0][0]["opt"]["state"]) == [0, 1]
    two = reshard_checkpoint(one, 2)
    assert two["engine"]["num_microbatches"] == 4
    for r in range(2):
        for i in range(2):
            a = ckpt["states"][r][i]["opt"]["state"][0]
            b = two["states"][r][i]["opt"]["state"][0]
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), (r, i, k)
    with pytest.raises(ValueError, match="does not divide"):
        reshard_checkpoint(ckpt, 3)


def test_zero_updater_with_codec_keeps_f32_master(rt):
    """Two ZeroUpdater ranks under the int8 codec: the optimizer steps
    the f32 master shard (bitwise the plain Adam step on the dequantized
    mean gradient), the returned params are the master's int8 image, and
    opt_state() carries the master beside the optimizer state."""
    def body(rank, g2):
        import functools as ft

        import numpy as np_
        import torch as torch_

        from ray_tpu_torch.parallel import quant
        from ray_tpu_torch.parallel.zero import ZeroUpdater

        params = {"w": torch_.from_numpy(
            np_.random.RandomState(0).randn(600).astype(np_.float32))}
        grads = {"w": torch_.from_numpy(
            np_.random.RandomState(10 + rank).randn(600).astype(
                np_.float32))}
        upd = ZeroUpdater(ft.partial(torch_.optim.Adam, lr=0.1), 2, rank,
                          group_name=g2, grad_codec="int8").init(params)
        new = upd.update(params, grads)
        state = upd.opt_state()
        return {"new": new["w"], "master": state["master"],
                "tx": state["tx"], "bytes": upd.opt_state_bytes(),
                "g_deq": quant.dequantize(quant.quantize(grads["w"],
                                                         "int8"))}

    r0, r1 = _two_ranks(rt, body)
    w = torch.from_numpy(np.random.RandomState(0).randn(600).astype(
        np.float32))
    mean = (r0["g_deq"] + r1["g_deq"]) / 2
    ref = w.clone()
    opt = torch.optim.Adam([ref], lr=0.1)
    ref.grad = mean
    opt.step()
    master = torch.cat([r0["master"], r1["master"]])
    assert torch.equal(master, ref)
    from ray_tpu_torch.parallel import quant

    image = torch.cat([quant.dequantize(quant.quantize(r["master"], "int8"))
                       for r in (r0, r1)])
    assert torch.equal(r0["new"], image) and torch.equal(r1["new"], image)
    assert not torch.equal(r0["new"], master)
    assert r0["bytes"] == 2 * 300 * 4 + 4
    assert set(r0["tx"]["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}
