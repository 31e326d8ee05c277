"""The port's sharding layer (ray_tpu_torch.parallel.mesh,
ray_tpu_torch.parallel.sharding, ray_tpu_torch.parallel.mesh_group) and
tensor-parallel serving (``EngineConfig(tp > 1)``), on the CPU.

Held against the JAX package where the two compute the same thing:
- without processes: ``SpecLayout``'s family specs, ``spec_for_logical``,
  axis rebinding and ``prune_spec`` on the cases of
  tests/test_sharding.py:29-74, ``MeshSpec.resolve``,
  ``default_axis_rules`` and ``AxisRules.mesh_axes`` over a grid, and the
  four models' ``param_specs`` and ``param_shardings`` entry by entry;
- on gloo CPU ranks (one gang of four rank actors for the module):
  ``MeshOwner`` (tests/test_sharding.py:82-138), ``lower_jit`` bit for
  bit with column shards of (4, 8) and ``lower_shard_map``'s psum over 4
  shards (:145-190);
- the engine: at tp=2 and tp=4, gpt-tiny (2 heads: tp=4 pads) and
  llama-tiny (2 KV heads: tp=4 replicates them) on the JAX init's
  weights emit the JAX engine's greedy tokens (tp=1, and one JAX tp=2
  engine per model on 8 virtual CPU devices), on the prompts and config
  of tests/test_sharding.py:324-335; the tensor-parallel ``apply`` logits
  equal JAX ``apply``'s to 2e-5 (f32); the per-chip KV accounting, the
  tight-pool preemption case (:380-405) and the divisibility error hold.

The JAX package is imported only inside the tests that compare with it;
the functions the gangs run are defined inside the tests, so no worker
imports this module. Each gang costs its processes' start-up: the module
starts one gang for the owner checks and one per engine.
"""
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel.mesh import (AxisRules, MeshSpec,
                                         PartitionSpec as P,
                                         default_axis_rules, mesh_shape_for)
from ray_tpu_torch.parallel.sharding import (DEFAULT_LAYOUT, FsdpParams,
                                             FsdpPlane, SpecLayout,
                                             prune_spec)
from ray_tpu_torch.parallel.sharding.tensor_parallel import head_layout

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread in this process is as fast."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jspec(spec):
    """A JAX PartitionSpec as a plain tuple (the port's spec equals a
    tuple of the same entries)."""
    return tuple(spec)


# ---------------------------------------------------------------------------
# no processes: specs, rules, layouts


def test_family_specs_and_rebinding_equal_reference():
    from ray_tpu.parallel.sharding import SpecLayout as JSpecLayout

    for kw in ({}, {"tp_axis": "model"}, {"fsdp_axis": "zero",
                                          "data_axis": "batch"}):
        lay, jlay = SpecLayout(**kw), JSpecLayout(**kw)
        for fam in ("embeddings", "qkv_projection", "attn_output", "ffn_up",
                    "ffn_down", "norm", "activations", "kv_cache_blocks",
                    "flat_params", "replicated"):
            assert getattr(lay, fam)() == jspec(getattr(jlay, fam)()), fam
        for sharded in (False, True):
            assert lay.bias(sharded) == jspec(jlay.bias(sharded))
        for logical in [(None, "embed", "heads"), ("vocab", "embed"),
                        ("batch", "seq", "embed"), ("kv",), ("mlp", None),
                        ("expert", "stage"), (None, None), ("unknown",)]:
            assert lay.spec_for_logical(logical) == \
                jspec(jlay.spec_for_logical(logical)), (kw, logical)
    # the literal cases of tests/test_sharding.py:29-74
    lay = SpecLayout()
    assert lay.embeddings() == P("tp", None)
    assert lay.qkv_projection() == P(None, None, "tp")
    assert lay.attn_output() == P(None, "tp", None)
    assert lay.kv_cache_blocks() == P(None, "tp", None, None, None)
    assert lay.flat_params() == P("fsdp") and lay.norm() == P()
    assert SpecLayout(tp_axis="model").spec_for_logical(
        (None, "embed", "heads")) == P(None, None, "model")
    assert DEFAULT_LAYOUT == SpecLayout()


def test_partition_spec_equals_jax_spelling():
    from jax.sharding import PartitionSpec as JP

    cases = [(), ("tp",), ("tp", None), (None, "tp"), (("tp",),),
             (("fsdp", "tp"), None), ((),), (None,)]
    for a in cases:
        assert P(*a) == jspec(JP(*a)), a
        for b in cases:
            assert (P(*a) == P(*b)) == (JP(*a) == JP(*b)), (a, b)
            if P(*a) == P(*b):
                assert hash(P(*a)) == hash(P(*b))


@pytest.mark.parametrize("spec,sizes", [
    (("fsdp", "tp"), {"tp": 2}), ((("fsdp", "tp"), None), {"tp": 2}),
    (("fsdp",), {"tp": 2}), (("tp",), {"tp": 1}),
    ((("dp", "fsdp", "tp"), "sp"), {"dp": 2, "fsdp": 2, "sp": 1}),
    ((None, ("dp", "fsdp")), {"dp": 2, "fsdp": 4})])
def test_prune_spec_equals_reference(spec, sizes):
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.parallel.sharding import prune_spec as jprune

    assert prune_spec(P(*spec), sizes) == jspec(jprune(JP(*spec), sizes))


def test_mesh_spec_resolve_and_rules_equal_reference():
    from ray_tpu.parallel import mesh as jmesh

    specs = [dict(), dict(tp=2), dict(dp=2, tp=-1), dict(fsdp=-1, tp=2),
             dict(dp=2, fsdp=2, tp=2), dict(tp=3), dict(dp=-1, tp=-1),
             dict(slices=2, tp=2), dict(slices=3), dict(slices=0),
             dict(pp=2, dp=-1, sp=2)]
    for kw in specs:
        for n in (1, 2, 4, 6, 8, 12):
            try:
                want = jmesh.MeshSpec(**kw).resolve(n)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    MeshSpec(**kw).resolve(n)
                assert str(got.value) == str(e)
            else:
                assert MeshSpec(**kw).resolve(n) == want, (kw, n)
    for n, prefer in [(8, 4), (6, 4), (4, 8), (1, 2)]:
        assert MeshSpec.__eq__(mesh_shape_for(n, prefer),
                               MeshSpec(**{k: getattr(jmesh.mesh_shape_for(
                                   n, prefer), k) for k in ("dp", "tp")}))
    logicals = [("batch", "seq", "embed"), ("vocab", "embed"),
                (None, "embed", "heads"), ("expert", "embed", "mlp"),
                ("stage", "kv", None), (None, None), ("unknown", "heads")]
    for fsdp in (True, False):
        for multi in (True, False):
            rules = default_axis_rules(fsdp, multi)
            assert rules == jmesh.default_axis_rules(fsdp, multi)
            for logical in logicals:
                assert AxisRules(rules).mesh_axes(logical) == jspec(
                    jmesh.AxisRules(rules).mesh_axes(logical)), logical
    assert AxisRules().mesh_axes(("vocab", "embed")) == P("tp", "fsdp")


@pytest.mark.parametrize("family", ["gpt", "llama", "moe", "vit"])
def test_model_param_specs_equal_reference(family):
    """SpecLayout.param_specs and param_shardings' specs of the port's
    four models equal the JAX models', entry by entry."""
    from ray_tpu import models as jm
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu.parallel.sharding import SpecLayout as JSpecLayout
    from ray_tpu_torch import models as tm

    cls, cfg = {"gpt": ("GPT", "GPTConfig"), "llama": ("Llama", "LlamaConfig"),
                "moe": ("MoE", "MoEConfig"), "vit": ("ViT", "ViTConfig")}[
        family]
    if family in ("moe", "vit"):
        jmod = __import__(f"ray_tpu.models.{family}", fromlist=[cls])
        jmodel = getattr(jmod, cls)(getattr(jmod, cfg).tiny())
    else:
        jmodel = getattr(jm, cls)(getattr(jm, cfg).tiny())
    model = getattr(tm, cls)(getattr(tm, cfg).tiny())
    specs = SpecLayout().param_specs(model)
    jspecs = JSpecLayout().param_specs(jmodel)
    assert set(specs) == set(jspecs) == set(model.logical_axes())
    for name, spec in specs.items():
        assert spec == jspec(jspecs[name]), name
    for rules in (None, AxisRules(default_axis_rules(fsdp_enabled=False))):
        shardings = model.param_shardings(None, rules)
        jrules = jmesh.AxisRules(rules.rules) if rules else jmesh.AxisRules()
        for name, logical in jmodel.logical_axes().items():
            assert shardings[name].spec == jspec(jrules.mesh_axes(logical))


@pytest.mark.parametrize("n_head,n_kv,size", [
    (32, 32, 2), (2, 2, 4), (4, 2, 2), (4, 2, 4), (8, 2, 2), (12, 4, 8),
    (5, 5, 2), (6, 3, 4)])
def test_head_layout_covers_each_head_once(n_head, n_kv, size):
    """Every query head sits on exactly one rank; every rank has the same
    number of query and of KV heads; local query head j reads local KV
    head j // (Hl / KHl), which holds the KV head the GQA grouping gives
    it (repeat_interleave's)."""
    rep = n_head // n_kv
    seen = []
    layouts = [head_layout(n_head, n_kv, size, r) for r in range(size)]
    assert len({len(l.q_heads) for l in layouts}) == 1
    assert len({len(l.kv_heads) for l in layouts}) == 1
    for lay in layouts:
        hl, khl = len(lay.q_heads), len(lay.kv_heads)
        assert hl % khl == 0
        for j, g in enumerate(lay.q_heads):
            if g < 0:
                continue
            seen.append(g)
            assert lay.kv_heads[j // (hl // khl)] == g // rep
    assert sorted(seen) == list(range(n_head))


@pytest.mark.parametrize("n,size", [(10, 4), (8, 4), (3, 4), (11008, 2)])
def test_blocks_pad_past_the_end_with_zeros(n, size):
    """Each rank's block of ceil(n / size) rows, zero past n (a vocabulary
    or FFN width that does not divide by tp): the blocks concatenate to
    the rows and their zero padding, and take_heads zero-fills -1 heads."""
    from ray_tpu_torch.parallel.sharding.tensor_parallel import (
        TensorParallel)

    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) + 1
    blocks = [TensorParallel(r, size, group=object()).take_block(x, 0)
              for r in range(size)]
    per = -(-n // size)
    assert {tuple(b.shape) for b in blocks} == {(per, 3)}
    whole = torch.cat(blocks)
    assert torch.equal(whole[:n], x) and not whole[n:].any()
    heads = TensorParallel.take_heads(x.T, 1, [1, -1, 0], 1)
    assert torch.equal(heads[:, 0], x[1]) and not heads[:, 1].any()
    assert torch.equal(heads[:, 2], x[0])


def test_fsdp_plane_is_not_ported_yet():
    """Named before the plane was ported (ROADMAP A4.2): FsdpPlane and
    FsdpParams are now the plane's classes, and a plane over a mesh whose
    fsdp axis is under 2 raises a ValueError naming the axis. The plane
    on ranks is in tests/test_torch_fsdp.py."""
    from ray_tpu_torch.parallel.sharding import fsdp

    assert (FsdpPlane, FsdpParams) == (fsdp.FsdpPlane, fsdp.FsdpParams)

    class NoFsdpAxis:
        layout = DEFAULT_LAYOUT

        def axis_size(self, axis):
            return 1

    with pytest.raises(ValueError, match="'fsdp' axis of size >= 2, got 1"):
        FsdpPlane(NoFsdpAxis())


def test_gpt_fused_entry_exit_under_tp_raises():
    """A GPT with fused_entry_exit no longer raises on a tp rank (its
    tensor-parallel form, the fused entry on the rank's column shard and
    the row-parallel exit through the f32 partials, is ported and held to
    JAX in tests/test_torch_pipeline_spmd.py): at tp=2 it builds as rank
    1 of the split with its shards' shapes, which ln_matmul and the f32
    partial take; at tp=1 it is the unsplit model."""
    from ray_tpu_torch.models import GPT, GPTConfig
    from ray_tpu_torch.parallel.sharding.tensor_parallel import (
        TensorParallel)

    cfg = GPTConfig.tiny(dtype=torch.float32, fused_entry_exit=True)
    model = GPT(cfg)
    assert model.tensor_parallel(TensorParallel(0, 1)).tp is None
    rank1 = model.tensor_parallel(TensorParallel(1, 2, group=object()))
    assert rank1.tp.size == 2 and rank1.config.fused_entry_exit
    shards = rank1.shard_params(model.init(torch.Generator()))
    L, D, F = cfg.n_layer, cfg.d_model, cfg.d_ff
    assert shards["w_qkv"].shape == (L, D, 3 * D // 2)
    assert shards["w_proj"].shape == (L, D // 2, D)
    assert shards["w_fc"].shape == (L, D, F // 2)
    assert shards["w_out"].shape == (L, F // 2, D)
    assert shards["b_proj"].shape == shards["b_out"].shape == (L, D)


# ---------------------------------------------------------------------------
# with ranks: one gang of four gloo CPU rank actors


@pytest.fixture(scope="module")
def rt():
    # logical CPUs: every rank actor of the gang and of the engines (up
    # to 14 alive at once) holds some, and they mostly wait on each other
    # one intra-op thread in every worker the runtime starts (they
    # inherit OMP_NUM_THREADS), as in this process
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        runtime = ray_tpu_torch.init(num_cpus=16)
        yield runtime
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="class")
def gang(rt):
    """Four gloo CPU rank actors, for the tests of one class: its
    processes end before the engines' gangs start (the runtime keeps at
    most max(8, num_cpus) worker processes)."""
    from ray_tpu_torch.parallel.mesh_group import MeshGroup

    group = MeshGroup(4, spec=MeshSpec(dp=-1), device_type=CPU,
                      resources_per_worker={"CPU": 0.5})
    yield group
    group.shutdown()


class TestOnRanks:
    """MeshGroup, MeshOwner and the lowering on one gang."""

    def test_mesh_group_forms_one_world(self, gang):
        """Four ranks joined one gloo world at a free port chosen by rank 0;
        each built a MeshOwner over all four (dp=4); run and run_async reach
        every rank with its worker."""
        def body(w, k):
            import torch.distributed as dist

            o = w.mesh_owner
            return (dist.get_rank(), dist.get_world_size(),
                    dist.get_backend(), o.axis_sizes, o.describe(), k)

        out = gang.run(body, 7)
        assert [r[0] for r in out] == [0, 1, 2, 3]
        assert all(r[1] == 4 and r[2] == "gloo" and r[5] == 7 for r in out)
        assert out[0][3] == {"pp": 1, "dp": 4, "fsdp": 1, "ep": 1, "sp": 1,
                             "tp": 1}
        assert out[0][4]["devices"] == 4 and out[0][4]["platform"] == CPU
        assert gang.devices_per_worker == [1, 1, 1, 1]
        host, port = gang.coordinator.rsplit(":", 1)
        assert host == "127.0.0.1" and 0 < int(port) < 65536
        refs = gang.run_async(lambda w: w._process_id)
        assert ray_tpu_torch.get(refs) == [0, 1, 2, 3]


    def test_mesh_owner_on_ranks(self, gang):
        """tests/test_sharding.py:82-138 on four gloo ranks: tp_mesh and
        describe, the loud error past the world's ranks, the partial dict,
        pruning, place with per_device_bytes (each rank holds half of a
        [4, 8] f32 split by columns), validate_divisible."""
        def body(w):
            import torch as t

            from ray_tpu_torch.parallel.mesh import PartitionSpec as Spec
            from ray_tpu_torch.parallel.sharding import MeshOwner

            out = {}
            o = MeshOwner.tp_mesh(2, device_type="cpu")
            out["axes"], out["n"] = o.axis_sizes, o.num_devices
            out["describe"] = o.describe()
            for make in (lambda: MeshOwner.tp_mesh(999, device_type="cpu"),
                         lambda: MeshOwner.fsdp_mesh(999, device_type="cpu"),
                         lambda: MeshOwner({"tp": 999}, device_type="cpu")):
                try:
                    make()
                    out.setdefault("loud", []).append(None)
                except ValueError as e:
                    out.setdefault("loud", []).append(str(e))
            both = MeshOwner({"tp": 2, "dp": 2}, device_type="cpu")
            out["partial"] = (both.axis_size("tp"), both.axis_size("dp"),
                              both.num_devices, both.coordinate())
            out["pruned"] = (o.sharding(Spec("fsdp", "tp")).spec,
                             o.sharding(None).spec,
                             o.sharding((None, "embed", "heads")).spec)
            x = t.arange(32, dtype=t.float32).reshape(4, 8)
            if o.coordinate() is not None:
                placed = o.place({"x": x}, Spec(None, "tp"))
                out["placed"] = placed["x"]
                out["bytes"] = o.per_device_bytes(placed)
                out["tree"] = o.place([x, {"y": x}], [Spec("tp"), {"y": None}])
            o.validate_divisible("tp", 8, "heads")
            o.validate_divisible("absent", 3, "heads")
            try:
                o.validate_divisible("tp", 3, "heads")
                out["indivisible"] = None
            except ValueError as e:
                out["indivisible"] = str(e)
            return out

        res = gang.run(body)
        x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
        for rank, r in enumerate(res):
            assert r["axes"] == {"tp": 2} and r["n"] == 2
            assert r["describe"]["devices"] == 2
            assert r["describe"]["axes"] == {"tp": 2}
            assert all(e is not None and "devices" in e for e in r["loud"])
            assert r["partial"][:3] == (2, 2, 4)
            assert r["pruned"] == (P(None, "tp"), P(), P(None, None, "tp"))
            assert "heads" in r["indivisible"]
            if rank < 2:
                assert torch.equal(r["placed"], x[:, 4 * rank:4 * rank + 4])
                assert r["bytes"] == {rank: x.numel() * 4 // 2}
                assert torch.equal(r["tree"][0], x[2 * rank:2 * rank + 2])
                assert torch.equal(r["tree"][1]["y"], x)
            else:
                assert "placed" not in r
        # the partial dict's ranks: dp-major, as the JAX mesh lays them out
        assert [r["partial"][3] for r in res] == [
            {"pp": 0, "dp": d, "fsdp": 0, "ep": 0, "sp": 0, "tp": t_}
            for d in range(2) for t_ in range(2)]


    def test_lower_jit_matches_unsharded_bitwise(self, gang):
        """tanh(x @ w) with w split by columns over tp=2 (DTensor semantics):
        each rank's output is its (4, 8) column shard, and the shards equal
        the unsharded result bit for bit (tests/test_sharding.py:145-162)."""
        def body(w):
            import torch as t

            from ray_tpu_torch.parallel.mesh import PartitionSpec as Spec
            from ray_tpu_torch.parallel.sharding import MeshOwner, lower_jit

            o = MeshOwner.tp_mesh(2, device_type="cpu")
            if o.coordinate() is None:
                return None
            g = t.Generator().manual_seed(0)
            wt = t.randn(8, 16, generator=g)
            x = t.randn(4, 8, generator=g)

            def fn(w_, x_):
                return t.tanh(x_ @ w_)

            lowered = lower_jit(fn, o, in_specs=(Spec(None, "tp"), Spec()),
                                out_specs=Spec(None, "tp"))
            return lowered(o.place(wt, Spec(None, "tp")), x), fn(wt, x)

        res = gang.run(body)
        assert res[2] is None and res[3] is None
        want = res[0][1]
        assert {tuple(r[0].shape) for r in res[:2]} == {(4, 8)}
        assert torch.equal(torch.cat([res[0][0], res[1][0]], dim=1), want)


    def test_lower_shard_map_psum_and_unbound_axes(self, gang):
        """psum over 4 shards of arange(8) (tests/test_sharding.py:164-178):
        every shard sees the cross-shard sum; a collective over an axis the
        call does not bind, or outside any body, raises."""
        def body(w):
            import torch as t

            from ray_tpu_torch.parallel.mesh import PartitionSpec as Spec
            from ray_tpu_torch.parallel.sharding import MeshOwner, lower
            from ray_tpu_torch.parallel.sharding import lower_shard_map

            o = MeshOwner.tp_mesh(4, device_type="cpu")
            prog = lower_shard_map(lambda x: lower.psum(x, "tp"), o,
                                   in_specs=(Spec("tp"),), out_specs=Spec("tp"),
                                   axis_names=frozenset({"tp"}))
            x = t.arange(8, dtype=t.float32)
            got = prog(o.place(x, Spec("tp")))
            extra = {}
            idx = lower_shard_map(lambda x: (lower.axis_index("tp"),
                                             lower.all_gather(x, "tp",
                                                              tiled=True)),
                                  o, in_specs=(Spec("tp"),), out_specs=Spec())
            extra["index"], extra["gathered"] = idx(o.place(x, Spec("tp")))
            both = MeshOwner({"dp": 2, "tp": 2}, device_type="cpu")
            bad = lower_shard_map(lambda x: lower.psum(x, "dp"), both,
                                  in_specs=(Spec(),), out_specs=Spec(),
                                  axis_names=frozenset({"tp"}))
            for name, call in (("unbound", lambda: bad(x)),
                               ("outside", lambda: lower.psum(x, "tp"))):
                try:
                    call()
                    extra[name] = None
                except (ValueError, RuntimeError) as e:
                    extra[name] = f"{type(e).__name__}: {e}"
            return got, extra

        res = gang.run(body)
        x = np.arange(8, dtype=np.float32)
        want = (x.reshape(4, 2).sum(0)[None, :] * np.ones((4, 1))).reshape(8)
        got = torch.cat([r[0] for r in res]).numpy()
        np.testing.assert_allclose(got, want)
        for rank, (_, extra) in enumerate(res):
            assert extra["index"] == rank
            assert torch.equal(extra["gathered"], torch.arange(8.0))
            assert extra["unbound"].startswith("ValueError") and \
                "'dp'" in extra["unbound"]
            assert extra["outside"].startswith("RuntimeError")


    def test_meshes_shardings_and_constraints(self, gang):
        """build_mesh over a dp x tp spec, the multislice mesh (an
        outermost "slice" axis), virtual_mesh, from_mesh, the owner's
        param_shardings (pruned to the mesh's axes), named_sharding's and
        logical_to_mesh's DTensor placements, and shard_constraint laying a
        replicated tensor out by its logical axes."""
        def body(w):
            import torch as t
            from torch.distributed.tensor import Replicate, Shard

            from ray_tpu_torch.models import Llama, LlamaConfig
            from ray_tpu_torch.parallel import mesh as pm
            from ray_tpu_torch.parallel.sharding import MeshOwner

            out = {}
            m = pm.build_mesh(pm.MeshSpec(dp=2, tp=2), device_type="cpu")
            out["shape"] = (tuple(m.mesh_dim_names), tuple(m.shape))
            ms = pm.build_multislice_mesh(pm.MeshSpec(slices=2, tp=2),
                                          device_type="cpu")
            out["slices"] = (ms.mesh_dim_names[0], tuple(ms.shape),
                             ms.mesh.flatten().tolist())
            v = pm.virtual_mesh(2, {a: (2 if a == "tp" else 1)
                                    for a in pm.MESH_AXES},
                                device_type="cpu")
            out["virtual"] = tuple(v.shape)
            owner = MeshOwner.from_mesh(m, name="adopted")
            out["adopted"] = (owner.axis_sizes["tp"], owner.name)
            out["params"] = {n: sh.spec for n, sh in
                             owner.param_shardings(
                                 Llama(LlamaConfig.tiny())).items()}
            ns = pm.named_sharding(m, None, ("dp", "tp"))
            out["named"] = [type(p).__name__ + str(getattr(p, "dim", ""))
                            for p in ns.placements()]
            tree = pm.logical_to_mesh(None, {"w": (None, "heads")}, m)
            out["logical"] = tree["w"].spec
            x = t.arange(16.0).reshape(2, 8)
            d = pm.shard_constraint(x, m, None, "heads")
            out["constrained"] = (tuple(d.to_local().shape),
                                  d.full_tensor().equal(x),
                                  isinstance(d.placements[-1], Shard)
                                  and isinstance(d.placements[1],
                                                 Replicate))
            return out

        res = gang.run(body)
        for r in res:
            assert r["shape"] == (("pp", "dp", "fsdp", "ep", "sp", "tp"),
                                  (1, 2, 1, 1, 1, 2))
            assert r["slices"] == ("slice", (2, 1, 1, 1, 1, 1, 2),
                                   [0, 1, 2, 3])
            assert r["virtual"] == (1, 1, 1, 1, 1, 2)
            assert r["adopted"] == (2, "adopted")
            assert r["params"]["w_q"] == P(None, None, "tp")
            assert r["params"]["wte"] == P("tp")      # "fsdp" pruned
            assert r["params"]["attn_norm"] == P()
            assert r["named"] == ["Replicate", "Shard1", "Replicate",
                                  "Replicate", "Replicate", "Shard1"]
            assert r["logical"] == P(None, "tp")
            assert r["constrained"] == ((2, 4), True, True)

    def test_sharded_init_materializes_this_ranks_shards(self, gang):
        """sharded_init over an init that yields one full tensor at a time:
        each rank keeps exactly its slice of the seeded full init."""
        def body(w):
            import torch as t

            from ray_tpu_torch.parallel.mesh import PartitionSpec as Spec
            from ray_tpu_torch.parallel.sharding import MeshOwner, sharded_init

            o = MeshOwner.tp_mesh(4, device_type="cpu")

            def init(seed):
                g = t.Generator().manual_seed(seed)
                yield "w", t.randn(6, 8, generator=g)
                yield "b", t.randn(8, generator=g)

            shards = sharded_init(init, o, {"w": Spec(None, "tp"),
                                            "b": None})(3)
            return shards, dict(init(3))

        res = gang.run(body)
        for rank, (shards, full) in enumerate(res):
            assert torch.equal(shards["w"], full["w"][:, 2 * rank:2 * rank + 2])
            assert torch.equal(shards["b"], full["b"])


# ---------------------------------------------------------------------------
# the engine at tp > 1

PROMPTS = [[1, 5, 9, 2], [3, 4], [7, 8, 9, 10, 11, 12], [2, 9]]
ENGINE_KW = dict(max_batch=4, num_blocks=32, block_size=8,
                 max_blocks_per_seq=4, prefill_buckets=(8, 16))


def _port_pair(name):
    """((jax model, jax params), (port model, port params)) for a registry
    name, on the JAX init's weights."""
    from ray_tpu.serve.llm import build_model as jbuild_model
    from ray_tpu_torch.models import (GPT, GPTConfig, Llama, LlamaConfig,
                                      gpt_params_from_numpy,
                                      llama_params_from_numpy)

    jm, jp = jbuild_model(name)
    arrays = {n: np.asarray(a) for n, a in jp.items()}
    if name == "gpt-tiny":
        tm = GPT(GPTConfig.tiny(dtype=torch.float32, use_flash=False))
        tp = gpt_params_from_numpy(arrays, tm.config, CPU)
    else:
        tm = Llama(LlamaConfig.tiny(dtype=torch.float32, use_flash=False))
        tp = llama_params_from_numpy(arrays, tm.config, CPU)
    return (jm, jp), (tm, tp)


@pytest.fixture(scope="module")
def pairs():
    return {name: _port_pair(name) for name in ("gpt-tiny", "llama-tiny")}


@pytest.fixture(scope="class")
def engines(rt, pairs):
    """Port engines on the JAX weights, one per (model, tp), started on
    first use and shut down with the class that uses them."""
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    made = {}

    def get(name, tp):
        if (name, tp) not in made:
            m, params = pairs[name][1]
            made[name, tp] = LLMEngine(m, params, EngineConfig(
                **ENGINE_KW, tp=tp), name=f"t-{name}-tp{tp}")
        return made[name, tp]

    yield get
    for eng in made.values():
        eng.shutdown()


def _run(eng, prompts=PROMPTS, n=8):
    streams = [eng.add_request(p, max_tokens=n) for p in prompts]
    eng.run_until_idle(timeout=600)
    return [s.tokens() for s in streams]


class TestEngineTp:
    """The engine at tp=2 and tp=4 over one gang per (model, tp), alive
    for the tests of this class."""

    @pytest.mark.parametrize("model_name", ["gpt-tiny", "llama-tiny"])
    def test_tp_tokens_equal_jax_engine(self, model_name, pairs, engines):
        """tp=2 and tp=4 greedy decode of the port equals the JAX engine's
        at tp=1 and at tp=2, for the GPT family (2 heads: tp=4 pads) and GQA
        llama (2 KV heads: tp=4 holds each on two ranks); no block leaks."""
        from ray_tpu.serve.llm import EngineConfig as JEngineConfig
        from ray_tpu.serve.llm import LLMEngine as JLLMEngine

        jm, jp = pairs[model_name][0]
        want = {}
        for tp in (1, 2):
            jeng = JLLMEngine(jm, jp, JEngineConfig(**ENGINE_KW, tp=tp),
                              name=f"tj-{model_name}-tp{tp}")
            want[tp] = _run(jeng)
            jeng.pool.check_leaks()
        assert want[2] == want[1]
        for tp in (2, 4):
            eng = engines(model_name, tp)
            assert _run(eng) == want[1], tp
            eng.pool.check_leaks()
            assert eng.stats()["tp"] == tp

    @pytest.mark.parametrize("model_name", ["gpt-tiny", "llama-tiny"])
    def test_tp_apply_logits_match_jax(self, model_name, pairs, engines):
        """The tensor-parallel dense apply on each engine's ranks (tp=2 and
        tp=4) equals JAX apply on the same weights to 2e-5 (f32: summation
        order only), every rank gathering the full vocabulary."""
        import jax

        jm, jp = pairs[model_name][0]
        tokens = np.random.RandomState(1).randint(0, 512, (2, 16))
        want = np.asarray(jax.jit(jm.apply)(jp, tokens))

        def body(w, toks):
            import torch as t

            with t.no_grad():
                return w.model.apply(w.params, toks)

        for tp in (2, 4):
            out = engines(model_name, tp).mesh_group.run(
                body, torch.from_numpy(tokens))
            for logits in out:
                np.testing.assert_allclose(logits.numpy(), want, atol=2e-5,
                                           rtol=0)

    def test_kv_blocks_and_bytes_per_chip(self, engines):
        """The host pool is block-accounted per chip and balanced; each
        rank's KV cache holds its KV heads of every block: equal bytes, half
        of the unsplit cache's at tp=2; stats() carries tp and the pool's
        per-chip counts."""
        eng = engines("gpt-tiny", 2)
        streams = [eng.add_request(p, max_tokens=4) for p in PROMPTS]
        while not eng._running:
            eng.step()
        per_chip = eng.pool.used_per_shard()
        assert sum(per_chip) == eng.pool.used_count > 0
        assert max(per_chip) - min(per_chip) <= 1
        st = eng.stats()
        assert st["tp"] == 2 and st["kv_blocks_per_chip"] == per_chip
        byts = eng.kv_bytes_per_chip()
        c = eng.model.config
        full = 2 * c.n_layer * eng.config.num_blocks * eng.config.block_size \
            * c.n_head * c.head_dim * 4
        assert byts == {0: full // 2, 1: full // 2}
        assert st["kv_bytes_per_chip"] == {"0": full // 2, "1": full // 2}
        eng.run_until_idle(timeout=600)
        for s in streams:
            s.tokens()
        eng.pool.check_leaks()
        peak = eng.stats()["kv_blocks_peak_per_chip"]
        assert len(peak) == 2 and all(p >= u for p, u in zip(peak, per_chip))

    def test_tp_add_prefilled_and_server_from_seeded_shards(self, rt, pairs,
                                                            engines):
        """add_prefilled at tp=2 adopts full-head KV blocks (each rank keeps
        its KV heads) and decodes the tp=1 engine's tokens; LLMServer with
        engine_config={"tp": 2} builds each rank's shard from the seeded init
        (no full weights through the object store) and answers as the tp=1
        server of the same seed."""
        from ray_tpu_torch.serve.llm import (EngineConfig, LLMEngine,
                                             LLMServer)

        m, params = pairs["llama-tiny"][1]
        one = LLMEngine(m, params, EngineConfig(**ENGINE_KW))
        prompt = PROMPTS[2]
        want = _run(one, [prompt])[0]
        blocks = one.pool.alloc(1)
        row = torch.full((ENGINE_KW["max_blocks_per_seq"],), -1)
        row[0] = blocks[0]
        toks = torch.zeros((1, 8), dtype=torch.long)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        with torch.no_grad():
            logits, cache = one._prefill_fn(one.params, one._cache, toks,
                                            len(prompt), row)
        kv = {k: v[:, blocks] for k, v in cache.items()}
        eng = engines("llama-tiny", 2)
        st = eng.add_prefilled(prompt, kv, int(logits.argmax()), max_tokens=8)
        eng.run_until_idle(timeout=600)
        assert st.tokens() == want
        eng.pool.check_leaks()

        servers = [LLMServer("llama-tiny", device=CPU, engine_config=dict(
            ENGINE_KW, tp=tp)) for tp in (1, 2)]
        try:
            outs = [s({"tokens": prompt, "max_tokens": 8}) for s in servers]
            assert outs[0]["tokens"] == outs[1]["tokens"]
            assert all(o["finish_reason"] == "length" for o in outs)
            assert servers[1].stats()["tp"] == 2
            assert servers[1].engine.params.__class__.__name__ != "dict"
        finally:
            for s in servers:
                s.shutdown()


def test_tp_preemption_token_equivalent(rt, pairs):
    """A pool too small for both sequences at tp=2 forces preemption;
    greedy re-prefill reproduces the roomy tp=1 engine's tokens."""
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    m, params = pairs["gpt-tiny"][1]
    roomy = LLMEngine(m, params, EngineConfig(
        max_batch=2, num_blocks=32, block_size=4, max_blocks_per_seq=8,
        prefill_buckets=(8,)), name="t-roomy")
    prompts = [[1, 5, 9, 2, 7], [3, 4, 6, 8]]
    want = [_run(roomy, [p], 10)[0] for p in prompts]
    tight = LLMEngine(m, params, EngineConfig(
        max_batch=2, num_blocks=6, block_size=4, max_blocks_per_seq=8,
        prefill_buckets=(8, 16), tp=2), name="t-tight")
    try:
        assert _run(tight, prompts, 10) == want
        assert tight._total_preemptions >= 1
        tight.pool.check_leaks()
    finally:
        tight.shutdown()


def test_num_blocks_must_tile_tp(rt, pairs):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    m, params = pairs["gpt-tiny"][1]
    with pytest.raises(ValueError, match="divisible"):
        LLMEngine(m, params, EngineConfig(num_blocks=30, tp=4))
