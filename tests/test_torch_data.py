"""The port's data plane (ray_tpu_torch.data) on the CPU.

Held to the JAX package where they compute the same thing without a
runtime: the block helpers, the logical plan's fusion into segments, the
optimizer's rules, the TFRecord codec and the executor's per-block steps
(the shuffle, sort and groupby map and reduce functions,
ray_tpu/data/executor.py:156-299) take the same numpy blocks and seeds
and must give equal blocks.

Then, over the port's runtime, the behaviours tests/test_data.py asserts
of the JAX package's data plane, with the same names: transforms,
streaming execution and backpressure, shuffles, sort, groupby, actor
pools, pipelines, windowed shuffles, reads and writes, and the trainer's
shards. What needs a package the port does not carry (pyarrow, pandas,
tensorflow, PIL, fsspec) is held to raise, naming it; webdataset images
are replaced by text members. ``iter_torch_batches`` follows the port's
device rule (None is the card), so these tests pass ``device="cpu"``.

One runtime for the module; UDFs are closures defined in the tests, so
they travel to the workers by value.
"""
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.context import DataContext


@pytest.fixture(scope="module")
def cluster():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt = ray_tpu_torch.init(num_cpus=8)
        yield rt
        ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the JAX package's plain functions, on the same inputs


def _blocks_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype == object:
            assert list(x) == list(y), k
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


def _sample_block(seed=0, n=23):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 5, n), "v": rng.standard_normal(n),
            "f": rng.standard_normal(n).astype(np.float32).round(1),
            "name": np.asarray([f"r{i}" for i in range(n)], object)}


def test_block_helpers_equal_jax():
    from ray_tpu.data import block as jb

    from ray_tpu_torch.data import block as pb

    b = _sample_block()
    items = [{"a": i, "b": [i, i + 1], "c": f"s{i}"} for i in range(5)]
    for items_in in (items, list(range(7)), [{"a": 1}, {"a": None}], []):
        _blocks_equal(pb.block_from_items(items_in),
                      jb.block_from_items(items_in))
    for batch in ({"x": np.arange(6), "y": torch.arange(6.0)},
                  [{"a": 1}, {"a": 2}], np.arange(4), None):
        _blocks_equal(pb.block_from_batch(batch), jb.block_from_batch(batch))
    idx = np.asarray([3, 0, 7, 7, 22])
    _blocks_equal(pb.block_select(b, idx), jb.block_select(b, idx))
    _blocks_equal(pb.block_slice(b, 4, 11), jb.block_slice(b, 4, 11))
    parts = [pb.block_slice(b, 0, 5), {}, pb.block_slice(b, 5, 23)]
    _blocks_equal(pb.block_concat(parts), jb.block_concat(parts))
    assert pb.block_num_rows(b) == jb.block_num_rows(b) == 23
    assert pb.block_size_bytes(b) == jb.block_size_bytes(b)
    assert pb.block_to_rows(b) == jb.block_to_rows(b)
    assert pb.block_to_rows({"item": np.arange(3)}) == \
        jb.block_to_rows({"item": np.arange(3)})
    for fmt in ("numpy", "rows"):
        got, want = pb.block_to_batch(b, fmt), jb.block_to_batch(b, fmt)
        assert type(got) is type(want)
    num = {"x": np.arange(6, dtype=np.float32), "y": np.arange(6)}
    got = pb.block_to_torch(num, dtypes={"y": torch.int32}, device="cpu")
    want = jb.block_to_torch(num, dtypes={"y": torch.int32}, device="cpu")
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k]) and got[k].dtype == want[k].dtype
    with pytest.raises(TypeError, match="object dtype"):
        pb.block_to_torch({"name": b["name"]}, device="cpu")


def _plan_ops(plan, actor_pool):
    """The same logical op list in either package's plan module."""
    def add(block):
        return {**block, "v": block["v"] + 1.0}

    def keep_even(block):
        return {k: c[block["k"] % 2 == 0] for k, c in block.items()}

    def scale(block):
        return {**block, "v": block["v"] * 3.0}

    ops = [plan.SourceOp(refs=[], name="src"),
           plan.MapOp(add, name="add", commutes=True),
           plan.MapOp(keep_even, name="filter", commutes=True),
           plan.AllToAllOp("random_shuffle", 3),
           plan.MapOp(scale, name="scale",
                      compute=(2, None) if actor_pool else None),
           plan.WindowedShuffleOp(window=2, seed=5),
           plan.MapOp(add, name="add2")]
    return ops


@pytest.mark.parametrize("actor_pool", [False, True])
def test_plan_segments_equal_jax(actor_pool):
    from ray_tpu.data import plan as jplan

    from ray_tpu_torch._vendor import cloudpickle
    from ray_tpu_torch.data import plan as pplan

    got = pplan.build_segments(_plan_ops(pplan, actor_pool))
    want = jplan.build_segments(_plan_ops(jplan, actor_pool))
    assert [(s["source"][0], s["identity"], s["compute"]) for s in got] == \
        [(s["source"][0], s["identity"], s["compute"]) for s in want]
    assert [s["source"][1] for s in got if s["source"][0] != "reads"] == \
        [s["source"][1] for s in want if s["source"][0] != "reads"]
    block = _sample_block(1)
    for g, w in zip(got, want):
        out_g, out_w = dict(block), dict(block)
        for fn in cloudpickle.loads(g["chain"]):
            out_g = fn(out_g)
        for fn in cloudpickle.loads(w["chain"]):
            out_w = fn(out_w)
        _blocks_equal(out_g, out_w)


def test_optimizer_rules_equal_jax():
    from ray_tpu.data import optimizer as jopt
    from ray_tpu.data import plan as jplan

    from ray_tpu_torch.data import optimizer as popt
    from ray_tpu_torch.data import plan as pplan

    def shapes(ops):
        return [(type(o).__name__, getattr(o, "name", ""),
                 getattr(o, "kind", None)) for o in ops]

    cases = []
    for plan in (pplan, jplan):
        ident = (lambda b: b)
        project = (lambda cols: [("read", tuple(cols))])
        cases.append([
            # a commuting filter after a shuffle moves ahead of it
            [plan.SourceOp(refs=[]), plan.AllToAllOp("random_shuffle"),
             plan.MapOp(ident, name="filter", commutes=True)],
            # map_batches never moves; sort never lets a map through
            [plan.SourceOp(refs=[]), plan.AllToAllOp("repartition", 4),
             plan.MapOp(ident, name="map_batches")],
            [plan.SourceOp(refs=[]), plan.AllToAllOp("sort", ("id", False)),
             plan.MapOp(ident, name="drop_columns", commutes=True)],
            # projection pushdown into a column-aware source
            [plan.SourceOp(read_fns=[b"r"], name="parquet",
                           project=project),
             plan.MapOp(ident, name="select_columns", commutes=True,
                        projection=["a", "c"]),
             plan.MapOp(ident, name="map")],
        ])
    for p_ops, j_ops in zip(*cases):
        p_out, p_rules = popt.optimize(p_ops)
        j_out, j_rules = jopt.optimize(j_ops)
        assert p_rules == j_rules
        assert shapes(p_out) == shapes(j_out)
        assert [getattr(o, "read_fns", None) for o in p_out] == \
            [getattr(o, "read_fns", None) for o in j_out]


def test_tfrecords_codec_equal_jax(tmp_path):
    from ray_tpu.data import tfrecords as jtf

    from ray_tpu_torch.data import tfrecords as ptf

    feats = [{"idx": i, "score": float(i) * 0.5, "name": f"row{i}".encode(),
              "vec": [1.0, 2.0, float(i)], "ids": [i, -i, 2 ** 40]}
             for i in range(6)]
    for f in feats:
        assert ptf.encode_example(f) == jtf.encode_example(f)
        enc = jtf.encode_example(f)
        assert ptf.decode_example(enc) == jtf.decode_example(enc)
    for data in (b"", b"abc", bytes(range(256)) * 3):
        assert ptf._crc32c(data) == jtf._crc32c(data)
        assert ptf._masked_crc(data) == jtf._masked_crc(data)
    recs = [ptf.encode_example(f) for f in feats]
    ptf.write_tfrecord_file(str(tmp_path / "p.tfrecord"), recs)
    jtf.write_tfrecord_file(str(tmp_path / "j.tfrecord"), recs)
    assert (tmp_path / "p.tfrecord").read_bytes() == \
        (tmp_path / "j.tfrecord").read_bytes()
    _blocks_equal(ptf.tfrecords_to_block(str(tmp_path / "j.tfrecord")),
                  jtf.tfrecords_to_block(str(tmp_path / "p.tfrecord")))


_SPECS = [("count", None), ("sum", "v"), ("mean", "v"), ("min", "f"),
          ("max", "v")]


def _steps(ex):
    """Each per-block executor step of one package on the same inputs."""
    blocks = [_sample_block(s) for s in range(3)]
    bounds = np.asarray([1, 3])
    out = {}
    for n in (1, 3):
        maps = [ex._shuffle_map(b, n, 100 + i) for i, b in enumerate(blocks)]
        out[f"shuffle_map{n}"] = maps
        parts = [m if n == 1 else m[0] for m in maps]
        out[f"shuffle_reduce{n}"] = ex._shuffle_reduce(7, *parts)
        g = [ex._groupby_map(b, "k", _SPECS, n) for b in blocks]
        out[f"groupby_map{n}"] = g
        out[f"groupby_reduce{n}"] = ex._groupby_reduce(
            "k", _SPECS, *[m if n == 1 else m[-1] for m in g])
    out["sort_sample"] = [ex._sort_sample(b, "v", 4) for b in blocks]
    smaps = [ex._sort_map(b, "k", bounds) for b in blocks]
    out["sort_map"] = smaps
    for desc in (False, True):
        out[f"sort_reduce{desc}"] = ex._sort_reduce(
            "k", desc, *[m[1] for m in smaps])
    out["sort_reduce_empty"] = ex._sort_reduce("k", False, {}, {})
    out["groupby_reduce_empty"] = ex._groupby_reduce("k", _SPECS, {})
    out["slice_concat"] = ex._slice_concat([(2, 1, 4), (0, 0, 3)], *blocks)
    out["merge"] = ex._merge_parts(*blocks)
    out["buckets"] = [ex._bucket_of(np.asarray(v), 5) for v in (
        np.arange(-3, 9), [0.0, -0.0, 1.5, np.nan], ["a", "b", "a"])]
    return out


def test_executor_block_steps_equal_jax():
    from ray_tpu.data import executor as jex

    from ray_tpu_torch.data import executor as pex

    got, want = _steps(pex), _steps(jex)
    assert list(got) == list(want)

    def same(a, b):
        if isinstance(a, dict):
            _blocks_equal(a, b)
        elif isinstance(a, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            np.testing.assert_array_equal(a, b)

    for name in got:
        same(got[name], want[name])


def test_byte_window_buffers_head_of_line_as_jax():
    """_ByteWindow on both sides: the same admissions and buffered bytes
    through the same calls."""
    from ray_tpu.data import executor as jex

    from ray_tpu_torch.data import executor as pex

    class _Ref:
        class id:  # noqa: N801 — mimics ObjectId attribute shape
            pass

    trace = []
    for ex in (pex, jex):
        bw = ex._ByteWindow(ex.ExecStats(), budget=100)
        seq = [bw.admit(0)]
        bw.on_complete(_Ref(), 0)
        seq += [bw._buffered, bw.admit(1)]
        bw.on_emit(0)
        seq += [bw._buffered, bw.admit(0)]
        bw.close()
        trace.append(seq)
    assert trace[0] == trace[1]


# ---------------------------------------------------------------------------
# behaviours over the port's runtime (tests/test_data.py's assertions)


def test_range_count_take(cluster):
    ds = rd.range(100, parallelism=4)
    assert ds.count() == 100
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    assert ds.schema() == {"id": "int64"}


def test_from_items_map_filter(cluster):
    ds = rd.from_items(list(range(50)), parallelism=4)
    out = ds.map(lambda x: x * 2).filter(lambda x: x % 4 == 0)
    vals = sorted(out.take_all())
    assert vals == [x * 2 for x in range(50) if (x * 2) % 4 == 0]


def test_map_batches_columnar(cluster):
    ds = rd.range(64, parallelism=2)

    def double(batch):
        return {"id": batch["id"], "sq": batch["id"] ** 2}

    out = ds.map_batches(double)
    total = out.sum("sq")
    assert total == sum(i * i for i in range(64))


def test_flat_map_and_add_column(cluster):
    ds = rd.from_items([1, 2, 3], parallelism=1)
    out = ds.flat_map(lambda x: [x, x])
    assert sorted(out.take_all()) == [1, 1, 2, 2, 3, 3]
    ds2 = rd.range(10, parallelism=1).add_column(
        "neg", lambda b: -b["id"]).drop_columns(["id"])
    assert sorted(r["neg"] for r in ds2.take_all()) == list(range(-9, 1))


def test_repartition(cluster):
    ds = rd.range(100, parallelism=7).repartition(4)
    mat = ds.materialize()
    assert mat.num_blocks() == 4
    assert mat.count() == 100
    # even split
    sizes = [len(list(s.iter_rows())) for s in mat.split_shards(4)]
    assert sum(sizes) == 100


def test_random_shuffle_preserves_multiset(cluster):
    ds = rd.range(200, parallelism=4).random_shuffle(seed=7)
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == list(range(200))
    # actually shuffled
    first = [r["id"] for r in rd.range(200, parallelism=4)
             .random_shuffle(seed=7).take(20)]
    assert first != list(range(20))


def test_iter_batches_sizes(cluster):
    ds = rd.range(100, parallelism=3)
    batches = list(ds.iter_batches(batch_size=32))
    sizes = [len(b["id"]) for b in batches]
    assert sum(sizes) == 100
    assert all(s == 32 for s in sizes[:-1]) or len(sizes) == 1
    dropped = list(ds.iter_batches(batch_size=32, drop_last=True))
    assert all(len(b["id"]) == 32 for b in dropped)


def test_limit_and_materialize(cluster):
    ds = rd.range(1000, parallelism=8).limit(17)
    assert len(ds.take_all()) == 17
    mat = rd.range(30, parallelism=3).materialize()
    assert mat.count() == 30
    assert mat.count() == 30  # re-iterable without re-reading


def test_actor_pool_class_udf(cluster):
    class AddConst:
        def __init__(self, c):
            self.c = c

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    ds = rd.range(40, parallelism=4).map_batches(
        AddConst, fn_constructor_args=(100,),
        compute=rd.ActorPoolStrategy(size=2))
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == list(range(100, 140))


def test_backpressure_caps_in_flight(cluster):
    ctx = DataContext.get_current()
    old = ctx.max_in_flight_blocks
    ctx.max_in_flight_blocks = 3
    try:
        ds = rd.range(60, parallelism=12).map_batches(
            lambda b: {"id": b["id"] + 1})
        assert ds.count() == 60
        stats = ds.stats()
        assert stats["peak_in_flight"] <= 3
        assert stats["tasks_submitted"] >= 12
    finally:
        ctx.max_in_flight_blocks = old


def test_read_csv_json(cluster, tmp_path):
    csv_path = os.path.join(tmp_path, "t.csv")
    with open(csv_path, "w") as f:
        f.write("a,b\n1,2\n3,4\n")
    ds = rd.read_csv(csv_path)
    rows = ds.take_all()
    assert len(rows) == 2 and rows[0]["a"] == 1.0

    json_path = os.path.join(tmp_path, "t.jsonl")
    with open(json_path, "w") as f:
        f.write('{"x": 1}\n{"x": 2}\n')
    assert rd.read_json(json_path).sum("x") == 3


def test_split_shards_for_train(cluster):
    ds = rd.range(64, parallelism=4)
    shards = ds.split_shards(2)
    assert len(shards) == 2
    counts = [s.count() for s in shards]
    assert sum(counts) == 64
    b = next(iter(shards[0].iter_batches(batch_size=8)))
    assert len(b["id"]) == 8


def test_sort(cluster):
    import numpy as np

    rng = np.random.default_rng(7)
    vals = rng.permutation(200).astype(np.int64)
    ds = rd.from_numpy({"v": vals}, parallelism=4).sort("v")
    out = np.asarray([r["v"] for r in ds.take_all()])
    np.testing.assert_array_equal(out, np.sort(vals))

    ds = rd.from_numpy({"v": vals}, parallelism=4).sort("v", descending=True)
    out = np.asarray([r["v"] for r in ds.take_all()])
    np.testing.assert_array_equal(out, np.sort(vals)[::-1])


def test_sort_constant_keys(cluster):
    """Skewed/constant sort keys leave range partitions empty — the
    reduce must hand back empty blocks, not crash (regression)."""
    import numpy as np

    vals = np.full(100, 5, np.int64)
    ds = rd.from_numpy({"v": vals}, parallelism=4).sort("v")
    out = np.asarray([r["v"] for r in ds.take_all()])
    np.testing.assert_array_equal(out, vals)


def test_groupby_aggregates(cluster):
    import numpy as np

    n = 300
    keys = np.arange(n) % 7
    vals = np.arange(n, dtype=np.float64)
    ds = rd.from_numpy({"k": keys, "v": vals}, parallelism=5)

    counts = {r["k"]: r["count()"] for r in ds.groupby("k").count().take_all()}
    sums = {r["k"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take_all()}
    means = {r["k"]: r["mean(v)"] for r in ds.groupby("k").mean("v").take_all()}
    mins = {r["k"]: r["min(v)"] for r in ds.groupby("k").min("v").take_all()}
    maxs = {r["k"]: r["max(v)"] for r in ds.groupby("k").max("v").take_all()}
    for k in range(7):
        mask = keys == k
        assert counts[k] == mask.sum()
        assert sums[k] == pytest.approx(vals[mask].sum())
        assert means[k] == pytest.approx(vals[mask].mean())
        assert mins[k] == vals[mask].min()
        assert maxs[k] == vals[mask].max()


def test_groupby_multi_aggregate_and_chain(cluster):
    import numpy as np

    keys = np.asarray([0, 1, 0, 1, 2])
    vals = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0])
    ds = rd.from_numpy({"k": keys, "v": vals}, parallelism=2)
    rows = (ds.groupby("k").aggregate(("count", None), ("sum", "v"))
            .sort("k").take_all())
    assert [(r["k"], r["count()"], r["sum(v)"]) for r in rows] == [
        (0, 2, 4.0), (1, 2, 6.0), (2, 1, 5.0)]


def test_iter_torch_batches(cluster):
    import numpy as np
    import torch

    ds = rd.from_numpy({"x": np.arange(32, dtype=np.float32),
                        "y": np.arange(32, dtype=np.int64)})
    total = 0
    for batch in ds.iter_torch_batches(batch_size=8, device="cpu"):
        assert isinstance(batch["x"], torch.Tensor)
        assert batch["x"].dtype == torch.float32
        assert batch["y"].dtype == torch.int64
        total += len(batch["x"])
    assert total == 32
    # dtype override
    b = next(ds.iter_torch_batches(batch_size=4, device="cpu",
                                   dtypes={"x": torch.float64,
                                           "y": torch.int32}))
    assert b["x"].dtype == torch.float64 and b["y"].dtype == torch.int32


def test_shard_iter_torch_batches(cluster):
    import numpy as np
    import torch

    ds = rd.from_numpy({"x": np.arange(20, dtype=np.float32)})
    shards = ds.split_shards(2)
    seen = 0
    for shard in shards:
        for batch in shard.iter_torch_batches(batch_size=5, device="cpu"):
            assert isinstance(batch["x"], torch.Tensor)
            seen += len(batch["x"])
    assert seen == 20


def test_push_based_shuffle_large_parallelism(cluster):
    """>merge-factor blocks route through the two-stage merge shuffle;
    the row multiset survives and the order actually changes."""
    import numpy as np

    n = 500
    vals = np.arange(n, dtype=np.int64)
    ds = (rd.from_numpy({"v": vals}, parallelism=20)
          .random_shuffle(seed=11))
    out = np.asarray([r["v"] for r in ds.take_all()])
    assert len(out) == n
    np.testing.assert_array_equal(np.sort(out), vals)  # nothing lost/duped
    assert not np.array_equal(out, vals)  # actually shuffled
    assert ds.num_blocks() == 20


def test_read_tfrecords_roundtrip(tmp_path, cluster):
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data.tfrecords import (decode_example,
                                              encode_example,
                                              write_tfrecord_file)

    # build two files of Examples with all three feature kinds
    for fi in range(2):
        recs = []
        for i in range(5):
            recs.append(encode_example({
                "idx": fi * 5 + i,
                "score": float(i) * 0.5,
                "name": f"row{fi}_{i}".encode(),
                "vec": [1.0, 2.0, float(i)],
            }))
        write_tfrecord_file(str(tmp_path / f"part{fi}.tfrecord"), recs)

    # low-level codec roundtrip
    ex = decode_example(encode_example({"a": 7, "b": 1.5, "c": b"xyz"}))
    assert ex["a"] == [7] and abs(ex["b"][0] - 1.5) < 1e-6
    assert ex["c"] == [b"xyz"]

    ds = rd.read_tfrecords(str(tmp_path))
    batches = list(ds.iter_batches(batch_size=None))
    block = {k: np.concatenate([b[k] for b in batches])
             for k in batches[0]}
    assert sorted(block["idx"].tolist()) == list(range(10))
    assert abs(float(block["score"].max()) - 2.0) < 1e-6
    assert set(len(v) for v in block["vec"]) == {3}


def test_read_tfrecords_detects_corruption(tmp_path, cluster):
    import pytest as _pytest

    from ray_tpu_torch.data.tfrecords import (encode_example,
                                              read_tfrecord_file,
                                              write_tfrecord_file)

    p = str(tmp_path / "c.tfrecord")
    write_tfrecord_file(p, [encode_example({"x": 1})])
    raw = bytearray(open(p, "rb").read())
    raw[14] ^= 0xFF  # flip a data byte
    open(p, "wb").write(bytes(raw))
    with _pytest.raises(ValueError):
        list(read_tfrecord_file(p))


class TestDatasetPipeline:
    def test_window_streams_one_window_at_a_time(self, cluster):
        import ray_tpu_torch.data as rd

        ds = rd.range(100, parallelism=10)
        pipe = ds.window(blocks_per_window=2)
        assert pipe.length == 5
        total = sorted(v for b in pipe.iter_batches(batch_size=None)
                       for v in b["id"])
        assert total == list(range(100))

    def test_window_with_transforms_and_count(self, cluster):
        import ray_tpu_torch.data as rd

        pipe = (rd.range(60, parallelism=6)
                .map_batches(lambda b: {"id": b["id"] * 2})
                .window(blocks_per_window=2)
                .filter(lambda r: r["id"] % 4 == 0))
        vals = sorted(r["id"] for r in pipe.iter_rows())
        assert vals == [v for v in range(0, 120, 2) if v % 4 == 0]

    def test_repeat_epochs(self, cluster):
        import ray_tpu_torch.data as rd

        pipe = rd.range(10, parallelism=2).repeat(3)
        assert pipe.length == 3
        rows = [r["id"] for r in pipe.iter_rows()]
        assert len(rows) == 30 and sorted(set(rows)) == list(range(10))

    def test_infinite_repeat_take(self, cluster):
        import ray_tpu_torch.data as rd

        pipe = rd.range(4, parallelism=1).repeat()
        assert pipe.length is None
        rows = pipe.take(11)
        assert len(rows) == 11

    def test_split_for_workers(self, cluster):
        import ray_tpu_torch.data as rd

        pipe = rd.range(40, parallelism=8).window(blocks_per_window=2)
        parts = pipe.split(2)
        a = sorted(r["id"] for r in parts[0].iter_rows())
        b = sorted(r["id"] for r in parts[1].iter_rows())
        assert not (set(a) & set(b))
        assert sorted(a + b) == list(range(40))

    def test_windowed_shuffle_then_repeat(self, cluster):
        import ray_tpu_torch.data as rd

        pipe = (rd.range(20, parallelism=4).window(blocks_per_window=2)
                .random_shuffle(seed=0).repeat(2))
        rows = [r["id"] for r in pipe.iter_rows()]
        assert len(rows) == 40


def test_read_sql_sqlite(tmp_path, cluster):
    import sqlite3

    import ray_tpu_torch.data as rd

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE metrics (step INTEGER, loss REAL)")
    conn.executemany("INSERT INTO metrics VALUES (?, ?)",
                     [(i, 10.0 / (i + 1)) for i in range(50)])
    conn.commit()
    conn.close()

    ds = rd.read_sql("SELECT step, loss FROM metrics WHERE step < 30",
                     db, parallelism=3)
    batches = list(ds.iter_batches(batch_size=None))
    steps = sorted(int(s) for b in batches for s in b["step"])
    assert steps == list(range(30))
    assert len(batches) == 3  # sharded into `parallelism` blocks


def test_window_rejects_global_ops_and_limit(cluster):
    import pytest as _pytest

    import ray_tpu_torch.data as rd

    with _pytest.raises(ValueError):
        rd.range(10, parallelism=5).sort("id").window(blocks_per_window=2)
    with _pytest.raises(ValueError):
        rd.range(10, parallelism=5).limit(5).window(blocks_per_window=2)
    # per-window shuffle AFTER windowing is the supported spelling
    pipe = rd.range(10, parallelism=5).window(
        blocks_per_window=2).random_shuffle(seed=0)
    assert sorted(r["id"] for r in pipe.iter_rows()) == list(range(10))


class TestPlanOptimizer:
    """Rule-based logical optimization (data/optimizer.py; ref:
    python/ray/data/_internal/logical/optimizers.py)."""

    def test_select_columns_api(self, cluster):
        import ray_tpu_torch.data as rd

        ds = rd.from_items([{"a": i, "b": i * 2, "c": i * 3}
                            for i in range(10)]).select_columns(["a", "c"])
        rows = ds.take_all()
        assert set(rows[0]) == {"a", "c"}
        assert [r["a"] for r in rows] == list(range(10))

    def test_commuting_filter_moves_before_shuffle(self, cluster):
        import ray_tpu_torch.data as rd
        from ray_tpu_torch.data.optimizer import optimize
        from ray_tpu_torch.data.plan import AllToAllOp, MapOp

        ds = (rd.range(100).random_shuffle(seed=0)
              .filter(lambda r: r["id"] % 2 == 0))
        ops, rules = optimize(ds._ops)
        kinds = [type(o).__name__ + ":" + getattr(o, "name", "")
                 for o in ops]
        # filter now sits before the shuffle barrier
        i_f = next(i for i, o in enumerate(ops)
                   if isinstance(o, MapOp) and o.name == "filter")
        i_s = next(i for i, o in enumerate(ops)
                   if isinstance(o, AllToAllOp))
        assert i_f < i_s, kinds
        assert any(r.startswith("commute") for r in rules)
        # semantics unchanged
        vals = sorted(r["id"] for r in ds.take_all())
        assert vals == list(range(0, 100, 2))

    def test_map_batches_never_moves(self, cluster):
        import ray_tpu_torch.data as rd
        from ray_tpu_torch.data.optimizer import optimize
        from ray_tpu_torch.data.plan import AllToAllOp

        ds = (rd.range(32).repartition(4)
              .map_batches(lambda b: {"id": b["id"] * 2}))
        ops, rules = optimize(ds._ops)
        assert isinstance(ops[1], AllToAllOp), \
            "batch-boundary-dependent op must not cross the barrier"
        assert not rules

    def test_sort_and_groupby_block_commuting(self, cluster):
        """drop/select must NOT move across sort (consumes its key) or
        groupby (replaces the row set)."""
        import ray_tpu_torch.data as rd
        from ray_tpu_torch.data.optimizer import optimize
        from ray_tpu_torch.data.plan import AllToAllOp

        ds = rd.range(20).sort("id").drop_columns(["id"])
        ops, rules = optimize(ds._ops)
        assert isinstance(ops[1], AllToAllOp) and ops[1].kind == "sort"
        assert not rules
        # end-to-end still correct (sort then drop)
        rows = ds.take_all()
        assert all("id" not in r for r in rows)


class TestWrites:
    """Distributed write_csv/write_json (ref: dataset.py write APIs: one
    file per block, parallel tasks). Parquet raises (no pyarrow) and a
    storage URL raises (no fsspec): tests below."""

    def test_write_csv_roundtrip(self, cluster, tmp_path):
        import ray_tpu_torch.data as rd

        ds = rd.from_items([{"x": i} for i in range(10)]).repartition(2)
        paths = ds.write_csv(str(tmp_path / "csvs"))
        assert len(paths) == 2
        back = rd.read_csv(str(tmp_path / "csvs"))
        assert sorted(int(r["x"]) for r in back.take_all()) == list(range(10))

    def test_write_json_to_fsspec_url(self, cluster, tmp_path):
        """A plain directory takes the parts; a storage URL raises through
        util/fs.split_fs_url (the port carries no fsspec)."""
        import json

        import ray_tpu_torch.data as rd

        ds = rd.from_items([{"v": i} for i in range(6)]).repartition(2)
        paths = ds.write_json(str(tmp_path / "dsjson"))
        assert len(paths) == 2
        rows = []
        for name in sorted((tmp_path / "dsjson").iterdir()):
            rows += [json.loads(ln)
                     for ln in name.read_text().splitlines()]
        assert sorted(r["v"] for r in rows) == list(range(6))
        with pytest.raises(ValueError, match="fsspec"):
            ds.write_json(f"file://{tmp_path}/dsjson")

    def test_rewrite_clears_stale_parts(self, cluster, tmp_path):
        import ray_tpu_torch.data as rd

        big = rd.from_items([{"a": i} for i in range(40)]).repartition(4)
        big.write_csv(str(tmp_path / "out"))
        small = rd.from_items([{"a": i} for i in range(10)]).repartition(2)
        small.write_csv(str(tmp_path / "out"))
        back = rd.read_csv(str(tmp_path / "out"))
        assert sorted(int(r["a"]) for r in back.take_all()) == \
            list(range(10))

class TestRound5DatasetOps:
    def test_union(self, cluster):
        import ray_tpu_torch.data as data

        a = data.range(5)
        b = data.range(3).map(lambda r: {"id": r["id"] + 100})
        u = a.union(b)
        ids = sorted(r["id"] for r in u.iter_rows())
        assert ids == [0, 1, 2, 3, 4, 100, 101, 102]
        assert u.count() == 8

    def test_zip_renames_conflicts(self, cluster):
        import ray_tpu_torch.data as data

        a = data.range(6)
        b = data.range(6).map(lambda r: {"id": r["id"] * 10})
        z = a.zip(b)
        rows = z.take_all()
        assert all(r["id_1"] == r["id"] * 10 for r in rows)
        with pytest.raises(Exception):
            data.range(4).zip(data.range(5)).count()

    def test_train_test_split_exact_partition(self, cluster):
        import ray_tpu_torch.data as data

        train, test = data.range(100).train_test_split(0.2)
        assert train.count() == 80
        assert test.count() == 20
        # both sides together hold every row exactly once
        ids = sorted(list(r["id"] for r in train.iter_rows())
                     + list(r["id"] for r in test.iter_rows()))
        assert ids == list(range(100))

    def test_random_sample_fraction(self, cluster):
        import ray_tpu_torch.data as data

        ds = data.range(4000).random_sample(0.25, seed=0)
        n = ds.count()
        assert 800 <= n <= 1200  # ~1000 expected
        # different blocks must not sample identical masks: ids spread
        ids = [r["id"] for r in ds.iter_rows()]
        assert min(ids) < 500 and max(ids) > 3500

    def test_unique_and_aggregates(self, cluster):
        import ray_tpu_torch.data as data
        import numpy as np

        ds = data.from_items([1.0, 2.0, 2.0, 3.0, 4.0])
        assert ds.unique("item") == [1.0, 2.0, 3.0, 4.0]
        assert ds.mean() == pytest.approx(2.4)
        assert ds.min() == 1.0
        assert ds.max() == 4.0
        assert ds.std() == pytest.approx(
            float(np.std([1, 2, 2, 3, 4], ddof=1)))

    def test_limit_respected_by_ref_consumers(self, cluster):
        import ray_tpu_torch.data as data

        u = data.range(10).limit(3).union(data.range(2))
        assert u.count() == 5
        assert data.range(10).limit(4).materialize().count() == 4

    def test_window_over_union(self, cluster):
        import ray_tpu_torch.data as data

        pipe = data.range(20).union(data.range(20)).window(
            blocks_per_window=2)
        total = sum(b["id"].sum() for w in pipe.iter_windows()
                    for b in w._stream_blocks())
        assert total == 2 * sum(range(20))

    def test_unseeded_random_sample_is_independent(self, cluster):
        import ray_tpu_torch.data as data

        ds = data.range(2000)
        a = set(r["id"] for r in ds.random_sample(0.5).iter_rows())
        b = set(r["id"] for r in ds.random_sample(0.5).iter_rows())
        assert a != b  # fresh randomness per call

    def test_double_zip_keeps_all_columns(self, cluster):
        import ray_tpu_torch.data as data

        base = data.range(5)
        z1 = base.zip(data.range(5).map(lambda r: {"id": r["id"] * 10}))
        z2 = z1.zip(data.range(5).map(lambda r: {"id": r["id"] * 100}))
        row = z2.take(1)[0]
        assert set(row) == {"id", "id_1", "id_2"}
        assert row["id_1"] == row["id"] * 10
        assert row["id_2"] == row["id"] * 100

    def test_limit_then_transform(self, cluster):
        import ray_tpu_torch.data as data

        # the transform must see only the truncated rows
        out = data.range(10).limit(3).flat_map(lambda x: [x, x])
        assert out.count() == 6
        assert data.range(10).limit(3).map(
            lambda r: {"id": r["id"]}).count() == 3


# ---------------------------------------------------------------------------
# windowed epoch shuffle
# ---------------------------------------------------------------------------


class TestWindowedShuffle:
    def test_exactly_once_and_windowed(self, cluster):
        """Every source row appears exactly once, and each window's
        output rows come only from that window's input blocks (the
        streaming property: W blocks buffer, shuffle, emit, repeat)."""
        ds = rd.range(80, parallelism=8).windowed_shuffle(
            window_blocks=4, seed=11)
        vals = [r["id"] for r in ds.take_all()]
        assert sorted(vals) == list(range(80))
        # blocks 0-3 hold rows 0..39, blocks 4-7 hold rows 40..79:
        # window locality means the first 40 emitted rows are exactly
        # the first window's rows (permuted), never a row from window 2
        assert sorted(vals[:40]) == list(range(40))
        assert vals[:40] != list(range(40))  # actually shuffled

    def test_same_seed_same_epoch_bit_identical(self, cluster):
        def run():
            return [r["id"] for r in rd.range(120, parallelism=6)
                    .windowed_shuffle(window_blocks=3, seed=5).take_all()]

        assert run() == run()

    def test_epochs_reshuffle_deterministically(self, cluster):
        """iter_epochs(): every epoch is a permutation of all rows,
        different epochs differ, and replaying the epoch sequence
        reproduces the same per-epoch orders bit-for-bit."""
        ds = rd.range(60, parallelism=6).windowed_shuffle(
            window_blocks=3, seed=9)

        def epochs(n):
            return [[r["id"] for r in e.take_all()]
                    for e in ds.iter_epochs(n)]

        a = epochs(3)
        for order in a:
            assert sorted(order) == list(range(60))
        assert a[0] != a[1] and a[1] != a[2]
        assert epochs(3) == a

    def test_seed_changes_order(self, cluster):
        base = rd.range(60, parallelism=6)
        one = [r["id"] for r in
               base.windowed_shuffle(window_blocks=3, seed=1).take_all()]
        two = [r["id"] for r in
               base.windowed_shuffle(window_blocks=3, seed=2).take_all()]
        assert one != two and sorted(one) == sorted(two)

    def test_window_one_and_tail_window(self, cluster):
        # window_blocks=1 degenerates to per-block row shuffle; a
        # 7-block source with window 4 leaves a 3-block tail window
        vals = sorted(r["id"] for r in rd.range(70, parallelism=7)
                      .windowed_shuffle(window_blocks=4, seed=3)
                      .take_all())
        assert vals == list(range(70))
        vals1 = sorted(r["id"] for r in rd.range(30, parallelism=3)
                       .windowed_shuffle(window_blocks=1, seed=3)
                       .take_all())
        assert vals1 == list(range(30))


# ---------------------------------------------------------------------------
# byte-budgeted backpressure + Shardable contract
# ---------------------------------------------------------------------------


def test_byte_budget_caps_outstanding_bytes(cluster):
    """target_max_bytes_inflight throttles admission: with a budget of
    ~2 blocks, peak outstanding bytes stay bounded while the run still
    completes; with the budget off the gauge path still counts."""
    ctx = DataContext.get_current()
    old = ctx.target_max_bytes_inflight
    block_bytes = 8 * 2048  # int64 rows per block below
    ctx.target_max_bytes_inflight = 2 * block_bytes
    try:
        ds = rd.range(16 * 2048, parallelism=16).map_batches(
            lambda b: {"id": b["id"]})
        assert ds.count() == 16 * 2048
        stats = ds.stats()
        assert stats["blocks_emitted"] == 16
        # bounded: bootstrap-estimate slack on top of the 2-block budget,
        # never the whole 16-block dataset in flight at once
        assert 0 < stats["peak_bytes_inflight"] <= 6 * block_bytes
    finally:
        ctx.target_max_bytes_inflight = old


def test_actor_pool_head_of_line_bytes_counted(cluster):
    """Regression: the actor-pool path's
    head-of-line buffer (completed-but-unemitted blocks in ordered
    mode) must surface in the byte accounting, not just the block
    window."""
    ctx = DataContext.get_current()
    old = ctx.target_max_bytes_inflight
    ctx.target_max_bytes_inflight = 1 << 20
    try:
        ds = rd.range(8 * 1024, parallelism=8).map_batches(
            lambda b: {"id": b["id"]},
            compute=rd.ActorPoolStrategy(size=2))
        assert ds.count() == 8 * 1024
        stats = ds.stats()
        # two segments emit: the read segment feeding the pool + the
        # pool itself — 8 source blocks each
        assert stats["blocks_emitted"] == 16
        # with 8KiB blocks the peak must reflect real completed-block
        # sizes (store-reported), not just the bootstrap estimate of
        # in-flight tasks
        assert stats["peak_bytes_inflight"] >= 8 * 1024
    finally:
        ctx.target_max_bytes_inflight = old


def test_byte_window_buffers_head_of_line():
    """_ByteWindow unit: completed-but-unemitted blocks count at
    measured size, admission blocks once outstanding >= budget, and a
    fully-drained window always admits (no oversized-block wedge)."""
    from ray_tpu_torch.data.executor import ExecStats, _ByteWindow

    class _Ref:
        class id:  # noqa: N801 — mimics ObjectId attribute shape
            pass

    bw = _ByteWindow(ExecStats(), budget=100)
    assert bw.admit(0)          # drained -> always admit
    bw.on_complete(_Ref(), 0)   # no store hint -> bootstrap estimate
    assert bw._buffered >= bw._BOOTSTRAP_EST
    assert not bw.admit(1)      # head-of-line bytes block admission
    bw.on_emit(0)
    assert bw._buffered == 0
    assert bw.admit(0)
    bw.close()


def test_trainer_rejects_broken_shardable(cluster):
    """An implementer that violates the Shardable contract (wrong shard
    count / wrong type) fails loudly at sharding time, not with
    silently skewed per-rank data."""
    from ray_tpu_torch import train
    from ray_tpu_torch.data.iterator import Shardable
    from ray_tpu_torch.train.trainer import DataParallelTrainer

    class Broken(Shardable):
        def split_shards(self, n, *, equal=True, locality_hints=None):
            return ["not-a-shard"] * n

    t = DataParallelTrainer(
        lambda config: None, datasets={"train": Broken()},
        scaling_config=train.ScalingConfig(num_workers=2, device_type="cpu"))
    with pytest.raises(TypeError, match="Shardable"):
        t._dataset_shards()


def test_trainer_shard_contract_disjoint_exhaustive(cluster):
    """A sharded Dataset gives the trainer's workers DISJOINT, EXHAUSTIVE
    row sets (the Shardable contract): each worker's DataShard, as
    _dataset_shards hands it out, holds half the rows, and the union is
    exactly the source rows."""
    from ray_tpu_torch import train
    from ray_tpu_torch.data import DataShard
    from ray_tpu_torch.train.trainer import DataParallelTrainer

    ds = rd.range(100, parallelism=4)
    shards = DataParallelTrainer(
        lambda config: None, datasets={"train": ds},
        scaling_config=train.ScalingConfig(
            num_workers=2, device_type="cpu"))._dataset_shards()
    parts = [s["train"] for s in shards]
    assert all(isinstance(p, DataShard) for p in parts)
    rows = [sorted(int(v) for b in p.iter_batches(batch_size=16)
                   for v in b["id"]) for p in parts]
    assert [len(r) for r in rows] == [50, 50]
    assert sorted(rows[0] + rows[1]) == list(range(100))
    assert not (set(rows[0]) & set(rows[1]))


def test_tfrecords_into_train_ingest(tmp_path, cluster):
    """TFRecords -> Dataset -> the trainer's shards for 2 workers: each
    rank's shard is exactly half the 40 rows, with no duplication."""
    from ray_tpu_torch import train
    from ray_tpu_torch.data.tfrecords import (encode_example,
                                              write_tfrecord_file)
    from ray_tpu_torch.train.trainer import DataParallelTrainer

    for fi in range(4):
        recs = [encode_example({"v": fi * 10 + i}) for i in range(10)]
        write_tfrecord_file(str(tmp_path / f"p{fi}.tfrecord"), recs)
    ds = rd.read_tfrecords(str(tmp_path))
    shards = DataParallelTrainer(
        lambda config: None, datasets={"train": ds},
        scaling_config=train.ScalingConfig(
            num_workers=2, device_type="cpu"))._dataset_shards()
    seen = [[int(v) for b in s["train"].iter_batches(batch_size=8)
             for v in b["v"]] for s in shards]
    assert [len(s) for s in seen] == [20, 20]
    assert sorted(seen[0] + seen[1]) == list(range(40))


def test_read_webdataset(tmp_path, cluster):
    """Text, class and json members decode; decode=False keeps bytes;
    an image member with decode=True raises naming PIL (the JAX
    package's test decodes PNG members through PIL)."""
    import io
    import json
    import tarfile

    for shard in range(2):
        with tarfile.open(tmp_path / f"shard{shard}.tar", "w") as tar:
            for i in range(3):
                key = f"{shard}{i:03d}"

                def add(name, data):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))

                add(f"{key}.txt", f"t{key}".encode())
                add(f"{key}.cls", str(i).encode())
                add(f"{key}.json", json.dumps({"k": key}).encode())

    ds = rd.read_webdataset(str(tmp_path))
    rows = sorted(ds.iter_rows(), key=lambda r: r["__key__"])
    assert len(rows) == 6
    assert rows[0]["txt"] == "t0000"
    assert rows[4]["cls"] == "1"
    assert rows[3]["json"]["k"] == "1000"
    raw = next(iter(rd.read_webdataset(
        str(tmp_path / "shard0.tar"), decode=False).iter_rows()))
    assert isinstance(raw["txt"], bytes) and isinstance(raw["cls"], bytes)
    with tarfile.open(tmp_path / "img.tar", "w") as tar:
        info = tarfile.TarInfo("a/0001.png")
        info.size = 4
        tar.addfile(info, io.BytesIO(b"\x89PNG"))
    # the read task raises; the runtime hands it back as the task's error
    with pytest.raises(ray_tpu_torch.exceptions.TaskError,
                       match="needs PIL") as err:
        rd.read_webdataset(str(tmp_path / "img.tar")).take_all()
    assert isinstance(err.value.cause, ImportError)
    rows = rd.read_webdataset(str(tmp_path / "img.tar"),
                              decode=False).take_all()
    assert rows[0]["__key__"] == "a/0001" and rows[0]["png"] == b"\x89PNG"


def test_read_webdataset_nested_heterogeneous(tmp_path, cluster):
    """Nested paths are distinct samples; optional members survive a
    first sample that lacks them; multi-extension members decode by the
    LAST segment (the webdataset base_plus_ext rules)."""
    import io
    import tarfile

    with tarfile.open(tmp_path / "n.tar", "w") as tar:
        def add(name, data):
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tar.addfile(ti, io.BytesIO(data))

        add("a/0001.txt", b"a")
        add("b/0001.txt", b"b")
        add("b/0001.cls", b"7")          # optional member, absent from a/
        add("b/0001.seg.txt", b"seg")    # multi-extension

    rows = sorted(rd.read_webdataset(str(tmp_path / "n.tar")).iter_rows(),
                  key=lambda r: r["__key__"])
    assert [r["__key__"] for r in rows] == ["a/0001", "b/0001"]
    assert rows[0]["cls"] is None and rows[1]["cls"] == "7"
    assert rows[0]["txt"] == "a" and rows[1]["txt"] == "b"
    assert rows[1]["seg.txt"] == "seg"


def test_iter_torch_batches_device_rule(cluster):
    """device=None is the CUDA card (the port's rule; the reference's
    default is the CPU): without a card it raises naming device='cpu';
    with one the tensors land there."""
    import torch

    ds = rd.from_numpy({"x": np.arange(8, dtype=np.float32)})
    shard = ds.split_shards(1)[0]
    if torch.cuda.is_available():
        assert next(ds.iter_torch_batches(batch_size=4))["x"].is_cuda
        assert next(shard.iter_torch_batches(batch_size=4))["x"].is_cuda
    else:
        for it in (ds.iter_torch_batches(batch_size=4),
                   shard.iter_torch_batches(batch_size=4)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                next(it)
    # a UDF's torch batch stays on the host, as the reference's does
    out = ds.map_batches(lambda b: {"x": b["x"].double() * 2},
                         batch_format="torch").take_all()
    assert [r["x"] for r in out] == [2.0 * i for i in range(8)]


@pytest.mark.parametrize("package,call", [
    ("pyarrow", lambda: rd.from_arrow(None)),
    ("pyarrow", lambda: rd.read_parquet("x.parquet")),
    ("pyarrow", lambda: rd.range(4).write_parquet("out")),
    ("pyarrow", lambda: rd.range(4).to_arrow_refs()),
    ("pyarrow", lambda: rd.range(4).iter_batches(
        batch_format="pyarrow").__next__()),
    ("pandas", lambda: rd.range(4).iter_batches(
        batch_format="pandas").__next__()),
    ("tensorflow", lambda: rd.range(4).iter_tf_batches()),
    ("tensorflow", lambda: rd.range(4).split_shards(1)[0].iter_tf_batches()),
    ("PIL", lambda: rd.read_images("imgs")),
], ids=["from_arrow", "read_parquet", "write_parquet", "to_arrow_refs",
        "batch_pyarrow", "batch_pandas", "iter_tf_batches",
        "shard_iter_tf_batches", "read_images"])
def test_paths_of_missing_packages_raise(cluster, package, call):
    """The paths that need a package the port does not carry raise an
    ImportError naming it and ROADMAP A10; none imports it."""
    import sys

    had = package.split(".")[0] in sys.modules
    with pytest.raises(ImportError, match=f"needs {package}.*ROADMAP A10"):
        call()
    assert had or package not in sys.modules
