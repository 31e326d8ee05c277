"""The port's host runtime (ray_tpu_torch.core, ray_tpu_torch.cgraph) on
the CPU: tasks, actors, the object store, placement groups and compiled
graphs with their wire codecs, run through one port runtime for the
module; and the byte formats the port shares with the JAX package (the
control-frame wire codec, the object serialization, the quantized wire
records) held to the reference's bytes on the same values.

The JAX package is imported only inside the tests that compare with it:
workers never import this module (every remote function here is defined
inside its test, so it travels by value), and the worker-modules test
checks what a worker of the port's own runtime loads.
"""
import pickle

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch.core import serialization, wire
from ray_tpu_torch.parallel import quant


@pytest.fixture(scope="module")
def rt():
    # one intra-op thread in every worker the runtime starts (they
    # inherit OMP_NUM_THREADS): the shapes are tiny, and the cores go to
    # the test files running beside this one
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        runtime = ray_tpu_torch.init(num_cpus=4)
        yield runtime
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# core API


def test_tasks_and_ref_args(rt):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    refs = [add.remote(i, i) for i in range(8)]
    assert ray_tpu_torch.get(refs, timeout=60) == [2 * i for i in range(8)]
    # an ObjectRef argument resolves to its value in the worker
    chained = add.remote(add.remote(1, 2), 10)
    assert ray_tpu_torch.get(chained, timeout=60) == 13


def test_actor_twenty_calls_in_order(rt):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.remote(100)
    refs = [c.inc.remote() for _ in range(20)]
    assert ray_tpu_torch.get(refs, timeout=60) == list(range(101, 121))
    ray_tpu_torch.kill(c)


def test_put_get_wait(rt):
    arr = np.arange(300_000, dtype=np.float32)   # large: the shm path
    ref = ray_tpu_torch.put({"a": arr, "s": "x"})
    got = ray_tpu_torch.get(ref, timeout=60)
    np.testing.assert_array_equal(got["a"], arr)
    assert got["s"] == "x"

    @ray_tpu_torch.remote
    def slow(t):
        import time

        time.sleep(t)
        return t

    fast, late = slow.remote(0.0), slow.remote(30.0)
    ready, pending = ray_tpu_torch.wait([fast, late], num_returns=1,
                                        timeout=20)
    assert ready == [fast] and pending == [late]
    ray_tpu_torch.cancel(late, force=True)


def test_task_error_propagates(rt):
    @ray_tpu_torch.remote(max_retries=0)
    def boom():
        raise ValueError("planted failure")

    with pytest.raises(exceptions.TaskError, match="planted failure"):
        ray_tpu_torch.get(boom.remote(), timeout=60)


def test_named_actor_and_kill(rt):
    @ray_tpu_torch.remote
    class Box:
        def __init__(self):
            self.v = None

        def set(self, v):
            self.v = v
            return True

        def get(self):
            return self.v

    box = Box.options(name="port-box").remote()
    assert ray_tpu_torch.get(box.set.remote(7), timeout=60)
    same = ray_tpu_torch.get_actor("port-box")
    assert ray_tpu_torch.get(same.get.remote(), timeout=60) == 7
    ray_tpu_torch.kill(box)
    with pytest.raises(exceptions.ActorDiedError):
        ray_tpu_torch.get(box.get.remote(), timeout=30)
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("port-box")


def test_placement_group(rt):
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy

    pg = ray_tpu_torch.placement_group([{"CPU": 1}, {"CPU": 1}],
                                       strategy="STRICT_PACK")
    assert pg.ready(timeout=30)

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    outs = ray_tpu_torch.get(
        [where.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg)).remote() for _ in range(2)], timeout=60)
    assert len(set(outs)) == 1
    ray_tpu_torch.remove_placement_group(pg)


def test_worker_loads_no_jax_package(rt):
    """A plain task's worker runs the port's worker module and holds
    neither JAX, the JAX package nor a site cloudpickle in sys.modules."""
    @ray_tpu_torch.remote
    def loaded():
        import sys

        main = sys.modules["__main__"]
        return (sorted({m.split(".")[0] for m in sys.modules}),
                getattr(main.__spec__, "name", None))

    tops, main = ray_tpu_torch.get(loaded.remote(), timeout=60)
    assert main == "ray_tpu_torch.core.worker_main"
    assert "ray_tpu_torch" in tops
    for banned in ("ray_tpu", "jax", "jaxlib", "cloudpickle", "ml_dtypes"):
        assert banned not in tops, (banned, tops)


# ---------------------------------------------------------------------------
# compiled graphs


def _two_stage(codec, channel_bytes=None):
    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, scale):
            self.scale = scale

        def fwd(self, x):
            import torch

            if isinstance(x, int):               # a payload of x floats
                x = torch.zeros(x)
            if isinstance(x, torch.Tensor):
                return {"t": x, "scale": self.scale}
            return {"t": x["t"], "scale": x["scale"] * self.scale}

    a, b = Stage.remote(2), Stage.remote(3)
    with ray_tpu_torch.InputNode() as inp:
        dag = b.fwd.bind(a.fwd.bind(inp))
    return dag.experimental_compile(codec=codec,
                                    channel_bytes=channel_bytes), (a, b)


@pytest.mark.parametrize("codec", [None, "int8", "e4m3"])
def test_compiled_graph_two_stages(rt, codec):
    """A bf16 tensor crosses two shared-memory channels: exact without a
    codec, the codec's block-quantized image with one, and the tensor
    comes back as a tensor of its dtype either way."""
    import torch

    compiled, actors = _two_stage(codec)
    try:
        g = torch.Generator().manual_seed(0)
        for step in range(3):
            x = torch.randn(64, 96, generator=g).to(torch.bfloat16)
            out = compiled.execute(x).get(timeout=60)
            assert out["scale"] == 6
            assert out["t"].dtype == torch.bfloat16
            want = x if codec is None else \
                quant.dequantize(quant.quantize(x, codec))
            assert torch.equal(out["t"], want), step
            if codec is not None:
                assert not torch.equal(out["t"], x)
    finally:
        compiled.teardown()
        for a in actors:
            ray_tpu_torch.kill(a)


def test_compiled_graph_channel_full(rt):
    """A payload over a channel's capacity raises ChannelFullError at the
    driver, whether the driver's input or a stage's output overflows;
    one under it passes, before and after."""
    import torch

    compiled, actors = _two_stage(None, channel_bytes=16 * 1024)
    try:
        assert torch.equal(compiled.execute(1024).get(timeout=60)["t"],
                           torch.zeros(1024))                 # 4 KiB
        with pytest.raises(exceptions.ChannelFullError):
            compiled.execute(8192).get(timeout=60)            # stage a
        with pytest.raises(exceptions.ChannelFullError):
            compiled.execute(torch.zeros(8192)).get(timeout=60)  # input
        assert compiled.execute(2).get(timeout=60)["scale"] == 6
    finally:
        compiled.teardown()
        for a in actors:
            ray_tpu_torch.kill(a)


def test_compiled_graph_channel_full_two_consumers(rt):
    """A stage whose value overflows its channel sends each of its two
    consumers the error in place of the value: neither runs its method,
    the driver's get raises ChannelFullError, and the next execution
    reaches both."""
    @ray_tpu_torch.remote
    class Stage:
        def __init__(self):
            self.calls = 0

        def fwd(self, x):
            import torch

            self.calls += 1
            return torch.zeros(x) if isinstance(x, int) else x.sum()

        def count(self):
            return self.calls

    a, b, c = Stage.remote(), Stage.remote(), Stage.remote()
    with ray_tpu_torch.InputNode() as inp:
        x = a.fwd.bind(inp)
        dag = ray_tpu_torch.MultiOutputNode([b.fwd.bind(x), c.fwd.bind(x)])
    compiled = dag.experimental_compile(channel_bytes=16 * 1024)
    try:
        assert [float(t) for t in compiled.execute(16).get(timeout=60)] \
            == [0.0, 0.0]
        with pytest.raises(exceptions.ChannelFullError):
            compiled.execute(8192).get(timeout=60)
        assert ray_tpu_torch.get([s.count.remote() for s in (a, b, c)],
                                 timeout=60) == [2, 1, 1]
        assert [float(t) for t in compiled.execute(16).get(timeout=60)] \
            == [0.0, 0.0]
        assert ray_tpu_torch.get([s.count.remote() for s in (a, b, c)],
                                 timeout=60) == [3, 2, 2]
    finally:
        compiled.teardown()
        for s in (a, b, c):
            ray_tpu_torch.kill(s)


# ---------------------------------------------------------------------------
# byte formats shared with the JAX package

VALUES = [
    None, True, 0, -1, 2 ** 63 - 1, 2 ** 80, 1.5, float("-inf"), "tpu",
    b"\x00\xff", [1, [2, (3, 4)]], {"a": {1: 2.0}, "b": (None, "x")},
    {1, 2, 3}, frozenset({"k"}), (),
]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_wire_bytes_equal_reference(value):
    from ray_tpu.core import wire as jwire

    assert wire.encode(value) == jwire.encode(value)
    assert wire.decode_py(jwire.encode(value)) == value


@pytest.mark.parametrize("value", VALUES + [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    {"kv": [np.ones((2, 3), np.int8), np.zeros(5)], "n": 3},
], ids=lambda v: type(v).__name__ + str(np.shape(v)) if isinstance(
    v, np.ndarray) else repr(v)[:30])
def test_serialization_bytes_equal_reference(value):
    from ray_tpu.core import serialization as jser

    assert serialization.dumps(value) == jser.dumps(value)


def test_tensor_travels_out_of_band():
    """A torch CPU tensor is one out-of-band buffer of its raw bytes,
    and comes back bitwise in its dtype; a tensor off the host is
    refused."""
    import torch

    t = torch.randn(4, 8, 16).to(torch.bfloat16)
    so = serialization.serialize({"k": t, "v": [t[0]]})
    assert [b.nbytes for b in so.buffers] == [t.numel() * 2, 8 * 16 * 2]
    back = serialization.loads(so.to_bytes())
    assert back["k"].dtype == torch.bfloat16
    assert torch.equal(back["k"].view(torch.int16), t.view(torch.int16))
    assert torch.equal(back["v"][0], t[0])
    with pytest.raises(TypeError, match="host"):
        serialization.dumps(torch.empty(3, device="meta"))


def _quant_inputs(dtype):
    rng = np.random.default_rng(3)
    # 1000 values: not a block multiple; magnitudes spread so e4m3
    # subnormals, an all-zero block and large values all occur
    x = rng.standard_normal(1000).astype(np.float32)
    x *= np.exp(rng.uniform(-12, 6, size=1000)).astype(np.float32)
    x[256:512] = 0.0
    x[600] = 448.0
    if dtype == "bfloat16":
        import ml_dtypes
        import torch

        ref_in = x.astype(ml_dtypes.bfloat16)
        port_in = torch.from_numpy(ref_in.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        ref_in = x
        port_in = x.copy()
    return ref_in.reshape(8, 125), port_in.reshape(8, 125)


@pytest.mark.parametrize("codec", ["int8", "e4m3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_bitwise_equal_reference(codec, dtype):
    from ray_tpu.parallel import quant as jquant

    ref_in, port_in = _quant_inputs(dtype)
    want = jquant.quantize(ref_in, codec)
    got = quant.quantize(port_in, codec)
    assert got.payload.dtype == want.payload.dtype
    assert got.payload.tobytes() == want.payload.tobytes()
    assert got.scales.tobytes() == want.scales.tobytes()
    assert (got.shape, got.dtype, got.block) == \
        (want.shape, want.dtype, want.block)
    assert got.nbytes() == want.nbytes()
    assert got.source_nbytes() == want.source_nbytes()
    # the decoded values agree bitwise as well, in the source dtype
    dec_want = np.asarray(jquant.dequantize(want))
    dec_got = quant.dequantize(got)
    if dtype == "bfloat16":
        import torch

        assert dec_got.dtype == torch.bfloat16
        assert dec_got.view(torch.int16).numpy().tobytes() == \
            dec_want.view(np.int16).tobytes()
    else:
        assert dec_got.tobytes() == dec_want.tobytes()
    # a record survives the port's serialization
    again = pickle.loads(pickle.dumps(got))
    assert again.payload.tobytes() == got.payload.tobytes()

