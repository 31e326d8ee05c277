"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with the JAX
package's (ray_tpu.ops), on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
flash attention runs its Pallas kernels in interpret mode, as
tests/test_ops.py does; the port's flash attention runs its plain
version, which is what a CPU tensor gets. Tolerances: 2e-5 for f32
(summation order only, as tests/test_ops.py:30), 3e-2 for bf16 outputs
(bf16 rounding, as tests/test_ops.py:61).
"""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu import ops as jops
from ray_tpu_torch import ops as tops

# the modules (each ops package re-exports its function under the same
# name)
jflash_mod = importlib.import_module("ray_tpu.ops.flash_attention")
fa_mod = importlib.import_module("ray_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and it
    leaves the machine's cores to the test files running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32_TOL = 2e-5
BF16_TOL = 3e-2


def _np(x):
    """JAX or torch array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _both(a, dtype="float32"):
    """numpy f32 array -> (jax array, torch tensor) of ``dtype``."""
    return (jnp.asarray(a, dtype=getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype)))


def _qkv(seed, b=2, s=128, h=4, d=32, sk=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, sk or s, h, d), dtype=np.float32),
            rng.standard_normal((b, sk or s, h, d), dtype=np.float32))


# ---------------------------------------------------------------------------
# layers


def _layer_case(name, rng):
    x = rng.standard_normal((3, 5, 16), dtype=np.float32)
    w = rng.standard_normal((16,), dtype=np.float32)
    b = rng.standard_normal((16,), dtype=np.float32)
    if name == "rmsnorm":
        return lambda m, X, W, B: m.rmsnorm(X, W), (x, w, b)
    if name == "rmsnorm_eps":
        return lambda m, X, W, B: m.rmsnorm(X, W, 1e-5), (x, w, b)
    if name == "layernorm":
        return lambda m, X, W, B: m.layernorm(X, W, B), (x, w, b)
    if name == "gelu":
        return lambda m, X, W, B: m.gelu(X), (x * 3, w, b)
    raise KeyError(name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["rmsnorm", "rmsnorm_eps", "layernorm",
                                  "gelu"])
def test_layers_match_jax(name, dtype):
    fn, arrays = _layer_case(name, np.random.default_rng(0))
    j_args, t_args = zip(*(_both(a, dtype) for a in arrays))
    want, got = fn(jops, *j_args), fn(tops, *t_args)
    assert str(got.dtype).endswith(dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_rope_cache_matches_jax():
    jc, js = jops.rope_cache(64, 32, 10000.0)
    tc, ts = tops.rope_cache(64, 32, 10000.0, device="cpu")
    assert tc.shape == (64, 16) and tc.dtype == torch.float32
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_matches_jax(with_positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16), dtype=np.float32)
    jc, js = jops.rope_cache(32, 16)
    tc, ts = tops.rope_cache(32, 16, device="cpu")
    pos = rng.integers(0, 32, (2, 6)) if with_positions else None
    want = jops.apply_rope(jnp.asarray(x), jc, js,
                           None if pos is None else jnp.asarray(pos))
    got = tops.apply_rope(torch.from_numpy(x), tc, ts,
                          None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 33), dtype=np.float32) * 3
    labels = rng.integers(0, 33, (2, 7))
    labels[0, :3] = -100                       # ignored positions
    want = jops.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                   z_loss=z_loss)
    got = tops.cross_entropy_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels), z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# mha_reference


@pytest.mark.parametrize("case", ["causal", "full", "offset_causal", "bias",
                                  "bf16"])
def test_mha_reference_matches_jax(case):
    q, k, v = _qkv(3, s=24, sk=40 if case == "offset_causal" else None)
    dtype = "bfloat16" if case == "bf16" else "float32"
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    kw = dict(causal=case != "full")
    jkw, tkw = dict(kw), dict(kw)
    if case == "bias":
        bias = np.random.default_rng(4).standard_normal(
            (2, 4, 24, 24), dtype=np.float32)
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    want = jops.mha_reference(jq, jk, jv, **jkw)
    got = tops.mha_reference(tq, tk, tv, **tkw)
    assert got.dtype == tq.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention: the port's plain path against the JAX Pallas kernels


@pytest.mark.parametrize("s,causal,dtype", [
    (128, True, "float32"),      # tests/test_ops.py:24 causal
    (128, False, "float32"),     # tests/test_ops.py:24 non-causal
    (192, True, "float32"),      # tests/test_ops.py:32 uneven blocks
    (128, True, "bfloat16"),     # tests/test_ops.py:54
])
def test_flash_attention_matches_jax_pallas(s, causal, dtype):
    q, k, v = _qkv(5, s=s)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got = tops.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                               block_k=64)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("block", [64, 128])   # tiled and single-block
@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax_flash_fwd(causal, block):
    q, k, v = _qkv(6, b=1, s=128, h=2)
    b, s, h, d = q.shape
    to_bhsd = lambda a: jnp.asarray(  # noqa: E731
        a.transpose(0, 2, 1, 3).reshape(b * h, s, d))
    j_out, j_lse = jflash_mod._flash_fwd(
        to_bhsd(q), to_bhsd(k), to_bhsd(v), 1.0 / np.sqrt(d), causal,
        block, block)
    out, lse = tops.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(lse).reshape(b * h, 1, s), _np(j_lse),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(
        _np(out).transpose(0, 2, 1, 3).reshape(b * h, s, d), _np(j_out),
        atol=F32_TOL, rtol=F32_TOL)


def test_flash_causal_requires_square():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, s=128, sk=256))
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        tops.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        tops.flash_attention_fwd(q, k, v, causal=True)
    # non-causal rectangular attention is allowed
    out = tops.flash_attention(q, k, v, causal=False)
    want = tops.mha_reference(q, k, v, causal=False)
    np.testing.assert_allclose(_np(out), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_flash_odd_length_routes_to_mha_reference():
    q, k, v = _qkv(8, s=96)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv)
    assert torch.equal(got, tops.mha_reference(tq, tk, tv))
    np.testing.assert_allclose(_np(got), _np(jops.flash_attention(jq, jk, jv)),
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# flash attention backward: the port's autograd Function (plain route on
# the CPU) against jax.vjp through the JAX Pallas backward kernels.
# Gradient tolerances: 2e-4 in f32 (tests/test_ops.py:51), 3e-2 in bf16.

GRAD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# (seq, JAX block, the JAX backward kernel that this regime runs)
BWD_REGIMES = [(128, 1024, "_bwd_fused_kernel"),
               (256, 128, "_bwd_dq_kernel")]


def _spy(monkeypatch, name):
    """Count the calls of a JAX Pallas kernel body (made while the
    interpreter traces it), to show the JAX side reached that kernel."""
    calls = []
    body = getattr(jflash_mod, name)

    def spy(*args, **kw):
        calls.append(name)
        return body(*args, **kw)

    monkeypatch.setattr(jflash_mod, name, spy)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq,block,kernel", BWD_REGIMES)
def test_flash_grads_match_jax_pallas(seq, block, kernel, causal, dtype,
                                      monkeypatch):
    q, k, v = _qkv(9, b=1, s=seq, h=2)
    g = np.random.default_rng(10).standard_normal(q.shape, dtype=np.float32)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_both(a, dtype)
                                              for a in (q, k, v, g))
    calls = _spy(monkeypatch, kernel)
    _, vjp = jax.vjp(lambda a, b_, c: jops.flash_attention(
        a, b_, c, causal=causal, block_q=block, block_k=block), jq, jk, jv)
    want = vjp(jg)
    assert calls, f"the JAX backward did not reach {kernel}"
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = tops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, tg)
    tol = GRAD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tq.dtype, name
        np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol,
                                   err_msg=name)


def _to_bhsd(a):
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _from_bhsd(a, b, h):
    bh, s, d = a.shape
    return np.ascontiguousarray(
        np.asarray(a, np.float32).reshape(b, h, s, d).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq,block,kernel", BWD_REGIMES)
def test_flash_bwd_plain_matches_jax_flash_bwd_bf16(seq, block, kernel,
                                                    causal):
    """The plain backward against the JAX package's _flash_bwd on the
    same bf16 residuals (out and lse from the JAX forward kernel), where
    the rounding points matter: q*scale, p and ds in bf16, products
    accumulated in f32."""
    q, k, v = _qkv(11, b=1, s=seq, h=2)
    b, s, h, d = q.shape
    g = np.random.default_rng(12).standard_normal(q.shape, dtype=np.float32)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(_to_bhsd(a), jnp.bfloat16)
                      for a in (q, k, v, g))
    j_out, j_lse = jflash_mod._flash_fwd(jq, jk, jv, scale, causal, block,
                                         block)
    want = jflash_mod._flash_bwd(jq, jk, jv, j_out, j_lse, jg, scale, causal,
                                 block, block)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = tops.flash_attention_bwd_plain(
        *(bf(a) for a in (q, k, v, _from_bhsd(j_out, b, h))),
        torch.from_numpy(np.array(j_lse, np.float32).reshape(b, h, s)),
        bf(g), causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(_np(a), _from_bhsd(w, b, h),
                                   atol=GRAD_TOL["bfloat16"],
                                   rtol=GRAD_TOL["bfloat16"], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_q_matches_jax_scaling(dtype, monkeypatch):
    """The one rounding of q that the kernels and the plain versions share,
    q * sm_scale in q's dtype, is the JAX kernels' own
    (``q * jnp.asarray(sm_scale, q.dtype)``, ray_tpu/ops/flash_attention.py
    :85 and :120): bitwise equal for bf16 and f32, at a scale that bf16
    does not hold exactly. Both plain versions reach it."""
    q, k, v = _qkv(15, b=1, s=128, h=2)
    scale = 1.0 / math.sqrt(40.0)
    jq, tq = _both(q, dtype)
    want = _np(jq * jnp.asarray(scale, jq.dtype))
    np.testing.assert_array_equal(_np(fa_mod._scale_q(tq, scale)), want)
    calls = []
    helper = fa_mod._scale_q
    monkeypatch.setattr(fa_mod, "_scale_q",
                        lambda *a: calls.append(a) or helper(*a))
    tk, tv = (_both(a, dtype)[1] for a in (k, v))
    out, lse = fa_mod.flash_attention_fwd_plain(tq, tk, tv, True, scale)
    fa_mod.flash_attention_bwd_plain(tq, tk, tv, out, lse, out, True, scale)
    assert len(calls) == 2 and all(a[1] == scale for a in calls)


def test_flash_backward_uses_saved_residuals(monkeypatch):
    """The backward runs from (q, k, v, out, lse) saved by the forward and
    never runs the forward again."""
    fwd_calls, bwd_calls = [], []
    fwd, bwd = fa_mod.flash_attention_fwd_plain, fa_mod.flash_attention_bwd
    monkeypatch.setattr(fa_mod, "flash_attention_fwd_plain",
                        lambda *a: fwd_calls.append(1) or fwd(*a))
    monkeypatch.setattr(fa_mod, "flash_attention_bwd",
                        lambda *a: bwd_calls.append(a) or bwd(*a))
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(13, b=1, s=128, h=2))
    out = tops.flash_attention(q, k, v)
    out.transpose(1, 2).sum().backward()       # a strided output gradient
    assert len(fwd_calls) == 1 and len(bwd_calls) == 1
    saved_q, _, _, saved_out, saved_lse, do = bwd_calls[0][:6]
    assert saved_q is q and torch.equal(saved_out, out)
    assert saved_lse.shape == (1, 2, 128) and do.is_contiguous()


def test_flash_bwd_checks_its_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(14, b=1, s=128, h=2))
    out, lse = tops.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        tops.flash_attention_bwd(q, k, v, out, lse[:, :1], out)
    with pytest.raises(ValueError, match="do"):
        tops.flash_attention_bwd(q, k, v, out, lse, out[:, :64])


def test_flash_fwd_has_no_fallback_off_cpu():
    """A tensor that is not on the CPU never gets the plain version: the
    wrapper launches the kernel or raises (here: no kernel for 'meta')."""
    q = torch.empty((1, 128, 2, 32), device="meta")
    before = tops.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="no kernel"):
        tops.flash_attention_fwd(q, q, q)
    assert tops.flash_attention_fwd.launches == before
    lse = torch.empty((1, 2, 128), device="meta")
    before = tops.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="no kernel"):
        tops.flash_attention_bwd(q, q, q, q, lse, q)
    assert tops.flash_attention_bwd.launches == before


# ---------------------------------------------------------------------------
# paged KV-cache primitives


def _cache(seed, n=6, bs=4, kh=2, hd=8):
    return np.random.default_rng(seed).standard_normal(
        (n, bs, kh, hd), dtype=np.float32)


def test_paged_gather_clips_like_jax():
    cache = _cache(10)
    rows = np.array([[3, 0, -1], [5, 9, 2]], np.int64)   # -1 and 9 clip
    want = jops.paged_gather_kv(jnp.asarray(cache), jnp.asarray(rows))
    got = tops.paged_gather_kv(torch.from_numpy(cache), torch.from_numpy(rows))
    assert got.shape == (2, 12, 2, 8)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_paged_write_step_drops_inactive_slots():
    cache = _cache(11)
    rows = np.array([[1, 2, -1], [4, -1, -1], [0, -1, -1]], np.int64)
    positions = np.array([5, 2, 3], np.int64)
    new = np.random.default_rng(12).standard_normal((3, 2, 8),
                                                    dtype=np.float32)
    active = np.array([True, True, False])
    want = jops.paged_write_step(jnp.asarray(cache), jnp.asarray(rows),
                                 jnp.asarray(positions), jnp.asarray(new),
                                 jnp.asarray(active))
    tc = torch.from_numpy(cache.copy())
    got = tops.paged_write_step(tc, torch.from_numpy(rows),
                                torch.from_numpy(positions),
                                torch.from_numpy(new), torch.from_numpy(active))
    assert got is tc                                   # written in place
    np.testing.assert_array_equal(_np(got), _np(want))
    # the inactive slot's block 0 is untouched
    np.testing.assert_array_equal(_np(got)[0], cache[0])


@pytest.mark.parametrize("start", [0, 3])
def test_paged_write_prefill_drops_pad_rows(start):
    cache = _cache(13)
    row = np.array([2, 5, 1, -1], np.int64)
    seq = np.random.default_rng(14).standard_normal((8, 2, 8),
                                                    dtype=np.float32)
    length = 5                                          # rows 5..7 are pad
    want = jops.paged_write_prefill(jnp.asarray(cache), jnp.asarray(row),
                                    jnp.asarray(seq), jnp.int32(length),
                                    start)
    got = tops.paged_write_prefill(torch.from_numpy(cache.copy()),
                                   torch.from_numpy(row),
                                   torch.from_numpy(seq), length, start)
    np.testing.assert_array_equal(_np(got), _np(want))
    # the pad rows' positions (start + length on) stay as they were
    end = start + length
    flat = _np(got)[row[:3]].reshape(12, 2, 8)
    np.testing.assert_array_equal(flat[end:], cache[row[:3]].reshape(
        12, 2, 8)[end:])


def test_paged_attention_decode_matches_jax():
    rng = np.random.default_rng(15)
    kc, vc = _cache(16), _cache(17)
    q = rng.standard_normal((3, 4, 8), dtype=np.float32)   # H=4, KH=2
    rows = np.array([[1, 2, -1], [4, 3, 0], [5, -1, -1]], np.int64)
    lengths = np.array([6, 11, 1], np.int64)
    want = jops.paged_attention_decode(*map(jnp.asarray,
                                            (q, kc, vc, rows, lengths)))
    got = tops.paged_attention_decode(*map(torch.from_numpy,
                                           (q, kc, vc, rows, lengths)))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("start", [0, 5])
def test_paged_attention_prefill_matches_jax(start):
    rng = np.random.default_rng(18)
    kc, vc = _cache(19), _cache(20)
    q = rng.standard_normal((4, 4, 8), dtype=np.float32)
    row = np.array([3, 0, 4, -1], np.int64)
    want = jops.paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(row),
        jnp.int32(start), jnp.int32(4))
    got = tops.paged_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(row), start, 4)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)
