"""Parity of the port's fused block entry and exit (ray_tpu_torch.ops.fused
and ``GPTConfig.fused_entry_exit``) with the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs its Pallas kernels (``_ln_matmul_kernel``, ``_mm_res_kernel``)
in interpret mode, with blocks small enough that the grid has more than
one block in each dimension, and a spy shows that the kernel bodies ran;
the port runs its plain versions, which is what a CPU tensor gets, and the
JAX package's plain recompute backward. Tolerances: 2e-4 for f32 (the
reference's own, tests/test_fused_ops.py:21-22, 41-42), 3e-2 for bf16
(bf16 rounding, as tests/test_ops.py:61); the model against the JAX model
as tests/test_torch_gpt.py (loss 1e-4, gradients 2e-4), the fused model
against the unfused one as tests/test_fused_ops.py:83-88 (1e-4, 5e-3).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT as JGPT
from ray_tpu.models import GPTConfig as JConfig
from ray_tpu_torch import ops as tops
from ray_tpu_torch.models import GPT, GPTConfig, gpt_params_from_numpy

jfused = importlib.import_module("ray_tpu.ops.fused")
tgpt = importlib.import_module("ray_tpu_torch.models.gpt")

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# a JAX grid of (3, 2) blocks: 192 rows in blocks of 64, 256 columns in
# blocks of 128
N, D, F, BLOCK_M, BLOCK_N = 192, 64, 256, 64, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and it
    leaves the machine's cores to the test files running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spy(monkeypatch, name):
    """Count the calls of a JAX Pallas kernel body (made while the
    interpreter traces it), to show the JAX side reached that kernel."""
    calls = []
    body = getattr(jfused, name)

    def spy(*args, **kw):
        calls.append(name)
        return body(*args, **kw)

    monkeypatch.setattr(jfused, name, spy)
    return calls


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _case(kernel, seed, dtype):
    """(JAX function, port function, [(array, dtype)] inputs, cotangent) of
    one fused kernel. The layernorm's gain and shift stay f32 whatever the
    dtype (raw parameters, as at the model's call site)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    if kernel == "ln_matmul":
        args = [(r(N, D) * 2 + 0.5, dtype), (1 + 0.1 * r(D), "float32"),
                (0.1 * r(D), "float32"), (0.1 * r(D, F), dtype),
                (0.1 * r(F), dtype)]
        jfn = lambda *a: jfused.ln_matmul(  # noqa: E731
            *a, 1e-5, BLOCK_M, BLOCK_N)
        tfn = tops.ln_matmul
    else:
        args = [(r(N, D), dtype), (0.1 * r(D, F), dtype), (0.1 * r(F), dtype),
                (r(N, F), dtype)]
        jfn = lambda *a: jfused.matmul_residual(  # noqa: E731
            *a, BLOCK_M, BLOCK_N)
        tfn = tops.matmul_residual
    return jfn, tfn, args, r(N, F)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,body", [("ln_matmul", "_ln_matmul_kernel"),
                                         ("matmul_residual",
                                          "_mm_res_kernel")])
def test_fused_op_and_grads_match_jax_pallas(kernel, body, dtype,
                                             monkeypatch):
    jfn, tfn, args, cot = _case(kernel, 1, dtype)
    calls = _spy(monkeypatch, body)
    out, vjp = jax.vjp(jfn, *(jnp.asarray(a, getattr(jnp, t))
                              for a, t in args))
    want = vjp(jnp.asarray(cot, getattr(jnp, dtype)))
    assert calls, f"the JAX side did not reach {body}"
    leaves = [torch.from_numpy(a).to(getattr(torch, t)).requires_grad_()
              for a, t in args]
    got = tfn(*leaves)
    assert got.dtype == leaves[0].dtype and got.shape == (N, F)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(out), atol=tol, rtol=tol)
    grads = torch.autograd.grad(got, leaves,
                                torch.from_numpy(cot).to(got.dtype))
    for i, (a, w) in enumerate(zip(grads, want)):
        assert a.dtype == leaves[i].dtype, i
        np.testing.assert_allclose(_np(a), _np(w), atol=tol, rtol=tol,
                                   err_msg=f"gradient {i}")


def test_fused_backward_dtypes_follow_jax():
    """The backward functions return each gradient in the dtype the JAX
    backward gives it: ln_matmul's dwb in x's dtype, matmul_residual's db
    in a's, dres the output gradient itself; the products are not rerun
    from the forward."""
    _, _, args, cot = _case("ln_matmul", 2, "bfloat16")
    x, g, b, w, _ = (torch.from_numpy(a).to(getattr(torch, t))
                     for a, t in args)
    dout = torch.from_numpy(cot).to(torch.bfloat16)
    dx, dg, db, dw, dwb = tops.fused.ln_matmul_bwd(x, g, b, w, dout, 1e-5)
    assert [t.dtype for t in (dx, dg, db, dw, dwb)] == [
        torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
        torch.bfloat16]
    a = torch.from_numpy(args[0][0]).to(torch.bfloat16)
    da, dw, db, dres = tops.fused.matmul_residual_bwd(a, w, dout)
    assert dres is dout
    assert [t.dtype for t in (da, dw, db)] == [torch.bfloat16] * 3
    # bf16 operands: the bf16 product (f32 accumulation) against the f32
    # product of the same values, rounded once
    want = (dout.float() @ w.float().T).to(torch.bfloat16)
    np.testing.assert_allclose(_np(da), _np(want), rtol=1e-2, atol=1e-2)


def test_fused_wrappers_check_shapes_and_have_no_fallback_off_cpu():
    """Shapes are checked on every device; a tensor that is not on the CPU
    never gets the plain version: the wrapper launches the kernel or
    raises (here: no kernel for 'meta')."""
    x, w = torch.zeros(4, 64), torch.zeros(64, 128)
    v64, v128 = torch.zeros(64), torch.zeros(128)
    with pytest.raises(ValueError, match="g must be"):
        tops.ln_matmul_fwd(x, v128, v64, w, v128)
    with pytest.raises(ValueError, match="res must be"):
        tops.matmul_residual_fwd(x, w, v128, x)
    meta = [t.to("meta") for t in (x, v64, w, v128)]
    before = tops.ln_matmul_fwd.launches, tops.matmul_residual_fwd.launches
    with pytest.raises(ValueError, match="no kernel"):
        tops.ln_matmul_fwd(meta[0], meta[1], meta[1], meta[2], meta[3])
    with pytest.raises(ValueError, match="no kernel"):
        tops.matmul_residual_fwd(meta[0], meta[2], meta[3],
                                 torch.zeros(4, 128, device="meta"))
    assert (tops.ln_matmul_fwd.launches,
            tops.matmul_residual_fwd.launches) == before


# ---------------------------------------------------------------------------
# the model: GPTConfig.tiny(fused_entry_exit=True) in f32


def _tokens(seed, b=2, s=64, vocab=512):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def fused_pair():
    """(jax fused model, jax params, port fused model, port params) on the
    same weights. S=64 sends attention to mha_reference on both sides."""
    jm = JGPT(JConfig.tiny(dtype=jnp.float32, remat=False,
                           fused_entry_exit=True))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = GPT(GPTConfig.tiny(dtype=torch.float32, fused_entry_exit=True))
    tp = gpt_params_from_numpy({n: np.asarray(a) for n, a in jp.items()},
                               tm.config, torch.device("cpu"))
    return jm, jp, tm, tp


def _loss_and_grads(model, params, tokens, targets):
    leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
    loss = model.loss(leaves, torch.from_numpy(tokens),
                      torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


@pytest.mark.parametrize("reference", ["jax fused", "port unfused"])
def test_fused_gpt_loss_and_grads(fused_pair, reference, monkeypatch):
    jm, jp, tm, tp = fused_pair
    tokens, targets = _tokens(3)
    loss, grads = _loss_and_grads(tm, tp, tokens, targets)
    if reference == "jax fused":
        calls = [_spy(monkeypatch, "_ln_matmul_kernel"),
                 _spy(monkeypatch, "_mm_res_kernel")]
        want_loss, want = jax.value_and_grad(jm.loss)(
            jp, jnp.asarray(tokens), jnp.asarray(targets))
        assert all(calls), "the JAX model did not reach both kernels"
        loss_tol, rtol, atol_scale = 1e-4, 2e-4, 2e-4
    else:
        unfused = GPT(dataclasses.replace(tm.config, fused_entry_exit=False))
        want_loss, want = _loss_and_grads(unfused, tp, tokens, targets)
        loss_tol, rtol, atol_scale = 1e-4, 5e-3, None
    np.testing.assert_allclose(loss, float(want_loss), rtol=loss_tol)
    assert set(grads) == set(want)
    for name, w in want.items():
        w = _np(w)
        atol = 5e-3 if atol_scale is None else \
            atol_scale * float(np.abs(w).max())
        np.testing.assert_allclose(_np(grads[name]), w, rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("with_generator", [True, False])
def test_fused_exit_only_without_dropout(fused_pair, with_generator,
                                         monkeypatch):
    """With dropout and a generator the entry stays fused and the exit
    takes the unfused code (which draws the dropout masks), as in the JAX
    model; without a generator (no dropout) the exit is fused too."""
    _, _, tm, tp = fused_pair
    cfg = dataclasses.replace(tm.config, dropout=0.1)
    calls = {"ln_matmul": 0, "matmul_residual": 0}
    for name in calls:
        fn = getattr(tgpt, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tgpt, name, spy)
    tokens = torch.from_numpy(_tokens(4)[0])
    gens = []
    for _ in range(2):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(5)
        gens.append(gen if with_generator else None)
    got = GPT(cfg).apply(tp, tokens, generator=gens[0])
    n_layer = cfg.n_layer
    assert calls == ({"ln_matmul": n_layer, "matmul_residual": 0}
                     if with_generator else
                     {"ln_matmul": 2 * n_layer,
                      "matmul_residual": 2 * n_layer})
    # the same dropout masks, drawn in the same order, as the unfused model
    want = GPT(dataclasses.replace(cfg, fused_entry_exit=False)).apply(
        tp, tokens, generator=gens[1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the LM head: bf16 operands, the f32 accumulation kept, as the JAX head


def _head_inputs():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 64), dtype=np.float32)
    w = rng.standard_normal((512, 64), dtype=np.float32) * 0.2
    return rng, x, w


def _bf16_ulps(got, ref, floor=1 / 1024):
    """|got - ref| in bf16 ulps of |ref|, the magnitude floored at `floor`
    of the largest |ref| (an entry whose sum cancels to near zero carries
    the rounding error of its large terms, not of its own size)."""
    mag = np.maximum(np.abs(ref), np.abs(ref).max() * floor)
    return np.abs(got - ref) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_lm_head_keeps_f32_accumulation():
    """In bf16 the port's LM head takes bf16 operands and keeps the
    product's f32 accumulation, as the JAX head does
    (preferred_element_type=f32): its logits equal the JAX logits to f32
    summation order (1e-5 at logits up to 6.9; measured 9.5e-7), far
    inside the half bf16 ulp (0.0156) that rounding them to bf16 would
    cost, and they are not bf16 values."""
    jm = JGPT(JConfig.tiny(dtype=jnp.bfloat16))
    tm = GPT(GPTConfig.tiny(dtype=torch.bfloat16))
    _, x, w = _head_inputs()
    want = np.asarray(jm._lm_head(jnp.asarray(w), jnp.asarray(x,
                                                              jnp.bfloat16)))
    got = tm._lm_head(torch.from_numpy(w),
                      torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == (2, 16, 512)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    assert not torch.equal(got, got.to(torch.bfloat16).float())


def test_lm_head_gradients_match_jax_grad():
    """dx and dw through the bf16 head against jax.grad of the JAX head,
    for a random f32 cotangent: JAX's transpose takes the f32 cotangent
    into both products and rounds once; the port splits it into two bf16
    halves (hi, lo) whose f32-accumulated products sum to the same to
    about 2^-16. Held element by element to one bf16 ulp (of |ref|,
    floored at 1/1024 of the largest), with at most 1% of the entries
    off at all (rounding flips near a tie; measured 0.39% of dx, 0.26% of
    dw, none beyond one ulp). The fault this repairs, the cotangent
    rounded to bf16 before bf16 products, lies measurably farther: over
    20% of the entries differ (measured 44% and 42%), by up to 117 ulps."""
    jm = JGPT(JConfig.tiny(dtype=jnp.bfloat16))
    tm = GPT(GPTConfig.tiny(dtype=torch.bfloat16))
    rng, x, w = _head_inputs()
    g = rng.standard_normal((2, 16, 512), dtype=np.float32)

    def head(xx, ww):
        return jnp.sum(jm._lm_head(ww, xx) * jnp.asarray(g))

    jdx, jdw = jax.grad(head, argnums=(0, 1))(jnp.asarray(x, jnp.bfloat16),
                                              jnp.asarray(w))
    want_dx = np.asarray(jdx.astype(jnp.float32))
    want_dw = np.asarray(jdw)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (tm._lm_head(tw, tx) * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    gb = torch.from_numpy(g).reshape(32, 512).to(torch.bfloat16).float()
    wb = torch.from_numpy(w).to(torch.bfloat16).float()
    xb = torch.from_numpy(x).reshape(32, 64).to(torch.bfloat16).float()
    fault = {"dx": (gb @ wb).to(torch.bfloat16).float().reshape(2, 16, 64),
             "dw": (gb.T @ xb).to(torch.bfloat16).float()}
    for name, got, want in (("dx", tx.grad.float().numpy(), want_dx),
                            ("dw", tw.grad.numpy(), want_dw)):
        ulps = _bf16_ulps(got, want)
        assert ulps.max() <= 1.0, name
        assert (ulps > 0).mean() <= 0.01, name
        fault_ulps = _bf16_ulps(fault[name].numpy(), want)
        assert (fault_ulps > 0).mean() >= 0.2 and fault_ulps.max() > 1.0, name
