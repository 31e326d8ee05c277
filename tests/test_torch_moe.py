"""Parity of the port's MoE (ray_tpu_torch.models.moe) with the JAX
package's, on the CPU, at MoEConfig.tiny in f32 (head_dim 16).

Both sides compute with the same weights: the JAX init's parameters go
through numpy into the port (moe_params_from_numpy), and tokens and
activations are numpy arrays from a seed. At S=128 the JAX flash path
runs its Pallas kernels in interpret mode and the port's its plain
versions. Tolerances:
- logits, aux loss and the MoE layer's output 2e-5 (atol and rtol): both
  sides are f32 throughout and differ only by summation order;
- losses 2e-5 relative, the same reason;
- gradients 2e-4 of each parameter's largest |gradient| (atol) and 2e-4
  relative, the gradient tolerance of tests/test_ops.py:51;
- parameters after three AdamW steps as tests/test_torch_gpt.py holds
  them (2 * lr * steps atol, and at most 0.1% of the entries off by more
  than lr / 100), for the reason given there.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import MoE as JMoE
from ray_tpu.models import MoEConfig as JConfig
from ray_tpu_torch.models import MoE, MoEConfig, moe_params_from_numpy

TOL = 2e-5
GRAD_TOL = 2e-4
LR, STEPS = 3e-4, 3
VOCAB = 512

jmoe_mod = importlib.import_module("ray_tpu.models.moe")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and it
    leaves the machine's cores to the test files running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(use_flash=True, **kw):
    """(jax model, jax params, port model, port params) on the same
    weights."""
    jm = JMoE(JConfig.tiny(dtype=jnp.float32, use_flash=use_flash, **kw))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = MoE(MoEConfig.tiny(dtype=torch.float32, use_flash=use_flash, **kw))
    tp = moe_params_from_numpy({n: np.asarray(a) for n, a in jp.items()},
                               tm.config, torch.device("cpu"))
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(seed, b=2, s=128):
    tokens = np.random.default_rng(seed).integers(0, VOCAB, (b, s))
    return tokens, np.roll(tokens, -1, axis=1)


def test_init_names_shapes_and_axes_match_jax(pair):
    jm, jp, tm, _ = pair
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = tm.init(gen)
    assert set(params) == set(jp) == set(tm.logical_axes())
    assert tm.logical_axes() == jm.logical_axes()
    for name, arr in jp.items():
        assert tuple(params[name].shape) == arr.shape, name
        assert params[name].dtype == torch.float32, name
        if name.endswith("_g"):
            assert torch.equal(params[name], torch.ones_like(params[name]))
        elif name.startswith("b_") or name.endswith("_b"):
            assert torch.equal(params[name], torch.zeros_like(params[name]))
    # w_down starts 1/sqrt(2L) narrower than w_up, as in JAX (L = 2)
    ratio = params["w_down"].std() / params["w_up"].std()
    assert abs(float(ratio) - 0.5) < 0.05
    # param_shardings maps the logical axes through the default rules to
    # the JAX model's specs (the sharding layer, parallel/mesh.py)
    from ray_tpu.parallel.mesh import AxisRules as JAxisRules

    for name, sharding in tm.param_shardings(None).items():
        assert sharding.spec == tuple(JAxisRules().mesh_axes(
            jm.logical_axes()[name])), name


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_config_and_num_params_match_jax(preset):
    jc, tc = getattr(JConfig, preset)(), getattr(MoEConfig, preset)()
    for field in ("vocab_size", "n_layer", "n_head", "d_model", "d_ff",
                  "num_experts", "top_k", "capacity_factor",
                  "aux_loss_coeff", "max_seq", "use_flash", "padded_vocab",
                  "head_dim"):
        assert getattr(tc, field) == getattr(jc, field), field
    assert MoE(tc).num_params() == JMoE(jc).num_params()


def test_convert_rejects_wrong_names_and_shapes(pair):
    _, jp, tm, _ = pair
    arrays = {n: np.asarray(a) for n, a in jp.items()}
    with pytest.raises(ValueError, match="missing"):
        moe_params_from_numpy({n: a for n, a in arrays.items()
                               if n != "w_router"}, tm.config, "cpu")
    with pytest.raises(ValueError, match="extra"):
        moe_params_from_numpy({**arrays, "w_gate": arrays["w_up"]},
                              tm.config, "cpu")
    arrays["w_up"] = arrays["w_up"][:, :3]
    with pytest.raises(ValueError, match="w_up"):
        moe_params_from_numpy(arrays, tm.config, "cpu")


@pytest.mark.parametrize("use_flash", [True, False])
def test_apply_logits_and_aux_match_jax(use_flash):
    """S=128: with use_flash the JAX side runs its Pallas forward at
    head_dim 16 (interpret mode) and the port its flash wrapper."""
    jm, jp, tm, tp = _pair(use_flash=use_flash)
    tokens, _ = _tokens(1)
    j_logits, j_aux = jax.jit(jm.apply)(jp, jnp.asarray(tokens))
    logits, aux = tm.apply(tp, torch.from_numpy(tokens))
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    assert tuple(logits.shape) == (2, 128, tm.config.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux.item(), float(j_aux), atol=TOL, rtol=TOL)


class _RecordingJnp:
    """Stands in for ``jnp`` in ray_tpu.models.moe and records the
    renormalised route weights [T, K] that reach the combine einsum:
    a route is kept exactly where its weight is positive."""

    def __init__(self):
        self.top_w = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kw):
        if spec == "tke,tkc,tk->tec":
            self.top_w.append(np.asarray(operands[2]))
        return jnp.einsum(spec, *operands, **kw)


def _k_major_keep(top_e, cap, num_experts):
    """The kept routes if capacity were counted k-major (every token's
    first choice before any second choice, GShard's usual order)."""
    T, K = top_e.shape
    assign = np.eye(num_experts)[top_e.T.reshape(-1)]        # [K*T, E]
    pos = (np.cumsum(assign, 0) - assign)[np.arange(K * T),
                                          top_e.T.reshape(-1)]
    return (pos < cap).reshape(K, T).T


@pytest.mark.parametrize("capacity_factor,dropped", [(0.5, True),
                                                     (4.0, False)])
def test_moe_ffn_and_kept_routes_match_jax(capacity_factor, dropped,
                                           monkeypatch):
    """One MoE layer on the same activations: its output and aux loss,
    and the set of kept (token, k) routes, which is JAX's exactly.
    Capacity positions are counted token-major; at capacity_factor 0.5
    a k-major count keeps another set, which the assertion would catch."""
    jm, jp, tm, tp = _pair(capacity_factor=capacity_factor)
    x = np.random.default_rng(2).standard_normal((2, 128, 64)).astype(
        np.float32)
    j_lp = {n: v[0] for n, v in jp.items()
            if n not in ("wte", "wpe", "lnf_g", "lnf_b")}
    t_lp = {n: v[0] for n, v in tp.items()
            if n not in ("wte", "wpe", "lnf_g", "lnf_b")}
    spy = _RecordingJnp()
    monkeypatch.setattr(jmoe_mod, "jnp", spy)
    j_out, j_aux = jm._moe_ffn(jnp.asarray(x), j_lp)
    monkeypatch.undo()
    out, aux = tm._moe_ffn(torch.from_numpy(x), t_lp)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(aux.item(), float(j_aux), atol=TOL, rtol=TOL)

    routes = tm._route(torch.from_numpy(x).reshape(256, 64),
                       t_lp["w_router"])
    (j_top_w,) = spy.top_w
    keep = routes.keep.numpy()
    np.testing.assert_array_equal(keep, j_top_w > 0)
    assert (~keep).any() == dropped
    cap = routes.combine.shape[-1]
    assert cap == max(1, int(capacity_factor * 256 * 2 / 4))
    k_major = _k_major_keep(routes.top_e.numpy(), cap, 4)
    assert (k_major != keep).any() == dropped


def test_combine_holds_each_kept_route_once():
    """combine [T, E, C]: each kept route's renormalised weight in its
    expert's slot, each slot used at most once, each token's weights
    summing to one (or zero with every route dropped)."""
    _, _, tm, tp = _pair(capacity_factor=0.5)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (256, 64)).astype(np.float32))
    r = tm._route(x, tp["w_router"][0])
    combine = r.combine
    assert ((combine > 0).sum(0) <= 1).all()            # one token a slot
    assert torch.equal((combine > 0).sum((1, 2)), r.keep.sum(-1))
    sums = combine.sum((1, 2))
    kept_any = r.keep.any(-1)
    np.testing.assert_allclose(sums[kept_any].numpy(), 1.0, atol=1e-6)
    assert torch.equal(sums[~kept_any], torch.zeros_like(sums[~kept_any]))


def _assert_grads_match(got, want):
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(w).max()), err_msg=name)


def test_grads_match_jax(pair):
    """jax.grad of the loss (cross entropy plus the aux loss) against
    .backward() for every parameter, router and experts included, the
    flash path on both sides (the JAX backward runs its fused Pallas
    kernel at S=128)."""
    jm, jp, tm, tp = pair
    tokens, targets = _tokens(4)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, jnp.asarray(tokens), jnp.asarray(targets))
    params = {n: p.clone().requires_grad_() for n, p in tp.items()}
    loss = tm.loss(params, torch.from_numpy(tokens),
                   torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
    for name in ("w_router", "w_up", "w_down", "b_up", "b_down"):
        assert float(np.abs(np.asarray(j_grads[name])).max()) > 0, name
    _assert_grads_match({n: p.grad for n, p in params.items()}, j_grads)


def test_adamw_steps_match_jax(pair):
    """The slice as a whole: three steps of the loss's value and gradient
    with AdamW, the flash path on both sides, against the JAX model under
    optax.adamw (the same update rule)."""
    jm, jp, tm, tp = pair
    tokens, targets = _tokens(5)
    tx = optax.adamw(LR, weight_decay=0.1)

    @jax.jit
    def jstep(p, o):
        loss, g = jax.value_and_grad(jm.loss)(
            p, jnp.asarray(tokens), jnp.asarray(targets))
        updates, o = tx.update(g, o, p)
        return loss, optax.apply_updates(p, updates), o

    params = {n: p.clone().requires_grad_() for n, p in tp.items()}
    opt = torch.optim.AdamW(params.values(), lr=LR, weight_decay=0.1)
    t_tokens, t_targets = torch.from_numpy(tokens), torch.from_numpy(targets)
    j_opt = tx.init(jp)
    losses = []
    for _ in range(STEPS):
        j_loss, jp, j_opt = jstep(jp, j_opt)
        opt.zero_grad()
        loss = tm.loss(params, t_tokens, t_targets)
        loss.backward()
        opt.step()
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    for name, p in params.items():
        got, want = p.detach().numpy(), np.asarray(jp[name])
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * STEPS,
                                   err_msg=name)
        assert np.mean(np.abs(got - want) > LR / 100) <= 1e-3, name
