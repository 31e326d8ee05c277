"""Parity of the port's GPT (ray_tpu_torch.models.gpt) with the JAX
package's, on the CPU, at GPTConfig.tiny in f32.

Both sides compute with the same weights: the JAX init's parameters go
through numpy into the port (gpt_params_from_numpy), and the tokens are
numpy arrays from a seed. Tolerances:
- logits 1e-4 (atol and rtol), as tests/test_torch_llama.py: both sides
  are f32 throughout and differ only by summation order;
- losses 1e-4 relative, the same reason;
- gradients 2e-4 of each parameter's largest |gradient| (atol) and 2e-4
  relative, the gradient tolerance of tests/test_ops.py:51;
- parameters after three AdamW steps 2 * lr * steps (atol). Adam's
  first step is about lr * sign(g): an entry whose gradient is near zero
  (a bias, a padded vocabulary row) can take either sign on the two sides
  when the sums run in another order, and differ by up to 2 * lr a step.
  That bound alone would pass a wrong update, so beside it at most 0.1%
  of a parameter's entries may differ by more than lr / 100 (measured:
  the largest difference is 0.01 * lr, and 0.012% of w_proj's entries
  lie above lr / 100).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import GPT as JGPT
from ray_tpu.models import GPTConfig as JConfig
from ray_tpu_torch.models import GPT, GPTConfig, gpt_params_from_numpy

TOL = 1e-4
GRAD_TOL = 2e-4
LR, STEPS = 3e-4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and it
    leaves the machine's cores to the test files running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(max_seq=128, use_flash=True, **jax_kw):
    """(jax model, jax params, port model, port params) on the same
    weights."""
    jm = JGPT(JConfig.tiny(dtype=jnp.float32, remat=False,
                           use_flash=use_flash, max_seq=max_seq, **jax_kw))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = GPT(GPTConfig.tiny(dtype=torch.float32, use_flash=use_flash,
                            max_seq=max_seq, remat=False))
    tp = gpt_params_from_numpy({n: np.asarray(a) for n, a in jp.items()},
                               tm.config, torch.device("cpu"))
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(seed, b, s, vocab=512):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return tokens, np.roll(tokens, -1, axis=1)


def test_init_names_shapes_and_dtypes_match_jax(pair):
    jm, jp, tm, _ = pair
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = tm.init(gen)
    assert set(params) == set(jp)
    for name, arr in jp.items():
        assert tuple(params[name].shape) == arr.shape, name
        assert params[name].dtype == torch.float32, name
        if name.endswith("_g"):          # layernorm gains start at one
            assert torch.equal(params[name], torch.ones_like(params[name]))
        elif name.startswith("b_") or name.endswith("_b"):
            assert torch.equal(params[name], torch.zeros_like(params[name]))
    assert params["wte"].shape[0] % 128 == 0          # padded vocabulary
    # the residual projections start 1/sqrt(2L) narrower, as in JAX
    ratio = params["w_proj"].std() / params["w_qkv"].std()
    assert abs(float(ratio) - 0.5) < 0.05            # L = 2


@pytest.mark.parametrize("preset", ["tiny", "small", "medium"])
def test_num_params_and_flops_match_jax(preset):
    jm = JGPT(getattr(JConfig, preset)())
    tm = GPT(getattr(GPTConfig, preset)())
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(1024) == jm.flops_per_token(1024)
    assert tm.flops_per_token() == jm.flops_per_token()
    if preset == "small":
        assert tm.num_params() == 124_475_904
        assert tm.flops_per_token(1024) == 803_478_528


def test_convert_rejects_wrong_names_and_shapes(pair):
    _, jp, tm, _ = pair
    arrays = {n: np.asarray(a) for n, a in jp.items()}
    with pytest.raises(ValueError, match="missing"):
        gpt_params_from_numpy({n: a for n, a in arrays.items()
                               if n != "w_qkv"}, tm.config, "cpu")
    with pytest.raises(ValueError, match="extra"):
        gpt_params_from_numpy({**arrays, "lm_head": arrays["wte"]},
                              tm.config, "cpu")
    arrays["w_fc"] = arrays["w_fc"][:, :, :8]
    with pytest.raises(ValueError, match="w_fc"):
        gpt_params_from_numpy(arrays, tm.config, "cpu")


@pytest.mark.parametrize("use_flash", [True, False])
def test_apply_logits_match_jax(use_flash):
    """S=128 so the JAX side's flash path runs its Pallas kernel (in
    interpret mode) and the port's runs its flash wrapper."""
    jm, jp, tm, tp = _pair(use_flash=use_flash)
    tokens, _ = _tokens(1, 2, 128)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(tokens)))
    got = tm.apply(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 128, tm.config.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_loss_chunked_matches_loss(pair):
    _, _, tm, tp = pair
    tokens, targets = (torch.from_numpy(a) for a in _tokens(2, 2, 32))
    params = {n: p.clone().requires_grad_() for n, p in tp.items()}
    full = tm.loss(params, tokens, targets)
    g_full = torch.autograd.grad(full, list(params.values()))
    chunked = tm.loss_chunked(params, tokens, targets, num_chunks=4)
    g_chunked = torch.autograd.grad(chunked, list(params.values()))
    np.testing.assert_allclose(chunked.item(), full.item(), rtol=1e-5)
    for name, a, b in zip(params, g_chunked, g_full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)
    with pytest.raises(ValueError, match="chunks"):
        tm.loss_chunked(params, tokens, targets, num_chunks=5)


def test_causality(pair):
    _, _, tm, tp = pair
    t1 = torch.from_numpy(_tokens(3, 1, 128)[0])
    t2 = t1.clone()
    t2[0, -1] = (t2[0, -1] + 1) % 512
    l1, l2 = tm.apply(tp, t1), tm.apply(tp, t2)
    # changing the last token must not affect earlier positions
    np.testing.assert_allclose(l1[:, :-1].numpy(), l2[:, :-1].numpy(),
                               atol=1e-5)
    assert not torch.allclose(l1[:, -1], l2[:, -1])


def test_dropout_keep_rate_and_scaling(pair):
    _, _, tm, tp = pair
    model = GPT(dataclasses.replace(tm.config, dropout=0.25))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    x = torch.ones((64, 256))
    y = model._dropout(x, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    # with a generator the forward changes, and a fixed seed repeats it;
    # without one it is the eval forward
    tokens = torch.from_numpy(_tokens(4, 2, 16)[0])
    eval_logits = model.apply(tp, tokens)
    assert torch.equal(eval_logits, tm.apply(tp, tokens))
    runs = []
    for seed in (2, 2, 3):
        gen.manual_seed(seed)
        runs.append(model.apply(tp, tokens, generator=gen))
    assert not torch.allclose(eval_logits, runs[0])
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2])


def _assert_grads_match(got, want):
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("seq,block", [
    (128, 1024),   # the JAX backward runs _bwd_fused_kernel
    (256, 128),    # the JAX backward runs _bwd_dq_kernel / _bwd_dkv_kernel
])
def test_adamw_steps_match_jax(seq, block):
    """The slice as a whole: three steps of loss_chunked's value and
    gradient with AdamW, the flash path on both sides, against the JAX
    model under optax.adamw (the same update rule)."""
    jm, jp, tm, tp = _pair(max_seq=seq, flash_block_q=block,
                           flash_block_k=block)
    tokens, targets = _tokens(5, 2, seq)
    tx = optax.adamw(LR, weight_decay=0.1)

    @jax.jit
    def jstep(p, o):
        loss, g = jax.value_and_grad(jm.loss_chunked)(
            p, jnp.asarray(tokens), jnp.asarray(targets), num_chunks=2)
        updates, o = tx.update(g, o, p)
        return loss, g, optax.apply_updates(p, updates), o

    params = {n: p.clone().requires_grad_() for n, p in tp.items()}
    opt = torch.optim.AdamW(params.values(), lr=LR, weight_decay=0.1)
    t_tokens, t_targets = torch.from_numpy(tokens), torch.from_numpy(targets)
    j_opt = tx.init(jp)
    for step in range(STEPS):
        j_loss, j_grads, jp, j_opt = jstep(jp, j_opt)
        opt.zero_grad()
        loss = tm.loss_chunked(params, t_tokens, t_targets, num_chunks=2)
        loss.backward()
        if step == 0:
            _assert_grads_match({n: p.grad for n, p in params.items()},
                                j_grads)
        opt.step()
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
    for name, p in params.items():
        got, want = p.detach().numpy(), np.asarray(jp[name])
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * STEPS,
                                   err_msg=name)
        assert np.mean(np.abs(got - want) > LR / 100) <= 1e-3, name


def test_loss_chunked_bf16_matches_jax():
    """loss_chunked's value and gradients in bf16 (GPTConfig.tiny, the
    flash path on both sides) against the JAX loss_chunked on the same
    weights and tokens. The LM head keeps its f32 logits on both sides, so
    the losses agree to 2e-5 relative (measured 2.3e-6); the gradients
    carry the bf16 roundings that the two backbones make at other places
    (layernorm, gelu, the flash kernels' bf16 p and ds), so each
    parameter's ||g - g_jax|| / ||g_jax|| is held to 3e-2 (measured at
    most 1.1e-2, in b_fc)."""
    jm = JGPT(JConfig.tiny(dtype=jnp.bfloat16, remat=False, max_seq=128))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = GPT(GPTConfig.tiny(dtype=torch.bfloat16, max_seq=128, remat=False))
    tp = gpt_params_from_numpy({n: np.asarray(a) for n, a in jp.items()},
                               tm.config, torch.device("cpu"))
    tokens, targets = _tokens(5, 2, 128)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss_chunked),
                              static_argnames="num_chunks")(
        jp, jnp.asarray(tokens), jnp.asarray(targets), num_chunks=2)
    params = {n: p.clone().requires_grad_() for n, p in tp.items()}
    loss = tm.loss_chunked(params, torch.from_numpy(tokens),
                           torch.from_numpy(targets), num_chunks=2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-5)
    for name, want in j_grads.items():
        want = np.asarray(want)
        got = params[name].grad.numpy()
        assert got.shape == want.shape, name
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-2, (name, rel)


# ---------------------------------------------------------------------------
# positions and the paged serving path, against the JAX methods. Both sides
# are f32 throughout (mha_reference / the plain paged primitives), so they
# differ only by summation order: logits and written cache blocks to 2e-5.

PAGED_TOL = 2e-5


@pytest.fixture(scope="module")
def plain_pair():
    """GPTConfig.tiny in f32 with use_flash=False, the serving registry's
    gpt-tiny, on the JAX init's weights."""
    return _pair(use_flash=False)


@pytest.mark.parametrize("positions", [None, "offset"])
def test_apply_positions_match_jax(plain_pair, positions):
    """GPT.apply indexes wpe by ``positions``; a positions tensor passed
    in the reference's argument order is not taken for a generator."""
    jm, jp, tm, tp = plain_pair
    tokens = np.random.RandomState(0).randint(0, 512, (1, 8))
    if positions is None:
        want = jm.apply(jp, jnp.asarray(tokens))
        got = tm.apply(tp, torch.from_numpy(tokens))
    else:
        pos = np.arange(8, 16)[None]
        want = jm.apply(jp, jnp.asarray(tokens), jnp.asarray(pos))
        got = tm.apply(tp, torch.from_numpy(tokens), torch.from_numpy(pos))
        # the offset moves the logits far beyond the tolerance
        base = tm.apply(tp, torch.from_numpy(tokens))
        assert (got - base).abs().max() > 100 * PAGED_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PAGED_TOL, rtol=0)


def _assert_cache_matches(tcache, jcache):
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=PAGED_TOL,
                                   rtol=0, err_msg=key)


def test_paged_prefill_extend_and_decode_match_jax(plain_pair):
    """paged_prefill writes a 13-token prompt (padded to 16) into blocks
    5, 2, 7, 4; paged_prefill_extend then writes a 5-token suffix (padded
    to 8) at start 8 over the prefix's first two blocks, in a second
    table whose third block is fresh; paged_decode_step continues both
    sequences, with an inactive third slot. Logits and every written
    cache block against the JAX methods."""
    jm, jp, tm, tp = plain_pair
    nb, bs = 10, 4
    jcache = jm.init_paged_cache(nb, bs)
    tcache = tm.init_paged_cache(nb, bs, torch.device("cpu"))
    rng = np.random.default_rng(7)

    prompt = rng.integers(1, 512, 13)
    tokens = np.zeros((1, 16), np.int64)
    tokens[0, :13] = prompt
    row_a = np.array([5, 2, 7, 4, -1, -1], np.int64)
    j_logits, jcache = jax.jit(jm.paged_prefill)(
        jp, jcache, jnp.asarray(tokens), jnp.int32(13), jnp.asarray(row_a))
    t_logits, tcache = tm.paged_prefill(tp, tcache, torch.from_numpy(tokens),
                                        13, torch.from_numpy(row_a))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=PAGED_TOL, rtol=0)
    _assert_cache_matches(tcache, jcache)

    suffix = np.zeros((1, 8), np.int64)
    suffix[0, :5] = rng.integers(1, 512, 5)
    row_b = np.array([5, 2, 9, 1, -1, -1], np.int64)
    j_logits, jcache = jax.jit(jm.paged_prefill_extend)(
        jp, jcache, jnp.asarray(suffix), jnp.int32(8), jnp.int32(5),
        jnp.asarray(row_b))
    t_logits, tcache = tm.paged_prefill_extend(
        tp, tcache, torch.from_numpy(suffix), 8, 5, torch.from_numpy(row_b))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=PAGED_TOL, rtol=0)
    _assert_cache_matches(tcache, jcache)
    # the extend computes the whole prompt's last logits at suffix cost
    full = np.concatenate([prompt[:8], suffix[0, :5]])[None]
    dense = tm.apply(tp, torch.from_numpy(full))[0, -1]
    np.testing.assert_allclose(t_logits.numpy(), dense.numpy(),
                               atol=PAGED_TOL, rtol=0)

    step_tokens = np.array([int(t_logits.argmax()), 17, 99])
    positions = np.array([13, 13, 3], np.int64)
    rows = np.stack([row_a, row_b, np.array([0, 3, -1, -1, -1, -1])])
    active = np.array([True, True, False])
    j_logits, jcache = jax.jit(jm.paged_decode_step)(
        jp, jcache, *map(jnp.asarray, (step_tokens, positions, rows, active)))
    t_logits, tcache = tm.paged_decode_step(
        tp, tcache, *map(torch.from_numpy,
                         (step_tokens, positions, rows, active)))
    np.testing.assert_allclose(t_logits.numpy()[:2],
                               np.asarray(j_logits)[:2], atol=PAGED_TOL,
                               rtol=0)
    _assert_cache_matches(tcache, jcache)
    # the inactive slot wrote nothing into its blocks 0 and 3
    assert not tcache["k"][:, [0, 3]].any()
