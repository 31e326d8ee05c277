"""Remat in the port's GPT and Llama (``GPTConfig.remat``,
``LlamaConfig.remat``: each block under ``ray_tpu_torch.ops.remat``) on
the CPU, at the tiny configs in f32.

- The port at remat=True equals JAX ``value_and_grad(loss)`` at
  remat=True on the same weights (the JAX init through numpy) and tokens
  (numpy, from a seed), both with mha_reference: the loss to 2e-5 and
  every gradient to 2e-4 (relative and absolute), the reference's own
  tolerances (tests/test_ops.py:23-61).
- remat=True equals remat=False bit for bit: GPT's ``loss`` and
  ``loss_chunked``, GPT with dropout 0.1 and one generator seed (each
  block draws its masks from a generator seeded per layer, so the
  recompute draws the forward's), and Llama's ``loss``. A block whose
  recompute draws its masks anew from the caller's generator (the
  planted control of chip_smoke.py's phase 18) parts from remat=False.
- The saved set, counted by a ``TorchDispatchMode`` during the backward,
  with use_flash=True (the flash op's plain version at S=128): GPT's
  policy recomputes no projection (as many ``aten::mm`` calls as with
  remat off) and no flash forward; Llama's full remat recomputes both
  (one flash forward a layer).

Each JAX program is jitted and compiled once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from ray_tpu.models import GPT as JGPT
from ray_tpu.models import GPTConfig as JGPTConfig
from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JLlamaConfig
from ray_tpu_torch.models import (GPT, GPTConfig, Llama, LlamaConfig,
                                  gpt_params_from_numpy,
                                  llama_params_from_numpy)
from ray_tpu_torch.ops.remat import remat

LOSS_TOL, GRAD_TOL = 2e-5, 2e-4
TOKENS = (2, 64)
FLASH_TOKENS = (2, 128)      # S % 128 == 0: flash_attention's op runs
CHUNKS = 4
DROPOUT, DROPOUT_SEED = 0.1, 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and it
    leaves the machine's cores to the test files running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(shape, seed=3):
    tokens = np.random.default_rng(seed).integers(0, 512, shape)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_refs():
    """{"gpt", "llama"}: (numpy params, tokens, targets, JAX loss, JAX
    gradients) of value_and_grad(loss) at remat=True, each jitted once."""
    out = {}
    for name, model in (
            ("gpt", JGPT(JGPTConfig.tiny(dtype=jnp.float32, use_flash=False,
                                         remat=True))),
            ("llama", JLlama(JLlamaConfig.tiny(dtype=jnp.float32,
                                               use_flash=False,
                                               remat=True)))):
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        tokens, targets = _tokens(TOKENS)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, tokens, targets)))(params)
        out[name] = ({k: np.asarray(v) for k, v in params.items()}, tokens,
                     targets, float(loss),
                     {k: np.asarray(v) for k, v in grads.items()})
    return out


def _model(name, **kw):
    if name == "gpt":
        return GPT(GPTConfig.tiny(dtype=torch.float32, **kw))
    return Llama(LlamaConfig.tiny(dtype=torch.float32, **kw))


def _port_params(name, model, np_params=None):
    if np_params is None:
        gen = torch.Generator()
        gen.manual_seed(0)
        return model.init(gen)
    convert = gpt_params_from_numpy if name == "gpt" \
        else llama_params_from_numpy
    return convert(np_params, model.config, torch.device("cpu"))


class _Counts(TorchDispatchMode):
    """Calls of each dispatcher op, by name without its overload."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split(".")[0]
        self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(model, params, loss_fn):
    """(loss, {name: gradient}, the backward's op calls)."""
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = loss_fn(model, params)
    with _Counts() as counts:
        loss.backward()
    return loss.detach(), {k: p.grad for k, p in params.items()}, \
        counts.calls


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_remat_matches_jax_value_and_grad(jax_refs, name):
    """remat=True (mha_reference) against JAX value_and_grad(loss) at
    remat=True on the same weights and tokens."""
    np_params, tokens, targets, want_loss, want_grads = jax_refs[name]
    model = _model(name, use_flash=False)
    assert model.config.remat
    tok, tgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    loss, grads, _ = _loss_and_grads(
        model, _port_params(name, model, np_params),
        lambda m, p: m.loss(p, tok, tgt))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert grads.keys() == want_grads.keys()
    for k, want in want_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


def _case(case):
    """(model name, config overrides, loss function) of a bitwise case."""
    tok, tgt = (torch.from_numpy(a) for a in _tokens(TOKENS))

    def seeded():
        gen = torch.Generator()
        gen.manual_seed(DROPOUT_SEED)
        return gen

    return {
        "gpt-loss": ("gpt", {}, lambda m, p: m.loss(p, tok, tgt)),
        "gpt-loss_chunked": ("gpt", {}, lambda m, p: m.loss_chunked(
            p, tok, tgt, num_chunks=CHUNKS)),
        "gpt-dropout": ("gpt", {"dropout": DROPOUT},
                        lambda m, p: m.loss_chunked(p, tok, tgt, seeded(),
                                                    num_chunks=CHUNKS)),
        "llama-loss": ("llama", {}, lambda m, p: m.loss(p, tok, tgt)),
    }[case]


@pytest.mark.parametrize("case", ["gpt-loss", "gpt-loss_chunked",
                                  "gpt-dropout", "llama-loss"])
def test_remat_equals_no_remat_bitwise(case):
    """The loss and every gradient at remat=True equal remat=False's bit
    for bit: the recompute runs the same ops on the same values."""
    name, kw, loss_fn = _case(case)
    runs = []
    for on in (False, True):
        model = _model(name, use_flash=False, remat=on, **kw)
        runs.append(_loss_and_grads(model, _port_params(name, model),
                                    loss_fn)[:2])
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_dropout_drawn_anew_in_the_recompute_parts(monkeypatch):
    """The planted control: each block drawing its masks from the
    caller's one generator, which the recompute has moved on, gives other
    gradients at remat=True than at remat=False."""
    name, kw, loss_fn = _case("gpt-dropout")

    def shared_generator_layer(self, x, lp, seed):
        gen = self._control_gen

        def block(x, lp):
            return self._block(x, lp, gen)

        if self.config.remat:
            return remat(block, x, lp, saved=self.REMAT_SAVED)
        return block(x, lp)

    monkeypatch.setattr(GPT, "_layer", shared_generator_layer)
    grads = []
    for on in (False, True):
        model = _model(name, use_flash=False, remat=on, **kw)
        model._control_gen = torch.Generator()
        model._control_gen.manual_seed(DROPOUT_SEED)
        grads.append(_loss_and_grads(model, _port_params(name, model),
                                     loss_fn)[1])
    assert any(not torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_backward_recomputes_what_the_policy_does_not_save(name):
    """With use_flash=True at S=128 (the flash op's plain version), the
    ops the backward calls: under GPT's policy as many ``aten::mm`` as
    with remat off (no projection recomputed) and no flash forward; under
    Llama's full remat more products and one flash forward a layer."""
    tok, tgt = (torch.from_numpy(a) for a in _tokens(FLASH_TOKENS))
    calls = {}
    for on in (False, True):
        model = _model(name, remat=on)
        calls[on] = _loss_and_grads(model, _port_params(name, model),
                                    lambda m, p: m.loss(p, tok, tgt))[2]
    flash, mm = "ray_tpu_torch::flash_fwd", "aten::mm"
    assert calls[False].get(flash, 0) == 0
    if name == "gpt":
        assert calls[True][mm] == calls[False][mm]
        assert calls[True].get(flash, 0) == 0
    else:
        assert calls[True][mm] > calls[False][mm]
        assert calls[True][flash] == LlamaConfig.tiny().n_layer
