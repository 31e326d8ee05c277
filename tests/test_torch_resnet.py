"""Parity of the port's ResNet (ray_tpu_torch.models.resnet) with the JAX
package's, on the CPU, in f32, at two small configs:
ResNetConfig(stage_sizes=(1, 1), width=8) on 16 x 16 images (the CIFAR
stem, a stride-2 stage with its projection) and the same with
small_inputs=False on 32 x 32 images (the 7 x 7 stride-2 stem and the
SAME max pool, where XLA pads asymmetrically).

The JAX init's (params, state) go through numpy into the port
(resnet_params_from_numpy); images and labels come from a seed.
Tolerances: logits and the new batch-norm state 2e-5 (atol and rtol; f32
on both sides, summation order only); losses 2e-5 relative; gradients
2e-4 of each parameter's largest |gradient| (atol) and 2e-4 relative, as
tests/test_ops.py:51.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ray_tpu.models import ResNet as JResNet
from ray_tpu.models import ResNetConfig as JConfig
from ray_tpu_torch.models import (ResNet, ResNetConfig,
                                  resnet_params_from_numpy)
from ray_tpu_torch.models.resnet import _same_pad

TOL = 2e-5
GRAD_TOL = 2e-4
CONFIGS = {"cifar_stem": (dict(stage_sizes=(1, 1), width=8), 16),
           "imagenet_stem": (dict(stage_sizes=(1, 1), width=8,
                                  small_inputs=False), 32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(jax model, jax params and state, port model, port params and
    state, images, labels) of one config, built once: no test changes
    them. The JAX init is compiled; a jitted dict comes back with its
    names sorted, so they are put back in the order the init made them
    (read while it was traced)."""
    kw, size = CONFIGS[name]
    jm = JResNet(JConfig(dtype=jnp.float32, **kw))
    order = []

    def init(key):
        p, s = jm.init(key)
        order[:] = [list(p), list(s)]
        return p, s

    jp, js = jax.jit(init)(jax.random.PRNGKey(0))
    jp, js = ({n: tree[n] for n in names}
              for tree, names in zip((jp, js), order))
    tm = ResNet(ResNetConfig(dtype=torch.float32, **kw))
    tp, ts = resnet_params_from_numpy(
        {n: np.asarray(a) for n, a in jp.items()},
        {n: np.asarray(a) for n, a in js.items()}, tm.config,
        torch.device("cpu"))
    rng = np.random.default_rng(1)
    images = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (4,))
    return jm, jp, js, tm, tp, ts, images, labels


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_names_and_shapes_match_jax(name):
    jm, jp, js, tm, _, _, _, _ = _pair(name)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params, state = tm.init(gen)
    assert list(params) == list(jp) and list(state) == list(js)
    for got, want in ((params, jp), (state, js)):
        for n, a in want.items():
            assert tuple(got[n].shape) == a.shape, n
            assert got[n].dtype == torch.float32, n
    # He-normal convolutions: std sqrt(2 / fan_in)
    w = params["s0b0/c1"]
    assert abs(float(w.std()) / np.sqrt(2 / (3 * 3 * 8)) - 1) < 0.15
    assert all(torch.equal(state[n], torch.zeros_like(state[n]))
               for n in state if n.endswith("/mean"))


def test_resnet50_imagenet_is_the_reference_layout():
    """The reference's 'resnet50_imagenet' is a basic-block network with
    stages (3, 4, 6, 3), kept as the reference has it."""
    jc, tc = JConfig.resnet50_imagenet(), ResNetConfig.resnet50_imagenet()
    assert tc.stage_sizes == jc.stage_sizes == (3, 4, 6, 3)
    assert (tc.small_inputs, tc.num_classes) == (jc.small_inputs,
                                                 jc.num_classes)
    jp, js = jax.eval_shape(JResNet(jc).init, jax.random.PRNGKey(0))
    _, state_shapes = ResNet(tc).shapes()
    assert ResNet(tc).param_shapes() == {n: a.shape for n, a in jp.items()}
    assert state_shapes == {n: a.shape for n, a in js.items()}
    assert ResNetConfig.resnet18_cifar() == ResNetConfig()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_logits_and_state_match_jax(name, train):
    jm, jp, js, tm, tp, ts, images, _ = _pair(name)
    if not train:
        # running statistics away from their init, so eval reads them
        rng = np.random.default_rng(2)
        js = {n: jnp.asarray(np.asarray(a) + (0.5 * rng.random(a.shape)
                                              .astype(np.float32)))
              for n, a in js.items()}
        ts = {n: torch.from_numpy(np.array(a)) for n, a in js.items()}
    j_logits, j_state = jm.apply(jp, js, jnp.asarray(images), train=train)
    logits, state = tm.apply(tp, ts, torch.from_numpy(images), train=train)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (4, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=TOL, rtol=TOL)
    assert list(state) == list(j_state)
    for n, want in j_state.items():
        np.testing.assert_allclose(state[n].numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL, err_msg=n)
        assert not state[n].requires_grad
    moved = [n for n in state if not torch.equal(state[n], ts[n])]
    assert bool(moved) == train


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_grads_match_jax(name):
    jm, jp, js, tm, tp, ts, images, labels = _pair(name)

    def jloss(p):
        return jm.loss(p, js, jnp.asarray(images), jnp.asarray(labels))[0]

    j_loss, j_grads = jax.jit(jax.value_and_grad(jloss))(jp)
    params = {n: p.clone().requires_grad_() for n, p in tp.items()}
    loss, _ = tm.loss(params, ts, torch.from_numpy(images),
                      torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
    for name_, w in j_grads.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            params[name_].grad.numpy(), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(w).max()), err_msg=name_)


@pytest.mark.parametrize("n,k,stride", [(8, 3, 2), (7, 3, 2), (32, 7, 2),
                                        (16, 3, 1), (16, 1, 2), (16, 3, 2)])
def test_same_pad_matches_xla_same(n, k, stride):
    """A conv over the explicitly padded input equals XLA's SAME conv; at
    stride 2 on an even size the padding is asymmetric, and the
    symmetric padding=k//2 of PyTorch differs."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, n, n, 2)).astype(np.float32)
    w = rng.standard_normal((k, k, 2, 3)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = F.conv2d(_same_pad(xt, k, stride), wt, stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=TOL, rtol=TOL)
    symmetric = F.conv2d(xt, wt, stride=stride, padding=k // 2)
    asymmetric = stride == 2 and n % 2 == 0 and k > 1
    assert (symmetric.shape != got.shape
            or not torch.allclose(symmetric, got, atol=1e-3)) == asymmetric


def test_convert_rejects_wrong_names_and_shapes():
    jm, jp, js, tm, _, _, _, _ = _pair("cifar_stem")
    params = {n: np.asarray(a) for n, a in jp.items()}
    state = {n: np.asarray(a) for n, a in js.items()}
    with pytest.raises(ValueError, match="missing"):
        resnet_params_from_numpy({n: a for n, a in params.items()
                                  if n != "s1b0/proj"}, state, tm.config,
                                 "cpu")
    with pytest.raises(ValueError, match="extra"):
        resnet_params_from_numpy(params, {**state, "head/mean": state[
            "stem/bn/mean"]}, tm.config, "cpu")
    params["stem/w"] = params["stem/w"].transpose(3, 2, 0, 1)   # OIHW
    with pytest.raises(ValueError, match="stem/w"):
        resnet_params_from_numpy(params, state, tm.config, "cpu")
