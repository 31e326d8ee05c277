"""Parity of the port's ViT (ray_tpu_torch.models.vit) with the JAX
package's, on the CPU, at ViTConfig.tiny in f32.

The JAX init's parameters go through numpy into the port
(vit_params_from_numpy). Its head starts at zero, which makes every
logit the head's bias and every gradient but the head's zero, so the
tests draw ``head/w`` from a seed (the same array on both sides). At
17 tokens both sides run mha_reference (17 is not a multiple of 8).
Tolerances: logits 2e-5 (atol and rtol; f32 on both sides, summation
order only); losses 2e-5 relative; gradients 2e-4 of each parameter's
largest |gradient| (atol) and 2e-4 relative, as tests/test_ops.py:51.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import ViT as JViT
from ray_tpu.models import ViTConfig as JConfig
from ray_tpu_torch.models import ViT, ViTConfig, vit_params_from_numpy

vit_mod = importlib.import_module("ray_tpu_torch.models.vit")

TOL = 2e-5
GRAD_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(remat):
    """(jax model, jax params, port model, port params) on the same
    weights, ``head/w`` drawn from a seed."""
    jm = JViT(JConfig.tiny(dtype=jnp.float32, remat=remat))
    arrays = {n: np.asarray(a)
              for n, a in jax.jit(jm.init)(jax.random.PRNGKey(0)).items()}
    arrays["head/w"] = np.random.default_rng(1).standard_normal(
        arrays["head/w"].shape).astype(np.float32)
    tm = ViT(ViTConfig.tiny(dtype=torch.float32, remat=remat))
    tp = vit_params_from_numpy(arrays, tm.config, torch.device("cpu"))
    return jm, {n: jnp.asarray(a) for n, a in arrays.items()}, tm, tp


def _batch(seed, b=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, (b,)))


def test_init_names_shapes_and_axes_match_jax():
    jm = JViT(JConfig.tiny())
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm = ViT(ViTConfig.tiny())
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = tm.init(gen)
    assert set(params) == set(jp) == set(tm.logical_axes())
    assert tm.logical_axes() == jm.logical_axes()
    for name, arr in jp.items():
        assert tuple(params[name].shape) == arr.shape, name
        assert params[name].dtype == torch.float32, name
    for name in ("cls", "head/w", "head/b", "patch/b"):
        assert torch.equal(params[name], torch.zeros_like(params[name]))
    assert abs(float(params["patch/w"].std()) * np.sqrt(8 * 8 * 3) - 1) < 0.1
    # param_shardings maps the logical axes through the default rules to
    # the JAX model's specs (the sharding layer, parallel/mesh.py)
    from ray_tpu.parallel.mesh import AxisRules as JAxisRules

    for name, sharding in tm.param_shardings(None).items():
        assert sharding.spec == tuple(JAxisRules().mesh_axes(
            jm.logical_axes()[name])), name


def test_convert_rejects_wrong_names_and_shapes():
    jm = JViT(JConfig.tiny())
    arrays = {n: np.zeros(a.shape, np.float32) for n, a in
              jax.eval_shape(jm.init, jax.random.PRNGKey(0)).items()}
    config = ViTConfig.tiny(dtype=torch.float32)
    with pytest.raises(ValueError, match="missing"):
        vit_params_from_numpy({n: a for n, a in arrays.items()
                               if n != "cls"}, config, "cpu")
    with pytest.raises(ValueError, match="extra"):
        vit_params_from_numpy({**arrays, "head/w2": arrays["head/w"]},
                              config, "cpu")
    arrays["patch/w"] = arrays["patch/w"].reshape(3, 64, 64)
    with pytest.raises(ValueError, match="patch/w"):
        vit_params_from_numpy(arrays, config, "cpu")


def test_patchify_matches_jax():
    """(py, px, c) order inside each patch vector, patches row-major."""
    images = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(
        2, 32, 32, 3)
    want = np.asarray(JViT(JConfig.tiny())._patchify(jnp.asarray(images)))
    got = ViT(ViTConfig.tiny())._patchify(torch.from_numpy(images))
    assert tuple(got.shape) == (2, 16, 192)
    np.testing.assert_array_equal(got.numpy(), want)
    # the first patch of image 0: rows 0..7, columns 0..7, channel fastest
    np.testing.assert_array_equal(got[0, 0, :6].numpy(),
                                  images[0, 0, :2].reshape(-1))


@pytest.mark.parametrize("remat", [False, True])
def test_apply_and_grads_match_jax(remat, monkeypatch):
    jm, jp, tm, tp = _pair(remat)
    images, labels = _batch(2)
    want = jax.jit(jm.apply)(jp, jnp.asarray(images))
    flash_calls = []
    monkeypatch.setattr(vit_mod, "flash_attention",
                        lambda *a, **k: flash_calls.append(a))
    got = tm.apply(tp, torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, jnp.asarray(images), jnp.asarray(labels))
    params = {n: p.clone().requires_grad_() for n, p in tp.items()}
    blocks = []
    block = tm._block
    monkeypatch.setattr(tm, "_block",
                        lambda *a: blocks.append(1) or block(*a))
    loss = tm.loss(params, torch.from_numpy(images),
                   torch.from_numpy(labels))
    loss.backward()
    # remat runs each block again in the backward
    assert len(blocks) == (4 if remat else 2)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
    for name, w in j_grads.items():
        w = np.asarray(w)
        assert float(np.abs(w).max()) > 0, name
        np.testing.assert_allclose(
            params[name].grad.numpy(), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(w).max()), err_msg=name)
    # 17 tokens: the flash branch (S % 8 == 0) is never taken
    assert not flash_calls
