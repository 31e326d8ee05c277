"""Parity of the port's MLP (ray_tpu_torch.models.mlp) with the JAX
package's, on the CPU, in f32: the same weights (the JAX init's, through
mlp_params_from_numpy) and inputs from a seed. Tolerance 2e-5 of the
largest |output| (f32 on both sides, summation order only)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import MLP as JMLP
from ray_tpu.models import MLPConfig as JConfig
from ray_tpu_torch.models import MLP, MLPConfig, mlp_params_from_numpy

TOL = 2e-5
SHAPE = dict(in_dim=6, hidden=(32, 16), out_dim=3)


@pytest.mark.parametrize("activation", ["tanh", "relu", "gelu", "silu"])
def test_apply_matches_jax(activation):
    jm = JMLP(JConfig(activation=activation, **SHAPE))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = MLP(MLPConfig(activation=activation, **SHAPE))
    tp = mlp_params_from_numpy({n: np.asarray(a) for n, a in jp.items()},
                               tm.config, torch.device("cpu"))
    x = 3 * np.random.default_rng(1).standard_normal((5, 6)).astype(
        np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.from_numpy(x))
    assert tuple(got.shape) == (5, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


def test_init_is_orthogonal_and_scaled_as_jax():
    """w_i: sqrt(2) times orthonormal columns (rows where in > out), the
    last layer 0.01 times; zero biases; the JAX init's names and
    shapes."""
    config = MLPConfig(in_dim=6, hidden=(32, 16), out_dim=3)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = MLP(config).init(gen)
    jp = JMLP(JConfig(**SHAPE)).init(jax.random.PRNGKey(0))
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: a.shape for n, a in jp.items()}
    for i, scale in enumerate((2 ** 0.5, 2 ** 0.5, 0.01)):
        w = params[f"w{i}"].double() / scale
        gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        np.testing.assert_allclose(gram.numpy(), np.eye(min(w.shape)),
                                   atol=1e-5)
        assert torch.equal(params[f"b{i}"], torch.zeros_like(params[f"b{i}"]))


def test_convert_rejects_wrong_names_and_shapes():
    config = MLPConfig(**SHAPE)
    arrays = {n: np.asarray(a) for n, a in
              JMLP(JConfig(**SHAPE)).init(jax.random.PRNGKey(0)).items()}
    with pytest.raises(ValueError, match="missing"):
        mlp_params_from_numpy({n: a for n, a in arrays.items()
                               if n != "b2"}, config, "cpu")
    with pytest.raises(ValueError, match="extra"):
        mlp_params_from_numpy({**arrays, "w3": arrays["w2"]}, config, "cpu")
    arrays["w1"] = arrays["w1"].T
    with pytest.raises(ValueError, match="w1"):
        mlp_params_from_numpy(arrays, config, "cpu")
