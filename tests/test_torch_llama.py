"""Parity of the port's Llama (ray_tpu_torch.models.llama) with the JAX
package's, on the CPU, at LlamaConfig.tiny in f32.

Both sides compute with the same weights: the JAX init's parameters go
through numpy into the port (llama_params_from_numpy). Tolerance 1e-4
(atol and rtol) on logits: both sides are f32 throughout, so they differ
only by summation order (matmuls, softmax, the online softmax of the JAX
flash kernel against the port's one-shot plain version), and that order
difference compounds over the two layers and the LM head.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_numpy

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and it
    leaves the machine's cores to the test files running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) on the same
    weights."""
    jm = JLlama(JConfig.tiny(dtype=jnp.float32))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = Llama(LlamaConfig.tiny(dtype=torch.float32))
    tp = llama_params_from_numpy({n: np.asarray(a) for n, a in jp.items()},
                                 tm.config, torch.device("cpu"))
    return jm, jp, tm, tp


def test_init_names_shapes_and_dtypes_match_jax(pair):
    jm, jp, tm, _ = pair
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = tm.init(gen)
    assert set(params) == set(jp)
    for name, arr in jp.items():
        assert tuple(params[name].shape) == arr.shape, name
        assert params[name].dtype == torch.float32, name
    assert tm.num_params() == jm.num_params()
    # norms start at one, like the JAX init
    assert torch.equal(params["attn_norm"], torch.ones_like(
        params["attn_norm"]))


def test_convert_rejects_wrong_names_and_shapes(pair):
    _, jp, tm, _ = pair
    arrays = {n: np.asarray(a) for n, a in jp.items()}
    with pytest.raises(ValueError, match="missing"):
        llama_params_from_numpy({n: a for n, a in arrays.items()
                                 if n != "w_q"}, tm.config, "cpu")
    arrays["w_q"] = arrays["w_q"][:, :, :8]
    with pytest.raises(ValueError, match="w_q"):
        llama_params_from_numpy(arrays, tm.config, "cpu")


@pytest.mark.parametrize("use_flash", [True, False])
def test_apply_logits_match_jax(pair, use_flash):
    """S=128 so the JAX side's flash path runs its Pallas kernel (in
    interpret mode) and the port's runs its flash wrapper."""
    import dataclasses

    jm, jp, tm, tp = pair
    jm = JLlama(dataclasses.replace(jm.config, use_flash=use_flash))
    tm = Llama(dataclasses.replace(tm.config, use_flash=use_flash))
    tokens = np.random.default_rng(0).integers(0, 512, (2, 128))
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(tokens, jnp.int32)))
    got = tm.apply(tp, torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 128, tm.config.padded_vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_paged_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    nb, bs = 8, 4
    jcache = jm.init_paged_cache(nb, bs)
    tcache = tm.init_paged_cache(nb, bs, torch.device("cpu"))
    rng = np.random.default_rng(1)

    # prefill an 11-token prompt padded to a 16 bucket into blocks 5, 2, 7
    tokens = np.zeros((1, 16), np.int64)
    tokens[0, :11] = rng.integers(1, 512, 11)
    row = np.array([5, 2, 7, -1], np.int64)
    j_logits, jcache = jax.jit(jm.paged_prefill)(
        jp, jcache, jnp.asarray(tokens), jnp.int32(11), jnp.asarray(row))
    t_logits, tcache = tm.paged_prefill(tp, tcache, torch.from_numpy(tokens),
                                        11, torch.from_numpy(row))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=TOL, rtol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=TOL,
                                   rtol=TOL)

    # one decode step: slot 0 continues the prompt at position 11, slot 1
    # is a one-token sequence in block 3, slot 2 is inactive
    step_tokens = np.array([int(np.argmax(t_logits.numpy())), 17, 99])
    positions = np.array([11, 0, 4], np.int64)
    rows = np.array([[5, 2, 7, -1], [3, -1, -1, -1], [0, 1, -1, -1]],
                    np.int64)
    active = np.array([True, True, False])
    j_logits, jcache = jax.jit(jm.paged_decode_step)(
        jp, jcache, *map(jnp.asarray, (step_tokens, positions, rows, active)))
    t_logits, tcache = tm.paged_decode_step(
        tp, tcache, *map(torch.from_numpy,
                         (step_tokens, positions, rows, active)))
    np.testing.assert_allclose(t_logits.numpy()[:2],
                               np.asarray(j_logits)[:2], atol=TOL, rtol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=TOL,
                                   rtol=TOL)
        # the inactive slot wrote nothing into its blocks 0 and 1
        assert not tcache[key][:, :2].any()


def test_cast_matmul_weights_keeps_head_and_norms_f32():
    m = Llama(LlamaConfig.tiny())                 # bf16 compute
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = m.cast_matmul_weights(m.init(gen))
    for name, p in params.items():
        want = torch.bfloat16 if name in Llama.MATMUL_PARAMS else torch.float32
        assert p.dtype == want, name
