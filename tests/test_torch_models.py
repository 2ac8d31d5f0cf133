"""The port's LLR estimators and the evaluator's numerics against the JAX
package (CPU).

* The three estimators on the same NumPy inputs, the flax params carried
  across by ``convert.llr_state_dict_from_flax`` (within 1e-5), at full
  width (``ofdm_size`` 32: hidden width 512) and at a narrow one; the
  inverse ``llr_params_to_flax`` run back through flax.
* ``block_dft`` and the tanh inversion (the JAX evaluator's float32 clip
  exactly, its log within 2 ulps: XLA's and torch's logs round apart),
  ``weighted_mse`` and ``bit_errors``.
* A fresh init draws flax ``Dense``'s defaults: the same submodule names
  and shapes, a zero bias, a lecun-normal kernel (truncated at 2σ, std
  √(1/fan_in)), reproducible from a generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.models import llr as jax_llr
from ldpc_sims_tpu.ops import phy as jax_phy
from ldpc_sims_tpu_torch import models
from ldpc_sims_tpu_torch.convert import (
    llr_params_to_flax,
    llr_state_dict_from_flax,
)
from ldpc_sims_tpu_torch.evaluate import invert_tanh
from ldpc_sims_tpu_torch.models.llr import block_dft
from ldpc_sims_tpu_torch.ops import phy

NAMES = ["LLRestimator", "LLRestimatorWithSNR", "LLRestimatorTanh"]


def _inputs(name, ofdm, rows, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 2 * ofdm)).astype(np.float32)
    if name != "LLRestimator":
        snr = rng.uniform(1.0, 10.0, size=(rows, 1)).astype(np.float32)
        x = np.concatenate([x, snr], axis=1)
    return x


@pytest.mark.parametrize("ofdm", [32, 4])
@pytest.mark.parametrize("name", NAMES)
def test_estimator_matches_flax(name, ofdm):
    x = _inputs(name, ofdm, 64, seed=ofdm)
    fmod = getattr(jax_llr, name)(ofdm)
    params = fmod.init(jax.random.key(ofdm), jnp.asarray(x[:2]))
    params = jax.tree.map(np.asarray, params)
    # perturb the DFT layer so it is not the init the port also draws
    if "fft_layer" in params["params"]:
        k = params["params"]["fft_layer"]["kernel"]
        params["params"]["fft_layer"]["kernel"] = k + 0.01 * np.float32(
            np.random.default_rng(1).normal(size=k.shape))
    want = np.asarray(fmod.apply(params, jnp.asarray(x)))
    model = getattr(models, name)(ofdm)
    model.load_state_dict(llr_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # and back: the port's weights as flax params give flax the same output
    back = llr_params_to_flax(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    np.testing.assert_allclose(
        np.asarray(fmod.apply(back, jnp.asarray(x))), want, rtol=0,
        atol=1e-6)
    # the inner dict converts as well as the variables
    inner = llr_state_dict_from_flax(params["params"])
    assert inner.keys() == model.state_dict().keys()


@pytest.mark.parametrize("name", NAMES)
def test_fresh_init_is_flax_dense_default(name):
    ofdm = 32
    x = _inputs(name, ofdm, 2, seed=0)
    flax_params = jax.tree.map(np.asarray, getattr(jax_llr, name)(ofdm).init(
        jax.random.key(0), jnp.asarray(x)))
    model = getattr(models, name)(
        ofdm, generator=torch.Generator().manual_seed(3))
    ours = llr_params_to_flax(model)
    assert jax.tree.structure(ours) == jax.tree.structure(flax_params)
    for layer, leaves in ours["params"].items():
        for kind, a in leaves.items():
            ref = flax_params["params"][layer][kind]
            assert a.shape == ref.shape and a.dtype == ref.dtype
            if kind == "bias":
                assert not a.any()
            elif layer == "fft_layer":
                np.testing.assert_array_equal(a, ref)  # the block DFT
            else:
                std = (1.0 / a.shape[0]) ** 0.5
                # truncated at 2 of the pre-scaling std (std / 0.8796)
                assert np.abs(a).max() <= 2 * std / 0.87962566103423978
                assert abs(a.std() / std - 1) < 0.05
                assert abs(ref.std() / std - 1) < 0.05
    again = getattr(models, name)(
        ofdm, generator=torch.Generator().manual_seed(3))
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k])


@pytest.mark.parametrize("n", [4, 32])
def test_block_dft(n):
    np.testing.assert_array_equal(block_dft(n), jax_llr._block_dft(n))


def test_tanh_inversion_matches_jax():
    rng = np.random.default_rng(5)
    est = np.concatenate([
        np.tanh(rng.normal(scale=4.0, size=4096)),
        [1.0, -1.0, 0.9999999, -0.99999994, 0.0],
    ]).astype(np.float32)
    e = jnp.clip(jnp.asarray(est), -1 + 1e-7, 1 - 1e-7)
    np.testing.assert_array_equal(
        torch.clamp(torch.from_numpy(est), -1 + 1e-7, 1 - 1e-7).numpy(),
        np.asarray(e))
    assert float(e.max()) == np.float32(1 - 1e-7) < 1.0
    want = np.asarray(0.5 * jnp.log((1 + e) / (1 - e)))
    got = invert_tanh(torch.from_numpy(est)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    assert np.isfinite(got).all()


def test_weighted_mse_and_bit_errors_match_jax():
    rng = np.random.default_rng(6)
    llr = rng.normal(scale=5.0, size=10000).astype(np.float32)
    est = llr + rng.normal(size=10000).astype(np.float32)
    for eps in (0.001, 0.5):
        want = float(jax_phy.weighted_mse(jnp.asarray(est),
                                          jnp.asarray(llr), eps))
        got = float(phy.weighted_mse(torch.from_numpy(est),
                                     torch.from_numpy(llr), eps))
        assert got == pytest.approx(want, rel=1e-6)
    a = rng.integers(0, 2, size=(64, 648)).astype(np.int8)
    b = rng.integers(0, 2, size=(64, 648)).astype(np.int8)
    want = int(jax_phy.bit_errors(jnp.asarray(a), jnp.asarray(b)))
    got = phy.bit_errors(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and int(got) == want
