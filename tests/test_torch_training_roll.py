"""The training steps on the roll backend against the JAX package (CPU),
in a file of their own: each JAX gradient of a layered roll decode is
15-45 s of XLA compile.

* the step of ``train_minsum_weights`` (wifi648, layered-3, batch 32, no
  clamp): the ms_alpha/ms_beta gradients within 1e-4 of ``jax.grad``, one
  adam update within 1e-5;
* the step of ``train_neural_bp`` on wifi648 min-sum layered-2 with
  random per-edge weights: the four weight gradients within 1e-4 of
  ``jax.grad``'s and finite (ties among the minima take JAX's even split,
  ``ops/bp_roll.py:_minsum_excl``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.training import TrainConfig
from ldpc_sims_tpu_torch.training.trainer import minsum_step
from test_torch_training import (
    _bpsk_llrs,
    _tree_close,
    neural_bp_gradients_match_jax,
)


def test_neural_bp_step_gradients_match_jax_on_roll():
    neural_bp_gradients_match_jax("wifi648", "min-sum", "layered", 2)


def _ms_weights(seed):
    rng = np.random.default_rng(seed)
    return {"ms_alpha": rng.uniform(0.7, 1.0, 3).astype(np.float32),
            "ms_beta": rng.uniform(0.0, 0.2, 3).astype(np.float32)}


def test_minsum_step_matches_jax():
    code, jcode = get_code("wifi648"), jax_get_code("wifi648")
    llr = _bpsk_llrs(code.n, 32, 2.0, seed=5)
    w0 = _ms_weights(6)
    kw = dict(iterations=3, clamp=None, schedule="layered")

    def loss_fn(w):
        p1 = jax_bp_decode(jnp.asarray(llr), jcode, method="min-sum",
                           weights=w, output="soft", **kw)
        return -jnp.mean(jnp.log(1.0 - p1 + 1e-7))

    jw = {k: jnp.asarray(v) for k, v in w0.items()}
    grads = jax.jit(jax.grad(loss_fn))(jw)
    opt = optax.adam(0.02)
    updates, _ = opt.update(grads, opt.init(jw))
    stepped = optax.apply_updates(jw, updates)

    w = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in w0.items()}
    # a step at rate 0 leaves the gradient it computed and the weights
    minsum_step(w, torch.optim.SGD(w.values(), lr=0.0), code,
                torch.from_numpy(llr), **kw)
    _tree_close({k: v.grad for k, v in w.items()}, grads, 1e-4)
    # one adam update from the same weights
    w = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in w0.items()}
    topt = TrainConfig(optimizer="adam", learning_rate=0.02).make_optimizer(
        w.values())
    minsum_step(w, topt, code, torch.from_numpy(llr), **kw)
    for k in w0:
        np.testing.assert_allclose(w[k].detach().numpy(),
                                   np.asarray(stepped[k]), rtol=0, atol=1e-5)
