"""The port's trainers and joint model against the JAX package (CPU).

Each case feeds both packages the same NumPy inputs; flax params cross
with ``convert``:

* ``train_llr`` with SGD and adam (ref6432, 3 epochs, batch 128, holdout
  1/16) from JAX's init: the same data order (NumPy's
  ``default_rng(seed)``), params within rtol 1e-4 / atol 1e-5 of JAX's and
  the loss histories within 1e-5 relative;
* the step of ``train_neural_bp``: the four weight gradients within 1e-4
  of JAX's and finite, on ref6432 sum-product flooding-3 (the port's
  gather backend beside JAX's dense one); the roll-backend steps (wifi648
  min-sum layered-2 with edge weights, and ``train_minsum_weights``' step)
  are in ``tests/test_torch_training_roll.py``;
* ``Joint`` (ref6432, 2 iterations): the forward within 1e-5 and every
  parameter's BCE gradient within 1e-4 relative; a short ``train_joint``
  from JAX's init (64 codewords, 4 epochs, minibatches of 16) with its
  losses within 1e-4, and the ``llr_warm_start`` graft.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.models import Joint as JaxJoint
from ldpc_sims_tpu.models import LLRestimator as JaxLLRestimator
from ldpc_sims_tpu.ops.bp import bp_decode as jax_bp_decode
from ldpc_sims_tpu.training import TrainConfig as JaxTrainConfig
from ldpc_sims_tpu.training import train_joint as jax_train_joint
from ldpc_sims_tpu.training import train_llr as jax_train_llr
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.convert import (
    joint_params_to_flax,
    joint_state_dict_from_flax,
    llr_params_to_flax,
)
from ldpc_sims_tpu_torch.models import Joint, LLRestimator
from ldpc_sims_tpu_torch.training import (
    TrainConfig,
    train_joint,
    train_llr,
)
from ldpc_sims_tpu_torch.training.trainer import bce, neural_bp_step


def _tree_close(got, want, rtol, atol=None):
    """Every leaf within ``rtol`` and ``atol`` (None: ``rtol`` × the
    leaf's largest magnitude)."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), path
        tol = rtol * np.abs(b).max() if atol is None else atol
        np.testing.assert_allclose(a, b, rtol=rtol, atol=tol,
                                   err_msg=str(path))


def _bpsk_llrs(n, batch, snrdb, seed, scale=1.0):
    """All-zero codewords over BPSK/AWGN: LLR = −2r/σ² (log Pr1/Pr0)."""
    rng = np.random.default_rng(seed)
    sigma = (10.0 ** (snrdb / 10.0)) ** -0.5
    r = 1.0 + sigma * rng.normal(size=(batch, n))
    return (scale * -2.0 * r / sigma ** 2).astype(np.float32)


def _jax_params(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref6432_llr_data():
    """JAX's ``make_llr_dataset`` on ref6432 (QPSK/OFDM-32 at 5 dB, 512
    codewords: 512 rows of 64 samples and their 64 LLRs)."""
    from ldpc_sims_tpu.ops import LinkConfig as JaxLinkConfig
    from ldpc_sims_tpu.training import make_llr_dataset

    return make_llr_dataset(jax.random.key(0), jax_get_code("ref6432"),
                            JaxLinkConfig(bp_iterations=1), 512, snrdb=5.0)


# adam moves a weight by about its rate a step whatever the gradient's
# size, so a gradient that sums to near zero, whose sign the two packages'
# roundings can set apart, moves it by up to twice the rate: 1e-4 keeps
# nine such steps inside the tolerance (1e-3 put one weight in 262,144 at
# 1.9e-5)
@pytest.mark.parametrize("optimizer, lr", [("sgd", 0.01), ("adam", 1e-4)])
def test_train_llr_matches_jax(ref6432_llr_data, optimizer, lr):
    x, y = ref6432_llr_data
    cfg = dict(learning_rate=lr, num_epochs=3, batch_size=128,
               optimizer=optimizer, seed=3)
    fmod = JaxLLRestimator(32)
    init = _jax_params(fmod.init(jax.random.key(1), jnp.asarray(x[:2])))
    want, winfo = jax_train_llr(fmod, x, y, JaxTrainConfig(**cfg),
                                init_params=init, log=None)
    model, info = train_llr(LLRestimator(32), x, y, TrainConfig(**cfg),
                            init_params=init, log=None, device="cpu")
    np.testing.assert_allclose(info["train_loss"], winfo["train_loss"],
                               rtol=1e-5)
    _tree_close(llr_params_to_flax(model), _jax_params(want), 1e-4, 1e-5)


def _edge_weights(code, iterations, seed):
    g = code.graph
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(0.8, 1.2, shape).astype(np.float32)

    return {"w_msg": u(iterations, g.n_vars, g.dv),
            "w_llr": u(iterations, g.n_vars),
            "w_msg_final": u(g.n_vars, g.dv),
            "w_llr_final": u(g.n_vars)}


@pytest.mark.parametrize("name, method, schedule, iters", [
    ("ref6432", "sum-product", "flooding", 3),  # gather here, dense in JAX
])
def test_neural_bp_step_gradients_match_jax(name, method, schedule, iters):
    """The ref6432 case; wifi648 min-sum layered-2 (roll in both) is in
    tests/test_torch_training_roll.py, its JAX gradient ~45 s of XLA
    compile."""
    neural_bp_gradients_match_jax(name, method, schedule, iters)


def neural_bp_gradients_match_jax(name, method, schedule, iters):
    code, jcode = get_code(name), jax_get_code(name)
    llr = _bpsk_llrs(code.n, 16, 1.5, seed=7)
    bits = np.zeros((16, code.n), np.int8)
    w0 = _edge_weights(code, iters, seed=8)
    kw = dict(iterations=iters, method=method, clamp=20.0,
              schedule=schedule)

    def loss_fn(w):
        p1 = jax_bp_decode(jnp.asarray(llr), jcode, weights=w,
                           output="soft", **kw)
        b = jnp.asarray(bits, jnp.float32)
        return -jnp.mean(b * jnp.log(p1 + 1e-7)
                         + (1 - b) * jnp.log(1 - p1 + 1e-7))

    grads = jax.jit(jax.grad(loss_fn))(
        {k: jnp.asarray(v) for k, v in w0.items()})
    w = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in w0.items()}
    # a step at rate 0 leaves the gradient it computed and the weights
    loss = neural_bp_step(w, torch.optim.SGD(w.values(), lr=0.0), code,
                          torch.from_numpy(llr), torch.from_numpy(bits),
                          **kw)
    assert np.isclose(float(loss), float(loss_fn(
        {k: jnp.asarray(v) for k, v in w0.items()})), rtol=1e-5)
    _tree_close({k: v.grad for k, v in w.items()}, grads, 1e-4)


def _joint_inputs(rows, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.8, size=(rows, 64)).astype(np.float32)
    bits = (rng.random((rows, 64)) < 0.5).astype(np.int8)
    return x, bits


def test_joint_forward_and_gradients_match_jax():
    x, bits = _joint_inputs(16, seed=9)
    fmod = JaxJoint(iterations=2)
    params = _jax_params(fmod.init(jax.random.key(2), jnp.asarray(x)))
    # decoder weights away from the ones, so each one's gradient is its own
    rng = np.random.default_rng(10)
    for k, v in params["params"].items():
        if k.startswith("bp_w"):
            params["params"][k] = (v * rng.uniform(0.8, 1.2, v.shape)
                                   ).astype(np.float32)

    def loss_fn(p):
        p1 = fmod.apply(p, jnp.asarray(x))
        b = jnp.asarray(bits, jnp.float32)
        return -jnp.mean(b * jnp.log(p1 + 1e-7)
                         + (1 - b) * jnp.log(1 - p1 + 1e-7))

    want = np.asarray(fmod.apply(params, jnp.asarray(x)))
    grads = _jax_params(jax.grad(loss_fn)(params))
    model = Joint(iterations=2)
    model.load_state_dict(joint_state_dict_from_flax(params))
    p1 = model(torch.from_numpy(x))
    np.testing.assert_allclose(p1.detach().numpy(), want, rtol=0, atol=1e-5)
    bce(p1, torch.from_numpy(bits)).backward()
    # the gradients in flax's layout, through the params' own converter
    grad_model = Joint(iterations=2)
    grad_model.load_state_dict({n: p.grad for n, p in
                                model.named_parameters()})
    _tree_close(joint_params_to_flax(grad_model), grads, 1e-4)


def test_train_joint_matches_jax_and_grafts_the_llr_net():
    x, bits = _joint_inputs(64, seed=11)
    cfg = dict(learning_rate=0.01, num_epochs=4, batch_size=32,
               minibatch_size=16, eval_every=2, seed=4)
    fmod = JaxJoint(iterations=2)
    init = _jax_params(fmod.init(jax.random.key(3), jnp.asarray(x[:16])))
    want, winfo = jax_train_joint(fmod, x, bits, JaxTrainConfig(**cfg),
                                  init_params=init, log=None)
    model, info = train_joint(Joint(iterations=2), x, bits,
                              TrainConfig(**cfg), init_params=init,
                              log=None, device="cpu")
    np.testing.assert_allclose(info["train_loss"], winfo["train_loss"],
                               rtol=1e-4)
    assert [h["epoch"] for h in info["holdout"]] == [0, 2]
    for h, wh in zip(info["holdout"], winfo["holdout"]):
        assert abs(h["ber"] - wh["ber"]) <= 1.0 / bits[:4].size + 1e-9
        assert np.isclose(h["loss"], wh["loss"], rtol=1e-4)
    _tree_close(joint_params_to_flax(model), _jax_params(want), 1e-3, 1e-5)

    # the warm start: a trained LLR net's params under LLRest, the rest
    # the init's, the same key tree as JAX's graft
    llr = _jax_params(JaxLLRestimator(32).init(jax.random.key(5),
                                               jnp.asarray(x[:2])))
    cfg0 = dict(cfg, num_epochs=0)
    want, _ = jax_train_joint(fmod, x, bits, JaxTrainConfig(**cfg0),
                              init_params=init, llr_warm_start=llr,
                              log=None)
    model, _ = train_joint(Joint(iterations=2), x, bits,
                           TrainConfig(**cfg0), init_params=init,
                           llr_warm_start=llr, log=None, device="cpu")
    got = joint_params_to_flax(model)
    assert jax.tree.structure(got) == jax.tree.structure(_jax_params(want))
    _tree_close(got["params"]["LLRest"], llr["params"], 0, 0)
    _tree_close(got, _jax_params(want), 0, 0)
