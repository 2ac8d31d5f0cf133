"""The trainers' checkpoints, data, probe and subcommands against the JAX
package (CPU).

* The port's ``train_llr`` (SGD, adam) and ``train_joint`` checkpoints:
  flax's ``from_bytes(None, ...)`` gives JAX's key tree, shapes and dtypes
  (adam's ``count`` int32), JAX's ``load_checkpoint`` with a real template
  reads them and ``model.apply`` gives the port's outputs; an adam state
  the JAX package wrote loads into ``torch.optim.Adam`` and converts back
  unchanged.
* ``snr_per_symbol``: the port's LLRs (QPSK, BPSK, 16-QAM) and per-symbol
  AGC samples from its own received samples and per-symbol SNRs equal
  JAX's formulas on the same arrays within 1e-5; the drawn SNRs lie in
  range; ``make_llr_dataset(with_snr_feature=True)`` gives 65 columns,
  the feature in [1, 10].
* All twelve subcommands' parsers: JAX's dests, defaults, choices and
  ``required``; the four training subcommands run at a tiny size with
  ``--device cpu``, and their checkpoints read in both packages.
* ``decoded_ber_probe``: its SNR keys, BERs in [0, 0.5], the trained
  tensors' ``.grad`` untouched; ``train_neural_bp`` and
  ``train_minsum_weights`` end to end with probes.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldpc_sims_tpu.models import Joint as JaxJoint
from ldpc_sims_tpu.models import LLRestimator as JaxLLRestimator
from ldpc_sims_tpu.ops import phy as jax_phy
from ldpc_sims_tpu.training import TrainConfig as JaxTrainConfig
from ldpc_sims_tpu.utils import checkpoint as jax_ckpt
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.convert import (
    optimizer_state_from_flax,
    optimizer_state_to_flax,
)
from ldpc_sims_tpu_torch.models import Joint, LLRestimator
from ldpc_sims_tpu_torch.ops import LinkConfig, link_step
from ldpc_sims_tpu_torch.training import (
    TrainConfig,
    decoded_ber_probe,
    make_joint_dataset,
    make_llr_dataset,
    train_joint,
    train_llr,
    train_minsum_weights,
    train_neural_bp,
)
from ldpc_sims_tpu_torch.utils import load_checkpoint


def _leaf_shapes(tree):
    return jax.tree.map(lambda a: (np.shape(a), np.asarray(a).dtype.name),
                        tree)


def _read_flax(path):
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        return flax.serialization.from_bytes(None, f.read())


def _jax_saved(tree):
    """What flax writes for ``tree``, read back structure-free."""
    return flax.serialization.msgpack_restore(
        flax.serialization.to_bytes(jax.tree.map(np.asarray, tree)))


@pytest.fixture(scope="module")
def llr_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 64)).astype(np.float32)
    y = (3.0 * x[:, ::-1]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_llr_checkpoint_in_jax_layout(tmp_path, llr_data, optimizer):
    x, y = llr_data
    cfg = dict(num_epochs=2, batch_size=64, optimizer=optimizer,
               learning_rate=1e-3)
    model, _ = train_llr(LLRestimator(32), x, y, TrainConfig(**cfg),
                         ckpt_dir=str(tmp_path), log=None, device="cpu")
    fmod = JaxLLRestimator(32)
    params = fmod.init(jax.random.key(0), jnp.asarray(x[:2]))
    opt = JaxTrainConfig(**cfg).make_optimizer()
    template = {"params": params, "opt_state": opt.init(params)}
    assert (_leaf_shapes(_read_flax(str(tmp_path)))
            == _leaf_shapes(_jax_saved(template)))
    got, manifest = jax_ckpt.load_checkpoint(str(tmp_path), template)
    assert manifest["config"]["optimizer"] == optimizer
    assert len(manifest["train_loss"]) == 2
    if optimizer == "adam":  # 3 batches an epoch (240 rows train)
        assert int(got["opt_state"][0].count) == 6
    with torch.no_grad():
        want = model(torch.from_numpy(x[:16])).numpy()
    np.testing.assert_allclose(
        np.asarray(fmod.apply(got["params"], x[:16])), want, rtol=0,
        atol=1e-5)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_joint_checkpoint_in_jax_layout(tmp_path, optimizer):
    code = get_code("ref6432")
    x, bits = make_joint_dataset(torch.Generator().manual_seed(1), code,
                                 LinkConfig(bp_iterations=1, qbits=3), 64)
    cfg = dict(num_epochs=2, batch_size=32, minibatch_size=16,
               optimizer=optimizer, learning_rate=2e-5)
    model, info = train_joint(Joint(iterations=2), x, bits,
                              TrainConfig(**cfg), ckpt_dir=str(tmp_path),
                              log=None, device="cpu")
    assert np.isfinite(info["train_loss"]).all()
    assert all(np.isfinite(h["ber"]) for h in info["holdout"])
    fmod = JaxJoint(iterations=2)
    params = fmod.init(jax.random.key(0), jnp.asarray(x[:16]))
    tc = JaxTrainConfig(**cfg)

    def label_fn(tree):
        return {"params": {k: ("llr" if k == "LLRest" else "bp")
                           for k in tree["params"]}}

    opt = optax.multi_transform(
        {"llr": tc.make_optimizer(tc.learning_rate * tc.llr_lr_multiplier),
         "bp": tc.make_optimizer()}, label_fn)
    template = {"params": params, "opt_state": opt.init(params)}
    assert (_leaf_shapes(_read_flax(str(tmp_path)))
            == _leaf_shapes(_jax_saved(template)))
    got, _ = jax_ckpt.load_checkpoint(str(tmp_path), template)
    with torch.no_grad():
        want = model(torch.from_numpy(x[:16])).numpy()
    np.testing.assert_allclose(
        np.asarray(fmod.apply(got["params"], x[:16])), want, rtol=0,
        atol=1e-5)
    # the port reads its own checkpoint, in the same key tree
    tree, _ = load_checkpoint(str(tmp_path))
    assert (jax.tree.structure(_leaf_shapes(tree))
            == jax.tree.structure(_leaf_shapes(_read_flax(str(tmp_path)))))


def test_adam_state_round_trip_from_jax(tmp_path, llr_data):
    """An adam state the JAX package's trainer wrote loads into
    ``torch.optim.Adam`` and converts back to the same tree."""
    from ldpc_sims_tpu.training import train_llr as jax_train_llr

    x, y = llr_data
    cfg = dict(num_epochs=1, batch_size=64, optimizer="adam")
    jax_train_llr(JaxLLRestimator(32), x, y, JaxTrainConfig(**cfg),
                  ckpt_dir=str(tmp_path), log=None)
    tree, _ = load_checkpoint(str(tmp_path))
    model = LLRestimator(32)
    opt = TrainConfig(**cfg).make_optimizer(model.parameters())
    optimizer_state_from_flax(opt, model, tree["opt_state"])
    p = model.hidden3.weight
    assert float(opt.state[p]["step"]) == 3.0
    np.testing.assert_array_equal(
        opt.state[p]["exp_avg"].numpy(),
        tree["opt_state"]["0"]["mu"]["params"]["hidden3"]["kernel"].T)
    back = optimizer_state_to_flax(opt, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree["opt_state"])
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(tree["opt_state"])):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("modulation, qbits", [
    ("qpsk", None), ("bpsk", None), ("qam16", None), ("qpsk", 3)])
def test_snr_per_symbol_matches_jax(modulation, qbits):
    """The port's LLRs from its received samples and per-symbol SNRs equal
    JAX's formula on the same arrays (``ops/chain.py:154-200``): each
    OFDM symbol's SNR repeated over its subcarriers, and the per-symbol
    AGC quantizer."""
    code = get_code("wifi648")
    cfg = LinkConfig(modulation=modulation, bp_method="min-sum",
                     bp_iterations=1, snr_per_symbol=True, snrdb_low=0.0,
                     snrdb_high=10.0, qbits=qbits, agc="per-symbol")
    out = link_step(torch.Generator().manual_seed(2), 0.0, code, cfg, 16,
                    return_arrays=True)
    snr = out["snr_sym"].numpy()
    assert snr.shape == tuple(out["rx_time"].shape[:2])
    assert snr.min() >= 1.0 and snr.max() <= 10.0
    llr_fn = {"qpsk": jax_phy.demodulate_qpsk_llr, "bpsk": jax_phy.bpsk_llr,
              "qam16": jax_phy.qam16_llr}[modulation]
    snr_sc = jnp.repeat(jnp.asarray(snr), cfg.ofdm_size, axis=1)

    def jax_llrs(samples):
        sym = jax_phy.ofdm_demodulate(jnp.asarray(samples))
        return np.asarray(llr_fn(sym, snr_sc)).reshape(16, code.n)

    want = jax_llrs(out["rx_time"].numpy())
    np.testing.assert_allclose(out["llrs"].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if qbits is not None:
        factor = jax_phy.agc_per_symbol(jnp.asarray(snr), cfg.agc_clip,
                                        cfg.clip_ratio)[..., None]
        q = jax_phy.quantize_complex(jnp.asarray(out["rx_time"].numpy())
                                     * factor, qbits,
                                     jnp.asarray(cfg.agc_clip),
                                     cfg.legacy_clip) / factor
        np.testing.assert_allclose(out["q_time"].numpy(), np.asarray(q),
                                   rtol=1e-5, atol=1e-6)
        want = jax_llrs(np.asarray(q))
        np.testing.assert_allclose(out["qllrs"].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_llr_dataset_with_snr_feature():
    code = get_code("ref6432")
    link = LinkConfig(bp_iterations=1, snr_per_symbol=True, snrdb_low=0.0,
                      snrdb_high=10.0)
    x, y = make_llr_dataset(torch.Generator().manual_seed(3), code, link,
                            128, with_snr_feature=True)
    assert x.shape == (128, 65) and y.shape == (128, 64)
    assert x.dtype == y.dtype == np.float32
    assert x[:, -1].min() >= 1.0 and x[:, -1].max() <= 10.0
    assert len(np.unique(x[:, -1])) == 128
    # tanh targets and the fixed-SNR set, as JAX's shapes
    _, yt = make_llr_dataset(torch.Generator().manual_seed(3), code, link,
                             128, with_snr_feature=True, tanh_targets=True)
    np.testing.assert_allclose(yt, np.tanh(y), rtol=1e-6, atol=1e-6)


# all twelve subcommands of the JAX CLI
SUBCOMMANDS = ["sweep", "train-llr", "train-joint", "train-grid",
               "train-minsum", "evaluate-grid", "evaluate", "noise-study",
               "evaluate-joint", "scaling-probe", "generate-data",
               "code-info"]


def _subparsers(parser):
    return next(a for a in parser._actions
                if isinstance(a, type(parser._subparsers._group_actions[
                    0]))).choices


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_subcommand_parsers_match_jax(cmd):
    """JAX's dests, defaults, choices, option strings and ``required``;
    only the port's ``--device`` (default the card) is extra."""
    from ldpc_sims_tpu.cli.main import build_parser as jax_build_parser
    from ldpc_sims_tpu_torch.cli.main import build_parser

    def actions(parser):
        return {a.dest: (a.default, a.choices, a.option_strings, a.required)
                for a in _subparsers(parser)[cmd]._actions
                if a.dest != "help"}

    ours, theirs = actions(build_parser()), actions(jax_build_parser())
    assert ours.pop("device")[0] == "cuda"
    assert ours == theirs
    assert sorted(_subparsers(build_parser())) == sorted(
        _subparsers(jax_build_parser())) == sorted(SUBCOMMANDS)


def test_subcommands_run_on_the_cpu(tmp_path):
    from ldpc_sims_tpu.utils import load_decoder_weights as jax_weights
    from ldpc_sims_tpu_torch.cli.main import build_parser, load_llr_model
    from ldpc_sims_tpu_torch.cli.main import main as cli_main
    from ldpc_sims_tpu_torch.utils import load_decoder_weights, load_runs

    out = str(tmp_path)
    common = ["--device", "cpu", "--out", out]
    cli_main(["generate-data", "--num-codewords", "32", *common])
    cli_main(["train-llr", "--num-codewords", "64", "--epochs", "2",
              "--batch", "32", "--qbits", "3", "--snr-low", "0",
              "--snr-high", "10", *common])
    cli_main(["train-joint", "--num-codewords", "32", "--epochs", "1",
              "--batch", "16", "--iters", "2", "--qbits", "3", *common])
    cli_main(["train-minsum", "--code", "wifi648", "--schedule", "layered",
              "--iters", "2", "--clamp", "0", "--steps", "2", "--batch", "8",
              *common])
    kinds = [r["kind"] for r in load_runs(out)]
    assert kinds == ["train-llr", "train-joint", "train-minsum"]
    files = os.listdir(out)
    assert sum(f.endswith("_data.npz") for f in files) == 1
    ckpts = {d.split("_")[1]: os.path.join(out, "model", d)
             for d in os.listdir(os.path.join(out, "model"))}
    model, snr_feature, tanh = load_llr_model(ckpts["llr"], 32)
    assert type(model).__name__ == "LLRestimatorWithSNR" and snr_feature
    # --warm-start from that checkpoint: zero epochs keep its weights
    warm = str(tmp_path / "warm")
    cli_main(["train-llr", "--num-codewords", "64", "--epochs", "0",
              "--qbits", "3", "--snr-low", "0", "--snr-high", "10",
              "--warm-start", ckpts["llr"], "--device", "cpu", "--out", warm])
    (again,) = os.listdir(os.path.join(warm, "model"))
    back, _, _ = load_llr_model(os.path.join(warm, "model", again), 32)
    for a, b in zip(back.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    ms = load_decoder_weights(ckpts["minsum"])
    assert set(ms) == {"ms_alpha", "ms_beta"} and ms["ms_alpha"].shape == (2,)
    for k, v in jax_weights(ckpts["minsum"]).items():
        np.testing.assert_array_equal(np.asarray(v), ms[k])
    # the schedule checkpoint freezes into a sweep's alpha/beta
    from ldpc_sims_tpu_torch.cli.main import sweep_configs

    _, link, *_ = sweep_configs(build_parser().parse_args([
        "sweep", "--code", "wifi648", "--method", "min-sum", "--schedule",
        "layered", "--iters", "2", "--clamp", "0", "--schedule-ckpt",
        ckpts["minsum"]]))
    assert link.alpha == tuple(float(a) for a in ms["ms_alpha"])


def test_probe_and_decoder_trainers(tmp_path):
    code = get_code("wifi648")
    probe = decoded_ber_probe(code, (1.0, 3.0), batch=32, device="cpu",
                              iterations=2, schedule="layered",
                              method="min-sum")
    w = {k: v.requires_grad_() for k, v in
         {"ms_alpha": torch.full((2,), 0.8),
          "ms_beta": torch.full((2,), 0.1)}.items()}
    loss = sum((v ** 2).sum() for v in w.values())
    loss.backward()
    grads = {k: v.grad.clone() for k, v in w.items()}
    bers = probe(w, 5)
    assert list(bers) == [1.0, 3.0]
    assert all(0.0 <= b <= 0.5 for b in bers.values())
    assert bers[3.0] < bers[1.0]
    assert probe(w, 5) == bers  # the seed sets the draw
    assert all(torch.equal(w[k].grad, grads[k]) for k in w)

    weights, info = train_minsum_weights(
        code, TrainConfig(learning_rate=0.02, optimizer="adam"),
        iterations=2, steps=3, batch=8, probe_snr_db=(2.0,), probe_batch=16,
        ckpt_dir=str(tmp_path / "ms"), log=None, device="cpu")
    assert len(info["loss"]) == 3 and len(info["probe"]) == 3
    assert not weights["ms_alpha"].requires_grad
    assert info["alpha"] == weights["ms_alpha"].tolist()
    edge, info = train_neural_bp(
        code, np.random.default_rng(1).normal(2.0, 1.0, (32, 648)).astype(
            np.float32) * -1.0, np.zeros((32, 648), np.int8),
        TrainConfig(learning_rate=0.01, num_epochs=2, batch_size=16,
                    eval_every=1), iterations=2, method="min-sum",
        schedule="layered", probe_snr_db=(2.0,), probe_batch=16,
        ckpt_dir=str(tmp_path / "nbp"), log=None, device="cpu")
    assert len(info["loss"]) == 4 and [p["epoch"] for p in
                                      info["probe"]] == [0, 1]
    assert all(np.isfinite(info["loss"]))
    from ldpc_sims_tpu.utils import load_decoder_weights as jax_weights

    got = jax_weights(str(tmp_path / "nbp"))
    assert set(got) == {"w_msg", "w_llr", "w_msg_final", "w_llr_final"}
    np.testing.assert_array_equal(np.asarray(got["w_msg"]),
                                  edge["w_msg"].numpy())
