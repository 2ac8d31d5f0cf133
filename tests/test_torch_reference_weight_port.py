"""The reference-weight example (``ldpc_sims_tpu_torch.examples.
reference_weight_port``) on the CPU, on synthetic checkpoints in the
reference's 2019 format: the port's loader against the JAX script's
``load_reference_params`` → flax ``LLRestimator.apply``, the script end to
end on a synthetic registry, and its exit without one. The run on the
reference's own checkpoints waits until they are in the repository.
"""

import collections
import importlib.util
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.models import LLRestimator as FlaxLLRestimator
from ldpc_sims_tpu_torch.examples import reference_weight_port as rwp
from ldpc_sims_tpu_torch.models import LLRestimator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32  # OFDM size: 2N = 64 inputs and outputs, hidden width 8·2N


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_reference_weight_port",
        os.path.join(ROOT, "examples", "reference_weight_port.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_checkpoint(path, seed):
    """A reference LLRestimator checkpoint as its 2019 trainer saved it:
    ``model_state_dict`` of a ``DataParallel`` module (``module.``
    prefix) with the unused ``hidden1``/``hidden2``/``scalar`` beside the
    layers the estimator runs."""
    g = torch.Generator().manual_seed(seed)
    w = 8 * 2 * N
    shapes = {"fft_layer.weight": (2 * N, 2 * N),
              "hidden1.weight": (w, 2 * N + 1), "hidden1.bias": (w,),
              "hidden2.weight": (w, w), "hidden2.bias": (w,),
              "hidden3.weight": (w, 2 * N), "hidden3.bias": (w,),
              "hidden4.weight": (w, w), "hidden4.bias": (w,),
              "hidden5.weight": (w, w), "hidden5.bias": (w,),
              "final.weight": (2 * N, w), "final.bias": (2 * N,),
              "scalar": (1,)}
    sd = collections.OrderedDict(
        ("module." + k, torch.randn(s, generator=g) / s[-1] ** 0.5)
        for k, s in shapes.items())
    torch.save({"epoch": 100, "model_state_dict": sd,
                "optimizer_state_dict": {}, "loss": 0.5}, path)


@pytest.fixture
def reference(tmp_path):
    """A reference snapshot with two per-SNR checkpoints and the results
    registry that names them."""
    root = tmp_path / "pytorch"
    (root / "outputs" / "model").mkdir(parents=True)
    (root / "outputs" / "results").mkdir(parents=True)
    names = ["q3_snr4.pth", "q3_snr6.pth"]
    for seed, name in enumerate(names):
        write_checkpoint(root / "outputs" / "model" / name, seed)
    with open(root / "outputs" / "results" / rwp.REGISTRY, "wb") as f:
        pickle.dump({"snrdb": [4.0, 6.0], "filenames": names}, f)
    return root


def test_loader_matches_jax_script(reference):
    """Both checkpoints: the port's module from ``load_reference_params``
    against flax ``LLRestimator.apply`` on the JAX script's params, on the
    same seeded inputs, within 1e-5; the interleaved-to-block permutation
    is the JAX script's."""
    jrwp = jax_script()
    flax_model = FlaxLLRestimator(N)
    template = flax_model.init(jax.random.key(0),
                               np.zeros((2, 2 * N), np.float32))
    x = np.random.default_rng(7).normal(0, 1, (256, 2 * N)).astype(
        np.float32)
    for name in ("q3_snr4.pth", "q3_snr6.pth"):
        path = str(reference / "outputs" / "model" / name)
        want = np.asarray(flax_model.apply(
            jrwp.load_reference_params(path, N, template), x))
        model = rwp.load_reference_params(path, N, LLRestimator(N))
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    sd = torch.load(path, weights_only=False)["model_state_dict"]
    idx = rwp.block_index(N)
    np.testing.assert_array_equal(
        model.fft_layer.weight.detach().numpy(),
        sd["module.fft_layer.weight"].numpy()[:, idx])


def test_script_end_to_end(reference, tmp_path, monkeypatch):
    """``main()`` on the CPU at a small batch: one point a checkpoint of
    the registry, the record under ``--out`` with the JAX script's keys,
    every value finite."""
    monkeypatch.setenv("LDPC_REFERENCE", str(reference))
    out = tmp_path / "outputs" / "rwp.json"
    rwp.main(["--batch", "256", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["snrdb"] == [4.0, 6.0] and rec["num_codewords"] == 256
    assert rec["registry"] == rwp.REGISTRY
    for k in ("coded_ber_nn", "coded_bler_nn", "wmse_nn", "coded_ber",
              "coded_ber_qllr"):
        assert len(rec[k]) == 2 and np.isfinite(rec[k]).all(), k


def test_script_exits_without_registry(tmp_path, monkeypatch):
    """No registry under ``LDPC_REFERENCE``: the JAX script's message and
    a non-zero exit, before any data is drawn."""
    monkeypatch.setenv("LDPC_REFERENCE", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        rwp.main(["--device", "cpu", "--out", str(tmp_path / "x.json")])
    assert str(e.value) == ("reference registry not found: "
                            + os.path.join(str(tmp_path), "outputs",
                                           "results", rwp.REGISTRY))
    assert not (tmp_path / "x.json").exists()
