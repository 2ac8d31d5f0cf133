"""The model-family drivers against the JAX package (CPU).

* ``tests/test_grid.py``'s flow through the port's CLI: ``train-grid`` on
  ref6432 at two SNRs, qbits 3, two epochs, 128 codewords; a resume that
  trains no new cell; ``evaluate-grid`` with ``--plot`` and its
  (n_snr, n_qbits, n_clipdb) arrays.
* Across the packages: JAX's ``evaluate_grid`` reads the port-trained
  family, and at its 2 dB cell, at 4096 codewords, its Traditional
  (``coded_ber``) and quantized (``coded_ber_qllr``) columns agree with
  the port's within 4/√(frames in error), relative; JAX's ``train_grid``
  resumes the port's family without training a cell, and the port's
  ``evaluate_grid`` reads a family JAX trained.
* An unknown family raises JAX's ``ValueError``.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from ldpc_sims_tpu_torch.cli.main import main as cli_main
from ldpc_sims_tpu_torch.utils.registry import find_runs

GRID = ["--code", "ref6432", "--snr", "2,6", "--qbits-grid", "3",
        "--clipdb-grid", "0", "--epochs", "2", "--batch", "128",
        "--num-codewords", "128", "--family", "testfam"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores, and an OpenMP pool of every core in each of them
    stalls the others' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """The port-trained two-SNR family (stage 1 and 2: four cells)."""
    out = str(tmp_path_factory.mktemp("grid"))
    cli_main(["train-grid", *GRID, "--device", "cpu", "--out", out])
    return out


def test_train_grid_then_evaluate_grid(family):
    out = family
    unq = find_runs("train-llr", out, family="testfam", stage="unquantized")
    qnt = find_runs("train-llr", out, family="testfam", stage="quantized")
    assert len(unq) == 2 and len(qnt) == 2
    for r in qnt:
        assert r["warm_start"]  # chained from the stage-1 checkpoint
        assert os.path.isfile(os.path.join(r["ckpt"], "params.msgpack"))
    with open(os.path.join(out, "testfam_family.json")) as f:
        assert set(json.load(f)["unquantized"]) == {"2", "6"}

    # resume: re-running creates no new cell
    cli_main(["train-grid", *GRID, "--device", "cpu", "--out", out])
    assert len(find_runs("train-llr", out, family="testfam")) == 4

    cli_main(["evaluate-grid", "--code", "ref6432", "--family", "testfam",
              "--batch", "128", "--iters", "3", "--plot", "--device", "cpu",
              "--out", out])
    grid_files = [f for f in os.listdir(out)
                  if f.endswith("grid_testfam.json")]
    assert len(grid_files) == 1
    with open(os.path.join(out, grid_files[0])) as f:
        grid = json.load(f)
    assert grid["snrdb"] == [2.0, 6.0]
    assert grid["qbits"] == [3] and grid["clipdb"] == [0.0]
    trad = np.asarray(grid["coded_ber"])
    nn = np.asarray(grid["coded_ber_nn"])
    assert trad.shape == nn.shape == (2, 1, 1)
    assert np.isfinite(trad).all() and np.isfinite(nn).all()
    assert trad[1, 0, 0] <= trad[0, 0, 0]
    assert any(f.endswith("grid_testfam.png") for f in os.listdir(out))
    assert [r["kind"] for r in find_runs("evaluate-grid", out)] == [
        "evaluate-grid"]


def test_jax_reads_and_resumes_the_port_family(family):
    from ldpc_sims_tpu.codes import reference_6432 as jax_ref6432
    from ldpc_sims_tpu.grid import evaluate_grid as jax_evaluate_grid
    from ldpc_sims_tpu.grid import train_grid as jax_train_grid
    from ldpc_sims_tpu.training import TrainConfig as JaxTrainConfig
    from ldpc_sims_tpu_torch.codes import reference_6432
    from ldpc_sims_tpu_torch.grid import evaluate_grid

    n = 4096
    theirs = jax_evaluate_grid(jax_ref6432(), "testfam", num_codewords=n,
                               out_dir=family, log=None)
    ours = evaluate_grid(reference_6432(), "testfam", num_codewords=n,
                         out_dir=family, log=None, device="cpu")
    assert theirs["snrdb"] == ours["snrdb"] == [2.0, 6.0]
    for col, frames_col in (("coded_ber", "coded_bler"),
                            ("coded_ber_qllr", "coded_bler_qllr")):
        a = ours[col][0][0][0]
        b = theirs[col][0][0][0]
        frames = 0.5 * n * (ours[frames_col][0][0][0]
                            + theirs[frames_col][0][0][0])
        rel = abs(a - b) / (0.5 * (a + b))
        assert rel <= 4 / math.sqrt(frames), (col, a, b, frames)
    assert np.isfinite(np.asarray(theirs["coded_ber_nn"])).all()

    # JAX's train_grid finds every cell the port trained: nothing to train
    before = len(find_runs("train-llr", family))
    manifest = jax_train_grid(
        jax_ref6432(), (2.0, 6.0), (3,), (0.0,),
        JaxTrainConfig(num_epochs=2, batch_size=128), num_codewords=128,
        out_dir=family, family="testfam", log=None)
    assert len(find_runs("train-llr", family)) == before
    assert manifest["quantized"]["2_3_0"].endswith(
        "testfam_quantized_snr=2_qbits=3_clipdb=0")


def test_port_reads_a_jax_family(tmp_path):
    from ldpc_sims_tpu.cli.main import main as jax_main
    from ldpc_sims_tpu_torch.codes import reference_6432
    from ldpc_sims_tpu_torch.grid import evaluate_grid

    out = str(tmp_path)
    jax_main(["train-grid", "--code", "ref6432", "--snr", "3",
              "--qbits-grid", "3", "--clipdb-grid", "0", "--epochs", "1",
              "--batch", "64", "--num-codewords", "64", "--family", "jaxfam",
              "--out", out])
    grid = evaluate_grid(reference_6432(), "jaxfam", num_codewords=64,
                         out_dir=out, log=None, device="cpu")
    assert grid["snrdb"] == [3.0] and grid["qbits"] == [3]
    for k in ("coded_ber", "coded_ber_qllr", "coded_ber_nn", "wmse_nn"):
        assert np.isfinite(np.asarray(grid[k])).all(), k
    # the port resumes it: no cell trained again
    cli_main(["train-grid", "--code", "ref6432", "--snr", "3",
              "--qbits-grid", "3", "--clipdb-grid", "0", "--epochs", "1",
              "--family", "jaxfam", "--device", "cpu", "--out", out])
    assert len(find_runs("train-llr", out, family="jaxfam")) == 2


def test_evaluate_grid_unknown_family(tmp_path):
    from ldpc_sims_tpu_torch.codes import reference_6432
    from ldpc_sims_tpu_torch.grid import evaluate_grid

    with pytest.raises(ValueError, match="no 'quantized' train-llr runs"):
        evaluate_grid(reference_6432(), "nope", out_dir=str(tmp_path),
                      device="cpu")
