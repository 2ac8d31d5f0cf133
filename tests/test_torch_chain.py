"""The port's link chain and sweep engine (CPU) against the JAX package.

Stage by stage on shared numpy inputs (encode bit-exact; QPSK/BPSK, OFDM
and LLRs within 1e-4 given the same numpy noise), then ``link_step`` as a
whole statistically, then the sweep engine's manifest resume, the CLI,
the package's isolation from JAX and ``chip_smoke.py``'s refusal to run
without a card.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops import LinkConfig as JaxLinkConfig
from ldpc_sims_tpu.ops import encode as jax_encode
from ldpc_sims_tpu.ops import link_step as jax_link_step
from ldpc_sims_tpu.ops import phy as jax_phy
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.cli.main import main as cli_main
from ldpc_sims_tpu_torch.ops import LinkConfig, encode, link_step, phy
from ldpc_sims_tpu_torch.parallel import SweepConfig, mc_step, run_sweep

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "peg128_64",
                                  "ref6432"])
def test_encode_bit_exact(name):
    rng = np.random.default_rng(0)
    code = get_code(name)
    u = rng.integers(0, 2, (64, code.k)).astype(np.int8)
    ours = encode(torch.from_numpy(u), code)
    ref = np.asarray(jax_encode(jnp.asarray(u), jax_get_code(name)))
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), code.encode_np(u))


@pytest.mark.parametrize("modulation", ["qpsk", "bpsk"])
def test_phy_stages_match_jax(modulation):
    """modulate → OFDM → (+ shared noise) → DFT → LLR, within 1e-4."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (8, 512)).astype(np.int8)
    snr = np.float32(10 ** (1.5 / 10))
    if modulation == "qpsk":
        mods = phy.modulate_qpsk, jax_phy.modulate_qpsk
        llrs = phy.demodulate_qpsk_llr, jax_phy.demodulate_qpsk_llr
    else:
        mods = phy.modulate_bpsk, jax_phy.modulate_bpsk
        llrs = phy.bpsk_llr, jax_phy.bpsk_llr
    sym = mods[0](torch.from_numpy(bits))
    jsym = mods[1](jnp.asarray(bits))
    np.testing.assert_allclose(sym.numpy(), np.asarray(jsym), atol=1e-6)
    tx = phy.ofdm_modulate(sym, 8)
    jtx = jax_phy.ofdm_modulate(jsym, 8)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jtx), atol=1e-4)
    tx_cp = phy.add_cyclic_prefix(tx, 2)
    np.testing.assert_array_equal(
        tx_cp.numpy(), np.asarray(jax_phy.add_cyclic_prefix(jtx, 2)))
    np.testing.assert_array_equal(
        phy.remove_cyclic_prefix(tx_cp, 2).numpy(), tx.numpy())
    sigma = 1.0 / np.sqrt(2.0 * snr)
    noise = (sigma * (rng.normal(size=tx.shape)
                      + 1j * rng.normal(size=tx.shape))).astype(np.complex64)
    rx = phy.ofdm_demodulate(tx + torch.from_numpy(noise))
    jrx = jax_phy.ofdm_demodulate(jtx + jnp.asarray(noise))
    np.testing.assert_allclose(rx.numpy(), np.asarray(jrx), atol=1e-4)
    llr = llrs[0](rx, torch.tensor(snr))
    jllr = llrs[1](jrx, jnp.asarray(snr))
    assert llr.shape == (8, 512)
    np.testing.assert_allclose(llr.numpy(), np.asarray(jllr), rtol=1e-4,
                               atol=1e-4)


def test_awgn_and_bits_statistics():
    gen = torch.Generator()
    gen.manual_seed(0)
    bits = phy.random_bits(gen, (64, 1000))
    assert bits.dtype == torch.int8 and abs(bits.float().mean() - 0.5) < 0.01
    snr = 2.0
    x = phy.awgn(gen, torch.zeros((64, 1000), dtype=torch.complex64), snr)
    for part in (x.real, x.imag):  # per-component sigma^2 = 1/(2 snr)
        assert abs(float(part.var()) - 1 / (2 * snr)) < 0.01


def test_link_step_frame_errors_match_jax():
    """wifi1944 flooding-20 at 1.5 dB, 256 codewords: frame-error counts
    agree within the binomial 4σ bound of their difference."""
    batch, snrdb = 256, 1.5
    jcfg = JaxLinkConfig(bp_iterations=20, bp_method="min-sum", clamp=None)
    jout = jax_link_step(jax.random.key(0), jnp.float32(snrdb),
                         jax_get_code("wifi1944"), jcfg, batch)
    gen = torch.Generator()
    gen.manual_seed(0)
    cfg = LinkConfig(bp_iterations=20, bp_method="min-sum", clamp=None)
    out = link_step(gen, snrdb, get_code("wifi1944"), cfg, batch)
    assert all(v.dtype == torch.int32 for v in out.values())
    f_jax, f_ours = int(jout["frame_errors"]), int(out["frame_errors"])
    p = (f_jax + f_ours) / (2 * batch)
    assert 0.4 < p < 0.8  # the waterfall, where the counts say something
    assert abs(f_jax - f_ours) <= 4 * math.sqrt(2 * batch * p * (1 - p))
    assert int(out["info_bits"]) == batch * 972
    assert int(out["uncoded_bits"]) == batch * 1944
    assert int(out["frames"]) == batch
    # QPSK uncoded BER = Q(sqrt(snr)) per bit, to within 4σ
    q = 0.5 * math.erfc(math.sqrt(10 ** (snrdb / 10)) / math.sqrt(2))
    ber = int(out["uncoded_bit_errors"]) / (batch * 1944)
    assert abs(ber - q) < 4 * math.sqrt(q * (1 - q) / (batch * 1944))
    assert int(out["coded_bit_errors"]) < int(out["uncoded_bit_errors"]) / 2


def test_link_step_arrays_and_grouping():
    code = get_code("wifi648")
    gen = torch.Generator()
    gen.manual_seed(3)
    cfg = LinkConfig(bp_iterations=3, bp_method="min-sum", cyclic_prefix=4)
    out = link_step(gen, 3.0, code, cfg, 16, return_arrays=True)
    assert out["llrs"].shape == (16, 648) and out["coded"].dtype == torch.int8
    assert out["rx_time"].shape == out["tx_time"].shape == (2, 81, 32)
    with pytest.raises(ValueError, match="multiple of 8"):
        link_step(gen, 3.0, code, cfg, 12)


@pytest.mark.parametrize("over, match", [
    (dict(modulation="qam16"), "ROADMAP A5"),
    (dict(qbits=3), "ROADMAP A5"),
    (dict(snr_per_symbol=True), "ROADMAP A5"),
])
def test_link_step_unported_raise(over, match):
    cfg = LinkConfig(bp_method="min-sum", **over)
    with pytest.raises(NotImplementedError, match=match):
        link_step(torch.Generator(), 3.0, get_code("wifi648"), cfg, 8)


SMALL = LinkConfig(bp_iterations=3, bp_method="min-sum", clamp=None)


def test_sweep_resumes_without_recounting(tmp_path):
    code = get_code("wifi648")
    sweep = SweepConfig(snrdb=(1.0, 2.0), batch_cw=16, max_info_bits=8000,
                        min_info_bits=0, target_frame_errors=10**9, seed=5)
    path = str(tmp_path / "m.json")
    # an interrupted sweep: only the first point ran
    first = run_sweep(code, SMALL, dataclasses.replace(sweep, snrdb=(1.0,)),
                      manifest_path=path, log=None, device="cpu")
    with open(path) as f:
        steps_after_first = json.load(f)["points"]["1"]["steps"]
    assert steps_after_first == 2  # 2 x 16 x 324 info bits >= 8000

    class Count:
        def __init__(self):
            self.steps = []

        def log(self, event, **fields):
            if event == "sweep-step":
                self.steps.append(fields["snrdb"])

    seen = Count()
    resumed = run_sweep(code, SMALL, sweep, manifest_path=path, log=None,
                        metrics=seen, device="cpu")
    assert seen.steps == [2.0, 2.0]  # the finished point is not recounted
    assert resumed.coded_ber[0] == first.coded_ber[0]
    fresh = run_sweep(code, SMALL, sweep, log=None, device="cpu")
    # the resumed sweep drew the same random stream as an uninterrupted one
    assert fresh.coded_ber == resumed.coded_ber
    assert fresh.uncoded_ber == resumed.uncoded_ber
    again = Count()
    run_sweep(code, SMALL, sweep, manifest_path=path, log=None,
              metrics=again, device="cpu")
    assert again.steps == []


def test_mc_step_chunk_and_guard():
    code = get_code("wifi648")
    step = mc_step(code, SMALL, 8, steps_per_sync=3, device="cpu")
    out = step(11, 2.0)
    assert int(out["frames"]) == 24 and out["frames"].dtype == torch.int32
    with pytest.raises(ValueError, match="overflows int32"):
        mc_step(code, SMALL, 2**20, steps_per_sync=2048, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        mc_step(code, SMALL, 8, mesh=object(), device="cpu")


def test_sweep_es_auto_needs_early_stop_port():
    cfg = LinkConfig(bp_method="min-sum", early_stop=True, es_mode="auto")
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        run_sweep(get_code("wifi648"), cfg, SweepConfig(snrdb=(1.0,)),
                  log=None, device="cpu")


def test_cuda_request_without_card_raises():
    """No silent fallback: asking for the card without one raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(get_code("wifi648"), SMALL, SweepConfig(snrdb=(1.0,)),
                  log=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mc_step(get_code("wifi648"), SMALL, 8)


def test_cli_sweep_on_cpu(tmp_path, capsys):
    cli_main(["sweep", "--code", "wifi648", "--iters", "3", "--batch", "16",
              "--snr", "2.0", "--max-bits", "1000", "--device", "cpu",
              "--out", str(tmp_path), "--bp-alpha", "0.8,0.8,0.9"])
    printed = capsys.readouterr().out
    assert "curves ->" in printed
    curves = [p for p in os.listdir(tmp_path) if p.endswith("_curves.json")]
    with open(tmp_path / curves[0]) as f:
        rec = json.load(f)
    assert rec["code"] == "wifi648_r12" and rec["snrdb"] == [2.0]
    assert rec["link"]["alpha"] == [0.8, 0.8, 0.9]


def test_package_imports_no_jax():
    """ldpc_sims_tpu_torch and chip_smoke load no jax* module and nothing
    of ldpc_sims_tpu."""
    code = (
        "import sys, chip_smoke, ldpc_sims_tpu_torch\n"
        "import ldpc_sims_tpu_torch.cli.main, ldpc_sims_tpu_torch.convert\n"
        "import ldpc_sims_tpu_torch.kernels, ldpc_sims_tpu_torch.parallel\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'jax'\n"
        "       or m.startswith('jax') or m == 'ldpc_sims_tpu'\n"
        "       or m.startswith('ldpc_sims_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    """Without a card, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
