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
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.cli.main import PRESETS as JAX_PRESETS
from ldpc_sims_tpu.codes import get_code as jax_get_code
from ldpc_sims_tpu.ops import LinkConfig as JaxLinkConfig
from ldpc_sims_tpu.ops import encode as jax_encode
from ldpc_sims_tpu.ops import link_step as jax_link_step
from ldpc_sims_tpu.ops import phy as jax_phy
from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.cli.main import PRESETS
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


def test_qam16_matches_jax():
    """Gray 16-QAM and its exact log-sum-exp LLRs, on shared inputs."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (8, 512)).astype(np.int8)
    sym = phy.modulate_qam16(torch.from_numpy(bits))
    jsym = np.asarray(jax_phy.modulate_qam16(jnp.asarray(bits)))
    np.testing.assert_allclose(sym.numpy(), jsym, rtol=1e-5, atol=1e-5)
    assert abs(float((sym.abs() ** 2).mean()) - 1.0) < 0.05
    for snrdb in (4.0, 12.0):
        snr = np.float32(10 ** (snrdb / 10))
        sigma = 1.0 / np.sqrt(2.0 * snr)
        noise = (sigma * (rng.normal(size=sym.shape)
                          + 1j * rng.normal(size=sym.shape))).astype(
            np.complex64)
        rx = jsym + noise
        llr = phy.qam16_llr(torch.from_numpy(rx), torch.tensor(snr))
        jllr = np.asarray(jax_phy.qam16_llr(jnp.asarray(rx),
                                            jnp.asarray(snr)))
        assert llr.shape == (8, 512)
        np.testing.assert_allclose(llr.numpy(), jllr, rtol=1e-5, atol=1e-5)
    # noiseless: every LLR has the sign of its bit
    clean = phy.qam16_llr(sym, torch.tensor(10.0))
    np.testing.assert_array_equal((clean > 0).numpy(), bits == 1)


def test_link_step_qam16_probe_frame_errors_match_jax():
    """wifi648, 16-QAM over OFDM-64, layered-8 with es_mode='probe' at
    7 dB, 256 codewords: frame errors within the binomial 4σ bound of
    their difference, and the 16-QAM uncoded BER within 4σ of theory."""
    batch, snrdb = 256, 7.0
    kw = dict(modulation="qam16", ofdm_size=64, bp_iterations=8,
              bp_method="min-sum", clamp=None, bp_schedule="layered",
              early_stop=True, es_mode="probe", es_probe_iters=3)
    jout = jax_link_step(jax.random.key(1), jnp.float32(snrdb),
                         jax_get_code("wifi648"), JaxLinkConfig(**kw), batch)
    gen = torch.Generator()
    gen.manual_seed(1)
    out = link_step(gen, snrdb, get_code("wifi648"), LinkConfig(**kw),
                    batch)
    f_jax, f_ours = int(jout["frame_errors"]), int(out["frame_errors"])
    p = (f_jax + f_ours) / (2 * batch)
    assert 0.2 < p < 0.8
    assert abs(f_jax - f_ours) <= 4 * math.sqrt(2 * batch * p * (1 - p))
    x = math.sqrt(10 ** (snrdb / 10) / 5)
    q = lambda t: 0.5 * math.erfc(t / math.sqrt(2))  # noqa: E731
    theory = (3 * q(x) + 2 * q(3 * x) - q(5 * x)) / 4
    nbits = batch * 648
    ber = int(out["uncoded_bit_errors"]) / nbits
    assert abs(ber - theory) < 4 * math.sqrt(theory * (1 - theory) / nbits)


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


@pytest.mark.parametrize("agc, snrdb", [("global", 8.0),
                                         ("per-symbol", 4.5)])
def test_link_step_quantized_adc_decodes(agc, snrdb):
    """The quantized-ADC branch, which raised until it was ported: a 3-bit
    ADC costs frame errors against the ideal one on the same noise, the
    uncoded count stays the ideal ADC's, and the decode still corrects
    (the comparison with JAX is in tests/test_torch_quant.py)."""
    code = get_code("wifi648")
    ideal = LinkConfig(bp_iterations=6, bp_method="min-sum", clamp=None)
    outs = []
    for cfg in (ideal, dataclasses.replace(ideal, qbits=3, agc=agc)):
        gen = torch.Generator()
        gen.manual_seed(6)
        outs.append(link_step(gen, snrdb, code, cfg, 64))
    assert torch.equal(outs[0]["uncoded_bit_errors"],
                       outs[1]["uncoded_bit_errors"])
    assert int(outs[1]["coded_bit_errors"]) >= int(
        outs[0]["coded_bit_errors"])
    assert int(outs[1]["coded_bit_errors"]) < int(
        outs[1]["uncoded_bit_errors"])


@pytest.mark.parametrize("over, match", [
    # ported with the trainers: one SNR an OFDM symbol, uniform in dB
    (dict(snr_per_symbol=True, snrdb_low=1.0, snrdb_high=4.0), (1.0, 4.0)),
])
def test_link_step_unported_raise(over, match):
    cfg = LinkConfig(bp_method="min-sum", **over)
    out = link_step(torch.Generator().manual_seed(3), 3.0,
                    get_code("wifi648"), cfg, 8, return_arrays=True)
    lo, hi = (10 ** (v / 10) for v in match)
    snr = out["snr_sym"]
    assert snr.shape == out["rx_time"].shape[:2]
    assert float(snr.min()) >= lo and float(snr.max()) <= hi
    assert len(torch.unique(snr)) == snr.numel()  # drawn, not broadcast
    assert torch.isfinite(out["llrs"]).all()


@pytest.mark.parametrize("argv", [
    ["sweep", "--preset", "small-cpu", "--seed", "7"],
    ["sweep", "--code", "wifi648", "--method", "min-sum", "--seed", "7"],
], ids=["preset", "flags"])
def test_sweep_passes_its_seed(argv):
    """``sweep --seed`` reaches the sweep's SweepConfig, with a preset and
    with flags. The JAX CLI builds its SweepConfig without the seed
    (ldpc_sims_tpu/cli/main.py:227, :232-237), so every JAX sweep runs
    seed 0 whatever --seed says; the port keeps the seed it is given
    (ROADMAP C5)."""
    from ldpc_sims_tpu_torch.cli.main import build_parser, sweep_configs

    _, _, sweep, _, _ = sweep_configs(build_parser().parse_args(argv))
    assert sweep.seed == 7
    default = build_parser().parse_args(argv[:-2])
    assert sweep_configs(default)[2].seed == default.seed


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
    # a one-rank mesh runs, and draws the mesh-less stream
    from ldpc_sims_tpu_torch.parallel import make_mesh

    meshed = mc_step(code, SMALL, 8, steps_per_sync=3, mesh=make_mesh(),
                     device="cpu")(11, 2.0)
    assert {k: int(v) for k, v in meshed.items()} == {
        k: int(v) for k, v in out.items()}


class Events:
    def __init__(self):
        self.steps, self.auto = [], []

    def log(self, event, **fields):
        if event == "sweep-step":
            self.steps.append(fields["mode"])
        elif event == "es-auto":
            self.auto.append(fields)


def test_sweep_es_auto_needs_early_stop_port(tmp_path):
    """es_mode='auto' calibrates only with early stop: without it the
    sweep runs the fixed decode alone and records no choice."""
    cfg = dataclasses.replace(SMALL, es_mode="auto")
    sweep = SweepConfig(snrdb=(2.0,), batch_cw=16, max_info_bits=8000,
                        min_info_bits=0, target_frame_errors=10**9)
    path = str(tmp_path / "m.json")
    seen = Events()
    run_sweep(get_code("wifi648"), cfg, sweep, manifest_path=path,
              log=None, metrics=seen, device="cpu")
    assert seen.steps == ["fixed", "fixed"] and seen.auto == []
    with open(path) as f:
        assert "es_auto_mode" not in json.load(f)["points"]["2"]


def test_sweep_es_auto_calibrates_and_resumes(tmp_path, monkeypatch):
    """With early stop, each point warms each mode once per sweep, times
    both, keeps the faster and records it; every calibration chunk's
    counts go into the point (the JAX package's behaviour, ROADMAP §C); a
    resumed point reuses the recorded mode without calibrating."""
    import ldpc_sims_tpu_torch.parallel.mc as mc

    build = mc.mc_step

    def slow_probe(code, cfg, *a, **kw):
        step = build(code, cfg, *a, **kw)
        if cfg.es_mode != "probe":
            return step

        def run(seed, snrdb):
            time.sleep(0.3)  # the probe decode loses every calibration
            return step(seed, snrdb)
        return run

    monkeypatch.setattr(mc, "mc_step", slow_probe)
    cfg = dataclasses.replace(SMALL, bp_schedule="layered", early_stop=True,
                              es_mode="auto", es_probe_iters=1)
    code = get_code("wifi648")
    chunk = 16 * code.k
    sweep = SweepConfig(snrdb=(2.0, 3.0), batch_cw=16,
                        max_info_bits=5 * chunk, min_info_bits=0,
                        target_frame_errors=10**9)
    path = str(tmp_path / "m.json")
    seen = Events()
    run_sweep(code, cfg, sweep, manifest_path=path, log=None,
              metrics=seen, device="cpu")
    # point 1 warms and times both modes; point 2 only times them
    assert seen.steps == ["fixed", "fixed", "probe", "probe", "fixed",
                          "fixed", "probe", "fixed", "fixed", "fixed"]
    assert [a["mode"] for a in seen.auto] == ["fixed", "fixed"]
    assert all(a["probe"] > a["fixed"] for a in seen.auto)
    with open(path) as f:
        points = json.load(f)["points"]
    for key in ("2", "3"):  # the calibration chunks count
        assert points[key]["es_auto_mode"] == "fixed"
        assert points[key]["steps"] == 5 and points[key]["frames"] == 80
    # resume with a larger budget: the recorded mode, no calibration
    points["3"]["es_auto_mode"] = "probe"
    with open(path, "w") as f:
        json.dump({"points": points, "steps_per_sync": 1}, f)
    again = Events()
    run_sweep(code, cfg, dataclasses.replace(sweep,
                                             max_info_bits=7 * chunk),
              manifest_path=path, log=None, metrics=again, device="cpu")
    assert again.steps == ["fixed", "fixed", "probe", "probe"]
    assert again.auto == []


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
    cli_main(["sweep", "--code", "wifi648", "--method", "min-sum",
              "--clamp", "0", "--iters", "3", "--batch", "16",
              "--snr", "2.0", "--max-bits", "1000", "--device", "cpu",
              "--out", str(tmp_path), "--bp-alpha", "0.8,0.8,0.9"])
    printed = capsys.readouterr().out
    assert "curves ->" in printed
    curves = [p for p in os.listdir(tmp_path) if p.endswith("_curves.json")]
    with open(tmp_path / curves[0]) as f:
        rec = json.load(f)
    assert rec["code"] == "wifi648_r12" and rec["snrdb"] == [2.0]
    assert rec["link"]["alpha"] == [0.8, 0.8, 0.9]


def test_presets_match_jax():
    """The port's PRESETS give the JAX table's LinkConfig and SweepConfig."""
    from ldpc_sims_tpu.parallel import SweepConfig as JaxSweepConfig

    assert set(PRESETS) == set(JAX_PRESETS)
    for name, p in PRESETS.items():
        jp = JAX_PRESETS[name]
        assert p["code"] == jp["code"]
        assert p.get("msg_qbits_grid") == jp.get("msg_qbits_grid")
        assert (dataclasses.asdict(LinkConfig(**p["link"]))
                == dataclasses.asdict(JaxLinkConfig(**jp["link"])))
        assert (dataclasses.asdict(SweepConfig(**p["sweep"]))
                == dataclasses.asdict(JaxSweepConfig(**jp["sweep"])))


def test_cli_preset_ofdm_qam16(tmp_path, monkeypatch):
    """--preset ofdm-qam16 runs the preset's configuration (the sweep is
    cut here to one point of 32 codewords)."""
    import ldpc_sims_tpu_torch.parallel as par

    calls = []
    real = par.run_sweep

    def short(code, link, sweep, **kw):
        calls.append((code.name, link, sweep))
        return real(code, link, dataclasses.replace(
            sweep, snrdb=(10.0,), batch_cw=32, steps_per_sync=1,
            max_info_bits=1, min_info_bits=0), **kw)

    monkeypatch.setattr(par, "run_sweep", short)
    cli_main(["sweep", "--preset", "ofdm-qam16", "--device", "cpu",
              "--out", str(tmp_path)])
    (name, link, sweep), = calls
    p = PRESETS["ofdm-qam16"]
    assert name == "wifi1944_r12"
    assert link == LinkConfig(**p["link"])
    assert sweep == SweepConfig(**p["sweep"])
    assert link.modulation == "qam16" and link.es_mode == "auto"
    curves = [f for f in os.listdir(tmp_path) if f.endswith("_curves.json")]
    with open(tmp_path / curves[0]) as f:
        rec = json.load(f)
    assert rec["preset"] == "ofdm-qam16" and rec["snrdb"] == [10.0]
    assert rec["coded_ber"][0] < rec["uncoded_ber"][0]


def cut_sweeps(monkeypatch, snrdb):
    """Make the CLI's run_sweep run one point of 32 codewords, recording
    each call's (code name, link, sweep)."""
    import ldpc_sims_tpu_torch.parallel as par

    calls = []
    real = par.run_sweep

    def short(code, link, sweep, **kw):
        calls.append((code.name, link, sweep))
        return real(code, link, dataclasses.replace(
            sweep, snrdb=(snrdb,), batch_cw=32, steps_per_sync=1,
            max_info_bits=1, min_info_bits=0), **kw)

    monkeypatch.setattr(par, "run_sweep", short)
    return calls


def test_cli_preset_wifi648_sweep(tmp_path, monkeypatch):
    """--preset wifi648-sweep, which raised until sum-product was ported:
    layered-20 sum-product with es_mode='auto' (cut to one point)."""
    calls = cut_sweeps(monkeypatch, 3.0)
    cli_main(["sweep", "--preset", "wifi648-sweep", "--device", "cpu",
              "--out", str(tmp_path)])
    (name, link, sweep), = calls
    p = PRESETS["wifi648-sweep"]
    assert name == "wifi648_r12" and link == LinkConfig(**p["link"])
    assert sweep == SweepConfig(**p["sweep"])
    assert link.bp_method == "sum-product" and link.es_mode == "auto"
    curves = [f for f in os.listdir(tmp_path) if f.endswith("_curves.json")]
    with open(tmp_path / curves[0]) as f:
        rec = json.load(f)
    assert rec["preset"] == "wifi648-sweep" and rec["snrdb"] == [3.0]
    assert rec["coded_ber"][0] < rec["uncoded_ber"][0]


def test_cli_preset_quantized_minsum(tmp_path, monkeypatch):
    """--preset quantized-minsum, which raised until message quantization
    was ported: one sweep per width of msg_qbits_grid, each with its own
    manifest and curves file tagged _msgq{b}, as the JAX CLI writes them;
    a given --manifest is tagged per width too."""
    calls = cut_sweeps(monkeypatch, 3.0)
    manifest = str(tmp_path / "m.json")
    cli_main(["sweep", "--preset", "quantized-minsum", "--device", "cpu",
              "--out", str(tmp_path), "--manifest", manifest])
    assert [c[1].msg_qbits for c in calls] == [3, 4, 5]
    p = PRESETS["quantized-minsum"]
    assert all(c[1] == dataclasses.replace(LinkConfig(**p["link"]),
                                           msg_qbits=b)
               for c, b in zip(calls, (3, 4, 5)))
    files = sorted(os.listdir(tmp_path))
    for b in (3, 4, 5):
        assert f"m_msgq{b}.json" in files
        curves, = [f for f in files if f.endswith(f"_curves_msgq{b}.json")]
        with open(tmp_path / curves) as f:
            assert json.load(f)["link"]["msg_qbits"] == b


def test_cli_quantization_flags(tmp_path, monkeypatch):
    """The message and ADC quantization flags reach the link (the sweep is
    cut to one point of 32 codewords)."""
    calls = cut_sweeps(monkeypatch, 6.0)
    cli_main(["sweep", "--code", "wifi648", "--iters", "4", "--clamp", "0",
              "--snr", "6.0", "--device", "cpu",
              "--out", str(tmp_path), "--method", "sum-product",
              "--msg-qbits", "4", "--qbits", "3", "--clipdb", "3",
              "--agc", "per-symbol"])
    curves, = [f for f in os.listdir(tmp_path)
               if f.endswith("_curves_msgq4.json")]
    with open(tmp_path / curves) as f:
        link = json.load(f)["link"]
    assert link["bp_method"] == "sum-product" and link["msg_qbits"] == 4
    assert link["qbits"] == 3 and link["agc"] == "per-symbol"
    assert link["clip_ratio"] == 10 ** 0.3
    (_, cfg, _), = calls
    assert dataclasses.asdict(cfg) == link


@pytest.mark.parametrize("preset, match", [
    ("small-cpu", "peg128_64"),
    ("reference", "ref6432"),
])
def test_cli_unported_presets_raise(tmp_path, monkeypatch, preset, match):
    """The two presets of non-QC codes, which raised until the gather
    backend was ported, run their configurations (cut to one point of 32
    codewords) and decode below the uncoded BER."""
    calls = cut_sweeps(monkeypatch, 6.0)
    cli_main(["sweep", "--preset", preset, "--device", "cpu",
              "--out", str(tmp_path)])
    (name, link, sweep), = calls
    p = PRESETS[preset]
    assert name.startswith(match) and link == LinkConfig(**p["link"])
    assert sweep == SweepConfig(**p["sweep"])
    curves = [f for f in os.listdir(tmp_path) if f.endswith("_curves.json")]
    with open(tmp_path / curves[0]) as f:
        rec = json.load(f)
    assert rec["preset"] == preset and rec["snrdb"] == [6.0]
    assert rec["coded_ber"][0] < rec["uncoded_ber"][0]


def test_cli_early_stop_flags(tmp_path):
    cli_main(["sweep", "--code", "wifi648", "--method", "min-sum",
              "--clamp", "0", "--iters", "4", "--batch", "32",
              "--snr", "3.0", "--max-bits", "1000", "--device", "cpu",
              "--out", str(tmp_path), "--schedule", "layered",
              "--early-stop", "--es-mode", "probe", "--es-probe-iters", "2",
              "--es-probe-alpha", "0.9,0.8", "--modulation", "qam16",
              "--ofdm-size", "64"])
    curves = [f for f in os.listdir(tmp_path) if f.endswith("_curves.json")]
    with open(tmp_path / curves[0]) as f:
        link = json.load(f)["link"]
    assert link["early_stop"] and link["es_mode"] == "probe"
    assert link["es_probe_iters"] == 2 and link["es_probe_alpha"] == [0.9,
                                                                     0.8]
    assert link["modulation"] == "qam16"


def test_package_imports_no_jax():
    """chip_smoke and every module of ldpc_sims_tpu_torch (found with
    pkgutil.walk_packages, the examples included; ``__main__`` runs the
    CLI) load no jax*, optax, flax or msgpack module and nothing of
    ldpc_sims_tpu."""
    code = (
        "import importlib, pkgutil, sys, chip_smoke, ldpc_sims_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    ldpc_sims_tpu_torch.__path__, 'ldpc_sims_tpu_torch.')\n"
        "    if not m.name.endswith('__main__')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods), file=sys.stderr)\n"
        "assert 'ldpc_sims_tpu_torch.examples.train_edge_layered_1944' in "
        "mods\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'jax'\n"
        "       or m.startswith('jax') or m == 'ldpc_sims_tpu'\n"
        "       or m.split('.')[0] in ('optax', 'flax', 'msgpack')\n"
        "       or m.startswith('ldpc_sims_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"
    assert int(res.stderr.strip().splitlines()[-1]) > 40


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
