"""What the port's ``sweep`` writes and reads beyond its curves, against
the JAX CLI (CPU).

* ``--snr-unit eb``: the committed TPU sweeps of qc1944_r23/r34/r56 ran on
  the Eb/N0 grid 1:4.5:8; ``sweep_configs`` turns that grid and those
  flags into each artifact's Es/N0 points within 1e-9 and its link
  configuration, with no decode. ``ebn0db_to_snrdb``/``snrdb_to_ebn0db``
  against JAX's.
* One tiny sweep of each CLI on ref6432 into its own directory: the same
  files (curves, manifest, ``metrics.jsonl``, ``registry.jsonl``, the
  ``--plot`` figure), the same event names and phase names
  (``compile+first-step``, ``steady-step``) and the same registry keys;
  the port's ``--profile`` Chrome trace; ``--plot`` without matplotlib
  stops before the sweep.
"""

import dataclasses
import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_sims_tpu.cli.main import main as jax_cli_main
from ldpc_sims_tpu.ops import phy as jax_phy
from ldpc_sims_tpu_torch.cli.main import build_parser, main, sweep_configs
from ldpc_sims_tpu_torch.ops import phy

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                        "20260821_{}_sweep_tpu.json")


@pytest.mark.parametrize("name", ["qc1944_r23", "qc1944_r34", "qc1944_r56"])
def test_snr_unit_eb_reproduces_tpu_sweeps(name):
    with open(ARTIFACT.format(name)) as f:
        art = json.load(f)
    args = build_parser().parse_args([
        "sweep", "--code", name, "--method", "min-sum", "--schedule",
        "layered", "--iters", "20", "--clamp", "20", "--early-stop",
        "--es-mode", "freeze", "--snr", "1:4.5:8", "--snr-unit", "eb"])
    code, link, sweep, _, _ = sweep_configs(args)
    np.testing.assert_allclose(sweep.snrdb, art["snrdb"], rtol=0, atol=1e-9)
    assert all(type(s) is float for s in sweep.snrdb)
    assert {k: v for k, v in dataclasses.asdict(link).items()
            if k in art["link"]} == art["link"]
    es = sweep_configs(build_parser().parse_args([
        "sweep", "--code", name, "--snr", "1:4.5:8"]))[2]
    eb = [phy.snrdb_to_ebn0db(s, code.rate, 2) for s in sweep.snrdb]
    np.testing.assert_allclose(eb, es.snrdb, rtol=0, atol=1e-9)


def test_snr_unit_ignored_by_presets():
    """As in the JAX CLI, a preset's grid is its own."""
    grids = [sweep_configs(build_parser().parse_args(
        ["sweep", "--preset", "small-cpu", "--snr-unit", u]))[2].snrdb
        for u in ("es", "eb")]
    assert grids[0] == grids[1] == (2.0,)


def test_ebn0_conversions_match_jax():
    ebn0 = np.linspace(-1.0, 6.0, 8)
    for rate, bps in ((0.5, 2), (5 / 6, 4), (2 / 3, 1)):
        ref = np.asarray(jax_phy.ebn0db_to_snrdb(jnp.asarray(ebn0), rate,
                                                 bps))
        ours = phy.ebn0db_to_snrdb(torch.from_numpy(ebn0), rate, bps)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6)
        assert phy.ebn0db_to_snrdb(1.0, rate, bps) == pytest.approx(
            float(jax_phy.ebn0db_to_snrdb(1.0, rate, bps)), rel=1e-6)
        back = phy.snrdb_to_ebn0db(ours, rate, bps)
        np.testing.assert_allclose(back.numpy(), ebn0, atol=1e-12)
        np.testing.assert_allclose(
            back.numpy(), np.asarray(jax_phy.snrdb_to_ebn0db(
                jnp.asarray(ref), rate, bps)), atol=1e-5)


def outputs(out):
    """{file name with the stamp cut: kind}, the metrics events and the
    registry records of a sweep's --out directory."""
    files = {re.sub(r"^\d{8}-\d{6}_", "", f): os.path.isdir(out / f)
             for f in os.listdir(out)}
    with open(out / "metrics.jsonl") as f:
        events = [json.loads(line) for line in f]
    with open(out / "registry.jsonl") as f:
        runs = [json.loads(line) for line in f]
    return files, events, runs


def test_sweep_outputs_match_jax_cli(tmp_path, capsys):
    flags = ["sweep", "--snr", "2", "--batch", "2048", "--max-bits", "1",
             "--plot"]
    jax_cli_main(flags + ["--out", str(tmp_path / "jax")])
    main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu",
                  "--profile"])
    printed = capsys.readouterr().out
    assert "profiler trace ->" in printed and "figure ->" in printed
    jfiles, jevents, jruns = outputs(tmp_path / "jax")
    files, events, runs = outputs(tmp_path / "port")
    assert files.pop("trace") is True
    assert files == jfiles == {
        "ber.png": False, "curves.json": False, "sweep.json": False,
        "metrics.jsonl": False, "registry.jsonl": False}
    names = [e["event"] for e in events]
    assert names == [e["event"] for e in jevents] == [
        "sweep-step", "sweep-step", "sweep-point", "sweep-phases"]
    assert (set(events[-1]) == set(jevents[-1])
            == {"event", "t", "compile+first-step", "steady-step"})
    assert len(runs) == len(jruns) == 1
    assert set(runs[0]) == set(jruns[0])
    assert runs[0]["kind"] == "sweep" and runs[0]["code"] == "ref6432"
    assert os.path.exists(runs[0]["curves"])
    assert os.path.exists(runs[0]["manifest"])
    trace, = [f for f in os.listdir(tmp_path / "port") if f.endswith(
        "_trace")]
    with open(tmp_path / "port" / trace / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::matmul", "aten::index_select"} & names
    png, = [f for f in os.listdir(tmp_path / "port")
            if f.endswith("_ber.png")]
    with open(tmp_path / "port" / png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_without_matplotlib_stops_first(tmp_path, monkeypatch):
    import ldpc_sims_tpu_torch.parallel as par

    def no_sweep(*a, **k):
        raise AssertionError("the sweep ran")

    monkeypatch.setattr(par, "run_sweep", no_sweep)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="--plot needs matplotlib"):
        main(["sweep", "--device", "cpu", "--plot", "--out",
              str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
