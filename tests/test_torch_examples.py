"""The port's examples on the CPU at their smallest sizes.

* ``error_floor_campaign`` on wifi648 with a registry holding a trained
  layered-3 schedule: the control and every schedule decode the same
  frames (a function of (point, step) only), the verdicts follow the
  floor_ok rule, and the folded flags go into a copy beside the record.
  Run on the committed registry, the fold lands in the copy and the
  committed ``docs/artifacts/minsum_trained_schedules.json`` keeps its
  bytes (C14: no port code writes under ``docs/artifacts/``).
* ``de_thresholds`` on wifi648 (few samples, batch 16): its record's
  keys and verdict, written where ``DE_OUT`` says.
* ``joint_before_after`` at its smallest size: its record's keys.
* Every example's ``main()`` refuses a missing card unless asked for the
  CPU.
"""

import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from ldpc_sims_tpu_torch.examples import error_floor_campaign as efc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores, and an OpenMP pool of every core in each of them
    stalls the others' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest_artifacts() -> dict[str, str]:
    return {f: hashlib.sha256(open(os.path.join(ARTIFACTS, f), "rb")
                              .read()).hexdigest()
            for f in sorted(os.listdir(ARTIFACTS))
            if os.path.isfile(os.path.join(ARTIFACTS, f))}


def _campaign(monkeypatch, tmp_path, **env) -> dict:
    base = dict(EF_CODE="wifi648", EF_SNRS="2.0,2.5", EF_TARGET_BITS="1",
                EF_BATCH="16", EF_CHUNK_STEPS="2", EF_DEVICE="cpu",
                EF_OUT=str(tmp_path / "rec.json"))
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(k, v)
    assert efc.main() == 0
    with open(tmp_path / "rec.json") as f:
        return json.load(f)


def test_error_floor_campaign_pairs_frames(monkeypatch, tmp_path):
    reg = {"wifi648": {"layered": {"3": {
        "alpha": [0.8, 0.9, 1.0], "beta": [0.1, 0.1, 0.0],
        "parity_ok": True}}}}
    reg_path = tmp_path / "reg.json"
    reg_path.write_text(json.dumps(reg))
    seen: dict[str, list] = {}
    decode = efc.bp_decode

    def spy(llr, code, **kw):
        seen.setdefault(repr(sorted(kw.items())), []).append(llr.clone())
        return decode(llr, code, **kw)

    monkeypatch.setattr(efc, "bp_decode", spy)
    rec = _campaign(monkeypatch, tmp_path, EF_REGISTRY=str(reg_path))
    names = [p["schedule"] for p in rec["points"]]
    assert names == 2 * ["flooding-20", "layered-10", "trained-layered-3",
                         "probe-trained3-20", "probe-plain4-20"]
    # every schedule decoded the control's frames, step for step
    runs = list(seen.values())
    assert len(runs) == 5 and all(len(r) == 4 for r in runs)
    for r in runs[1:]:
        for a, b in zip(r, runs[0]):
            assert torch.equal(a, b)
    # the frames are a function of (point, step) only
    code = efc.get_code("wifi648")
    assert torch.equal(runs[0][3], efc.point_llrs(code, 2.5, 1, 1, 16,
                                                  torch.device("cpu")))
    # the floor_ok rule against the paired control
    ctrl = {p["snr_db"]: p for p in rec["points"]
            if p["schedule"] == "flooding-20"}
    for name, vs in rec["verdicts"].items():
        for v in vs:
            p = next(q for q in rec["points"] if q["schedule"] == name
                     and q["snr_db"] == v["snr_db"])
            c = ctrl[v["snr_db"]]
            ce = c["bit_errs"] * p["coded_bits"] / c["coded_bits"]
            assert v["floor_ok"] == (
                p["bit_errs"] <= ce * 1.15 + 5 * math.sqrt(ce) + 20)
    assert set(rec["verdicts"]) == set(names) - {"flooding-20"}
    with open(tmp_path / "rec_schedules.json") as f:
        folded = json.load(f)
    ent = folded["wifi648"]["layered"]["3"]
    assert ent["floor_ok"] == all(
        v["floor_ok"] for v in rec["verdicts"]["trained-layered-3"])
    assert ent["floor_points_db"] == [2.0, 2.5]
    assert json.loads(reg_path.read_text()) == reg  # read, not written


def test_error_floor_campaign_never_writes_artifacts(monkeypatch, tmp_path):
    before = _digest_artifacts()
    rec = _campaign(monkeypatch, tmp_path, EF_SNRS="2.0",
                    EF_ONLY="layered-10")
    assert [p["schedule"] for p in rec["points"]] == ["flooding-20",
                                                      "layered-10"]
    with open(os.path.join(ARTIFACTS, "minsum_trained_schedules.json")) as f:
        committed = json.load(f)
    with open(tmp_path / "rec_schedules.json") as f:
        folded = json.load(f)
    # the fold happened, in the copy
    assert folded["wifi648"]["layered_plain_floor_ok"] == rec["verdicts"][
        "layered-10"][0]["floor_ok"]
    assert "wifi648" not in committed
    assert {k: v for k, v in folded.items() if k != "wifi648"} == committed
    assert _digest_artifacts() == before


def test_error_floor_campaign_registry_schedules():
    """The committed registry's wifi1944 schedules, JAX's list in its
    order, the per-edge decoders' weights packed for the kernels."""
    with open(efc.REGISTRY) as f:
        reg = json.load(f)
    names = [n for n, _ in efc.schedules_from_registry(
        "wifi1944", reg, ARTIFACTS, torch.device("cpu"))]
    assert names == [
        "flooding-20", "layered-10", "probe-trained4-20",
        "probe-trained5-20", "trained-layered-6", "probe-trained6-20",
        "trained-layered-7", "probe-trained7-20", "trained-layered-8",
        "probe-trained8-20", "trained-layered-10", "probe-trained10-20",
        "edge-layered-5", "edge-layered-6", "probe-plain4-20"]


def test_de_thresholds_example(monkeypatch, tmp_path):
    from ldpc_sims_tpu_torch.examples import de_thresholds

    out = tmp_path / "de.json"
    for k, v in dict(DE_CODES="wifi648", DE_SAMPLES="512", DE_BATCH="16",
                     DE_DEVICE="cpu", DE_OUT=str(out)).items():
        monkeypatch.setenv(k, v)
    assert de_thresholds.main() == 0
    with open(out) as f:
        rec = json.load(f)
    ent = rec["codes"]["wifi648"]
    assert set(ent) >= {"th_minsum_20it_db", "th_minsum_db",
                        "th_sumproduct_db", "measured_1e3_crossing_db",
                        "gap_db", "gap_max_db", "consistent"}
    assert ent["th_sumproduct_db"] <= ent["th_minsum_db"] <= ent[
        "th_minsum_20it_db"]
    assert ent["gap_max_db"] == 1.2
    assert ent["consistent"] == (0 < ent["gap_db"] < 1.2)


def test_joint_before_after_smallest(monkeypatch, tmp_path):
    from ldpc_sims_tpu_torch.examples import joint_before_after as jb

    rec = jb.run(torch.device("cpu"), codewords=64, epochs=1,
                 joint_codewords=64, joint_epochs=1, eval_codewords=64)
    assert rec["snrdb"] == [3.0, 4.0, 5.0, 6.0]
    for k in ("ber_joint_before", "ber_joint_after", "ber_classic",
              "ber_quantized_llr", "bler_joint_before", "bler_joint_after"):
        assert len(rec[k]) == 4 and np.isfinite(rec[k]).all(), k
    assert isinstance(rec["improves_at_train_snr"], bool)
    assert len(rec["train_loss_first_last"]) == 2


@pytest.mark.parametrize("name, var", [
    ("error_floor_campaign", "EF_DEVICE"), ("de_thresholds", "DE_DEVICE"),
    ("joint_before_after", "JB_DEVICE"), ("quantized_llr_study", None),
    ("tanh_family", "TANH_DEVICE"), ("train_minsum_1944", "MS_DEVICE"),
    ("train_minsum_short", "MS_DEVICE"), ("train_minsum_tail7", "T7_DEVICE"),
    ("train_edge_1944", "EDGE_DEVICE"),
    ("train_edge_layered_1944", "EL_DEVICE"),
])
def test_examples_refuse_a_missing_card(monkeypatch, name, var):
    """Without a card each example's main() raises before any work, unless
    its device variable (``quantized_llr_study``: its ``device``
    argument) says cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    mod = importlib.import_module(f"ldpc_sims_tpu_torch.examples.{name}")
    if var is not None:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
