"""A run of a cell driven on the CPU at a small batch: its result line, its
refusals, and ``correct`` coming out false under the control and under
faults planted in the timed path. The card's own run is the ``gpu`` test
at the end."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import check, control, devtrace, harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELL = "wifi1944.ms-flood20"
SEED = 2**33 + 17  # more than 32 bits


def _run(traced=False, cell=CELL, batch=16):
    return harness.run_cell(cell, SEED, 0.3, traced, time.perf_counter(),
                            device="cpu", batch=batch, log=lambda m: None)


def test_result_line_keys():
    r = _run()
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"info_bits_per_s", "step_ms_p95",
                                 "setup_s"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(r["device"])
    assert set(r["checks"]) == set(check.NUMBERS)
    json.dumps(r)


def test_traced_result_line_keys():
    r = _run(traced=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(r["device"])
    # the CPU's trace has no device activity: no device metric is read
    assert "device_idle_share" not in r["metrics"]
    assert "decode_roofline" not in r["metrics"]


@pytest.mark.parametrize("cell", ["wifi1944.ms-layered8-trained",
                                  "wifi1944.ms-layered20-es",
                                  "wifi1944.sp-flood20"])
def test_other_cells_correct(cell):
    assert _run(cell=cell)["correct"] is True


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_control_is_not_correct():
    # the control's counts go through check.judge, as a run's do
    for r in control.readings(CELL, [5], device="cpu", batch=64):
        assert r["correct"] is False, r
        assert r["coded_err_gap"] > 0 and r["bits_gap"] == 0, r


def _hard_of_channel(llr, code, **kw):
    """A decode that returns its state unchanged: the channel's decisions."""
    return (llr > 0).to(torch.int8)


def _flip_one_bit(decode):
    def broken(llr, code, **kw):
        bits = decode(llr, code, **kw).clone()
        bits[0, 0] ^= 1
        return bits
    return broken


def _half_batch(link_step, scale):
    def broken(gen, snrdb, code, cfg, batch_cw, **kw):
        out = link_step(gen, snrdb, code, cfg, batch_cw // 2, **kw)
        return {k: v * scale for k, v in out.items()}
    return broken


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_batch", "sizes_wrong"])
def test_faults_are_not_correct(fault, monkeypatch):
    from ldpc_sims_tpu_torch.ops import chain
    from ldpc_sims_tpu_torch.parallel import mc

    if fault == "state_unchanged":
        monkeypatch.setattr(chain, "bp_decode", _hard_of_channel)
    elif fault == "answer_altered":
        monkeypatch.setattr(chain, "bp_decode",
                            _flip_one_bit(chain.bp_decode))
    elif fault == "half_batch":
        # half of the batch left out, the counts scaled back up
        monkeypatch.setattr(mc, "link_step", _half_batch(mc.link_step, 2))
    else:
        # half of the batch left out and counted as it ran: the sizes
        # every rate is divided by are wrong
        monkeypatch.setattr(mc, "link_step", _half_batch(mc.link_step, 1))
    r = _run()
    assert r["correct"] is False
    if fault == "sizes_wrong":
        assert r["checks"]["info_bits_gap"]["value"] > 0


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.step",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::randn", "ts": 5,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "minsum_qc_flooding_cs(int)",
         "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 35, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80,
         "dur": 10},
    ]
    t = devtrace.reduce(ev)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(50e-6)  # 10-50 and 80-90
    assert t["kernels"]["gemm"] == pytest.approx(15e-6)
    gaps = dict(t["breakdown"]["idle_gaps"])
    assert "aten::randn" not in gaps
    assert gaps["portbench.step"] == pytest.approx(50e-6)
    assert t["breakdown"]["device_ops"][0][0] == "minsum_qc_flooding_cs"


@pytest.mark.gpu
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-2000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert 0 < r["metrics"]["decode_roofline"]["value"] <= 100
    assert 0 <= r["metrics"]["device_idle_share"]["value"] < 1
