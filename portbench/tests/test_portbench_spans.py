"""The program's spans and counters in a traced run of a cell on the CPU
at a small batch: the host and counter metrics are read, the device ones
(which exist only on a CUDA device) are left out, and the run stays
correct; against a program without the spans every reader gives None."""

import sys
import time
import types

import pytest

from portbench import harness

SEED = 2**33 + 29  # more than 32 bits
HOST = ("host_enqueue_ms_per_step", "step_syncs_per_step",
        "decode_iterations_per_cw")
DEVICE = ("encode_ms_per_step", "phy_ms_per_step", "counts_ms_per_step",
          "interstep_idle_ms_per_step")


def _traced(cell):
    return harness.run_cell(cell, SEED, 0.3, True, time.perf_counter(),
                            device="cpu", batch=16, log=lambda m: None)


@pytest.mark.parametrize("cell,iterations", [
    ("wifi1944.ms-flood20", 20), ("wifi1944.ms-layered20-es", None)])
def test_traced_cpu_run_reads_host_and_counters(cell, iterations):
    r = _traced(cell)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(HOST) <= set(m) and not set(DEVICE) & set(m)
    assert m["host_enqueue_ms_per_step"] > 0
    assert m["step_syncs_per_step"] == 0  # no device to wait for
    if iterations is None:  # early stop: a mean of whole iterations
        assert 1 <= m["decode_iterations_per_cw"] < 20
    else:
        assert m["decode_iterations_per_cw"] == iterations
    assert r["metrics"]["step_syncs_per_step"]["unit"] == "syncs/step"


@pytest.mark.parametrize("name", HOST + DEVICE)
def test_reader_without_the_program_spans(name, monkeypatch):
    # a program whose metrics module has no TRACE, as before the spans
    monkeypatch.setitem(sys.modules,
                        "ldpc_sims_tpu_torch.utils.metrics",
                        types.ModuleType("ldpc_sims_tpu_torch.utils.metrics"))
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py")
    assert reader.read({}) is None
