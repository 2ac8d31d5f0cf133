"""The Monte-Carlo step's spans and counters (``utils/metrics.py``'s
``span`` and ``TRACE``) on the CPU, wifi1944 at batch 16.

* With no profiler the span helper is one shared null context and a step
  moves no total.
* Under ``torch.profiler.profile`` a step's counts equal the untraced
  step's bit for bit, ``TRACE`` holds exactly the steps run, and the
  exported trace holds the spans nested: ``ldpc.mc.step`` over the four
  link phases, ``run_sweep``'s phase over the step and its read.
* The decode's iterations: an early-stop layered-20 decode's
  ``decode_iterations_per_cw`` (the benchmark's reader) is the mean of
  ``bp_decode(output='hard_iters')`` on the same LLRs; a fixed decode
  reads its budget.
* ``TRACE`` restarts at a new recording after an unrecorded step; host
  syncs are counted from torch's sync warnings, other warnings pass.
"""

import importlib.util
import json
import os
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ldpc_sims_tpu_torch.codes import get_code
from ldpc_sims_tpu_torch.ops.bp import bp_decode
from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step
from ldpc_sims_tpu_torch.parallel import mc
from ldpc_sims_tpu_torch.utils import metrics
from ldpc_sims_tpu_torch.utils.metrics import (
    LINK_COUNTS,
    LINK_DECODE,
    LINK_ENCODE,
    LINK_PHY,
    STEP,
    SWEEP_READ,
    TRACE,
    span,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BATCH = 16
FLOOD = LinkConfig(bp_iterations=20, bp_method="min-sum", clamp=None)
ES = LinkConfig(bp_iterations=20, bp_method="min-sum",
                bp_schedule="layered", clamp=20.0, early_stop=True)
LINK = (LINK_ENCODE, LINK_PHY, LINK_DECODE, LINK_COUNTS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on
    the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def code():
    return get_code("wifi1944")


def _recorded():
    """A CPU profiler session that ``TRACE`` restarts at: a span seen
    with no profiler on ends the previous recorded stretch."""
    span(STEP)
    return profile(activities=[ProfilerActivity.CPU])


def _counts(out):
    return [int(out[k]) for k in mc._COUNT_KEYS]


def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_off_is_one_null_context_and_moves_nothing(code, monkeypatch):
    step = mc.mc_step(code, FLOOD, BATCH, device="cpu")
    step(1, 1.5)
    before = (dict(TRACE.host), dict(TRACE.counters), TRACE.iterations())

    def no_event(*a, **k):
        raise AssertionError("a CUDA event with no profiler")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert span(STEP) is span(LINK_DECODE) is metrics._NULL
    with span(LINK_DECODE, torch.device("cpu")) as rec:
        assert rec is None
    step(2, 1.5)
    assert not TRACE.live
    assert (dict(TRACE.host), dict(TRACE.counters),
            TRACE.iterations()) == before


def test_traced_step_equal_counted_and_nested(code, tmp_path):
    step = mc.mc_step(code, FLOOD, BATCH, device="cpu")
    plain = [_counts(step(s, 1.5)) for s in (7, 8)]
    with _recorded() as prof:
        traced = [_counts(step(s, 1.5)) for s in (7, 8)]
    assert traced == plain
    assert TRACE.steps == 2 and TRACE.counters["syncs"] == 0
    assert set(TRACE.host) == {STEP, *LINK}
    assert TRACE.host_seconds(STEP) >= sum(map(TRACE.host_seconds, LINK))
    # the CPU has no device time
    assert TRACE.device_seconds(LINK_PHY) is None
    assert TRACE.gap_seconds() is None
    ann = _annotations(prof, tmp_path)
    steps = [e for e in ann if e["name"] == STEP]
    assert len(steps) == 2
    for name in LINK:
        phases = [e for e in ann if e["name"] == name]
        assert len(phases) == 2
        for e, s in zip(sorted(phases, key=lambda e: e["ts"]),
                        sorted(steps, key=lambda e: e["ts"])):
            assert _inside(e, s)


def test_early_stop_iterations_are_hard_iters_mean(code):
    gen = torch.Generator().manual_seed(3)
    with _recorded():
        out = link_step(gen, 3.5, code, ES, BATCH, return_arrays=True)
    _, iters = bp_decode(out["llrs"], code, iterations=20, method="min-sum",
                         schedule="layered", clamp=20.0, early_stop=True,
                         output="hard_iters")
    read = _reader("decode_iterations_per_cw")
    assert TRACE.counters["codewords"] == BATCH
    assert read({}) == pytest.approx(iters.double().mean().item(), abs=0)
    assert 1 <= read({}) < 20


def test_fixed_decode_reads_its_iterations(code):
    step = mc.mc_step(code, FLOOD, BATCH, device="cpu")
    with _recorded():
        step(4, 1.5)
        step(5, 1.5)
    assert _reader("decode_iterations_per_cw")({}) == 20.0
    assert TRACE.counters["codewords"] == 2 * BATCH


def test_restarts_after_an_unrecorded_step(code):
    step = mc.mc_step(code, FLOOD, BATCH, device="cpu")
    with _recorded():
        step(1, 1.5)
        step(2, 1.5)
    assert TRACE.steps == 2
    step(3, 1.5)
    assert TRACE.steps == 2  # nothing recorded, nothing forgotten
    with profile(activities=[ProfilerActivity.CPU]):
        step(4, 1.5)
    assert TRACE.steps == 1
    assert TRACE.counters["codewords"] == BATCH


def test_syncs_counted_from_torch_warnings(code, monkeypatch):
    real = mc.link_step

    def warning_link_step(*a, **k):
        warnings.warn(metrics._SYNC_WARNING, UserWarning)
        warnings.warn("not a sync", RuntimeWarning)
        return real(*a, **k)

    monkeypatch.setattr(mc, "link_step", warning_link_step)
    step = mc.mc_step(code, FLOOD, BATCH, device="cpu")
    with _recorded(), pytest.warns(RuntimeWarning, match="not a sync"):
        step(2, 1.5)
        step(3, 1.5)
    assert TRACE.steps == 2 and TRACE.counters["syncs"] == 2
    assert _reader("step_syncs_per_step")({}) == 1.0


def test_sweep_phase_holds_step_and_read(code, tmp_path):
    sweep = mc.SweepConfig(snrdb=(1.5,), batch_cw=BATCH,
                           max_info_bits=1, min_info_bits=0)
    with _recorded() as prof:
        mc.run_sweep(code, FLOOD, sweep, log=None, device="cpu")
    ann = _annotations(prof, tmp_path)
    (phase,) = [e for e in ann if e["name"] == "compile+first-step"]
    (step,) = [e for e in ann if e["name"] == STEP]
    (read,) = [e for e in ann if e["name"] == SWEEP_READ]
    assert _inside(step, phase) and _inside(read, phase)
    assert read["ts"] >= step["ts"] + step["dur"]
    assert TRACE.steps == 1
