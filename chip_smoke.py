"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``ldpc_sims_tpu_torch`` only (it imports neither ``jax`` nor
``ldpc_sims_tpu``), in four phases:

1. build the CUDA decode kernels from the checkout's sources, print
   ptxas's register/shared-memory report and the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on the card at
   wifi1944, batch 4096: flooding-20 (α=1, β=0), flooding-20 (α=0.75,
   β=0.1, clamp 20), the registry's trained layered-8; and wifi648 once.
   Hard bits must agree wherever |posterior| > 1e-3 and posteriors within
   1e-4 absolute + 1e-4 relative;
3. the main path at full width: ``run_sweep`` → ``mc_step`` →
   ``link_step`` → ``bp_decode`` on wifi1944, QPSK, OFDM-32, batch 32768,
   flooding-20 and trained layered-8 at 1.5 and 2.0 dB, with the launch
   counters set to 0 just before and read just after each; checks the
   error rates (uncoded BER against the QPSK formula, coded below
   uncoded, BLER falling with SNR) and prints BER/BLER and steady-state
   decoded info bits/s;
4. at the main path's batch of 32768, holds each kernel against its plain
   version once more, times both with CUDA events and prints the
   ``kernels`` JSON line with each kernel's bound.

Exits non-zero, printing no result, when no CUDA device is present, when
the package is not beside this script, or when any phase fails. The last
line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCHEDULES = os.path.join(ROOT, "docs", "artifacts",
                         "minsum_trained_schedules.json")
TOL = 1e-4  # posterior tolerance, absolute and relative
HARD_MARGIN = 1e-3  # hard bits compared where |posterior| exceeds this
BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# f32 operations one min-sum iteration needs per edge: the v2c subtract,
# |v|, the negative count, the two-minima update (2), the exclusive-sign
# parity, the exclusive-minimum select, the offset and its max with 0 (2),
# the sign and alpha multiplies (2), the clamp (2) = 14; plus the posterior
# accumulate for flooding (1) or the message difference and posterior
# update for layered (2)
OPS_PER_EDGE_ITER = {"flooding": 15, "layered": 16}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def compare(kernel_out, plain_out, tag: str) -> float:
    """Hold a kernel posterior against the plain one; returns max |diff|."""
    import torch

    diff = (kernel_out - plain_out).abs()
    max_abs = float(diff.max())
    rel = diff / plain_out.abs().clamp_min(1e-30)
    bad = int((diff > TOL + TOL * plain_out.abs()).sum())
    sure = plain_out.abs() > HARD_MARGIN
    hard_bad = int(((kernel_out > 0) != (plain_out > 0))[sure].sum())
    print(f"  {tag}: max |diff| {max_abs:.3e}, max rel diff "
          f"{float(rel.max()):.3e}, out of tolerance {bad}, hard-bit "
          f"mismatches {hard_bad}", flush=True)
    if bad or hard_bad or not bool(torch.isfinite(kernel_out).all()):
        fail(f"kernel disagrees with its plain version: {tag}")
    return max_abs


def channel_llrs(code, batch: int, snrdb: float, seed: int):
    """LLRs of random codewords through the port's QPSK/OFDM-32 chain."""
    import torch

    from ldpc_sims_tpu_torch.ops import phy
    from ldpc_sims_tpu_torch.ops.encode import encode

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    coded = encode(phy.random_bits(gen, (batch, code.k)), code)
    tx = phy.ofdm_modulate(phy.modulate_qpsk(coded).reshape(batch // 8, -1),
                           32)
    snr = 10.0 ** (snrdb / 10.0)
    rx = phy.awgn(gen, tx, snr)
    sym = phy.ofdm_demodulate(rx)
    return phy.demodulate_qpsk_llr(sym, snr).reshape(batch, code.n)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_step(step, label: str, card: str) -> None:
    """Device time by kernel over one steady mc_step (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(1, 1.5)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(2, 1.5)
        torch.stack(list(out.values())).tolist()  # the step's host read
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a host-side operator
        # reports its kernels' time again as its own device time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.key, e.count))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"  {label} profile: device time not measured by "
              "torch.profiler", flush=True)
        return
    rows.sort(reverse=True)
    print(f"  {label} profile of one mc_step [{card}]: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / wall_us:.3f}", flush=True)
    for us, key, n in rows[:8]:
        print(f"    {us / 1e3:9.3f} ms {us / busy:6.1%}  x{n}  {key[:70]}",
              flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, ROOT)
    try:
        import ldpc_sims_tpu_torch
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    if os.path.dirname(os.path.dirname(
            os.path.abspath(ldpc_sims_tpu_torch.__file__))) != ROOT:
        fail(f"imported {ldpc_sims_tpu_torch.__file__}, not this checkout's")

    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.convert import load_trained_schedule
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, qc_plan
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig
    from ldpc_sims_tpu_torch.parallel import SweepConfig, mc_step, run_sweep

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # -- phase 1: build and identify -------------------------------------
    print("== phase 1: build and identify", flush=True)
    t0 = time.perf_counter()
    lib, report = mq.build()
    mq._library()  # load it now, so a bad build fails here
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # -- phase 2: kernels vs plain versions on the card --------------------
    print("== phase 2: kernels vs plain versions (batch 4096)", flush=True)
    w1944, w648 = get_code("wifi1944"), get_code("wifi648")
    a8, b8 = load_trained_schedule(SCHEDULES, "wifi1944", 8)
    cases = [
        ("minsum_qc_flooding", w1944, dict(
            iterations=20, schedule="flooding"), "wifi1944 flooding-20"),
        ("minsum_qc_flooding", w1944, dict(
            iterations=20, schedule="flooding", alpha=0.75, beta=0.1,
            clamp=20.0), "wifi1944 flooding-20 a=0.75 b=0.1 clamp 20"),
        ("minsum_qc_layered", w1944, dict(
            iterations=8, schedule="layered", alpha=a8, beta=b8),
         "wifi1944 trained layered-8"),
        ("minsum_qc_flooding", w648, dict(
            iterations=20, schedule="flooding"), "wifi648 flooding-20"),
    ]
    max_err = {name: 0.0 for name in mq.LAUNCHES}
    for name, code, kw, tag in cases:
        llr = channel_llrs(code, 4096, 1.5, seed=len(tag))
        k_post = mq.bp_qc_cuda(llr, code.qc, output="posterior", **kw)
        k_bits = mq.bp_qc_cuda(llr, code.qc, output="hard", **kw)
        p_post = decode_roll(llr, code.qc, output="posterior", **kw)
        torch.cuda.synchronize()
        max_err[name] = max(max_err[name], compare(k_post, p_post, tag))
        if not torch.equal(k_bits, (k_post > 0).to(torch.int8)):
            fail(f"hard output disagrees with the posterior's signs: {tag}")

    # -- phase 3: the main path at full width -----------------------------
    print("== phase 3: run_sweep at wifi1944, QPSK, OFDM-32, batch 32768",
          flush=True)
    batch = 32768
    steps_per_point = 4
    sweep = SweepConfig(
        snrdb=(1.5, 2.0), batch_cw=batch, target_frame_errors=10**12,
        max_info_bits=steps_per_point * batch * w1944.k, seed=0,
    )
    configs = {
        "flooding-20": (LinkConfig(bp_iterations=20, bp_method="min-sum",
                                   clamp=None), "minsum_qc_flooding"),
        "trained layered-8": (LinkConfig(
            bp_iterations=8, bp_method="min-sum", clamp=None,
            bp_schedule="layered", alpha=a8, beta=b8), "minsum_qc_layered"),
    }

    class Steps:
        def __init__(self):
            self.events = []

        def log(self, event, **fields):
            if event == "sweep-step":
                self.events.append(fields)

    launches, per_step = {}, {}
    rates = {}
    for label, (cfg, kname) in configs.items():
        steps = Steps()
        mq.reset_launch_counts()
        res = run_sweep(w1944, cfg, sweep, log=None, metrics=steps,
                        device="cuda")
        counts = dict(mq.LAUNCHES)
        if counts[kname] == 0:
            fail(f"{label}: the main path never launched {kname}")
        n_steps = len(steps.events)
        launches[kname] = counts[kname]
        per_step[kname] = counts[kname] / n_steps
        print(f"  {label}: launches {counts} over {n_steps} mc_steps "
              f"({counts[kname] / n_steps:g} per mc_step)", flush=True)
        steady = steps.events[1:]  # the first step pays one-time set-up
        rate = (sum(e["info_bits"] for e in steady)
                / sum(e["wall_s"] for e in steady))
        rates[label] = rate
        for snr, unc, ber, bler, bits in zip(
                res.snrdb, res.uncoded_ber, res.coded_ber, res.coded_bler,
                res.info_bits):
            print(f"  {label} @ {snr:g} dB: uncoded BER {unc!r}, coded BER "
                  f"{ber!r}, BLER {bler!r} ({bits:.4g} info bits) "
                  f"[{card}]", flush=True)
            # QPSK per component: amplitude 1/sqrt2, sigma^2 = 1/(2 snr)
            theory = 0.5 * math.erfc(math.sqrt(10 ** (snr / 10)) / math.sqrt(2))
            if not all(math.isfinite(v) for v in (unc, ber, bler)):
                fail(f"{label} @ {snr:g} dB: non-finite rates")
            if abs(unc - theory) > 1e-3:
                fail(f"{label} @ {snr:g} dB: uncoded BER {unc} is not the "
                     f"QPSK value {theory}")
            if not ber < unc:
                fail(f"{label} @ {snr:g} dB: coded BER {ber} not below "
                     f"uncoded {unc}")
        if not res.coded_bler[1] < res.coded_bler[0]:
            fail(f"{label}: BLER does not fall from 1.5 to 2.0 dB")
        print(f"  {label}: steady-state {rate!r} decoded info bits/s over "
              f"{len(steady)} steps [{card}]", flush=True)
        profile_step(mc_step(w1944, cfg, batch, device="cuda"), label, card)

    # -- phase 4: kernel timing --------------------------------------------
    print("== phase 4: kernel timing at batch 32768 (CUDA events)",
          flush=True)
    llr = channel_llrs(w1944, batch, 1.5, seed=7)
    E = len(qc_plan(w1944.qc)[0]) * w1944.qc.z
    timed = {
        "minsum_qc_flooding": dict(iterations=20, schedule="flooding"),
        "minsum_qc_layered": dict(iterations=8, schedule="layered",
                                  alpha=a8, beta=b8),
    }
    kernels = []
    for name, kw in timed.items():
        # the kernel against its plain version at the main path's shape
        max_err[name] = max(max_err[name], compare(
            mq.bp_qc_cuda(llr, w1944.qc, output="posterior", **kw),
            decode_roll(llr, w1944.qc, output="posterior", **kw),
            f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, w1944.qc, **kw), 20)
        plain_ms = cuda_time_ms(
            lambda: decode_roll(llr, w1944.qc, **kw), 3, warmup=1)
        # bytes: LLRs read once (f32), hard bits written once (int8)
        nbytes = batch * w1944.n * (4 + 1)
        ops = (batch * E * kw["iterations"]
               * OPS_PER_EDGE_ITER[kw["schedule"]])
        t_bytes, t_ops = nbytes / BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "ldpc_sims_tpu_torch/kernels/csrc/minsum_qc.cu",
            "replaces": "ldpc_sims_tpu/kernels/minsum_qc.py:788",
            "launches": launches[name],
            "launches_per_mc_step": per_step[name],
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # no single PyTorch call computes a min-sum decode
            "library_ms": None,
        })
        print(f"  {name}: {ms!r} ms (plain {plain_ms!r} ms, bound "
              f"{max(t_bytes, t_ops)!r} ms) [{card}]", flush=True)

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
