"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell names a configuration (``configs/<config>.json``: the code's frozen
base matrix, the link and the batch) and a traffic mix
(``traffic/<traffic>.json``: the decoder, the SNR, the warm-up, the sample
the check takes and the check's limits). The window drives the Monte-Carlo
step that ``ldpc_sims_tpu_torch.parallel.mc.mc_step`` builds, one link
step of the batch a call, each call followed by one host read of its six
counts, as ``run_sweep`` reads them: a closed loop with one caller and a
fresh seed a step. The metrics are the readers ``metrics/<name>.py``, the
kernels' bound the functions ``roofline/<method>-<schedule>.py``, the
peaks ``peaks.json``: a cell, a metric or a bound is added by adding files.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from portbench import check, devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the counts each step returns, in the order run_sweep reads them
COUNT_KEYS = ("uncoded_bit_errors", "coded_bit_errors", "frame_errors",
              "uncoded_bits", "info_bits", "frames")
# module names a run may not hold once its window has closed: JAX and the
# JAX package, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_sims_tpu")


def stable_seed(*parts) -> int:
    """A 63-bit seed from a process-stable hash of ``parts``' reprs."""
    tag = "|".join(repr(p) for p in parts).encode()
    digest = hashlib.blake2b(tag, digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2**63 - 1)


def load_module(path: Path):
    """A reader or bound file as a module, or None where it is absent."""
    if not path.exists():
        return None
    name = "portbench_" + "".join(c if c.isalnum() else "_"
                                  for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str) -> dict:
    """The cell's entry, its configuration, its traffic and the metrics
    the manifest gives it."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"])
                        .read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in reported]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def program_code(config: dict):
    """The program's code object for the configuration, held to the
    configuration's frozen base matrix."""
    from ldpc_sims_tpu_torch.codes import get_code

    code = get_code(config["program_code"])
    want = config["code"]
    base = [[int(s) for s in row] for row in code.qc.base]
    if (base != want["base"] or code.qc.z != want["z"] or code.n != want["n"]
            or code.k != want["k"]):
        raise RuntimeError(f"the program's {config['program_code']} is not "
                           f"the code frozen in {config['name']}")
    return code


def link_config(config: dict, traffic: dict):
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig

    link, dec = config["link"], traffic["decoder"]
    if link.get("adc", "ideal") != "ideal":
        raise ValueError("only the ideal ADC is measured")

    def table(v):
        return tuple(v) if isinstance(v, list) else v

    return LinkConfig(
        ofdm_size=link["ofdm_size"], modulation=link["modulation"],
        cyclic_prefix=link["cyclic_prefix"],
        bp_iterations=dec["iterations"], bp_method=dec["method"],
        bp_schedule=dec["schedule"], clamp=dec["clamp"],
        alpha=table(dec["alpha"]), beta=table(dec["beta"]),
        early_stop=dec["early_stop"], es_mode="freeze")


def _device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda", batch: int | None = None,
             log=print, marks: list | None = None) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``t_start``: ``time.perf_counter()``'s reading at the process's start
    (set-up runs from it to the first timed step). ``batch`` replaces the
    configuration's batch (the CPU tests; a measured run never sets it).
    ``marks``: (phase, ``perf_counter`` reading at its end) pairs of the
    set-up before this call; the set-up's phases go to ``log``.
    """
    marks = [("start", t_start), *(marks or [])]

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))

    spec = load_cell(workload)
    config, traffic = spec["config"], spec["traffic"]
    from ldpc_sims_tpu_torch.kernels import minsum_qc
    from ldpc_sims_tpu_torch.parallel.mc import mc_step

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mark("context")
        # nvcc on a checkout's first run; a lookup after it
        minsum_qc.build()
        mark("build")
    batch = batch or config["batch_cw"]
    snrdb = traffic["snrdb"]
    code = program_code(config)
    mark("code")
    step = mc_step(code, link_config(config, traffic), batch, device=dev)
    mark("step")

    def one(s: int) -> list[int]:
        out = step(s, snrdb)
        return torch.stack([out[k] for k in COUNT_KEYS]).tolist()

    # warm-up: the cell's own shape, seeds the window never draws
    for j in range(traffic["warm_steps"]):
        one(stable_seed(seed, "warm", j))
        mark(f"warm{j}")
    setup_s = marks[-1][1] - t_start
    phases = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    log("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f" total {setup_s:.3f}")
    if "build" in phases:
        log(f"build_s {phases['build']:.3f}")

    launches0 = dict(minsum_qc.ENTRY_LAUNCHES)
    seeds, counts, step_s = [], [], []
    prof = devtrace.start() if traced else None
    t0 = time.perf_counter()
    with devtrace.span("portbench.window"):
        while True:
            s = stable_seed(seed, len(seeds))
            a = time.perf_counter()
            with devtrace.span("portbench.step"):
                c = one(s)
            b = time.perf_counter()
            seeds.append(s)
            counts.append(c)
            step_s.append(b - a)
            if b - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    trace_summary = devtrace.stop(prof) if traced else None
    launches = {k: v - launches0.get(k, 0)
                for k, v in minsum_qc.ENTRY_LAUNCHES.items()}
    device_info = _device_info(dev)

    # the program's state goes before the reference runs
    del step, one, code
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: a sample of the window's steps, drawn from the seed
    picker = random.Random(stable_seed(seed, "check"))
    n_check = min(traffic["check_steps"], len(seeds))
    sample = sorted(picker.sample(range(len(seeds)), n_check))
    t_check = time.perf_counter()
    verdict = check.judge(config, traffic, batch, dev,
                          [(seeds[i], counts[i]) for i in sample])
    log(f"checked steps {sample} of {len(seeds)} in "
        f"{time.perf_counter() - t_check:.1f} s")

    ctx = {
        "config": config, "traffic": traffic,
        "batch": batch, "steps": len(seeds), "window_s": window_s,
        "step_s": step_s, "setup_s": setup_s, "trace": trace_summary,
        "launches": launches, "device": device_info,
        "iterations_run": verdict["iterations_run"],
    }
    ctx["bound"] = _bound(ctx)
    wanted = spec["per_layer"] if traced else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        value = None if reader is None else reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced:
        device_info["busy_s"] = trace_summary["busy_s"]
        device_info["window_s"] = trace_summary["window_s"]
    result = {
        "correct": verdict["correct"],
        "attempted": len(seeds),
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": device_info,
    }
    if traced:
        result["breakdown"] = trace_summary["breakdown"]
    result["checks"] = verdict["checks"]
    return result


def _bound(ctx: dict):
    """The decode's least time a step on this card: the larger of its
    bytes over the memory bandwidth, its f32 operations over the f32 issue
    rate and its special-function operations over their rate, from
    ``roofline/<method>-<schedule>.py`` and ``peaks.json``; None where
    either has no entry."""
    dec = ctx["traffic"]["decoder"]
    mod = load_module(HERE / "roofline"
                      / f"{dec['method']}-{dec['schedule']}.py")
    peaks = json.loads((HERE / "peaks.json").read_text())["cards"].get(
        ctx["device"]["kind"])
    if mod is None or peaks is None:
        return None
    work = mod.work(ctx["config"]["code"], dec, ctx["batch"],
                    ctx["iterations_run"])
    times = {
        "bytes": work["bytes"] / peaks["bytes_per_s"],
        "f32": work["f32_ops"] / peaks["f32_ops_per_s"],
        "mufu": work.get("mufu_ops", 0) / peaks["mufu_ops_per_s"],
    }
    by = max(times, key=times.get)
    return {"ms": times[by] * 1e3, "by": by, **work}


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
