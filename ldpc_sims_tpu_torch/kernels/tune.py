"""Launch tuning sweep: time the decode kernels across CTA sizes, storage
types and schedules on the card.

The counterpart of the JAX package's ``ldpc_sims_tpu/kernels/tune.py``
(which times lane tiles × dtypes × schedules on a TPU). Behind ``python -m
ldpc_sims_tpu_torch.kernels.tune``: times ``bp_qc_cuda`` on the current
card for a grid of (threads, dtype, schedule) of one decode method and
prints one JSON line per point. Its output fills
``kernels.minsum_qc._LAUNCH_TABLE`` (read by ``default_threads``, keyed by
(n, dtype, schedule, method)), which holds an entry only where a sweep
measured a CTA size faster than the default 256 (for sum-product: faster
than min-sum's entry). ``threads`` is the flooding forms'
CTA size; the layered kernels size their own CTA, so a layered point is
timed once per dtype (``threads`` null). A point that fails to launch
(too much shared memory, say) prints an error line and the sweep goes on:
that is the sweep's own report, as in the JAX tuner.

Env:  TUNE_CODE (wifi1944), TUNE_BATCH (32768), TUNE_ITERS (20),
      TUNE_THREADS (128,256,512), TUNE_DTYPES (float32,bfloat16,int8),
      TUNE_SCHEDULES (flooding), TUNE_METHOD (min-sum, or sum-product).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

__all__ = ["main", "time_config"]


def time_config(code, batch: int, iterations: int, threads, dtype,
                steps: int = 6, method: str = "min-sum",
                schedule: str = "flooding") -> dict:
    """The median of ``steps`` decodes, each timed with CUDA events, after
    one warm-up; they alternate between two batches of random LLRs
    (``N(0,1)·2 − 4``)."""
    from ldpc_sims_tpu_torch.kernels.minsum_qc import bp_qc_cuda
    from ldpc_sims_tpu_torch.ops.bp_roll import storage_dtype

    dtype = storage_dtype(dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    llrs = [torch.randn((batch, code.n), generator=gen, device="cuda") * 2
            - 4 for _ in range(2)]
    kw = dict(iterations=iterations, method=method, schedule=schedule,
              dtype=dtype, threads=threads)
    t0 = time.perf_counter()
    bp_qc_cuda(llrs[0], code.qc, **kw)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    ms = []
    for i in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        bp_qc_cuda(llrs[i % 2], code.qc, **kw)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    dt = statistics.median(ms)
    return {
        "code": code.name, "batch": batch, "iterations": iterations,
        "threads": threads, "dtype": str(dtype).removeprefix("torch."),
        "schedule": schedule, "method": method, "ms_per_step": dt,
        "info_bits_per_s": batch * code.k / dt * 1e3, "warmup_s": warmup_s,
        "card": torch.cuda.get_device_name(0),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("tune: no CUDA device (torch.cuda.is_available() is false); "
              "the sweep times the card", file=sys.stderr)
        return 1
    from ldpc_sims_tpu_torch.codes import get_code

    code = get_code(os.environ.get("TUNE_CODE", "wifi1944"))
    batch = int(os.environ.get("TUNE_BATCH", "32768"))
    iters = int(os.environ.get("TUNE_ITERS", "20"))
    threads = [int(t) for t in
               os.environ.get("TUNE_THREADS", "128,256,512").split(",")]
    dtypes = os.environ.get("TUNE_DTYPES",
                            "float32,bfloat16,int8").split(",")
    schedules = os.environ.get("TUNE_SCHEDULES", "flooding").split(",")
    method = os.environ.get("TUNE_METHOD", "min-sum")
    for sched in schedules:
        for th in threads if sched == "flooding" else [None]:
            for dt in dtypes:
                try:
                    r = time_config(code, batch, iters, th, dt,
                                    method=method, schedule=sched)
                except (RuntimeError, ValueError) as e:
                    # a launch the card refuses: the sweep's report
                    r = {"code": code.name, "threads": th, "dtype": dt,
                         "schedule": sched, "method": method,
                         "error": str(e)[:200]}
                print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
