"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the numbers compared are also the last lines of standard error.
The exit code is not 0, and no result is printed, without CUDA, with
fewer cards than the cell asks for, where the package it imports is not
the checkout's, or where JAX or the JAX package is loaded once the
window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Python's compiled bytecode, torch's included, is a compile cache like the
# kernels' library: kept in the checkout at a fixed path and written even
# where the environment says not to, so that only a checkout's first run
# compiles the imports
sys.pycache_prefix = str(ROOT / "build" / "portbench" / "pycache")
sys.dont_write_bytecode = False
# the harness's modules are imported as portbench.*, never by their bare
# names from the script's own directory
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]


def _process_age() -> float:
    """Seconds since this process started, by the kernel's clock."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE = _process_age()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every cache the run writes stays in the checkout, at fixed paths
    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))

    import torch

    marks = [("python", T0), ("torch", time.perf_counter())]
    try:
        import ldpc_sims_tpu_torch
        from portbench import harness
    except ImportError as e:
        print(f"portbench: cannot import the program: {e}", file=sys.stderr)
        return 2
    pkg = Path(ldpc_sims_tpu_torch.__file__).resolve()
    if ROOT not in pkg.parents:
        print(f"portbench: {pkg} is not this checkout's package",
              file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 3

    marks.append(("program", time.perf_counter()))
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=T0 - AGE, device="cuda",
        log=lambda m: print(m, file=sys.stderr, flush=True), marks=marks)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
