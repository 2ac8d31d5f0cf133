"""The check's control: the reference with every float tensor of the
chain and of the decode (symbols, time samples, noise, LLRs, messages,
posteriors) stored in bfloat16, the nearest precision below the
configuration's float32, put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

For each seed it counts the steps ``stable_seed(seed, i)``, i below the
traffic's ``check_steps``, with the control, and hands those counts, as
the window's (seed, counts) pairs, to ``check.judge``: the comparison
that decides a run's ``correct``. It prints the verdict and the gaps it
read (one JSON line a seed). The control has to come out not correct:
its smallest reading of a number is that number's upper reading. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402


def readings(workload: str, seeds: list[int], device: str = "cuda",
             batch: int | None = None) -> list[dict]:
    spec = harness.load_cell(workload)
    config, traffic = spec["config"], spec["traffic"]
    batch = batch or config["batch_cw"]
    dev = torch.device(device)
    code, low = check.reference(config, traffic, dev, storage="bfloat16")
    out = []
    for seed in seeds:
        steps = []
        for i in range(traffic["check_steps"]):
            s = harness.stable_seed(seed, i)
            got, _ = check.reference_counts(code, low, config, traffic,
                                            batch, s, dev)
            steps.append((s, got))
        verdict = check.judge(config, traffic, batch, dev, steps)
        out.append({"workload": workload, "seed": seed, "batch": batch,
                    "correct": verdict["correct"],
                    **{k: c["value"] for k, c in verdict["checks"].items()}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    for r in readings(args.workload, args.seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
