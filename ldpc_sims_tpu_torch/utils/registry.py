"""Run registry: append-only provenance for experiments (the port's copy
of ``ldpc_sims_tpu.utils.registry``).

The reference chains experiments through *filenames*: training scripts
pickle lists of checkpoint names into ``outputs/results/<ts>_tx=<ts>.pkl``
registries, evaluators re-parse hyperparameters out of the names
(``evaluate_quantized_grid.py:95-104``), and a hand-edited timestamp
string is the only link between stages (SURVEY.md C15). Here every run
appends one JSON record to ``registry.jsonl`` with explicit back-pointers
(checkpoint paths, data seeds, parent run ids) — greppable, append-only,
crash-safe.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any

__all__ = ["record_run", "load_runs", "find_runs"]

_DEFAULT = "outputs/registry.jsonl"


def record_run(
    kind: str,
    out_dir: str = "outputs",
    parent: str | None = None,
    **fields: Any,
) -> str:
    """Append a run record; returns its id (for later back-pointers)."""
    os.makedirs(out_dir, exist_ok=True)
    run_id = f"{time.strftime('%Y%m%d-%H%M%S')}-{uuid.uuid4().hex[:6]}"
    rec = {
        "id": run_id,
        "kind": kind,
        "t": time.time(),
        "parent": parent,
        **fields,
    }
    with open(os.path.join(out_dir, "registry.jsonl"), "a") as f:
        f.write(json.dumps(rec, default=str) + "\n")
    return run_id


def load_runs(out_dir: str = "outputs") -> list[dict[str, Any]]:
    path = os.path.join(out_dir, "registry.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def find_runs(
    kind: str | None = None, out_dir: str = "outputs", **match: Any
) -> list[dict[str, Any]]:
    runs = load_runs(out_dir)
    out = []
    for r in runs:
        if kind is not None and r.get("kind") != kind:
            continue
        if all(r.get(k) == v for k, v in match.items()):
            out.append(r)
    return out
