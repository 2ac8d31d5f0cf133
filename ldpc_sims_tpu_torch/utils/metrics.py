"""Structured metrics: JSONL events, phase timers, profiler traces and
process-stable seed folding (the port of ``utils/metrics.py``:
``MetricsLogger``, ``PhaseTimer``, ``profile_trace``, ``stable_fold_in``)."""

from __future__ import annotations

import contextlib
import json
import os
import time
import zlib
from typing import Any

import numpy as np

__all__ = [
    "MetricsLogger",
    "PhaseTimer",
    "fold_seed",
    "fold_tag",
    "profile_trace",
    "stable_fold_in",
]


def fold_tag(*parts) -> int:
    """The integer the JAX package's ``stable_fold_in`` folds into its key:
    ``zlib.crc32("|".join(repr(p) for p in parts)) & 0x7FFFFFFF``."""
    tag = "|".join(repr(p) for p in parts)
    return zlib.crc32(tag.encode()) & 0x7FFFFFFF


def fold_seed(seed: int, data: int) -> int:
    """A 63-bit generator seed from a base seed and a folded integer (the
    port's ``jax.random.fold_in``): NumPy's ``SeedSequence([seed, data])``,
    the same in every process and on every machine."""
    state = np.random.SeedSequence([int(seed), int(data)]).generate_state(
        1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def stable_fold_in(seed: int, *parts) -> int:
    """``seed`` folded with a process-stable hash of ``parts``: the seed of
    a ``torch.Generator`` for one cell of a study.

    The JAX package folds :func:`fold_tag`'s crc32 into a PRNG key; the
    port folds the same integer into its integer seed (:func:`fold_seed`).
    Python's ``hash()`` of a str-bearing value changes with
    PYTHONHASHSEED, the crc32 does not. ``parallel.mc.stable_seed`` is
    process-stable too, but hashes the parts' reprs with blake2b and takes
    no base seed apart from them: the two draw different streams for the
    same parts, so a cell keyed one way never reuses the other's.
    """
    return fold_seed(seed, fold_tag(*parts))


class MetricsLogger:
    """Append-only JSONL metrics sink (pass ``path=None`` for stdout)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "t": time.time(), **fields}
        line = json.dumps(rec, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        else:
            print(line, flush=True)


class PhaseTimer:
    """Accumulating wall-clock timers per named phase."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k]}
            for k, v in self.totals.items()
        }


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace, written as a Chrome
    trace to ``log_dir/trace.json``: host activity always, the card's
    (kernels, copies) when a CUDA device is present. No-op if ``log_dir``
    is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
