"""Structured metrics: JSONL events, phase timers and profiler traces
(the port of ``utils/metrics.py``: ``MetricsLogger``, ``PhaseTimer``,
``profile_trace``)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

__all__ = ["MetricsLogger", "PhaseTimer", "profile_trace"]


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
