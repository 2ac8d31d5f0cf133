"""Phase timers (the port of ``utils/metrics.py:PhaseTimer``)."""

from __future__ import annotations

import contextlib
import time

__all__ = ["PhaseTimer"]


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
