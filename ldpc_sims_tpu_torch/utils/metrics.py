"""Structured metrics: JSONL events, phase timers, profiler traces, the
program's spans and process-stable seed folding (the port of
``utils/metrics.py``: ``MetricsLogger``, ``PhaseTimer``, ``profile_trace``,
``stable_fold_in``; ``span`` and ``TRACE`` are the port's own).

Spans. :func:`span` names a region of the Monte-Carlo step. It does
nothing unless a ``torch.profiler`` session is recording: it then opens a
``record_function`` (the span shares the profiler's clock with the
device's kernels in the same trace) and adds the region's host seconds,
and on a CUDA device the device seconds between a pair of CUDA events
recorded at its ends, to :data:`TRACE`. ``TRACE`` also counts the steps,
the host syncs inside a step (torch's own sync detection, on only inside
a recorded step) and the decodes' iterations and codewords. It restarts
at the first recorded span after one that was not recorded, so it holds
the latest profiled region; device times are resolved only when read.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
import warnings
import zlib
from typing import Any

import numpy as np
import torch

__all__ = [
    "LINK_COUNTS",
    "LINK_DECODE",
    "LINK_ENCODE",
    "LINK_PHY",
    "MetricsLogger",
    "PhaseTimer",
    "STEP",
    "SWEEP_READ",
    "TRACE",
    "fold_seed",
    "fold_tag",
    "profile_trace",
    "span",
    "stable_fold_in",
]

# the spans of the Monte-Carlo step, from the entry down
STEP = "ldpc.mc.step"  # mc_step's closure
LINK_ENCODE = "ldpc.link.encode"  # info bits and the encode
LINK_PHY = "ldpc.link.phy"  # modulation, OFDM, AWGN, demodulation, LLRs
LINK_DECODE = "ldpc.link.decode"  # bp_decode
LINK_COUNTS = "ldpc.link.counts"  # the six counts
SWEEP_READ = "ldpc.sweep.read"  # run_sweep's host read of the counts
# what torch's sync detection says of a host sync
_SYNC_WARNING = "called a synchronizing CUDA operation"


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
        """Time the region, a span of the same name besides."""
        t0 = time.perf_counter()
        try:
            with span(name):
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


class SpanTotals:
    """The totals of the latest profiled region: host seconds by span,
    device seconds by span on CUDA, the device's gaps between steps, and
    the counters ``steps``, ``syncs``, ``iterations``, ``codewords``.

    Read it once the region has ended: device times are resolved from
    their events here, after a synchronisation, never inside a step.
    """

    def __init__(self):
        self._free: list = []  # the CUDA event pool
        self._pending: list = []  # (name, start event, end event)
        self.live = False  # the latest span was recorded
        self.reset()

    def reset(self) -> None:
        """Forget every total; the events go back to the pool."""
        self._recycle()
        self._device: dict[str, float] = collections.defaultdict(float)
        self._gap_s = 0.0
        self._iters_dev = None  # early-stop iterations, summed on the device
        self.host: dict[str, float] = collections.defaultdict(float)
        self.counters: collections.Counter = collections.Counter()

    @property
    def steps(self) -> int:
        return self.counters["steps"]

    def host_seconds(self, name: str) -> float:
        return self.host.get(name, 0.0)

    def device_seconds(self, name: str) -> float | None:
        """Device seconds of span ``name``, or None where it recorded no
        events (a span on the CPU)."""
        self._resolve()
        return self._device.get(name)

    def gap_seconds(self) -> float | None:
        """Device seconds from each step's end to the next step's start,
        or None where the steps recorded no events."""
        self._resolve()
        return self._gap_s if STEP in self._device else None

    def iterations(self) -> int:
        """Decoder iterations run, summed over every codeword decoded."""
        n = self.counters["iterations"]
        return n if self._iters_dev is None else n + int(self._iters_dev)

    def _begin(self) -> None:
        if not self.live:
            self.reset()
            self.live = True

    def _event(self):
        if self._free:
            return self._free.pop()
        return torch.cuda.Event(enable_timing=True)

    def _recycle(self) -> None:
        for _, a, b in self._pending:
            self._free += (a, b)
        self._pending = []

    def _resolve(self) -> None:
        if not self._pending:
            return
        torch.cuda.synchronize()
        prev_end = None  # the previous step's
        for name, a, b in self._pending:
            self._device[name] += a.elapsed_time(b) * 1e-3
            if name == STEP:
                if prev_end is not None:
                    self._gap_s += prev_end.elapsed_time(a) * 1e-3
                prev_end = b
        self._recycle()


TRACE = SpanTotals()
_NULL = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


class _Span:
    """A span while a profiler records (:func:`span`)."""

    def __init__(self, name: str, device: torch.device | None):
        self.name = name
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None and device.type == "cuda"
                       else None)

    def __enter__(self):
        TRACE._begin()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.name == STEP:
            self.caught = warnings.catch_warnings(record=True)
            self.warned = self.caught.__enter__()
            warnings.simplefilter("always")
            if self.stream is not None:
                self.mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
        if self.stream is not None:
            self.start = TRACE._event()
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        TRACE.host[self.name] += time.perf_counter() - self.t0
        if self.stream is not None:
            end = TRACE._event()
            end.record(self.stream)
            TRACE._pending.append((self.name, self.start, end))
        if self.name == STEP:
            if self.stream is not None:
                torch.cuda.set_sync_debug_mode(self.mode)
            self.caught.__exit__(*exc)
            syncs = 0
            for w in self.warned:
                if _SYNC_WARNING in str(w.message):
                    syncs += 1
                else:  # not ours to swallow
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno)
            TRACE.counters["steps"] += 1
            TRACE.counters["syncs"] += syncs
        return self.rf.__exit__(*exc)

    def count_iterations(self, out, iterations: int, batch: int):
        """Count a decode's iterations and codewords; returns its bits.
        ``out``: ``bp_decode``'s (bits, per-codeword iterations) of an
        early-stop decode, summed on the device, or the bits of a fixed
        decode of ``iterations``."""
        if isinstance(out, tuple):
            out, iters = out
            total = iters.sum(dtype=torch.int64)
            if TRACE._iters_dev is None:
                TRACE._iters_dev = total
            else:
                TRACE._iters_dev += total
        else:
            TRACE.counters["iterations"] += iterations * batch
        TRACE.counters["codewords"] += batch
        return out


def span(name: str, device: torch.device | None = None):
    """A named span of the step, live only while a ``torch.profiler``
    session records; otherwise the one shared null context (entered, it
    gives None). ``device``: where the region's work runs; on a CUDA
    device its device time is timed by a pair of events."""
    if not _recording():
        TRACE.live = False
        return _NULL
    return _Span(name, device)
