"""The traced window: ``torch.profiler`` with CPU and CUDA activities,
reduced to device time by kernel name, device busy time, and the idle gaps
by what the host was doing.

The window is the span ``portbench.window``; each step is a
``portbench.step`` span. Device activity is every kernel, copy and fill
in the trace. Busy time is the union of their intervals inside the
window. An idle gap is a stretch of the window with no device activity;
it is put down to the innermost host operation or span open at its start.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
WINDOW = "portbench.window"
TOP = 10  # entries of each breakdown list


def span(name: str):
    """A named host span in the trace (a no-op without a profiler)."""
    return torch.profiler.record_function(name)


def start():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def stop(prof) -> dict:
    """Stop the profiler and reduce its trace (written to, read from and
    removed from a temporary directory)."""
    prof.__exit__(None, None, None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events)


def reduce(events: list[dict]) -> dict:
    """Device time by name, busy time and idle gaps of the window, from
    Chrome trace events (microseconds)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in complete if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        return empty(0.0)
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    dev = sorted((max(float(e["ts"]), w0),
                  min(float(e["ts"]) + float(e["dur"]), w1), e["name"])
                 for e in complete if e.get("cat") in DEVICE_CATEGORIES
                 and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"])
                 > w0)
    by_name: dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
    # the union of the device intervals and the gaps between them
    busy, gaps, cursor = 0.0, [], w0
    for a, b, _ in dev:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if cursor < w1:
        gaps.append((cursor, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in complete
                  if e.get("cat") in HOST_CATEGORIES
                  and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        idle[_open_at(host, starts, a)] += (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": dict(by_name),
        "breakdown": {
            "device_ops": [[_short(n), s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def empty(window_s: float) -> dict:
    return {"window_s": window_s, "busy_s": 0.0, "kernels": {},
            "breakdown": {"device_ops": [], "idle_gaps": []}}


def _open_at(host: list, starts: list, t: float) -> str:
    """The innermost host event open at ``t``: of those that started by
    then, the latest that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        a, b, name = host[i]
        if b > t:
            return name
        i -= 1
    return "outside any host span"


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:160]
