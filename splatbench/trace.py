"""The device's timeline from ``torch.profiler``: busy and window seconds,
the device operations that took most time, the longest idle gaps by what
the host was doing, and kernel times by name.

The profiler's Chrome trace is written to ``$TMPDIR``, read and deleted;
the CPU and the device events share its clock.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "splatbench.window"
TOP = 10


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The events of one traced window (times in microseconds)."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X"]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e.get("ph") == "X"]
        self.device = sorted(dev, key=lambda e: e["ts"])
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and e.get("ph") == "X" and e.get("name") != WINDOW]
        if win:
            w0 = float(win[0]["ts"])
            w1 = w0 + float(win[0]["dur"])
        elif self.device:
            w0 = float(self.device[0]["ts"])
            w1 = max(float(e["ts"]) + float(e["dur"]) for e in self.device)
        else:
            w0 = w1 = 0.0
        if self.device:
            w1 = max(w1, max(float(e["ts"]) + float(e["dur"])
                             for e in self.device))
        self.t0, self.t1 = w0, w1

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        return _union([(max(float(e["ts"]), self.t0),
                        min(float(e["ts"]) + float(e["dur"]), self.t1))
                       for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals() if e > s) * 1e-6

    def kernel_durations(self, names) -> list:
        """Seconds of each device event whose name holds one of
        ``names``, in launch order."""
        return [float(e["dur"]) * 1e-6 for e in self.device
                if any(n in e["name"] for n in names)]

    def top_ops(self) -> list:
        tot = {}
        for e in self.device:
            key = e["name"][:96]
            tot[key] = tot.get(key, 0.0) + float(e["dur"]) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:TOP]

    def _host_at(self, t: float) -> str:
        """The innermost host event around time ``t``."""
        best = None
        for e in self.host:
            s = float(e["ts"])
            if s <= t <= s + float(e["dur"]):
                if best is None or float(e["dur"]) < float(best["dur"]):
                    best = e
        return best["name"][:96] if best is not None else "no host event"

    def idle_gaps(self) -> list:
        """The longest idle stretches of the device in the window, each
        named by what the host was doing at its midpoint."""
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(0.5 * (s + e)), (e - s) * 1e-6]
                for s, e in gaps[:TOP]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def profile(fn) -> Trace:
    """Run ``fn()`` (which waits for the device at its end) under
    ``torch.profiler`` and return its timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with tprofile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="splatbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return Trace(events)
