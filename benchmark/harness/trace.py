"""The traced run: ``torch.profiler`` over the measured window, the
benchmark's own spans around each call into the port, and what is read
from the device timeline (busy time, idle gaps, the heaviest operations).

Spans are ``record_function`` ranges named ``bench.<what>``; the one named
``bench.window`` covers the whole window, final synchronise included.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Trace:
    """Device operations and host spans of one traced window, times in
    seconds from the window's start."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("bench.")]
        win = [e for e in spans if e["name"] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no bench.window span")
        t0 = float(win[0]["ts"])
        self.window_s = float(win[0]["dur"]) / 1e6
        self.spans = sorted(((e["name"], (e["ts"] - t0) / 1e6,
                              (e["ts"] + e["dur"] - t0) / 1e6)
                             for e in spans if e["name"] != WINDOW), key=lambda s: s[1])
        self.device = sorted(
            ((str(e["name"]), (e["ts"] - t0) / 1e6, (e["ts"] + e["dur"] - t0) / 1e6)
             for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
             and 0.0 <= (e["ts"] - t0) / 1e6 <= self.window_s), key=lambda d: d[1])

    def named(self, pattern: str) -> list:
        """Device operations whose name holds ``pattern``, in time order."""
        return [d for d in self.device if pattern in d[0]]

    def span_times(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals."""
        out = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        """Seconds inside the window with an operation on the device."""
        return sum(min(e, self.window_s) - max(s, 0.0) for s, e in self.busy_intervals())

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches with nothing on the device, each named by
        the benchmark span the host was in when it began."""
        busy = self.busy_intervals()
        edges = [0.0] + [x for iv in busy for x in iv] + [self.window_s]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self._host_at(t), d] for d, t in gaps[:top]]

    def _host_at(self, t: float) -> str:
        inner = None
        for name, s, e in self.spans:
            if s > t:
                break
            if e >= t:
                inner = name
        return inner or "bench.window"

    def top_ops(self, top: int = 10) -> list:
        by = {}
        for name, s, e in self.device:
            by[name[:160]] = by.get(name[:160], 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class Tracer:
    """``with tracer.window(): ...`` profiles the window when on (the body
    ends in its own synchronise); ``span`` marks a call into the port (a
    no-op when tracing is off)."""

    def __init__(self, on: bool):
        self.on = on
        self.trace = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                yield
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f)["traceEvents"])
        finally:
            os.unlink(path)

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)
