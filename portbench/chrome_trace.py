"""Reading a ``torch.profiler`` Chrome trace: device activity, the host
time each device operation was launched at, and the benchmark's spans.

The benchmark wraps its window in a span ``pb:window``, each call into
the port in ``pb:call:<family>:<call>`` and each wait on an item's
completion in ``pb:wait`` (``torch.profiler.record_function``).  A device
operation belongs to the call span that holds its launch on the host: the
launch is found through the profiler's correlation id (the kernel's
``correlation`` matches the ``cuda_runtime`` or ``cuda_driver`` event that
launched it) or, failing that, its ``External id`` (the CPU op or span
that was innermost at the launch).  Names of kernels play no part in it.
Times in the file are microseconds; everything here returns seconds.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "pb:window"
WAIT = "pb:wait"
CALL = "pb:call:"


def call_span(family, call):
    """The span name of one call into the port."""
    return f"{CALL}{family}:{call}"


class Trace:
    """The parts of one Chrome trace that the metrics read."""

    def __init__(self, events):
        self.device = []   # (start, end, name, launch time or None)
        self.spans = []    # (start, end, name): call and wait spans
        self.window = None  # (start, end) of pb:window
        launch, external = {}, {}
        kernels = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            args = ev.get("args") or {}
            start = float(ev["ts"]) * 1e-6
            end = start + float(ev.get("dur", 0.0)) * 1e-6
            if cat in DEVICE_CATS:
                kernels.append((start, end, ev.get("name", ""),
                                args.get("correlation"),
                                args.get("External id")))
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    launch[args["correlation"]] = start
            elif cat in HOST_CATS:
                name = ev.get("name", "")
                if "External id" in args:
                    external.setdefault(args["External id"], start)
                if name == WINDOW:
                    self.window = (start, end)
                elif name.startswith(CALL) or name == WAIT:
                    self.spans.append((start, end, name))
        self.spans.sort()
        self._starts = [s[0] for s in self.spans]
        for start, end, name, corr, ext in kernels:
            t = launch.get(corr)
            if t is None:
                t = external.get(ext)
            self.device.append((start, end, name, t))
        self.device.sort()

    @classmethod
    def load(cls, path):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    def span_at(self, t):
        """The call or wait span that holds host time ``t``, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i]
        return None

    def busy_intervals(self, lo, hi):
        """The union of device activity within [lo, hi], merged."""
        merged = []
        for start, end, _, _ in self.device:
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_s(self, lo, hi):
        return sum(e - s for s, e in self.busy_intervals(lo, hi))

    def idle_gaps(self, lo, hi):
        """(start, end) of every stretch of [lo, hi] with no device
        activity."""
        gaps, t = [], lo
        for start, end in self.busy_intervals(lo, hi):
            if start > t:
                gaps.append((t, start))
            t = max(t, end)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def call_device_s(self):
        """{call span: device seconds of every operation launched inside
        it}, over the call spans that start in the window."""
        lo, hi = self.window
        out = {s: 0.0 for s in self.spans
               if s[2].startswith(CALL) and lo <= s[0] <= hi}
        for start, end, _, t in self.device:
            if t is None:
                continue
            span = self.span_at(t)
            if span in out:
                out[span] += end - start
        return out

    def unattributed(self):
        """Device operations whose launch the trace does not show."""
        return sum(1 for d in self.device if d[3] is None)

    def roofline_pct(self, family, bounds):
        """100 x the summed bounds (``bounds``: seconds by call name) of
        the family's calls in the window over the device time of all
        operations launched inside their spans; None where the window
        holds no such call or no device time."""
        prefix = f"{CALL}{family}:"
        bound, device = 0.0, 0.0
        for span, seconds in self.call_device_s().items():
            if span[2].startswith(prefix):
                bound += bounds[span[2][len(prefix):]]
                device += seconds
        if device <= 0.0:
            return None
        return 100.0 * bound / device

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took the most
        time in the window, summed by name."""
        lo, hi = self.window
        by_name = defaultdict(float)
        for start, end, name, _ in self.device:
            start, end = max(start, lo), min(end, hi)
            if end > start:
                by_name[name] += end - start
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, seconds] for name, seconds in ranked]

    def labelled_gaps(self, top=10):
        """[[label, seconds]] of the longest idle gaps of the window, each
        labelled with the span the host was in where the gap began."""
        lo, hi = self.window
        gaps = sorted(self.idle_gaps(lo, hi), key=lambda g: g[0] - g[1])
        out = []
        for start, end in gaps[:top]:
            span = self.span_at(start)
            out.append([span[2] if span else "pb:loop", end - start])
        return out
