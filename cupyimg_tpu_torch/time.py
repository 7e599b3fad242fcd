"""Benchmark timing harness: the counterpart of ``cupyimg_tpu.time``.

``repeat``: CPU wall time via ``perf_counter`` around each call (the
enqueue), and device time from a pair of ``torch.cuda.Event``s around
each call on the current stream.  A measurement needs a CUDA device: with
none, ``repeat`` raises rather than timing the CPU.  ``trace``: a
``torch.profiler`` trace of a block, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib as _contextlib
import math
import os
import tempfile
import time as _time

import numpy as np
import torch

__all__ = ["repeat", "trace"]


class _PerfCaseResult:
    def __init__(self, name, ts, devices):
        assert ts.ndim == 2 and ts.shape[0] == len(devices) + 1
        self.name = name
        self._ts = ts
        self._devices = devices

    @property
    def cpu_times(self):
        return self._ts[0]

    @property
    def gpu_times(self):
        return self._ts[1:]

    device_times = gpu_times

    @staticmethod
    def _to_str_per_item(device_name, t):
        assert t.ndim == 1 and t.size > 0
        t_us = t * 1e6
        s = "    {}:{:9.03f} us".format(device_name, t_us.mean())
        if t.size > 1:
            s += "   +/-{:6.03f} (min:{:9.03f} / max:{:9.03f}) us".format(
                t_us.std(), t_us.min(), t_us.max()
            )
        return s

    def to_str(self, show_device=False):
        results = [self._to_str_per_item("CPU", self._ts[0])]
        if show_device:
            for i, d in enumerate(self._devices):
                results.append(
                    self._to_str_per_item(f"GPU-{d}", self._ts[1 + i])
                )
        return f"{self.name:<20s}:" + " ".join(results)

    def __str__(self):
        return self.to_str(show_device=True)


def repeat(
    func,
    args=(),
    kwargs={},
    n_repeat=10000,
    *,
    name=None,
    n_warmup=10,
    max_duration=math.inf,
):
    """Time ``func`` on the current CUDA device, after ``n_warmup`` calls.

    Returns per-repeat CPU times (seconds to enqueue) and device times
    (seconds between CUDA events recorded before and after each call).
    """
    if not callable(func):
        raise ValueError("`func` should be a callable object.")
    if not isinstance(args, tuple):
        raise ValueError("`args` should be of tuple type.")
    if not isinstance(kwargs, dict):
        raise ValueError("`kwargs` should be of dict type.")
    if not torch.cuda.is_available():
        raise RuntimeError("repeat() times a CUDA device; none is available")
    if name is None:
        name = func.__name__
    device = torch.cuda.current_device()

    for _ in range(n_warmup):
        func(*args, **kwargs)
    torch.cuda.synchronize(device)

    cpu_times = []
    events = []
    duration = 0.0
    for _ in range(n_repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = _time.perf_counter()
        start.record()
        func(*args, **kwargs)
        end.record()
        t1 = _time.perf_counter()
        end.synchronize()
        cpu_times.append(t1 - t0)
        events.append((start, end))
        duration += _time.perf_counter() - t0
        if duration > max_duration:
            break
    dev_times = [s.elapsed_time(e) * 1e-3 for s, e in events]
    ts = np.asarray([cpu_times, dev_times], dtype=np.float64)
    return _PerfCaseResult(name, ts, devices=(device,))


@_contextlib.contextmanager
def trace(log_dir=None):
    """Capture a ``torch.profiler`` trace of the enclosed block.

    Records CPU activity, and CUDA activity (each kernel's launch and its
    run on the card) when CUDA is available.  On leaving the block it
    waits for the card and writes a Chrome trace,
    ``<log_dir>/<host>_<pid>.<time>.pt.trace.json`` (open it in Perfetto,
    ``chrome://tracing`` or TensorBoard's profile plugin).  ``log_dir``
    defaults to ``cupyimg_tpu_torch_trace`` in the temporary directory;
    it is yielded.  Usage::

        with cupyimg_tpu_torch.time.trace("tr") as d:
            out = ndi.uniform_filter(x, 5)
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "cupyimg_tpu_torch_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
