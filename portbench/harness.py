"""One run of one cell: set-up, the closed-loop window, the metrics, and
the comparison with the plain reference that decides ``correct``.

Everything a cell is made of is found by name under the benchmark's
folder: ``configs/<config>.json``, ``traffic/<traffic>.json`` (read by
``inputs.py``), ``reference/<function>.py``, ``bounds/<bound>.py`` and
``metrics/<metric>.py``.  A metric file defines ``read(readings)``,
which returns a number or None (nothing to read: the metric is left out
of the result).  A metric ``<quantity>.<part>`` without a file of its own
is read by ``metrics/<quantity>.py``: a quantity split by the end-to-end
metric it moves keeps one reader.  A per-layer metric without a
``workloads`` list is read in every cell that reports the end-to-end
metric it moves.

The window is a closed loop: the host keeps the mix's ``inflight`` items
issued and waits on the oldest item's CUDA event before issuing the
next.  An item's latency runs from the host's clock when its first call
is issued to the moment the host sees its event complete; the items that
complete inside the window are its throughput and its tail.

A traced run measures two windows of the same length: an untraced one,
which the host-clock readings (throughput, host issue time, launches)
come from, then the traced one, which the trace's readings come from; so
the profiler's own host cost a call stays out of the former.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import sys
import tempfile
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import inputs as _inputs
from portbench.chrome_trace import WAIT, WINDOW, Trace, call_span

BENCH_DIR = Path(__file__).resolve().parent
PACKAGE = "cupyimg_tpu_torch"
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "cupyimg_tpu")
#: the port's modules that count kernel launches (``launches``)
COUNTER_MODULES = ("fused_separable", "fused_dense", "fused_rank",
                   "spline_gather", "fused_fft")


def load_file(path, name):
    """The module of the Python file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def launch_counters():
    """{counter: launches so far} of every kernel wrapper of the port: a
    module's ``launches`` and each function's ``launches``."""
    out = {}
    for mod_name in COUNTER_MODULES:
        mod = sys.modules.get(f"{PACKAGE}.ops.{mod_name}")
        if mod is None:
            continue
        for attr, value in vars(mod).items():
            if attr == "launches" and isinstance(value, int):
                out[mod_name] = value
            elif callable(value) and isinstance(
                    getattr(value, "launches", None), int):
                out[f"{mod_name}.{attr}"] = value.launches
    return out


class HostEvent:
    """A completion marker for a CPU run: the work is done on issue."""

    def record(self):
        pass

    def synchronize(self):
        pass


@dataclass
class Call:
    """One call of an item: the port's function and its arguments."""

    name: str
    module: object
    attr: str
    args: dict
    family: str
    reference: object
    bound: object
    limit: float
    item_args: bool = False

    def __call__(self, x, kwargs):
        return getattr(self.module, self.attr)(x, **kwargs)


@dataclass
class Readings:
    """What one window measured: what the metric files read."""

    seconds: float
    setup_s: float
    issued: int = 0
    latencies: list = field(default_factory=list)
    host_issue_s: float = 0.0
    launches: dict = field(default_factory=dict)
    peak_bytes: int = 0
    input_bytes: int = 0
    held_bytes: int = 0
    bounds: dict = field(default_factory=dict)
    trace: Trace | None = None
    traced_items: int = 0


class Cell:
    """A cell of ``BENCHMARK.json``, resolved from its files."""

    def __init__(self, workload, spec, bench_dir=BENCH_DIR, device="cuda",
                 shape=None):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.cell = cells[workload]
        self.dir = Path(bench_dir)
        self.device = torch.device(device)
        self.config = self._json("configs", self.cell["config"])
        if shape is not None:
            self.config["shape"] = list(shape)
        self.mix = self._json("traffic", self.cell["traffic"])
        self.calls = [self._call(c) for c in self.mix["calls"]]
        self.metrics = {"end_to_end": [
            (m, self._metric(m["name"])) for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])]}
        reported = {m["name"] for m, _ in self.metrics["end_to_end"]}
        self.metrics["per_layer"] = [
            (m, self._metric(m["name"])) for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]

    def _json(self, folder, name):
        with open(self.dir / folder / f"{name}.json") as f:
            return json.load(f)

    def _module(self, folder, name):
        return load_file(self.dir / folder / f"{name}.py",
                         f"portbench_{folder}_{name}".replace(".", "_"))

    def _metric(self, name):
        """The reader of metric ``name``: its own file, else that of the
        quantity it splits (the name before its first dot)."""
        if not (self.dir / "metrics" / f"{name}.py").exists():
            name = name.split(".", 1)[0]
        return self._module("metrics", name)

    def _call(self, c):
        path, attr = c["fn"].rsplit(".", 1)
        module = importlib.import_module(f"{PACKAGE}.{path}")
        return Call(c["name"], module, attr, c.get("args", {}), c["family"],
                    self._module("reference", attr),
                    self._module("bounds", c["bound"]), float(c["limit"]),
                    bool(c.get("item_args", False)))

    # -- inputs ------------------------------------------------------------

    def make_inputs(self, seed, dtype=None):
        """The seed's inputs, with every call's keyword arguments per
        table entry resolved once (operands and draws)."""
        inp = _inputs.make(self.config, self.mix, seed, self.device, dtype)
        self.kwargs = [[self._kwargs(c, inp, entry) for c in self.calls]
                       for entry in inp.table]
        return inp

    def _kwargs(self, call, inp, entry):
        kw = {k: inp.operands[v] if isinstance(v, str) and v.startswith("@")
              else v for k, v in call.args.items()}
        if call.item_args:
            kw.update(entry)
        return kw

    def bounds(self, inp):
        """{family: {call: least seconds}} of one item's calls."""
        shape = tuple(self.config["shape"])
        itemsize = torch.empty((), dtype=getattr(
            torch, self.config["dtype"])).element_size()
        out = {}
        for c in self.calls:
            out.setdefault(c.family, {})[c.name] = c.bound.bound_s(
                c.attr, shape, itemsize, c.args, inp.operands)
        return out

    # -- the window --------------------------------------------------------

    def _event(self):
        if self.device.type == "cuda":
            return torch.cuda.Event()
        return HostEvent()

    def issue(self, inp, i, trace=False):
        """Issue item ``i``'s calls; returns their outputs."""
        x, _ = inp.item(i)
        kwargs = self.kwargs[i % len(self.kwargs)]
        outs = []
        for call, kw in zip(self.calls, kwargs):
            if trace:
                with torch.profiler.record_function(
                        call_span(call.family, call.name)):
                    outs.append(call(x, kw))
            else:
                outs.append(call(x, kw))
        return outs

    def warm_up(self, inp, items=None):
        """Run the loop's own calls on the first items, pipelined as the
        window pipelines them, and wait for them."""
        self.loop(inp, items=items or self.mix.get("warm_items", 8))

    def loop(self, inp, seconds=None, items=None, trace=False, seed=0,
             readings=None):
        """The closed loop: for ``seconds`` (or ``items`` items), keeping
        ``inflight`` items issued.  Fills ``readings`` and returns the
        sampled items [(item, outputs)]: a reservoir of the mix's
        ``check_items`` drawn from the seed over the items issued."""
        inflight = self.mix["inflight"]
        keep = self.mix["check_items"]
        pick = random.Random(int(seed))
        samples = []
        pending = deque()
        latencies = []
        host_issue = 0.0
        issued = 0
        span = (lambda name: torch.profiler.record_function(name)) if trace \
            else (lambda name: nullcontext())

        def complete():
            t_issue, event, _ = pending.popleft()
            with span(WAIT):
                event.synchronize()
            done = time.perf_counter()
            if t_end is None or done <= t_end:
                latencies.append(done - t_issue)

        before = launch_counters()
        start = time.perf_counter()
        t_end = None if seconds is None else start + seconds
        with span(WINDOW):
            while True:
                t_issue = time.perf_counter()
                if (t_end is not None and t_issue >= t_end) or (
                        items is not None and issued >= items):
                    break
                outs = self.issue(inp, issued, trace)
                event = self._event()
                event.record()
                host_issue += time.perf_counter() - t_issue
                if issued < keep:
                    samples.append((issued, outs))
                else:
                    slot = pick.randrange(issued + 1)
                    if slot < keep:
                        samples[slot] = (issued, outs)
                pending.append((t_issue, event, outs))
                issued += 1
                while len(pending) >= inflight:
                    complete()
            launches = {k: v - before.get(k, 0)
                        for k, v in launch_counters().items()}
        while pending:
            complete()
        if readings is not None:
            readings.issued = issued
            readings.latencies = latencies
            readings.host_issue_s = host_issue
            readings.launches = launches
        return samples

    # -- the comparison ----------------------------------------------------

    def compare(self, inp, samples, outputs=None):
        """{call: the largest max|out - ref| / max|ref| over the sampled
        items}, each output against the reference computed in float64
        from the item's input.  ``outputs`` replaces the samples' outputs
        (the control).  Counts the sampled items with a call over its
        limit in ``failed_items``."""
        worst = {c.name: 0.0 for c in self.calls}
        self.failed_items = 0
        for k, (i, outs) in enumerate(samples):
            bad = False
            x, _ = inp.item(i)
            kwargs = self.kwargs[i % len(self.kwargs)]
            got = outputs[k] if outputs is not None else outs
            for call, kw, out in zip(self.calls, kwargs, got):
                args = dict(call.args)
                if call.item_args:
                    args.update(kw)
                ref = call.reference.reference(
                    x.to(torch.float64), args, inp.operands, torch.float64)
                err = rel_err(out, ref)
                worst[call.name] = max(worst[call.name], err)
                bad = bad or not err <= call.limit
                del ref
            self.failed_items += bad
        return worst

    def control_outputs(self, inp, samples, low):
        """The reference computed in ``low`` in the program's place, for
        the sampled items: the control of a mix whose program has no
        lower-precision path of its own."""
        outs = []
        for i, _ in samples:
            x, _ = inp.item(i)
            kwargs = self.kwargs[i % len(self.kwargs)]
            row = []
            for call, kw in zip(self.calls, kwargs):
                args = dict(call.args)
                if call.item_args:
                    args.update(kw)
                row.append(call.reference.reference(x, args, inp.operands,
                                                    low))
            outs.append(row)
        return outs

    def limits(self):
        return {c.name: c.limit for c in self.calls}


def rel_err(out, ref):
    """max |out - ref| / max |ref|, in float64 (0 for two zero arrays)."""
    out = out.to(torch.float64)
    ref = ref.to(torch.float64)
    if out.shape != ref.shape:
        return float("inf")
    diff = (out - ref).abs().nan_to_num(nan=float("inf")).max().item()
    scale = ref.abs().max().item()
    return diff / scale if scale > 0 else diff


def read_metrics(cell, kind, readings):
    """{metric: {"value", "unit"}} of the cell's metrics of ``kind`` that
    have something to read."""
    out = {}
    for spec, module in cell.metrics[kind]:
        value = module.read(readings)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def run_cell(workload, seed, seconds, trace, spec, t_start,
             bench_dir=BENCH_DIR, device="cuda", shape=None, log=sys.stderr,
             phases=()):
    """One run: returns the result object that ``run.py`` prints.  Raises
    where the run cannot give one.  ``phases``: (name, end time) of the
    caller's own set-up steps since ``t_start``, for the set-up line."""
    phases = list(phases) + [("harness", time.perf_counter())]
    cell = Cell(workload, spec, bench_dir, device, shape)
    cuda = cell.device.type == "cuda"
    phases.append(("cell", time.perf_counter()))
    inp = cell.make_inputs(seed)
    phases.append(("inputs", time.perf_counter()))
    cell.warm_up(inp)
    phases.append(("warm-up", time.perf_counter()))
    readings = Readings(seconds=float(seconds), setup_s=0.0,
                        input_bytes=inp.input_bytes, bounds=cell.bounds(inp))
    prof = None
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    phases.append(("reset", time.perf_counter()))
    readings.setup_s = time.perf_counter() - t_start
    marks = [t_start] + [t for _, t in phases]
    print("setup: " + ", ".join(
        f"{name} {marks[k + 1] - marks[k]:.3f} s"
        for k, (name, _) in enumerate(phases)), file=log)
    timed = readings
    if trace:
        # the untraced window first: its readings are the host's own
        cell.loop(inp, seconds=seconds, seed=seed, readings=readings)
        timed = Readings(seconds=float(seconds), setup_s=0.0)
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    samples = cell.loop(inp, seconds=seconds, trace=trace, seed=seed,
                        readings=timed)
    readings.traced_items = timed.issued if trace else 0
    if cuda:
        torch.cuda.synchronize()
        readings.peak_bytes = torch.cuda.max_memory_allocated()
        memory_peak = max(setup_peak, readings.peak_bytes)
    else:
        memory_peak = 0
    readings.held_bytes = sum(o.numel() * o.element_size()
                              for _, outs in samples for o in outs)
    if prof is not None:
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            readings.trace = Trace.load(path)
        finally:
            os.remove(path)
        del prof
    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(cell, kind, readings)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": int(cell.cell["chips"]),
                   "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": timed.issued, "failed": 0,
              "metrics": metrics, "device": device_info}
    if readings.trace is not None and readings.trace.window is not None:
        lo, hi = readings.trace.window
        device_info["busy_s"] = readings.trace.busy_s(lo, hi)
        device_info["window_s"] = hi - lo
        result["breakdown"] = {
            "device_ops": readings.trace.device_ops(),
            "idle_gaps": readings.trace.labelled_gaps()}
        print(f"trace: {len(readings.trace.device)} device operations, "
              f"{readings.trace.unattributed()} without a launch in the "
              "trace", file=log)
    print(f"items: {len(readings.latencies)} completed in the window, "
          f"{readings.issued} issued" + (
              f"; {timed.issued} issued in the traced window" if trace
              else ""), file=log)
    # the reference runs once the window is closed and its peak is read
    readings.trace = None
    worst = cell.compare(inp, samples)
    limits = cell.limits()
    failed = [name for name in limits if not worst[name] <= limits[name]]
    result["failed"] = cell.failed_items
    result["correct"] = not failed and bool(samples)
    result["checks"] = {f"{name}_err": {"value": worst[name],
                                        "limit": limits[name]}
                        for name in limits}
    return result
