"""Each metric reader against small profiler traces: a hand-made one
whose numbers are known, and traces recorded on an H100 (one item loop
of a cell at a small size each, ``tests/data``)."""

import copy
import json

import pytest
from conftest import CHECKOUT

from portbench.chrome_trace import Trace
from portbench.harness import Readings, load_file

DATA = CHECKOUT / "portbench" / "tests" / "data"


def metric(name):
    return load_file(CHECKOUT / "portbench" / "metrics" / f"{name}.py",
                     f"test_metric_{name.replace('.', '_')}")


def x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": args}


# times in microseconds: a window of 1000, two calls, one wait
EVENTS = [
    x("user_annotation", "pb:window", 0, 1000),
    x("user_annotation", "pb:call:separable:a", 10, 20),
    x("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=1),
    x("kernel", "k_one", 40, 100, correlation=1),
    # a kernel whose launch event is missing: found by its External id
    x("cpu_op", "aten::mul", 22, 5, **{"External id": 9}),
    x("kernel", "k_two", 150, 50, correlation=2, **{"External id": 9}),
    x("user_annotation", "pb:wait", 40, 300),
    x("user_annotation", "pb:call:gather:g", 400, 10),
    x("cuda_runtime", "cudaLaunchKernel", 405, 2, correlation=3),
    x("kernel", "k_three", 420, 200, correlation=3),
    x("gpu_memcpy", "Memcpy DtoD", 700, 100, correlation=4),
    # outside the window: left out of busy time, not of the call's time
    x("kernel", "k_three", 990, 30, correlation=5),
    x("cuda_runtime", "cudaLaunchKernel", 406, 1, correlation=5),
]
BOUNDS = {"separable": {"a": 30e-6}, "gather": {"g": 115e-6}}


def readings(events=EVENTS, **kw):
    r = Readings(seconds=1.0, setup_s=2.5, bounds=BOUNDS,
                 trace=Trace(copy.deepcopy(events)))
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_idle_share_is_the_union_of_device_activity():
    # busy: 40-140, 150-200, 420-620 (and 990-1000 of the late kernel,
    # which overlaps nothing), 700-800
    busy = 100 + 50 + 200 + 10 + 100
    assert metric("device_idle_pct").read(readings()) == \
        pytest.approx(100 * (1 - busy / 1000))


def test_untraced_idle_share_takes_device_time_an_item_from_the_trace():
    # every operation launched in a call span: 150 + 230 us over the 2
    # items traced; 2000 items a second untraced keep the card 38 % busy
    r = readings(traced_items=2, latencies=[0.001] * 2000)
    assert metric("untraced_idle_pct").read(r) == pytest.approx(62.0)
    assert metric("untraced_idle_pct").read(readings()) is None


def test_roofline_divides_bounds_by_device_time_of_the_calls_spans():
    # separable: k_one (by correlation) and k_two (by External id)
    assert metric("separable_roofline").read(readings()) == \
        pytest.approx(100 * 30 / 150)
    # gather: both launches inside its span, the late one in full
    assert metric("gather_roofline").read(readings()) == \
        pytest.approx(100 * 115 / 230)
    assert metric("fft_roofline").read(readings()) is None


def test_roofline_ignores_kernel_names():
    renamed = [dict(e, name=f"renamed_{i}") if e["cat"] == "kernel" else e
               for i, e in enumerate(EVENTS)]
    for name in ("separable_roofline", "gather_roofline"):
        assert metric(name).read(readings(renamed)) == \
            metric(name).read(readings())


def test_breakdown_and_gap_labels():
    t = Trace(copy.deepcopy(EVENTS))
    ops = dict(t.device_ops())
    assert ops["k_three"] == pytest.approx(210e-6)
    # idle: 0-40 (before the first call's span: the loop), 140-150 and
    # 200-420 (the host waiting), 620-700 and 800-990 (the loop)
    assert t.labelled_gaps() == [
        ["pb:wait", pytest.approx(220e-6)], ["pb:loop", pytest.approx(190e-6)],
        ["pb:loop", pytest.approx(80e-6)], ["pb:loop", pytest.approx(40e-6)],
        ["pb:wait", pytest.approx(10e-6)]]


def test_host_clock_and_counter_readers():
    r = readings(trace=None, issued=10, latencies=[0.001 * i for i in
                                                   range(1, 21)],
                 host_issue_s=0.005, launches={"a": 40, "b.c": 20},
                 peak_bytes=3 * 2**30, input_bytes=2**30,
                 held_bytes=2**29)
    assert metric("items_per_s").read(r) == 20.0
    assert metric("item_p95_ms").read(r) == pytest.approx(19.05)
    assert metric("host_issue_ms").read(r) == pytest.approx(0.5)
    assert metric("launches_per_item").read(r) == 6.0
    assert metric("work_mem_gib").read(r) == pytest.approx(1.5)
    assert metric("setup_s").read(r) == 2.5
    for name in ("device_idle_pct", "untraced_idle_pct",
                 "separable_roofline"):
        assert metric(name).read(r) is None


def recorded():
    return sorted(DATA.glob("trace_*.json"))


@pytest.mark.parametrize("path", recorded(), ids=lambda p: p.stem)
def test_readers_on_recorded_traces(path):
    data = json.loads(path.read_text())
    bounds = data.pop("portbench_bounds")
    trace = Trace(data["traceEvents"])
    assert trace.window is not None and trace.unattributed() == 0
    r = Readings(seconds=1.0, setup_s=1.0, bounds=bounds, trace=trace)
    idle = metric("device_idle_pct").read(r)
    assert 0.0 < idle < 100.0
    family = next(iter(bounds))
    share = metric(f"{family}_roofline").read(r)
    assert 0.0 < share < 100.0
    renamed = Trace([dict(e, name="k") if e.get("cat") == "kernel" else e
                     for e in data["traceEvents"]])
    assert metric(f"{family}_roofline").read(
        Readings(seconds=1.0, setup_s=1.0, bounds=bounds, trace=renamed)) \
        == pytest.approx(share)


def test_launches_are_counted_over_the_window_only(spec, monkeypatch):
    """The warm-up's launches stay out of ``launches_per_item``: with one
    counted launch a call to ``uniform_filter``, a run reads exactly 1."""
    import time

    from cupyimg_tpu_torch.ops import fused_separable
    from cupyimg_tpu_torch.scipy import ndimage

    from portbench import harness

    plain = ndimage.uniform_filter

    def counted(x, **kw):
        fused_separable.fused_separable_correlate.launches += 1
        return plain(x, **kw)

    monkeypatch.setattr(ndimage, "uniform_filter", counted)
    monkeypatch.setattr(fused_separable.fused_separable_correlate,
                        "launches", 0)
    result = harness.run_cell("img4096.separable", 3, 0.1, True, spec,
                              time.perf_counter(), device="cpu",
                              shape=(24, 20))
    assert result["correct"] is True
    assert result["metrics"]["launches_per_item"]["value"] == 1.0
    assert fused_separable.fused_separable_correlate.launches > \
        result["attempted"]


def test_a_traced_run_reads_the_host_in_its_untraced_window(spec,
                                                            monkeypatch):
    """``host_issue_ms`` and ``launches_per_item`` come from the window
    run without the profiler; the trace's readings from the traced one."""
    import time

    from portbench import harness

    loops = []
    plain = harness.Cell.loop

    def loop(self, inp, seconds=None, items=None, trace=False, seed=0,
             readings=None):
        out = plain(self, inp, seconds, items, trace, seed, readings)
        if seconds is not None:
            loops.append((trace, readings))
        return out

    monkeypatch.setattr(harness.Cell, "loop", loop)
    result = harness.run_cell("img4096.separable", 4, 0.1, True, spec,
                              time.perf_counter(), device="cpu",
                              shape=(24, 20))
    assert [t for t, _ in loops] == [False, True]
    untraced, traced = loops[0][1], loops[1][1]
    assert result["attempted"] == traced.issued
    assert result["metrics"]["host_issue_ms"]["value"] == pytest.approx(
        untraced.host_issue_s / untraced.issued * 1e3)
    assert untraced.traced_items == traced.issued
