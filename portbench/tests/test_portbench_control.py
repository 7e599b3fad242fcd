"""What decides ``correct``: sound runs pass every limit, the control
fails one of each cell's numbers, and a run whose timed path is broken
underneath comes out not correct (a call that returns its input
unchanged, half of its output left out, one answer altered where it is
produced).  At a tiny size on the CPU; the control also at each cell's
own size on a card (``cuda``)."""

import json
import time

import pytest
import torch
from conftest import CHECKOUT, need_card, tiny_shape

from portbench import calibrate, harness

SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def fails_one(cell, readings):
    limits = cell.limits()
    return any(not r[name] <= limits[name]
               for _, r in readings for name in limits)


def passes_all(cell, readings):
    limits = cell.limits()
    return all(r[name] <= limits[name] for _, r in readings for name in limits)


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails_tiny(spec, workload):
    cell = harness.Cell(workload, spec, device="cpu",
                        shape=tiny_shape(spec, workload))
    assert passes_all(cell, calibrate.readings(cell, [1, 2**35 + 1], 0.05))
    assert fails_one(cell, calibrate.readings(cell, [2, 3, 4], 0.05,
                                              control=True))


def identity(fn):
    return lambda x, **kw: x.clone()


def half_left_out(fn):
    def broken(x, **kw):
        out = fn(x, **kw).clone()
        h = out.shape[0] // 2
        out[h:] = x[h:].to(out.dtype)
        return out
    return broken


def one_altered(fn):
    def broken(x, **kw):
        out = fn(x, **kw).clone()
        flat = out.view(-1)
        flat[flat.numel() // 2] += 1e-3 * float(out.abs().max())
        return out
    return broken


FAULTS = {"unchanged": identity, "half": half_left_out,
          "altered": one_altered}


def calls():
    return [(w, c["name"]) for w in SPEC["workloads"]
            for c in json.loads((CHECKOUT / "portbench" / "traffic" /
                                 f"{w['traffic']}.json").read_text())["calls"]]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_call", calls(), ids=lambda c: f"{c[0]}-{c[1]}")
def test_a_broken_timed_path_is_not_correct(spec, monkeypatch, cell_call,
                                            fault):
    w, name = cell_call
    workload = w["name"]
    probe = harness.Cell(workload, spec, device="cpu",
                         shape=tiny_shape(spec, workload))
    call = next(c for c in probe.calls if c.name == name)
    monkeypatch.setattr(call.module, call.attr,
                        FAULTS[fault](getattr(call.module, call.attr)))
    result = harness.run_cell(workload, 5, 0.05, False, spec,
                              time.perf_counter(), device="cpu",
                              shape=tiny_shape(spec, workload))
    assert result["correct"] is False
    assert result["failed"] > 0
    assert result["checks"][f"{name}_err"]["value"] > \
        result["checks"][f"{name}_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(spec, workload):
    need_card()
    cell = harness.Cell(workload, spec, device="cuda")
    program = calibrate.readings(cell, [41, 42, 3000000043], 0.5)
    control = calibrate.readings(cell, [44, 45, 3000000046], 0.5,
                                 control=True)
    assert passes_all(cell, program)
    assert fails_one(cell, control)
    torch.cuda.empty_cache()
