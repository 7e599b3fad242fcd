"""Each mix's reference against the port's CPU path and against SciPy at
a tiny size."""

import numpy as np
import pytest
import scipy.ndimage as sndi
import scipy.signal as ssig
import torch
from conftest import tiny_shape

from portbench import harness


def _calls(spec):
    return [(w["name"], c) for w in spec["workloads"]
            for c in harness.Cell(w["name"], spec, device="cpu",
                                  shape=tiny_shape(spec, w["name"])).calls]


def cells_and_calls():
    import json
    from conftest import CHECKOUT

    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    return [(w, c.name) for w, c in _calls(spec)]


@pytest.mark.parametrize("workload,call", cells_and_calls())
def test_reference_against_port_cpu_path(spec, workload, call):
    cell = harness.Cell(workload, spec, device="cpu",
                        shape=tiny_shape(spec, workload))
    inp = cell.make_inputs(2**33 + 5)
    samples = cell.loop(inp, items=3, seed=1)
    worst = cell.compare(inp, samples)
    limit = cell.limits()[call]
    assert worst[call] <= limit
    if limit > 0:
        assert worst[call] > 0  # float32 against float64: never exact


def _scipy(call, x, args, operands):
    if call.attr == "uniform_filter":
        return sndi.uniform_filter(x, size=args["size"])
    if call.attr == "grey_opening":
        return sndi.grey_opening(x, size=args["size"])
    if call.attr == "edge_enhance_pipeline":
        sm = sndi.gaussian_filter(x, args["sigma"])
        grad = np.sqrt(sum(sndi.sobel(sm, axis=a) ** 2
                           for a in range(x.ndim)))
        return (1 + args["amount"]) * x - args["amount"] * sm + 0.1 * grad
    if call.attr == "affine_transform":
        return sndi.affine_transform(x, args["matrix"], args["offset"],
                                     order=args["order"], mode=args["mode"],
                                     prefilter=args["prefilter"])
    if call.attr == "fftconvolve":
        k = operands[args["in2"]].numpy().astype(np.float64)
        return ssig.fftconvolve(x, k, mode=args["mode"])
    raise KeyError(call.attr)


@pytest.mark.parametrize("workload,call", cells_and_calls())
def test_reference_against_scipy(spec, workload, call):
    cell = harness.Cell(workload, spec, device="cpu",
                        shape=tiny_shape(spec, workload))
    inp = cell.make_inputs(77)
    c = next(c for c in cell.calls if c.name == call)
    x, entry = inp.item(3)
    args = dict(c.args)
    if c.item_args:
        args.update(entry)
    ref = c.reference.reference(x.to(torch.float64), args, inp.operands,
                                torch.float64)
    want = _scipy(c, x.numpy().astype(np.float64), args, inp.operands)
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=1e-12)
