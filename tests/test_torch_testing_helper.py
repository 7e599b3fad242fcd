"""The torch port's dual-backend test oracle (``cupyimg_tpu_torch.testing``),
``time.trace`` and ``graft_entry.entry`` on the CPU; no JAX.

- Each decorator passes on a few port calls against numpy/scipy.
- Error equivalence: both halves raising the same class passes; different
  classes, or one half raising, fail; a body whose halves differ fails
  (the helper is not vacuous).
- ``time.trace`` writes a Chrome trace that holds the traced call's ops.
- ``entry(device="cpu")`` returns the pipeline and a CPU volume.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from cupyimg_tpu_torch import graft_entry, testing
from cupyimg_tpu_torch.core.config import config


def _arr(xp, a):
    return torch.from_numpy(a) if xp is torch else a


@testing.numpy_cupyimg_allclose(rtol=1e-6, atol=1e-6, scipy_name="scp")
def _uniform(xp, scp):
    x = _arr(xp, np.random.RandomState(0).rand(16, 12).astype(np.float32))
    return scp.ndimage.uniform_filter(x, 3, mode="nearest")


@testing.numpy_torch_allclose(rtol=1e-12, scipy_name="scp")
def _gaussian_f64(xp, scp):
    x = _arr(xp, np.random.RandomState(1).rand(20, 9))
    return scp.ndimage.gaussian_filter(x, 1.5), scp.ndimage.sobel(x, 0)


@testing.numpy_cupyimg_array_equal(scipy_name="scp")
def _median(xp, scp):
    x = _arr(xp, np.random.RandomState(2).randint(0, 50, (15, 15)).astype(
        np.int32))
    return scp.ndimage.median_filter(x, 3)


@testing.numpy_cupyimg_array_almost_equal(decimal=10, scipy_name="scp")
def _correlate(xp, scp):
    x = _arr(xp, np.random.RandomState(3).rand(10, 11))
    return scp.ndimage.correlate(x, np.arange(9.0).reshape(3, 3))


@testing.numpy_cupyimg_array_max_ulp(maxulp=4, scipy_name="scp")
def _shift(xp, scp):
    x = _arr(xp, np.random.RandomState(4).rand(12, 12))
    return scp.ndimage.shift(x, (0.5, -1.25), order=1)


@testing.numpy_cupyimg_array_almost_equal_nulp(nulp=4, scipy_name="scp")
def _zoom(xp, scp):
    x = _arr(xp, np.random.RandomState(5).rand(8, 8))
    return scp.ndimage.zoom(x, 2, order=1)


@testing.numpy_cupyimg_array_list_equal(scipy_name="scp")
def _label(xp, scp):
    x = _arr(xp, np.random.RandomState(6).rand(16, 16) > 0.5)
    lab, num = scp.ndimage.label(x)
    return lab, int(num)


@testing.numpy_cupyimg_array_less(scipy_name="scp")
def _below(xp, scp):
    # the port's half must come out below numpy's, element-wise
    x = _arr(xp, np.random.RandomState(7).rand(9, 9))
    return scp.ndimage.minimum_filter(x, 3) - (1.0 if xp is torch else 0.0)


@testing.numpy_cupyimg_equal(scipy_name="scp")
def _max(xp, scp):
    x = _arr(xp, np.arange(20.0).reshape(4, 5))
    return scp.ndimage.maximum_filter(x, 3)


@testing.numpy_cupyimg_raises(scipy_name="scp")
def _bad_mode(xp, scp):
    scp.ndimage.uniform_filter(_arr(xp, np.zeros((4, 4))), 3, mode="bogus")


@testing.numpy_cupyimg_allclose(scipy_name="scp", accept_error=ValueError)
def _bad_order(xp, scp):
    return scp.ndimage.gaussian_filter1d(_arr(xp, np.zeros(5)), 1.0,
                                         order=-1)


@pytest.mark.parametrize("body", [_uniform, _gaussian_f64, _median,
                                  _correlate, _shift, _zoom, _label, _below,
                                  _max, _bad_mode, _bad_order],
                         ids=lambda f: f.__name__.strip("_"))
def test_decorators_pass_on_port_calls(body):
    body()


def test_for_dtypes_and_product():
    seen = []

    @testing.for_dtypes([np.float32, np.float64])
    def body(dtype):
        seen.append(dtype)

    body()
    assert seen == [np.float32, np.float64]
    assert testing.product({"a": [1, 2], "b": ["x"]}) == [
        {"a": 1, "b": "x"}, {"a": 2, "b": "x"}]


def test_different_error_classes_fail():
    @testing.numpy_cupyimg_raises()
    def body(xp):
        raise (KeyError if xp is torch else ValueError)("differs")

    with pytest.raises(AssertionError, match="different errors"):
        body()


def test_one_half_raising_fails():
    @testing.numpy_cupyimg_allclose(accept_error=True)
    def body(xp):
        if xp is torch:
            raise ValueError("only the port")
        return np.zeros(3)

    with pytest.raises(AssertionError, match="only one backend raised"):
        body()


def test_unaccepted_error_fails():
    @testing.numpy_cupyimg_allclose()
    def body(xp):
        raise ValueError("both")

    with pytest.raises(AssertionError, match="errors not accepted"):
        body()


def test_halves_that_differ_fail():
    @testing.numpy_cupyimg_allclose(rtol=1e-6)
    def body(xp):
        return xp.ones(4) * (2.0 if xp is torch else 1.0)

    with pytest.raises(AssertionError):
        body()


def test_time_trace_writes_a_chrome_trace(tmp_path):
    from cupyimg_tpu_torch.scipy import ndimage as ndi
    from cupyimg_tpu_torch.time import trace

    with trace(str(tmp_path / "tr")) as log_dir:
        ndi.uniform_filter(torch.rand(32, 32), 5)
    assert log_dir == str(tmp_path / "tr")
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_entry_on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cuda")
    fn, (x,) = graft_entry.entry(device="cpu")
    assert callable(fn)
    assert x.device.type == "cpu" and x.dtype == torch.float32
    assert tuple(x.shape) == (128, 128, 128)
    np.testing.assert_array_equal(
        x[0, 0, :4].numpy(),
        np.random.RandomState(0).randn(128, 128, 128)[0, 0, :4].astype(
            np.float32))
    y = fn(x[:16, :16, :16])
    assert y.shape == (16, 16, 16) and bool(torch.isfinite(y).all())
