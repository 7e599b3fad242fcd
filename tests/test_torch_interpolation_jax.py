"""scipy.ndimage interpolation in the torch port against cupyimg_tpu.

Seven of the ten combinations held against cupyimg_tpu, each a distinct
compiled JAX computation (a jit compile on the CPU costs seconds, so the
order x mode grid runs against scipy in ``test_torch_interpolation.py``,
which holds the other three: the prefilters and
``geometric_transform``).  Between them they cover every public
function; the 2-D affine route and the plane-by-plane volume
``rotate`` (the callers of the TPU kernels B6/B8), the 2-D and 3-D
``map_coordinates`` routes (B7/B9's callers); orders 0, 1, 3 and 5; the
modes constant, nearest, grid-constant, wrap and opencv; and one
knife-edge affine case (exact half-integer and domain-edge coordinates).
Both sides form coordinates in float64 (``coord_precision='f64'``) from
the same numpy inputs: within 1e-10 of the input's range, order 0
exactly.
"""

import numpy as np
import pytest
import torch

import cupyimg_tpu.scipy.ndimage as jndi
from cupyimg_tpu.core.config import config as jax_config
import cupyimg_tpu_torch.scipy.ndimage as tndi
from cupyimg_tpu_torch.core.config import config

X2 = np.random.RandomState(0).rand(12, 10)
X3 = np.random.RandomState(1).rand(4, 12, 10)
C2 = np.random.RandomState(2).uniform(-5, 16, (2, 6, 5))
C3 = np.random.RandomState(3).uniform(-2, 13, (3, 3, 4, 5))


CASES = {
    "affine_transform-2d-order3-constant": (
        X2, lambda nd, x: nd.affine_transform(
            x, [[0.9, 0.3], [-0.2, 1.1]], (1.37, -2.21), (14, 9), order=3,
            mode="constant", cval=0.5)),
    # a knife edge: at output (14, 5) the second coordinate is 0.5 in
    # exact arithmetic and 0.49999999999999956 in float64 summed in
    # scipy's documented order (matrix terms, then offset), on both
    # sides; scipy's C code gets 0.5 there and takes the other sample
    # (test_torch_interpolation.py::test_affine_knife_edge_rounding)
    "affine_transform-knife-edge-order0-nearest": (
        X2, lambda nd, x: nd.affine_transform(
            x, [[0.9, 0.3], [-0.2, 1.1]], (1.5, -2.2), (15, 9), order=0,
            mode="nearest")),
    "rotate-3d-planes-order1-grid-constant": (
        X3, lambda nd, x: nd.rotate(
            x, 17, axes=(1, 2), reshape=False, order=1,
            mode="grid-constant", cval=-0.25)),
    "map_coordinates-2d-order5-wrap": (
        X2, lambda nd, x: nd.map_coordinates(x, _same(nd, C2), order=5,
                                             mode="wrap")),
    "map_coordinates-3d-order1-opencv": (
        X3, lambda nd, x: nd.map_coordinates(x, _same(nd, C3), order=1,
                                             mode="opencv", cval=0.75)),
    "shift-order3-nearest": (
        X2, lambda nd, x: nd.shift(x, (1.3, -2.6), order=3,
                                   mode="nearest")),
    "zoom-order0-constant": (
        X2, lambda nd, x: nd.zoom(x, (1.7, 0.8), order=0, mode="constant",
                                  cval=0.5)),
}


def _same(nd, c):
    return torch.from_numpy(c) if nd is tndi else c


@pytest.fixture
def f64_coordinates(monkeypatch):
    monkeypatch.setattr(jax_config, "coord_precision", "f64")
    monkeypatch.setattr(config, "coord_precision", "f64")


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_cupyimg_tpu(name, f64_coordinates):
    x, call = CASES[name]
    exp = np.asarray(call(jndi, x))
    got = call(tndi, torch.from_numpy(x)).numpy()
    assert got.shape == exp.shape and got.dtype == exp.dtype
    if "order0" in name:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-10)
