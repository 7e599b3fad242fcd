"""``skimage.filters`` and ``skimage.feature.canny`` of the torch port on
CPU tensors.

- skimage's edges, gaussian, median, unsharp-mask, gabor, window, LPI,
  thresholding, ridges and canny suites, with their literal expected
  numbers and synthetic stand-ins for skimage's bundled images.
- Full grids against scipy/numpy definitions: the edge filters over mode
  x axis x rank, ``gaussian`` and ``median`` over mode x dtype, the
  global thresholds against numpy transcriptions of skimage's formulas.
- A named list against ``cupyimg_tpu`` on JAX-CPU (x64): the traceable
  calls of every module that reaches a kernel as one jit program, and
  ``canny`` whole (eager: its hysteresis reads the label count).
- Every float32 call that reaches a kernel on the card runs with torch's
  matmul entry points made to raise (no TF32 can serve it).  The CUDA
  dispatch tests are in ``test_torch_skimage_filters_cuda.py``.

Tolerances: the suites' own; float64 against scipy or ``cupyimg_tpu``
within 1e-12 of max|ref|; float32 within 2e-6 of max|ref| (1e-5 for the
ridge filters, whose eigenvalues square the Hessian's rounding).
"""

import math
import warnings

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch
from scipy.signal import get_window

import jax
import jax.numpy as jnp

from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.scipy import ndimage as tndi
from cupyimg_tpu_torch.skimage import filters
from cupyimg_tpu_torch.skimage import restoration
from cupyimg_tpu_torch.skimage._shared._warnings import expected_warnings
from cupyimg_tpu_torch.skimage.feature import canny
from cupyimg_tpu_torch.skimage.feature._canny import (
    smooth_with_function_and_mask,
)
from cupyimg_tpu_torch.skimage.filters._gabor import _sigma_prefactor
from cupyimg_tpu_torch.skimage.filters._gaussian import (
    _guess_spatial_dimensions,
)
from cupyimg_tpu_torch.skimage.filters.edges import _mask_filter_result
from cupyimg_tpu_torch.skimage.util import img_as_float, invert


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """numpy and list inputs go to the CPU here (the library's default
    device is CUDA)."""
    monkeypatch.setattr(config, "device", "cpu")


def T(x, dtype=None):
    """A CPU tensor of an array-like (a tensor passes through)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=dtype))


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, ref, tol):
    """|got - ref| <= tol * max|ref| (tol itself where ref is all 0)."""
    got, ref = np.asarray(H(got), np.float64), np.asarray(H(ref), np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


assert_allclose = np.testing.assert_allclose


def assert_array_equal(a, b):
    np.testing.assert_array_equal(H(a), H(b))


def _img(shape=(32, 33), seed=0):
    return np.random.RandomState(seed).rand(*shape)


# ---------------------------------------------------------------------------
# skimage's edges suite
# ---------------------------------------------------------------------------

EDGES = ["sobel", "sobel_h", "sobel_v", "scharr", "scharr_h", "scharr_v",
         "prewitt", "prewitt_h", "prewitt_v", "roberts", "roberts_pos_diag",
         "roberts_neg_diag", "farid", "farid_h", "farid_v", "laplace"]


@pytest.mark.parametrize("name", EDGES)
def test_edges_zeros_and_masked_out(name):
    """All zeros stay zero; a mask of all False zeroes any image."""
    fn = getattr(filters, name)
    zeros = fn(torch.zeros((10, 10), dtype=torch.float64),
               mask=torch.ones((10, 10), dtype=torch.bool))
    assert float(torch.abs(zeros).max()) < 1e-16
    masked = fn(T(np.random.default_rng(EDGES.index(name)).uniform(
        size=(10, 10))), mask=torch.zeros((10, 10), dtype=torch.bool))
    assert_array_equal(masked, np.zeros((10, 10)))


def _hv_grids():
    return np.mgrid[-5:6, -5:6]


@pytest.mark.parametrize("name", ["sobel", "scharr", "prewitt"])
@pytest.mark.parametrize("vertical", [False, True])
def test_edges_magnitude_on_a_line(name, vertical):
    """A step's magnitude is 1/sqrt(2) on the step and 0 away from it."""
    i, j = _hv_grids()
    k = j if vertical else i
    result = H(getattr(filters, name)(T((k >= 0).astype(float)))) * np.sqrt(2)
    assert_allclose(result[k == 0], 1)
    assert_allclose(result[np.abs(k) > 1], 0, atol=1e-10)


@pytest.mark.parametrize("vertical", [False, True])
def test_farid_magnitude_on_a_line(vertical):
    i, j = _hv_grids()
    k = j if vertical else i
    result = H(filters.farid(T((k >= 0).astype(float)))) * np.sqrt(2)
    assert np.allclose(result[k == 0], result[k == 0][0])
    assert_allclose(result[np.abs(k) > 2], 0, atol=1e-10)


@pytest.mark.parametrize("name", ["sobel", "scharr", "prewitt", "farid"])
@pytest.mark.parametrize("suffix", ["_h", "_v"])
def test_edges_single_axis_on_lines(name, suffix):
    """The derivative along its axis sees the step across it (1 for the
    3-tap filters, one constant for farid) and nothing of the step along
    it."""
    i, j = _hv_grids()
    across, along = (i, j) if suffix == "_h" else (j, i)
    fn = getattr(filters, name + suffix)
    result = H(fn(T((across >= 0).astype(float))))
    if name == "farid":
        assert np.allclose(result[across == 0], result[across == 0][0])
        assert_allclose(result[np.abs(across) > 2], 0, atol=1e-10)
    else:
        assert_allclose(result[across == 0], 1)
        assert_allclose(result[np.abs(across) > 1], 0, atol=1e-10)
    assert_allclose(H(fn(T((along >= 0).astype(float) * np.sqrt(2)))), 0,
                    atol=1e-10)


def test_roberts_diagonals():
    image = np.tri(10, 10, 0)
    expected = ~(np.tri(10, 10, -1).astype(bool)
                 | np.tri(10, 10, -2).astype(bool).transpose())
    expected[-1, -1] = 0  # 'reflect' and the image's shape
    assert_array_equal(H(filters.roberts(T(image))).astype(bool), expected)
    image = np.rot90(np.tri(10, 10, 0), 3).copy()
    expected = ~np.rot90(np.tri(10, 10, -1).astype(bool)
                         | np.tri(10, 10, -2).astype(bool).transpose())
    expected = _mask_filter_result(T(expected.copy()), None)
    assert_array_equal(H(filters.roberts(T(image))).astype(bool), expected)


def test_laplace_zeros_and_mask():
    image = np.zeros((9, 9))
    image[3:-3, 3:-3] = 1
    check_result = np.array([
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, -1.0, -1.0, -1.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, 2.0, 1.0, 2.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, 1.0, 0.0, 1.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, 2.0, 1.0, 2.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, -1.0, -1.0, -1.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    assert_allclose(H(filters.laplace(T(image))), check_result)
    mask = np.zeros((9, 9), bool)
    mask[2:-2, 2:-2] = True
    # the eroded mask keeps the inner 3x3, where the result holds 1s and 2s
    got = H(filters.laplace(T(image), mask=T(mask)))
    assert_array_equal(got[mask == 0], 0)
    assert_allclose(got, -sndi.laplace(image) * sndi.binary_erosion(
        mask, np.ones((3, 3)), border_value=0))


@pytest.mark.parametrize("name", ["prewitt", "sobel", "scharr"])
@pytest.mark.parametrize("suffix", ["_h", "_v"])
def test_mask_line(name, suffix):
    """The filters mask the pixels around a masked-out line."""
    vgrad, _ = np.mgrid[:1:11j, :1:11j]
    if suffix == "_v":
        vgrad = vgrad.T.copy()
    mask = np.ones_like(vgrad)
    expected = np.zeros_like(vgrad)
    expected[1:-1, 1:-1] = 0.2
    if suffix == "_h":
        vgrad[5, :] = 1
        mask[5, :] = 0
        expected[4:7, 1:-1] = 0
    else:
        vgrad[:, 5] = 1
        mask[:, 5] = 0
        expected[1:-1, 4:7] = 0
    result = getattr(filters, name + suffix)(T(vgrad), T(mask))
    assert_allclose(H(result), expected, atol=1e-10)


# the constant 3x3x3 cubes that maximise each filter's output, embedded in
# a random binary volume (the maximum over any binary image is there)
MAX_SOBEL_0 = np.zeros((3, 3, 3))
MAX_SOBEL_0[2] = 1
MAX_SOBEL_ND = np.array([[[1, 0, 0], [1, 0, 0], [1, 0, 0]],
                         [[1, 0, 0], [1, 1, 0], [1, 1, 0]],
                         [[1, 1, 0], [1, 1, 0], [1, 1, 0]]], float)
MAX_SCHARR_ND = np.array([[[0, 0, 0], [0, 0, 1], [0, 1, 1]],
                          [[0, 0, 1], [0, 1, 1], [0, 1, 1]],
                          [[0, 0, 1], [0, 1, 1], [1, 1, 1]]], float)


def _blobs_with(pattern):
    rng = np.random.default_rng(42)
    vol = (rng.uniform(size=(40, 40, 40)) < 0.3).astype(float)
    vol[13:26, 13:26, 13:26] = 0.0
    vol[18:21, 18:21, 18:21] = pattern
    return T(vol)


@pytest.mark.parametrize(("name", "max_edge"), [
    ("prewitt", MAX_SOBEL_ND), ("sobel", MAX_SOBEL_ND),
    ("scharr", MAX_SCHARR_ND)])
def test_3d_edge_filters(name, max_edge):
    func = getattr(filters, name)
    edges = func(_blobs_with(max_edge))
    assert_allclose(float(edges.max()), float(func(T(max_edge))[1, 1, 1]),
                    rtol=1e-6)
    edges0 = func(_blobs_with(MAX_SOBEL_0), axis=0)
    assert_allclose(float(edges0.max()),
                    float(func(T(MAX_SOBEL_0), axis=0)[1, 1, 1]), rtol=1e-6)


@pytest.mark.parametrize("name", ["sobel", "scharr", "prewitt", "roberts",
                                  "farid"])
def test_edge_range(name):
    out = H(getattr(filters, name)(T(np.random.default_rng(12).random(
        (100, 100)))))
    assert out.min() >= 0 and out.max() <= 1


def test_sobel_on_a_ramp_and_rotation():
    r, _ = np.mgrid[0:16, 0:16]
    x = T(r.astype(np.float64))
    assert_allclose(H(filters.sobel_h(x))[2:-2, 2:-2], 2.0, atol=1e-10)
    assert_allclose(H(filters.sobel_v(x))[2:-2, 2:-2], 0.0, atol=1e-10)
    x = np.zeros((20, 20))
    x[:, 10:] = 1.0
    for name in ("sobel", "scharr", "prewitt", "farid"):
        fn = getattr(filters, name)
        assert_allclose(H(fn(T(x))), H(fn(T(x.T.copy()))).T, atol=1e-12)


SMOOTH = {"sobel": np.array([1, 2, 1]) / 4.0,
          "scharr": np.array([3, 10, 3]) / 16.0,
          "prewitt": np.ones(3) / 3.0,
          "farid": filters.edges.FARID_SMOOTH}
DERIV = {"sobel": np.array([-1.0, 0, 1]), "scharr": np.array([-1.0, 0, 1]),
         "prewitt": np.array([-1.0, 0, 1]), "farid": filters.edges.FARID_EDGE}


def _scipy_edge(x, name, axis, mode):
    """skimage's definition on scipy: the derivative along each axis
    smoothed along the others; over all axes the RMS over ndim."""
    axes = range(x.ndim) if axis is None else [axis % x.ndim]
    total = 0
    for e in axes:
        y = sndi.correlate1d(x, DERIV[name], axis=e, mode=mode)
        for s in range(x.ndim):
            if s != e:
                y = sndi.correlate1d(y, SMOOTH[name], axis=s, mode=mode)
        total = total + (y * y if axis is None else y)
    return np.sqrt(total / x.ndim) if axis is None else total


@pytest.mark.parametrize("name", ["sobel", "scharr", "prewitt", "farid"])
@pytest.mark.parametrize("mode", ["reflect", "constant", "nearest", "mirror",
                                  "wrap"])
@pytest.mark.parametrize("shape", [(13, 17), (6, 7, 8)])
@pytest.mark.parametrize("axis", [None, 0, -1])
def test_edges_match_scipy(name, mode, shape, axis):
    x = np.random.default_rng(len(shape)).random(shape) * 3 - 1
    got = getattr(filters, name)(T(x), axis=axis, mode=mode)
    assert got.dtype == torch.float64
    close(got, _scipy_edge(x, name, axis, mode), 1e-12)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_edges_cast_to_float64(dtype):
    x = (np.random.default_rng(3).random((12, 14)) * 100).astype(dtype)
    x64 = x.astype(np.float64)
    close(filters.sobel(T(x)), _scipy_edge(x64, "sobel", None, "reflect"),
          1e-12)
    close(filters.roberts_pos_diag(T(x)),
          sndi.convolve(x64, [[1, 0], [0, -1]]), 1e-12)
    close(filters.roberts_neg_diag(T(x)),
          sndi.convolve(x64, [[0, 1], [-1, 0]]), 1e-12)
    close(filters.laplace(T(x)), -sndi.laplace(x64), 1e-12)


def test_edges_mask_is_eroded():
    x = _img()
    mask = np.zeros(x.shape, bool)
    mask[8:20, 8:20] = True
    out = H(filters.sobel(T(x), mask=T(mask)))
    eroded = sndi.binary_erosion(mask, np.ones((3, 3)))
    assert (out[~eroded] == 0).all()
    close(out[eroded], _scipy_edge(x, "sobel", None, "reflect")[eroded],
          1e-12)


# ---------------------------------------------------------------------------
# gaussian and difference of gaussians
# ---------------------------------------------------------------------------


def _point_image():
    a = np.zeros((3, 3))
    a[1, 1] = 1.0
    return T(a)


def test_gaussian_sigma_rules():
    a = _point_image()
    for sigma in (-1.0, [-1.0, 1.0], np.asarray([-1.0, 1.0])):
        with pytest.raises(ValueError):
            filters.gaussian(a, sigma=sigma)
    assert_array_equal(filters.gaussian(a, 0), a)
    assert_array_equal(filters.gaussian(a), filters.gaussian(a, sigma=1))
    assert float(filters.gaussian(a, sigma=1, mode="reflect").std()) < float(
        a.std())


def test_gaussian_multichannel():
    a = np.zeros((5, 5, 3))
    a[1, 1] = np.arange(1, 4)
    a = T(a)
    means = [float(a[..., i].mean()) for i in range(3)]
    out = filters.gaussian(a, sigma=1, mode="reflect", multichannel=True)
    assert np.allclose(means, [float(out[..., i].mean()) for i in range(3)])
    with expected_warnings(["multichannel"]):
        out = filters.gaussian(a, sigma=1, mode="reflect")
    assert np.allclose(means, [float(out[..., i].mean()) for i in range(3)])
    out = filters.gaussian(a, sigma=[1, 2], mode="reflect", multichannel=True)
    assert np.allclose(means, [float(out[..., i].mean()) for i in range(3)])


def test_gaussian_range_4d_and_output():
    img = T(np.array([[10.0, -10.0], [-4, 3]], np.float32))
    assert filters.gaussian(img, 1, preserve_range=True).dtype == (
        torch.float32)
    img4 = np.zeros((5,) * 4)
    img4[2, 2, 2, 2] = 1
    assert np.allclose(float(filters.gaussian(T(img4), 1,
                                              mode="reflect").sum()), 1)
    for dtype in (torch.float32, torch.float64):
        image = torch.arange(9, dtype=dtype).reshape(3, 3)
        with pytest.raises(ValueError):
            filters.gaussian(image, sigma=1, output=torch.zeros_like(image),
                             preserve_range=True)
    with pytest.raises(ValueError):
        filters.gaussian(torch.arange(9.0).reshape(3, 3), sigma=1,
                         output=torch.zeros((3, 3), dtype=torch.uint8))
    assert filters.gaussian(T(_img()), 1, output=np.float32).dtype == (
        torch.float32)


def test_guess_spatial_dimensions():
    assert _guess_spatial_dimensions(torch.zeros((5, 5))) == 2
    assert _guess_spatial_dimensions(torch.zeros((5, 5, 5))) == 3
    assert _guess_spatial_dimensions(torch.zeros((5, 5, 3))) is None
    assert _guess_spatial_dimensions(torch.zeros((5, 5, 5, 3))) == 3
    with pytest.raises(ValueError):
        _guess_spatial_dimensions(torch.zeros((5,)))


@pytest.mark.parametrize("mode", ["nearest", "reflect", "constant", "mirror",
                                  "wrap"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_gaussian_matches_scipy(mode, dtype):
    x = _img((14, 17), 4)
    if dtype == np.uint8:
        x = (x * 255).astype(np.uint8)
        ref = sndi.gaussian_filter(x / 255.0, (1.5, 0.7), mode=mode, cval=0.3)
        tol = 1e-12
    else:
        x = x.astype(dtype)
        ref = sndi.gaussian_filter(x.astype(np.float64), (1.5, 0.7),
                                   mode=mode, cval=0.3)
        tol = 2e-6 if dtype == np.float32 else 1e-12
    got = filters.gaussian(T(x), (1.5, 0.7), mode=mode, cval=0.3)
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.float64)
    close(got, ref, tol)


@pytest.mark.parametrize("s", [1, (2, 3)])
@pytest.mark.parametrize("s2", [4, (5, 6), None])
def test_difference_of_gaussians(s, s2):
    x = _img((10, 10))
    image = T(x)
    high = 1.6 * np.array(s) if s2 is None else s2
    want = sndi.gaussian_filter(x, s, mode="nearest") - sndi.gaussian_filter(
        x, high, mode="nearest")
    close(filters.difference_of_gaussians(image, s, s2), want, 1e-12)


def test_difference_of_gaussians_errors():
    with pytest.raises(ValueError):
        filters.difference_of_gaussians(torch.ones((5, 5, 3)), (1, 2))
    with pytest.raises(ValueError):
        filters.difference_of_gaussians(torch.ones((5, 5, 3)), 1, (3, 4))
    with pytest.raises(ValueError):
        filters.difference_of_gaussians(torch.ones((5, 5, 3)), (1, 2, 3),
                                        multichannel=True)
    with pytest.raises(ValueError):
        filters.difference_of_gaussians(torch.ones((3, 3)), 3, 2)
    with pytest.raises(ValueError):
        filters.difference_of_gaussians(torch.ones((3, 3)), (1, 5), (2, 4))


# ---------------------------------------------------------------------------
# median, unsharp mask, rank_order
# ---------------------------------------------------------------------------

MEDIAN_IMAGE = np.array([[1, 2, 3, 2, 1], [1, 1, 2, 2, 3], [3, 2, 1, 2, 1],
                         [3, 2, 1, 1, 1], [1, 2, 1, 2, 3]], dtype=np.uint8)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.float32,
                                   np.float64])
@pytest.mark.parametrize("mode", ["nearest", "reflect", "constant", "mirror",
                                  "wrap"])
def test_median_matches_scipy(dtype, mode):
    x = (_img((11, 13), 5) * 200).astype(dtype)
    got = filters.median(T(x), mode=mode, cval=7)
    assert got.dtype == T(x).dtype
    assert_array_equal(got, sndi.median_filter(
        x, footprint=np.ones((3, 3), bool), mode=mode, cval=7))


def test_median_suite():
    image = T(MEDIAN_IMAGE)
    with warnings.catch_warnings(record=True) as records:
        warnings.simplefilter("always")
        got = filters.median(image, mode="nearest", behavior="ndimage")
    assert len(records) == 0
    assert_array_equal(got, tndi.median_filter(image, size=(3, 3),
                                               mode="nearest"))
    with pytest.warns(UserWarning, match="rank"):
        filters.median(image, behavior="rank")
    selem = T(np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    assert_array_equal(filters.median(image, selem), sndi.median_filter(
        MEDIAN_IMAGE, footprint=H(selem) != 0, mode="nearest"))
    assert filters.median(T(np.zeros((3, 3, 3), np.uint8))).shape == (3, 3, 3)
    assert filters.rank_filter is filters.median


@pytest.mark.parametrize("dtype, top", [
    (np.uint16, False), (np.uint32, False), (np.uint64, False),
    (np.uint32, True), (np.uint64, True)])
@pytest.mark.parametrize("name, kw", [
    ("median_filter", {"size": 3}), ("rank_filter", {"rank": 2, "size": 3}),
    ("percentile_filter", {"percentile": 30, "size": (3, 2)}),
    ("median_filter", {"size": 9}), ("minimum_filter", {"size": 3}),
    ("maximum_filter", {"footprint": np.eye(3)}),
    ("grey_opening", {"size": 3})])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_rank_and_minmax_filters_of_wide_unsigned_images(dtype, name, kw,
                                                         mode, top):
    """uint16/32/64 images (torch has no minimum, maximum or sort of
    them) compute in a signed type that keeps their order, and keep their
    dtype, as scipy's.  ``top`` mixes small values with values just under
    2^32 (uint32) or at and above 2^63 (uint64); these filters depend on
    the order alone, so the reference filters the values' ranks (numpy's
    sort of the type) with scipy and maps them back."""
    rng = np.random.default_rng(8)
    x = (rng.random((9, 11)) * 60000).astype(dtype)
    if top:
        hi = {np.uint32: 2**32 - 60000, np.uint64: 2**63 - 2**40}[dtype]
        x = np.where(rng.random(x.shape) < 0.5, x, x + dtype(hi))
        x.flat[:3] = [2**63, np.iinfo(dtype).max, 2**31] \
            if dtype == np.uint64 else [2**31, np.iinfo(dtype).max, 2**31 - 1]
    values, ranks = np.unique(np.append(x.ravel(), dtype(7)),
                              return_inverse=True)
    rank_img = ranks[:-1].reshape(x.shape)
    got = getattr(tndi, name)(T(x), mode=mode, cval=7, **kw)
    ref = values[getattr(sndi, name)(rank_img, mode=mode, cval=ranks[-1],
                                     **kw)]
    assert got.dtype == T(x).dtype
    assert_array_equal(got, ref)


@pytest.mark.parametrize("shape, multichannel", [
    ((29,), False), ((40, 4), True), ((32, 32), False), ((29, 31, 3), True),
    ((13, 17, 4, 8), False)])
def test_unsharp_masking_output_type_and_shape(shape, multichannel):
    rng = np.random.RandomState(0)
    for dtype in [np.uint8, np.int8, np.uint16, np.int16, np.uint32,
                  np.int32, np.uint64, np.int64, np.float32, np.float64]:
        for radius, amount, offset, preserve in [
                (0, 0.0, -1.0, False), (0.1, 0.5, 0.0, True),
                (2.0, 2.0, 1.0, False), (2.0, -1.0, -1.0, True)]:
            array = ((rng.random_sample(shape) + offset) * 128).astype(dtype)
            if preserve is False and dtype in [np.float32, np.float64]:
                array = array / max(np.abs(array).max(), 1.0)
            output = filters.unsharp_mask(T(array), radius, amount,
                                          multichannel, preserve)
            assert output.dtype in (torch.float32, torch.float64)
            assert tuple(output.shape) == shape


@pytest.mark.parametrize("shape, multichannel", [
    ((16, 16), False), ((15, 15, 2), True), ((13, 17, 3), True)])
@pytest.mark.parametrize("offset", [-5, 0, 5])
@pytest.mark.parametrize("preserve", [False, True])
def test_unsharp_masking_ranges_match_a_definition(shape, multichannel,
                                                   offset, preserve):
    """skimage's definition on scipy: x + amount * (x - gaussian(x)) per
    channel, clipped unless preserve_range."""
    array = (np.random.RandomState(0).random_sample(shape) * 5
             + offset).astype(np.int16)
    out = filters.unsharp_mask(T(array), 2.0, 1.0, multichannel, preserve)
    f = array.astype(np.float64) if preserve else H(img_as_float(T(array)))
    sig = (2.0, 2.0, 0) if multichannel else 2.0
    want = f + (f - sndi.gaussian_filter(f, sig, mode="nearest"))
    if not preserve:
        want = np.clip(want, -1.0 if f.min() < 0 else 0.0, 1.0)
    close(out, want, 1e-12)


def test_unsharp_mask_float32_stays_float32():
    x = sndi.gaussian_filter(_img((40, 40), 2), 2).astype(np.float32)
    out = filters.unsharp_mask(T(x), radius=2, amount=1.0)
    assert out.dtype == torch.float32
    assert float(out.std()) > x.std()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.float32,
                                   np.float64])
def test_rank_order_matches_numpy(dtype):
    x = (np.random.default_rng(7).random((9, 11)) * 20).astype(dtype)
    labels, values = filters.rank_order(T(x))
    uniq, inverse = np.unique(x, return_inverse=True)
    assert labels.dtype == torch.uint32
    assert_array_equal(labels.to(torch.int64), inverse.reshape(x.shape))
    assert_array_equal(values, uniq)
    assert values.dtype == T(x).dtype
    labels, values = filters.rank_order(torch.zeros((0,)))
    assert labels.shape == (0,) and values.shape == (0,)


# ---------------------------------------------------------------------------
# gabor, window, LPI filters
# ---------------------------------------------------------------------------


def test_gabor_kernel_sizes_and_prefactor():
    kernel = filters.gabor_kernel(0, theta=0, sigma_x=5, sigma_y=10)
    assert kernel.shape == (61, 31) and kernel.dtype == torch.complex128
    assert filters.gabor_kernel(0, theta=np.pi / 2, sigma_x=5,
                                sigma_y=10).shape == (31, 61)
    assert filters.gabor_kernel(1, bandwidth=1).shape == (5, 5)
    assert filters.gabor_kernel(1, bandwidth=0.5).shape == (9, 9)
    assert filters.gabor_kernel(0.5, bandwidth=1).shape == (9, 9)
    np.testing.assert_almost_equal(_sigma_prefactor(1), 0.56, 2)
    np.testing.assert_almost_equal(_sigma_prefactor(0.5), 1.09, 2)
    assert abs(complex(H(filters.gabor_kernel(0.1)).sum()).imag) < 1e-8


def test_gabor_kernel_sum_and_theta():
    for sigma_x in range(1, 10, 4):
        for sigma_y in range(1, 10, 4):
            for frequency in range(0, 10, 4):
                kernel = filters.gabor_kernel(frequency + 0.1, theta=0,
                                              sigma_x=sigma_x,
                                              sigma_y=sigma_y)
                np.testing.assert_almost_equal(
                    float(torch.abs(kernel).sum()), 1, 2)
                for theta in range(0, 10, 4):
                    k0 = filters.gabor_kernel(frequency + 0.1, theta=theta,
                                              sigma_x=sigma_x,
                                              sigma_y=sigma_y)
                    k180 = filters.gabor_kernel(frequency, theta=theta + np.pi,
                                                sigma_x=sigma_x,
                                                sigma_y=sigma_y)
                    np.testing.assert_array_almost_equal(
                        np.abs(H(k0)), np.abs(H(k180)))


def test_gabor_kernel_matches_a_definition():
    """The published formula, in numpy."""
    f, theta, sx, sy, off = 0.2, 0.7, 2.5, 1.5, 0.3
    k = H(filters.gabor_kernel(f, theta, sigma_x=sx, sigma_y=sy, offset=off))
    n0, n1 = k.shape
    y, x = np.mgrid[-(n0 // 2):n0 // 2 + 1, -(n1 // 2):n1 // 2 + 1]
    rotx = x * math.cos(theta) + y * math.sin(theta)
    roty = -x * math.sin(theta) + y * math.cos(theta)
    g = np.exp(-0.5 * (rotx ** 2 / sx ** 2 + roty ** 2 / sy ** 2)) / (
        2 * np.pi * sx * sy)
    assert_allclose(k, g * np.exp(1j * (2 * np.pi * f * rotx + off)),
                    atol=1e-15)


@pytest.mark.parametrize("mode", ["reflect", "constant", "wrap"])
def test_gabor_matches_scipy(mode):
    x = _img((20, 23), 6).astype(np.float32)
    real, imag = filters.gabor(T(x), 0.15, theta=0.4, mode=mode, cval=0.2)
    k = H(filters.gabor_kernel(0.15, theta=0.4))
    x64 = x.astype(np.float64)
    close(real, sndi.convolve(x64, k.real, mode=mode, cval=0.2), 1e-12)
    close(imag, sndi.convolve(x64, k.imag, mode=mode, cval=0.2), 1e-12)
    assert real.dtype == imag.dtype == torch.float64


def test_gabor_selects_frequencies():
    Y, X = np.mgrid[:40, :40]
    frequencies = (0.1, 0.3)
    waves = [T(np.sin(2 * np.pi * X * f)) for f in frequencies]

    def score(image, f):
        return float(torch.mean(torch.hypot(*filters.gabor(image, f))))

    r = np.array([[score(w, f) for f in frequencies] for w in waves])
    assert r[0, 0] > r[0, 1] and r[1, 1] > r[0, 1]
    assert r[0, 0] > r[1, 0] and r[1, 1] > r[1, 0]


def _window_reference(window_type, shape, order=1):
    """skimage's construction on scipy: the 1-d window sampled at each
    point's (float32) distance from the centre."""
    max_size = max(shape)
    w = get_window(window_type, max_size, fftbins=False)
    center = max_size / 2 - 0.5
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32) * np.float32(
        max_size / s) - np.float32(center) for s in shape], indexing="ij",
        sparse=True)
    dist = np.sqrt(sum(g * g for g in grids)) + np.float32(center)
    return sndi.map_coordinates(w, dist[None].astype(np.float64), order=order,
                                mode="constant")


@pytest.mark.parametrize("window_type", ["hann", ("tukey", 0.8), 16,
                                         "triang"])
@pytest.mark.parametrize("shape", [(16,), (17, 17), (8, 16), (2, 3, 4),
                                   (5, 6, 5, 6)])
def test_window_matches_scipy(window_type, shape):
    got = filters.window(window_type, shape)
    assert got.dtype == torch.float64 and tuple(got.shape) == shape
    close(got, _window_reference(window_type, shape), 1e-6)


@pytest.mark.parametrize("size", [10, 11, 16])
def test_window_1d_is_the_scipy_window(size):
    assert_allclose(H(filters.window("hann", size)),
                    get_window("hann", size, fftbins=False), atol=1e-6)


def test_window_suite():
    w = H(filters.window("hann", (17, 17)))
    assert w[8, 8] == pytest.approx(1.0, abs=1e-6)
    assert_allclose(w, w.T, atol=1e-10)
    for size in (5, 6):
        for ndim in (2, 3, 4):
            w = H(filters.window("hann", (size,) * ndim))
            for i in range(1, ndim - 1):
                assert_allclose(w.sum(axis=0), w.sum(axis=i), atol=1e-6)
    for shape in [(17, 33), (17, 97)]:
        w = H(filters.window(("tukey", 0.8), shape))
        assert abs(w[w.shape[0] // 2, :].mean()
                   - w[:, w.shape[1] // 2].mean()) < 0.01
    with pytest.raises(ValueError):
        filters.window(10, shape=(-5, 10))
    with pytest.raises(ValueError):
        filters.window(10, shape=(1.3, 2.0))
    with pytest.raises(TypeError):
        filters.window("hann", (5, 5), warp_kwargs={"clip": True})
    assert_allclose(H(filters.window("hann", (9, 9),
                                     warp_kwargs={"order": 3})),
                    _window_reference("hann", (9, 9), order=3), atol=1e-6)


def _lpi_image():
    yy, xx = np.mgrid[0:50, 0:50]
    return T((128 + 60 * np.sin(yy / 4.0) + 50 * np.cos(xx / 5.0)).astype(
        np.float64))


def _filt_func(r, c):
    return torch.exp(-torch.hypot(r, c) / 1)


def test_lpi_filter_suite():
    img = _lpi_image()
    f = filters.LPIFilter2D(_filt_func)
    for cols in (50, 45, 30):
        x = img[:, :cols]
        assert f(x).shape == x.shape
    F = f(img)
    flip = F.flip((0, 1))
    g = filters.inverse(F, predefined_filter=f)
    assert g.shape == img.shape
    for _ in range(2):  # the second call reads the cache
        g1 = filters.inverse(flip, predefined_filter=f)
        assert float((g - g1.flip((0, 1))).sum()) < 55
    g1 = filters.inverse(flip, _filt_func)
    assert float((g - g1.flip((0, 1))).sum()) < 55
    g = filters.wiener(F, predefined_filter=f)
    assert g.shape == img.shape
    g1 = filters.wiener(flip, predefined_filter=f)
    assert float((g - g1.flip((0, 1))).sum()) < 20
    g1 = filters.wiener(flip, _filt_func)
    assert float((g - g1.flip((0, 1))).sum()) < 20
    with pytest.raises(ValueError):
        filters.LPIFilter2D(None)
    with pytest.raises(ValueError):
        filters.wiener(F, _filt_func, K=1)
    assert filters.forward is filters.filter_forward


def test_lpi_filters_match_numpy_fft():
    """The forward, inverse and Wiener filters against numpy's FFT of the
    same (2n - 1)-padded grid."""
    x = H(_lpi_image())[:20, :17]
    oshape = (39, 33)
    r, c = np.mgrid[0:21.0, 0:17.0]
    r -= 10
    c -= 8
    f = np.exp(-np.hypot(r, c))
    Fp = np.zeros(oshape)
    Fp[:21, :17] = f
    Gp = np.zeros(oshape)
    Gp[:20, :17] = x
    F, G = np.fft.fftn(Fp), np.fft.fftn(Gp)
    eps = np.finfo(float).eps

    def center(a):
        return a[10:30, 9:26]

    got = filters.filter_forward(T(x), _filt_func)
    close(got, center(np.fft.ifftn(F * G).real), 1e-12)
    Fm = np.where(np.abs(F) < eps, np.sign(F) * eps + (F == 0) * eps, F)
    inv = np.conj(Fm) / np.abs(Fm) ** 2
    inv = np.where(np.abs(inv) > 2, inv / np.abs(inv) * 2, inv)
    close(filters.inverse(T(x), _filt_func),
          center(np.fft.ifftn(G * inv).real), 1e-10)
    H2 = np.abs(Fm) ** 2
    close(filters.wiener(T(x), _filt_func, K=0.1),
          center(np.fft.ifftn(G * (1 / Fm * H2 / (H2 + 0.1))).real), 1e-10)


# ---------------------------------------------------------------------------
# skimage's thresholding suite
# ---------------------------------------------------------------------------

IMAGE = np.array([[0, 0, 1, 3, 5], [0, 1, 4, 3, 4], [1, 2, 5, 4, 1],
                  [2, 4, 5, 2, 1], [4, 5, 1, 0, 0]], dtype=np.int64)


def test_simple_image_global_thresholds():
    img = T(IMAGE)
    with pytest.raises(RuntimeError):
        filters.threshold_minimum(img)
    assert float(filters.threshold_otsu(img)) == 2
    assert float(filters.threshold_otsu(img - 2)) == 0
    assert 2 <= float(filters.threshold_otsu(img.double())) < 3
    assert 2 < float(filters.threshold_li(img)) < 3
    assert 0 < float(filters.threshold_li(img - 2)) < 1
    assert 2 < float(filters.threshold_li(img.double())) < 3
    assert float(filters.threshold_li(torch.ones((10, 10)))) == 1.0
    assert float(filters.threshold_yen(img)) == 2
    assert float(filters.threshold_yen(img - 2)) == 0
    assert 2 <= float(filters.threshold_yen(img.double())) < 3
    assert float(filters.threshold_yen(torch.arange(256))) == 127
    binary = np.zeros([2, 256], dtype=np.uint8)
    binary[0] = 255
    assert float(filters.threshold_yen(T(binary))) < 1
    assert float(filters.threshold_yen(torch.zeros((5, 5),
                                                   dtype=torch.uint8))) == 0
    assert float(filters.threshold_yen(torch.full((5, 5), 255,
                                                  dtype=torch.uint8))) == 255
    assert float(filters.threshold_isodata(img)) == 2
    assert_array_equal(filters.threshold_isodata(img, return_all=True), [2])
    blank = torch.zeros((5, 5), dtype=torch.uint8)
    assert float(filters.threshold_isodata(blank)) == 0
    assert_array_equal(filters.threshold_isodata(blank, return_all=True), [0])
    lin = torch.linspace(-127, 0, 256, dtype=torch.float64)
    assert -63.8 < float(filters.threshold_isodata(lin)) < -63.6
    np.testing.assert_array_almost_equal(
        H(filters.threshold_isodata(lin, return_all=True)),
        [-63.74804688, -63.25195312])
    imfloat = T(np.random.RandomState(0).rand(256, 256))
    assert 0.49 < float(filters.threshold_isodata(imfloat, nbins=1024)) < 0.51
    assert np.all(H(filters.threshold_isodata(imfloat, nbins=1024,
                                              return_all=True)) > 0.49)


LOCAL_REF = {
    "gaussian": [[0, 0, 0, 0, 1], [0, 0, 1, 0, 1], [0, 0, 1, 1, 0],
                 [0, 1, 1, 0, 0], [1, 1, 0, 0, 0]],
    "median": [[0, 0, 0, 0, 1], [0, 0, 1, 0, 0], [0, 0, 1, 0, 0],
               [0, 0, 1, 1, 0], [0, 1, 0, 0, 0]],
    "niblack": [[0, 0, 0, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 1, 0],
                [0, 1, 1, 1, 1], [1, 1, 0, 0, 0]],
    "sauvola": [[0, 0, 0, 1, 1], [0, 0, 1, 1, 1], [0, 0, 1, 1, 0],
                [0, 1, 1, 1, 0], [1, 1, 0, 0, 0]],
    "niblack35": [[0, 0, 0, 1, 1], [0, 0, 1, 1, 1], [0, 1, 1, 1, 0],
                  [0, 1, 1, 1, 0], [1, 1, 0, 0, 0]],
}


def test_simple_image_local_thresholds():
    img = T(IMAGE)

    def check(out, key):
        assert_array_equal(H(img) > H(out), np.array(LOCAL_REF[key], bool))

    check(filters.threshold_local(img, 3, method="gaussian"), "gaussian")
    check(filters.threshold_local(img, 3, method="gaussian",
                                  param=1.0 / 3.0), "gaussian")
    check(filters.threshold_local(img, 3, method="mean"), "gaussian")
    check(filters.threshold_local(img, 3, method="median"), "median")
    check(filters.threshold_niblack(img, window_size=3, k=0.5), "niblack")
    check(filters.threshold_sauvola(img, window_size=3, k=0.2, r=128),
          "sauvola")
    check(filters.threshold_niblack(img, window_size=[3, 5], k=0.5),
          "niblack35")
    check(filters.threshold_sauvola(img, window_size=(3, 5), k=0.2, r=128),
          "sauvola")
    out = filters.threshold_local(img, 3, method="median", mode="constant",
                                  cval=20)
    assert_array_equal(out, [[20.0, 1.0, 3.0, 4.0, 20.0],
                             [1.0, 1.0, 3.0, 4.0, 4.0],
                             [2.0, 2.0, 4.0, 4.0, 4.0],
                             [4.0, 4.0, 4.0, 1.0, 2.0],
                             [20.0, 5.0, 5.0, 2.0, 20.0]])
    with pytest.raises(ValueError):
        filters.threshold_local(torch.zeros((16, 16)), block_size=4)
    with pytest.raises(ValueError):
        filters.threshold_local(img, 3, method="nope")
    value = 0.03082192 + 2.19178082e-09
    src = torch.full((4, 4), value, dtype=torch.float64)
    assert not bool(torch.isnan(filters.threshold_niblack(src)).any())


def test_li_edge_cases():
    nan = float("nan")
    inf = float("inf")
    assert np.isnan(float(filters.threshold_li(torch.full((5, 5), nan))))
    assert float(filters.threshold_li(T([inf, nan]))) == np.inf
    assert float(filters.threshold_li(T([inf, -inf]))) == 0
    assert float(filters.threshold_li(T([8, 8, 8, 8, nan]))) == 8
    with pytest.raises(ValueError):
        filters.threshold_li(torch.arange(25.0).reshape(5, 5),
                             initial_guess=-5)
    arrays = [[0, 0, 1, 0, 0, 1, 0, 1], [0, 0, 0.1, 0, 0, 0.1, 0, 0.1],
              [0, 0, 0.1, 0, 0, 0.1, 0.01, 0.1], [0, 0, 1, 0, 0, 1, 0.5, 1],
              [1, 1], [1, 2]]
    assert np.all(np.isfinite([filters.threshold_li(T(a)) for a in arrays]))
    seen = []
    t = filters.threshold_li(T(_img()), initial_guess=lambda a: a.mean(),
                             iter_callback=seen.append)
    assert len(seen) >= 2 and seen[-1] == t
    assert 0.3 < filters.threshold_li(T(_img()), initial_guess=0.4) < 0.6


def test_one_colour_images_minimum_and_mean():
    assert float(filters.threshold_otsu(torch.ones((10, 10),
                                                   dtype=torch.uint8))) == 1
    assert float(filters.threshold_otsu(torch.ones((10, 10, 10),
                                                   dtype=torch.uint8))) == 1
    img = np.arange(25 * 25, dtype=np.uint8).reshape((25, 25))
    img[0:9, :] = 50
    img[14:25, :] = 250
    assert float(filters.threshold_minimum(T(img))) == 95
    with pytest.raises(RuntimeError):
        filters.threshold_minimum(torch.zeros(256, dtype=torch.uint8))
    img = np.zeros((2, 6))
    img[:, 2:4] = 1
    img[:, 4:] = 2
    assert float(filters.threshold_mean(T(img))) == 1.0
    assert float(filters.threshold_mean(T(IMAGE))) == IMAGE.mean()


def _bimodal(seed, n0=2000, n1=6000):
    rng = np.random.RandomState(seed)
    img = np.concatenate([rng.normal(60, 8, n0), rng.normal(190, 12, n1)])
    return np.clip(img, 0, 255).astype(np.uint8)


def test_triangle_and_multiotsu_suite():
    img = _bimodal(0)
    t = float(filters.threshold_triangle(T(img)))
    assert 60 < t < 190
    assert 60 < 255 - float(filters.threshold_triangle(T(255 - img))) < 190
    image = 0.25 * T(np.tile(np.arange(5.0), (4, 1)))
    for classes in range(3, 6):
        assert len(filters.threshold_multiotsu(image, classes=classes)) == (
            classes - 1)
    image = np.zeros((100, 100), dtype="int")
    for (r, c), val in zip([(25, 25), (50, 50), (75, 75)], [64, 128, 192]):
        image[r - 14:r + 14, c - 14:c + 14] = val
    assert_array_equal(filters.threshold_multiotsu(T(image), classes=4),
                       [0, 64, 128])
    img1 = np.ones((10, 10), np.uint8)
    for cut, classes in ((None, 2), (3, 3), (6, 4)):
        if cut is not None:
            img1[:, cut:] = classes - 1
        with pytest.raises(ValueError):
            filters.threshold_multiotsu(T(img1), classes=classes)
    img = T(_bimodal(1, 3000, 5000))
    assert float(filters.threshold_otsu(img)) == float(
        filters.threshold_multiotsu(img, 2)[0])


def _np_histogram(x, nbins=256):
    counts, edges = np.histogram(x.ravel(), nbins)
    return counts.astype(np.float64), (edges[:-1] + edges[1:]) / 2


def _np_otsu(x):
    counts, centers = _np_histogram(x)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / np.where(w1 == 0, 1, w1)
    m2 = (np.cumsum((counts * centers)[::-1])
          / np.maximum(np.cumsum(counts[::-1]), 1))[::-1]
    return centers[:-1][np.argmax(w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2)]


def _np_yen(x):
    counts, centers = _np_histogram(x)
    pmf = counts / counts.sum()
    P1 = np.cumsum(pmf)
    P1_sq = np.cumsum(pmf ** 2)
    P2_sq = np.cumsum(pmf[::-1] ** 2)[::-1]
    crit = np.log(((P1_sq[:-1] * P2_sq[1:]) ** -1) * (P1[:-1] * (
        1.0 - P1[:-1])) ** 2)
    return centers[np.argmax(crit)]


def _np_isodata(x):
    counts, centers = _np_histogram(x)
    csuml = np.cumsum(counts)
    csumh = np.cumsum(counts[::-1])[::-1] - counts
    intensity = counts * centers
    csum_i = np.cumsum(intensity)
    lower = csum_i[:-1] / csuml[:-1]
    higher = (csum_i[-1] - csum_i[:-1]) / csumh[:-1]
    all_mean = (lower + higher) / 2.0
    d = all_mean - centers[:-1]
    return centers[:-1][(d >= 0) & (d < centers[1] - centers[0])]


@pytest.mark.parametrize("seed", range(6))
def test_global_thresholds_match_numpy(seed):
    """otsu, yen and isodata against numpy transcriptions of skimage's
    formulas, li against its fixed point, on bimodal float images."""
    rng = np.random.RandomState(80 + seed)
    x = np.concatenate([rng.normal(0.3, 0.05, 300 + 40 * seed),
                        rng.normal(0.7, 0.08, 500)])
    x = x.reshape(-1, 20) if x.size % 20 == 0 else x
    t = T(x)
    assert_allclose(float(filters.threshold_otsu(t)), _np_otsu(x),
                    rtol=1e-12)
    assert_allclose(float(filters.threshold_yen(t)), _np_yen(x), rtol=1e-12)
    assert_allclose(H(filters.threshold_isodata(t, return_all=True)),
                    _np_isodata(x), rtol=1e-12)
    # li's fixed point, on the image shifted to start at 0
    li = filters.threshold_li(t, tolerance=1e-12)
    xs = x - x.min()
    fore, back = xs[xs > li - x.min()].mean(), xs[xs <= li - x.min()].mean()
    assert_allclose(li - x.min(),
                    (back - fore) / (np.log(back) - np.log(fore)), rtol=1e-9)
    for name in ("threshold_otsu", "threshold_yen", "threshold_isodata",
                 "threshold_li", "threshold_minimum", "threshold_triangle"):
        assert 0.3 < float(getattr(filters, name)(t)) < 0.7, name


def test_thresholds_from_a_histogram():
    """A histogram over the image's range gives the image's thresholds;
    counts alone index their bins from 0."""
    x = _bimodal(2)
    lo = int(x.min())
    counts = np.bincount(x.ravel() - lo)
    centers = np.arange(lo, lo + counts.size)
    for name in ("threshold_otsu", "threshold_yen", "threshold_isodata"):
        fn = getattr(filters, name)
        want = float(fn(T(x)))
        assert float(fn(hist=(T(counts), T(centers)))) == want
        assert float(fn(hist=T(counts))) == want - lo
    with pytest.raises(Exception):
        filters.threshold_otsu()


def test_threshold_multiotsu_three_classes_and_local_means():
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.normal(0.15, 0.03, 400),
                        rng.normal(0.5, 0.03, 400),
                        rng.normal(0.85, 0.03, 400)])
    t = H(filters.threshold_multiotsu(T(x.reshape(30, 40))))
    assert t.shape == (2,) and 0.2 < t[0] < 0.45 and 0.55 < t[1] < 0.8
    x = _img()
    close(filters.threshold_niblack(T(x), window_size=7, k=0),
          sndi.uniform_filter(x, 7, mode="mirror"), 1e-12)
    close(filters.threshold_local(T(x), 7, method="mean"),
          sndi.uniform_filter(x, 7, mode="reflect"), 1e-12)
    m = sndi.uniform_filter(x, 7, mode="mirror")
    s = np.sqrt(np.maximum(sndi.uniform_filter(x * x, 7, mode="mirror")
                           - m * m, 0))
    r = 0.5 * (x.max() - x.min())
    close(filters.threshold_sauvola(T(x), window_size=7),
          m * (1 + 0.2 * (s / r - 1)), 1e-12)
    close(filters.threshold_local(T(x), 5, offset=0.1),
          sndi.gaussian_filter(x, 4 / 6.0, mode="reflect") - 0.1, 1e-12)


def test_threshold_local_generic_takes_a_torch_function():
    x = np.random.RandomState(0).rand(24, 25)
    got = filters.threshold_local(T(x), 5, method="generic",
                                  param=lambda v: torch.mean(v), offset=0.01)
    ref = filters.threshold_local(T(x), 5, method="mean", offset=0.01)
    close(got, ref, 1e-12)
    x = np.random.RandomState(1).rand(16, 18)
    got = filters.threshold_local(T(x), 3, method="generic",
                                  param=lambda v: v.max() - v.min())
    close(got, sndi.generic_filter(x, lambda v: v.max() - v.min(),
                                   size=(3, 3), mode="reflect"), 1e-12)
    with pytest.raises(ValueError):
        filters.threshold_local(torch.zeros((8, 8)), 3, method="generic",
                                param=3)


def test_apply_hysteresis_threshold():
    x = T(np.array([[0.0, 0.4, 0.9, 0.4, 0.0, 0.4, 0.0]]))
    assert_array_equal(filters.apply_hysteresis_threshold(x, 0.3, 0.8),
                       [[False, True, True, True, False, False, False]])
    img = _img((30, 31), 9)
    low, high = 0.45, 0.9
    lab, _ = sndi.label(img > low)
    keep = np.unique(lab[img > high])
    want = np.isin(lab, keep[keep > 0])
    assert_array_equal(filters.apply_hysteresis_threshold(T(img), low, high),
                       want)
    # a low threshold above the high one is clipped to it
    assert_array_equal(filters.apply_hysteresis_threshold(T(img), 2.0, high),
                       img > high)


# ---------------------------------------------------------------------------
# skimage's ridges suite
# ---------------------------------------------------------------------------


def _camera_like(shape=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(shape[0] // 4 + 2, shape[1] // 4 + 2))
    up = np.kron(base, np.ones((4, 4)))[:shape[0], :shape[1]]
    return T((up * 200 + 20).astype(np.uint8))


def _ridges(image, black, **kw):
    return [filters.meijering(image, black_ridges=black, **kw),
            filters.sato(image, black_ridges=black, mode="reflect", **kw),
            filters.frangi(image, black_ridges=black, **kw),
            filters.hessian(image, black_ridges=black, mode="reflect", **kw)]


@pytest.mark.parametrize("ndim", [2, 3])
def test_ridges_null_matrix_and_linearity(ndim):
    a_black = torch.zeros((3,) * ndim, dtype=torch.uint8)
    a_white = invert(a_black)
    zeros, ones = np.zeros((3,) * ndim), np.ones((3,) * ndim)
    for image, black in ((a_black, True), (a_white, False)):
        m, s, f, _ = _ridges(image, black)
        assert_allclose(H(m), zeros, atol=0 if ndim == 2 else 1e-1)
        assert_array_equal(s, zeros)
        assert_allclose(H(f), zeros, atol=1e-3)
    assert_array_equal(filters.hessian(a_black, black_ridges=False,
                                       mode="reflect"), ones)
    assert_array_equal(filters.hessian(a_white, black_ridges=True,
                                       mode="reflect"), ones)
    a_black = torch.ones((3,) * ndim, dtype=torch.uint8)
    a_white = invert(a_black)
    for image, black in ((a_black, True), (a_white, False)):
        for r1, r10 in zip(_ridges(1 * image, black),
                           _ridges(10 * image, black)):
            assert_allclose(H(r1), H(r10), atol=1e-3)


@pytest.mark.parametrize("ndim", [2, 3])
def test_ridges_energy_decrease(ndim):
    a_black = np.zeros((5,) * ndim, dtype=np.uint8)
    a_black[(2,) * ndim] = 255
    a_black = T(a_black)
    a_white = invert(a_black)

    def std(x):
        return float(torch.std(x.to(torch.float64), unbiased=False))

    for image, black in ((a_black, True), (a_white, False)):
        for r in _ridges(image, black):
            assert std(r) < std(image)


@pytest.mark.parametrize("stack", [False, True])
def test_ridges_cropped_camera(stack):
    a_2d = _camera_like(seed=2 if stack else 1)
    a_black = torch.stack([a_2d] * 3, dim=-1) if stack else a_2d
    a_white = invert(a_black)
    zeros, ones = np.zeros(a_black.shape), np.ones(a_black.shape)
    assert_allclose(H(filters.meijering(a_black, black_ridges=True)),
                    H(filters.meijering(a_white, black_ridges=False)),
                    atol=1e-5)
    assert_allclose(H(filters.sato(a_black, black_ridges=True,
                                   mode="reflect")),
                    H(filters.sato(a_white, black_ridges=False,
                                   mode="reflect")), atol=1e-5)
    assert_allclose(H(filters.frangi(a_black, black_ridges=True)), zeros,
                    atol=1e-3)
    assert_allclose(H(filters.frangi(a_white, black_ridges=False)), zeros,
                    atol=1e-3)
    assert_allclose(H(filters.hessian(a_black, black_ridges=True,
                                      mode="reflect")), ones, atol=1 - 1e-7)


def _retina_like(shape=(200, 200), seed=3):
    rng = np.random.default_rng(seed)
    return T(sndi.gaussian_filter(rng.uniform(size=shape), 3.0, mode="wrap"))


@pytest.mark.parametrize("name, tol", [("frangi", 1e-7), ("meijering", 5e-2),
                                       ("sato", 1e-3), ("hessian", 5e-2)])
def test_ridges_border_management(name, tol):
    out = H(getattr(filters, name)(_retina_like(), sigmas=[1],
                                   mode="reflect"))
    border = np.stack([out[:4, :].T, out[-4:, :].T, out[:, :4], out[:, -4:]])
    inside = out[4:-4, 4:-4]
    for a, b in ((out, inside), (out, border), (inside, border)):
        assert abs(a.std() - b.std()) < tol
        assert abs(a.mean() - b.mean()) < tol


@pytest.mark.parametrize("name", ["sato", "hessian"])
def test_ridges_border_warning(name):
    with pytest.warns(FutureWarning, match="implicitly used 'constant'"):
        getattr(filters, name)(_retina_like((40, 40), seed=4), sigmas=[1])


def test_ridges_on_a_line_and_scale_range():
    x = np.zeros((40, 40))
    x[20, 5:35] = 1.0
    x = T(sndi.gaussian_filter(x, 1))
    for name in ("meijering", "sato", "frangi"):
        kw = {"mode": "reflect"} if name == "sato" else {}
        out = H(getattr(filters, name)(x, sigmas=[1, 2], black_ridges=False,
                                       **kw))
        assert out[20, 10:30].mean() > 5 * (out[5, 10:30].mean() + 1e-12)
    out = H(filters.hessian(x, sigmas=[1], black_ridges=False,
                            mode="reflect"))
    assert (out[0:5] == 1.0).all()
    with pytest.warns(UserWarning, match="sigmas"):
        legacy = filters.frangi(x, scale_range=(1, 3), scale_step=1)
    assert_array_equal(legacy, filters.frangi(x, sigmas=[1, 2]))
    with pytest.raises(ValueError):
        filters.frangi(x, sigmas=[-1])


def test_hessian_eigenvalues_match_numpy():
    """The sigma^2-scaled Hessian's eigenvalues against numpy's eigvalsh
    of the same elements, sorted as asked."""
    x = _img((12, 13), 11)
    ev = filters.compute_hessian_eigenvalues(T(x), 1.5, sorting="val",
                                             mode="reflect")
    g = sndi.gaussian_filter(x, 1.5, mode="reflect")
    gr, gc = np.gradient(g)
    hrr, hrc = np.gradient(gr)
    _, hcc = np.gradient(gc)
    M = np.stack([np.stack([hrr, hrc], -1), np.stack([hrc, hcc], -1)], -2)
    want = np.moveaxis(np.linalg.eigvalsh(M * 2.25), -1, 0)
    close(ev, want, 1e-12)
    ev = H(filters.compute_hessian_eigenvalues(T(x), 1.5, sorting="abs",
                                               mode="reflect"))
    assert (np.abs(ev[0]) <= np.abs(ev[1])).all()


# ---------------------------------------------------------------------------
# skimage's canny suite
# ---------------------------------------------------------------------------


def _ring(noise_seed=None):
    i, j = np.mgrid[-200:200, -200:200].astype(float) / 200
    c = np.abs(np.sqrt(i * i + j * j) - 0.5) < 0.02
    if noise_seed is None:
        return c, c.astype(float)
    rs = np.random.RandomState(noise_seed)
    return c, c.astype(float) * 0.5 + rs.uniform(size=c.shape) * 0.5


def test_canny_zeros_mask_and_shape():
    assert not bool(canny(torch.zeros((20, 20), dtype=torch.float64), 4, 0,
                          0, torch.ones((20, 20), dtype=torch.bool)).any())
    assert not bool(canny(T(np.random.RandomState(0).uniform(size=(20, 20))),
                          4, 0, 0, torch.zeros((20, 20),
                                               dtype=torch.bool)).any())
    with pytest.raises(ValueError):
        canny(torch.zeros((20, 20, 20)), 4, 0, 0)
    a = canny(torch.zeros((20, 20)), 4, 0, 0,
              torch.ones((20, 20), dtype=torch.bool))
    assert_array_equal(a, canny(torch.zeros((20, 20)), 4, 0, 0))
    assert a.dtype == torch.bool


@pytest.mark.parametrize("noise_seed, low, high, it", [(None, 0, 0, 3),
                                                       (0, 0.1, 0.2, 4)])
def test_canny_circle(noise_seed, low, high, it):
    """The edges of a ring lie within its dilation less its erosion."""
    c, image = _ring(noise_seed)
    result = H(canny(T(image), 4, low, high, T(np.ones(c.shape, bool))))
    cd = sndi.binary_dilation(c, iterations=it)
    ce = sndi.binary_erosion(c, iterations=it)
    assert np.all((cd & ~ce)[result])
    assert 1200 < result.sum() < 1600


def test_canny_quantiles():
    """Quantile thresholds give the same edges as the thresholds at those
    quantiles of the gradient magnitude (numpy's quantile)."""
    img = T(np.random.RandomState(7).uniform(size=(64, 64)))
    got = canny(img, low_threshold=0.6, high_threshold=0.8,
                use_quantiles=True)
    smoothed = smooth_with_function_and_mask(
        img, lambda x: img_as_float(filters.gaussian(x, 1.0,
                                                     mode="constant")),
        torch.ones(img.shape, dtype=torch.bool))
    s = H(smoothed)
    magnitude = np.hypot(sndi.sobel(s, axis=0), sndi.sobel(s, axis=1))
    low, high = np.quantile(magnitude, [0.6, 0.8])
    want = canny(img, low_threshold=low, high_threshold=high)
    assert_array_equal(got, want)
    for lo, hi in [(0.5, 3.6), (-5, 0.5), (99, 0.9), (0.5, -100), (50, 150)]:
        with pytest.raises(ValueError):
            canny(img, use_quantiles=True, low_threshold=lo,
                  high_threshold=hi)


def test_canny_dtype():
    image_uint8 = (np.random.RandomState(9).uniform(size=(64, 64))
                   * 255).astype(np.uint8)
    assert_array_equal(canny(T(image_uint8)),
                       canny(img_as_float(T(image_uint8))))
    # integer thresholds are in the dtype's range
    assert_array_equal(canny(T(image_uint8), 1, 25.5, 51),
                       canny(img_as_float(T(image_uint8)), 1, 0.1, 0.2))


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64)
# ---------------------------------------------------------------------------


def test_named_calls_match_cupyimg_tpu():
    """gaussian, difference_of_gaussians, median, unsharp masking, window
    and the ridge filters as one jit program of cupyimg_tpu, float32
    where the card's kernels serve them: within 2e-6 of max|ref| for
    float32 (1e-5 for the ridge filters), 1e-12 for float64 (1e-6 for the
    window, sampled at float32 distances)."""
    import cupyimg_tpu.skimage.filters as jf
    from cupyimg_tpu.skimage.filters._unsharp_mask import (
        _unsharp_mask_single_channel,
    )

    cases = [
        ("gaussian f32", lambda m, a, b: m.gaussian(a, 1.5, mode="reflect"),
         2e-6),
        ("gaussian u8 nearest", lambda m, a, b: m.gaussian(b, (1, 2)), 1e-12),
        ("difference_of_gaussians f32",
         lambda m, a, b: m.difference_of_gaussians(a, 1, 2.5), 2e-6),
        ("median f32", lambda m, a, b: m.median(a), 0),
        ("median u8 5x5", lambda m, a, b: m.median(
            b, np.ones((5, 5)), mode="reflect"), 0),
        ("frangi f32", lambda m, a, b: m.frangi(a, sigmas=[1, 2]), 1e-5),
        ("sato f32", lambda m, a, b: m.sato(a, sigmas=[1.5], mode="reflect"),
         1e-5),
        ("meijering u8", lambda m, a, b: m.meijering(b, sigmas=[1]), 1e-12),
        ("hessian u8", lambda m, a, b: m.hessian(
            b, sigmas=[1], mode="constant"), 1e-12),
        # float64 data sampled at float32 distances (one float32 ulp)
        ("window hann", lambda m, a, b: m.window("hann", (9, 12)), 1e-6),
    ]
    rng = np.random.default_rng(14)
    x = rng.random((24, 26)).astype(np.float32)
    u8 = (rng.random((24, 26)) * 255).astype(np.uint8)

    @jax.jit
    def ref(a, b):
        out = [fn(jf, a, b) for _, fn, _ in cases]
        # unsharp_mask's clip reads the image's minimum on the host
        out.append(jnp.clip(_unsharp_mask_single_channel(a, 2.0, 1.5), 0, 1))
        return out

    want = ref(jnp.asarray(x), jnp.asarray(u8))
    for (name, fn, tol), w in zip(cases, want):
        got = fn(filters, T(x), T(u8))
        w = np.asarray(w)
        assert H(got).dtype == w.dtype, name
        if tol == 0:
            assert_array_equal(got, w)
        else:
            close(got, w, tol)
    got = filters.unsharp_mask(T(x), 2.0, 1.5)
    assert got.dtype == torch.float32
    close(got, np.asarray(want[-1]), 2e-6)


def test_canny_matches_cupyimg_tpu():
    """canny whole on a float32 image with a mask (eager: its hysteresis
    reads the label count): exactly the same edges.  The quantile
    thresholds are held to numpy's quantile in ``test_canny_quantiles``."""
    from cupyimg_tpu.skimage.feature import canny as jcanny

    i, j = np.mgrid[-24:24, -24:26].astype(np.float32) / 24
    rng = np.random.default_rng(15)
    img = (np.abs(np.hypot(i, j) - 0.5) < 0.1) * np.float32(0.6) + rng.random(
        i.shape, dtype=np.float32) * np.float32(0.4)
    mask = np.ones(img.shape, bool)
    mask[:, 40:] = False
    want = jcanny(jnp.asarray(img), 1.5, 0.1, 0.3, jnp.asarray(mask))
    got = canny(T(img), 1.5, 0.1, 0.3, T(mask))
    assert got.dtype == torch.bool
    assert_array_equal(got, np.asarray(want))
    assert 40 < int(got.sum()) < 600


# ---------------------------------------------------------------------------
# no matrix product in the float32 calls (TF32 cannot serve them)
# ---------------------------------------------------------------------------


def test_no_matmul_in_float32_filters(monkeypatch):
    """float32 canny, frangi, gaussian, unsharp_mask and richardson_lucy
    run with torch's matmul entry points made to raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("matmul in a float32 filter")

    x = T(_img((30, 31), 16).astype(np.float32))
    for name in ("matmul", "mm", "bmm", "einsum", "tensordot", "inner",
                 "mv", "addmm"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    monkeypatch.setattr(torch.Tensor, "matmul", refuse)
    outs = [canny(x, 1.5), filters.frangi(x, sigmas=[1, 2]),
            filters.gaussian(x, 2), filters.unsharp_mask(x, 2, 1),
            restoration.richardson_lucy(x, torch.ones((5, 5)) / 25, 3)]
    assert outs[2].dtype == outs[3].dtype == outs[4].dtype == torch.float32
    assert all(torch.isfinite(o.double()).all() for o in outs)


@pytest.mark.parametrize("name", [
    "skimage.filters", "skimage.filters.edges", "skimage.filters.thresholding",
    "skimage.filters.ridges", "skimage.filters.lpi_filter",
    "skimage.restoration", "skimage.restoration.uft",
    "skimage.restoration.deconvolution"])
def test_public_names_match_cupyimg_tpu(name):
    import importlib
    import types

    jmod = importlib.import_module("cupyimg_tpu." + name)
    tmod = importlib.import_module("cupyimg_tpu_torch." + name)

    def public(mod):
        names = set(getattr(mod, "__all__", ())) | {
            n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}
        return names - {"annotations", "np", "jnp", "jax", "math", "torch",
                        "ndi", "util", "warnings", "functools", "inspect",
                        "OrderedDict", "reduce", "make_complex", "fft",
                        # imported and unused by the JAX lpi_filter
                        "check_shape_equality", "img_as_float"}

    assert public(jmod) - public(tmod) == set()
    if name == "skimage.filters":
        assert len(jmod.__dict__.keys() & public(tmod)) >= 48
    if name == "skimage.restoration":
        assert isinstance(tmod.uft, types.ModuleType)
    from cupyimg_tpu_torch.skimage import feature
    assert feature.canny is canny


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5])
def test_eigenvalue_rows_sort_as_a_stable_argsort(rows):
    """The odd-even transposition sort of the eigenvalue rows equals a stable
    argsort by value and by magnitude, ties and NaN included."""
    from cupyimg_tpu_torch.skimage.filters.ridges import _sort_rows

    rng = np.random.default_rng(rows)
    x = rng.integers(-3, 4, (rows, 40)).astype(np.float64)
    x[:, :3] = np.nan
    x[0, 3] = np.nan
    for key, np_key in ((torch.abs, np.abs), (lambda r: r, lambda r: r)):
        got = _sort_rows(T(x), key)
        want = np.take_along_axis(x, np.argsort(np_key(x), axis=0,
                                                kind="stable"), axis=0)
        assert_array_equal(got, want)
