"""``skimage.feature`` (all but ``canny``) of the torch port on CPU
tensors.

- skimage's corner, peak, template and daisy suites, with their literal
  expected numbers and synthetic stand-ins for skimage's bundled images.
- Definitions in numpy/scipy: the structure tensor from sobel and
  gaussian filters, the Hessian from ``numpy.gradient``, the closed-form
  eigenvalues against ``numpy.linalg.eigvalsh``, the SURF determinant
  against box sums, ``match_template`` against a float64 direct
  normalized cross-correlation, ``peak_local_max`` against a
  maximum-filter definition.
- A named list against ``cupyimg_tpu`` on JAX-CPU (x64): the traceable
  calls as one jit program, ``peak_local_max``/``corner_peaks`` eager
  (they sync with the host).
- The CUDA dispatch tests carry the ``cuda`` marker.

Tolerances: the suites' own decimals; float64 against numpy/scipy or
``cupyimg_tpu`` within 1e-12 of max|ref| (``match_template``: 1e-10,
differences of cumulative sums); float32 against float64 within 1e-5 of
max|ref| (``match_template``: 1e-4, its float32 window sums).
"""

import itertools
import math

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.skimage.feature as jf
from chip_smoke import _daisy_reference
from cupyimg_tpu_torch.core import dtypes
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage import feature, img_as_float
from cupyimg_tpu_torch.skimage.feature import peak
from cupyimg_tpu_torch.skimage.feature import (
    corner_harris,
    corner_shi_tomasi,
    peak_local_max,
    corner_peaks,
    corner_kitchen_rosenfeld,
    corner_foerstner,
    structure_tensor,
    structure_tensor_eigenvalues,
    structure_tensor_eigvals,
    hessian_matrix,
    hessian_matrix_eigvals,
    hessian_matrix_det,
    shape_index,
    match_template,
    daisy,
)
from cupyimg_tpu_torch.skimage.morphology import diamond


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


def Z(shape, dtype=np.float64):
    return torch.zeros(shape, dtype=dtypes.to_torch(dtype))


def O(shape, dtype=np.float64):
    return torch.ones(shape, dtype=dtypes.to_torch(dtype))


def F(shape, value, dtype=np.float64):
    return torch.full(shape, value, dtype=dtypes.to_torch(dtype))


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_array_equal(a, b):
    np.testing.assert_array_equal(H(a), H(b))


def assert_array_almost_equal(a, b, decimal=6):
    np.testing.assert_array_almost_equal(H(a), H(b), decimal=decimal)


# ---------------------------------------------------------------------------
# skimage's corner suite
# ---------------------------------------------------------------------------


@pytest.fixture
def im3d():
    """Binary sphere of radius 10 padded by 10 (draw.ellipsoid analog)."""
    r, pad = 10, 10
    n = 2 * r + 3
    z, y, x = np.mgrid[:n, :n, :n] - (n - 1) / 2
    ball = (z / r) ** 2 + (y / r) ** 2 + (x / r) ** 2 <= 1
    return T(np.pad(ball, pad).astype(np.uint8))


def _circle_coords(row_c, col_c, radius, shape):
    """Integer circle-perimeter coordinates (draw.circle_perimeter
    analog; midpoint-free dense rasterization is fine for mean-response
    checks)."""
    theta = np.linspace(0, 2 * np.pi, max(16, int(8 * radius)),
                        endpoint=False)
    rr = np.round(row_c + radius * np.sin(theta)).astype(int)
    cc = np.round(col_c + radius * np.cos(theta)).astype(int)
    keep = (rr >= 0) & (rr < shape[0]) & (cc >= 0) & (cc < shape[1])
    return rr[keep], cc[keep]


def _astronaut_gray_like(shape=(128, 128), seed=5):
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(shape[0] // 8 + 2, shape[1] // 8 + 2))
    up = np.kron(base, np.ones((8, 8)))[: shape[0], : shape[1]]
    return T(up)


def test_structure_tensor():
    square = np.zeros((5, 5))
    square[2, 2] = 1
    Arr, Arc, Acc = structure_tensor(T(square), sigma=0.1,
                                     order="rc")
    assert_array_equal(
        Acc,
        [
            [0, 0, 0, 0, 0],
            [0, 1, 0, 1, 0],
            [0, 4, 0, 4, 0],
            [0, 1, 0, 1, 0],
            [0, 0, 0, 0, 0],
        ],
    )
    assert_array_equal(
        Arc,
        [
            [0, 0, 0, 0, 0],
            [0, 1, 0, -1, 0],
            [0, 0, 0, -0, 0],
            [0, -1, -0, 1, 0],
            [0, 0, 0, 0, 0],
        ],
    )
    assert_array_equal(
        Arr,
        [
            [0, 0, 0, 0, 0],
            [0, 1, 4, 1, 0],
            [0, 0, 0, 0, 0],
            [0, 1, 4, 1, 0],
            [0, 0, 0, 0, 0],
        ],
    )


def test_structure_tensor_3d():
    cube = np.zeros((5, 5, 5))
    cube[2, 2, 2] = 1
    A_elems = structure_tensor(T(cube), sigma=0.1)
    assert len(A_elems) == 6
    assert_array_equal(
        A_elems[0][:, 1, :],
        [
            [0, 0, 0, 0, 0],
            [0, 1, 4, 1, 0],
            [0, 0, 0, 0, 0],
            [0, 1, 4, 1, 0],
            [0, 0, 0, 0, 0],
        ],
    )
    assert_array_equal(
        A_elems[0][1],
        [
            [0, 0, 0, 0, 0],
            [0, 1, 4, 1, 0],
            [0, 4, 16, 4, 0],
            [0, 1, 4, 1, 0],
            [0, 0, 0, 0, 0],
        ],
    )
    assert_array_equal(
        A_elems[3][2],
        [
            [0, 0, 0, 0, 0],
            [0, 4, 16, 4, 0],
            [0, 0, 0, 0, 0],
            [0, 4, 16, 4, 0],
            [0, 0, 0, 0, 0],
        ],
    )


def test_structure_tensor_3d_rc_only():
    cube = Z((5, 5, 5))
    with pytest.raises(ValueError):
        structure_tensor(cube, sigma=0.1, order="xy")
    A_elems_rc = structure_tensor(cube, sigma=0.1, order="rc")
    A_elems_none = structure_tensor(cube, sigma=0.1)
    for a_rc, a_none in zip(A_elems_rc, A_elems_none):
        assert_array_equal(a_rc, a_none)


def test_structure_tensor_orders():
    square = np.zeros((5, 5))
    square[2, 2] = 1
    square = T(square)
    with pytest.warns(FutureWarning, match="the default order of the "
                                           "structure"):
        A_elems_default = structure_tensor(square, sigma=0.1)
    A_elems_xy = structure_tensor(square, sigma=0.1, order="xy")
    A_elems_rc = structure_tensor(square, sigma=0.1, order="rc")
    for elem_xy, elem_def in zip(A_elems_xy, A_elems_default):
        assert_array_equal(elem_xy, elem_def)
    for elem_xy, elem_rc in zip(A_elems_xy, A_elems_rc[::-1]):
        assert_array_equal(elem_xy, elem_rc)


def test_hessian_matrix():
    square = np.zeros((5, 5))
    square[2, 2] = 4
    Hrr, Hrc, Hcc = hessian_matrix(T(square), sigma=0.1,
                                   order="rc")
    assert_array_almost_equal(
        Hrr,
        [
            [0, 0, 0, 0, 0],
            [0, 0, 0, 0, 0],
            [2, 0, -2, 0, 2],
            [0, 0, 0, 0, 0],
            [0, 0, 0, 0, 0],
        ],
    )
    assert_array_almost_equal(
        Hrc,
        [
            [0, 0, 0, 0, 0],
            [0, 1, 0, -1, 0],
            [0, 0, 0, 0, 0],
            [0, -1, 0, 1, 0],
            [0, 0, 0, 0, 0],
        ],
    )
    assert_array_almost_equal(
        Hcc,
        [
            [0, 0, 2, 0, 0],
            [0, 0, 0, 0, 0],
            [0, 0, -2, 0, 0],
            [0, 0, 0, 0, 0],
            [0, 0, 2, 0, 0],
        ],
    )


def test_hessian_matrix_3d():
    cube = np.zeros((5, 5, 5))
    cube[2, 2, 2] = 4
    Hs = hessian_matrix(T(cube), sigma=0.1, order="rc")
    assert len(Hs) == 6
    assert_array_almost_equal(
        Hs[2][:, 2, :],
        [
            [0, 0, 0, 0, 0],
            [0, 1, 0, -1, 0],
            [0, 0, 0, 0, 0],
            [0, -1, 0, 1, 0],
            [0, 0, 0, 0, 0],
        ],
    )


def test_structure_tensor_eigenvalues():
    square = np.zeros((5, 5))
    square[2, 2] = 1
    A_elems = structure_tensor(T(square), sigma=0.1, order="rc")
    l1, l2 = structure_tensor_eigenvalues(A_elems)
    assert_array_equal(
        l1,
        [
            [0, 0, 0, 0, 0],
            [0, 2, 4, 2, 0],
            [0, 4, 0, 4, 0],
            [0, 2, 4, 2, 0],
            [0, 0, 0, 0, 0],
        ],
    )
    assert_array_equal(l2, np.zeros((5, 5)))


def test_structure_tensor_eigvals():
    square = np.zeros((5, 5))
    square[2, 2] = 1
    Arr, Arc, Acc = structure_tensor(T(square), sigma=0.1,
                                     order="xy")
    with pytest.warns(FutureWarning, match="deprecation warning"):
        l1, l2 = structure_tensor_eigvals(Arr, Arc, Acc)
    assert_array_equal(
        l1,
        [
            [0, 0, 0, 0, 0],
            [0, 2, 4, 2, 0],
            [0, 4, 0, 4, 0],
            [0, 2, 4, 2, 0],
            [0, 0, 0, 0, 0],
        ],
    )
    assert_array_equal(l2, np.zeros((5, 5)))


def test_hessian_matrix_eigvals():
    square = np.zeros((5, 5))
    square[2, 2] = 4
    H = hessian_matrix(T(square), sigma=0.1, order="rc")
    l1, l2 = hessian_matrix_eigvals(H)
    assert_array_almost_equal(
        l1,
        [
            [0, 0, 2, 0, 0],
            [0, 1, 0, 1, 0],
            [2, 0, -2, 0, 2],
            [0, 1, 0, 1, 0],
            [0, 0, 2, 0, 0],
        ],
    )
    assert_array_almost_equal(
        l2,
        [
            [0, 0, 0, 0, 0],
            [0, -1, 0, -1, 0],
            [0, 0, -2, 0, 0],
            [0, -1, 0, -1, 0],
            [0, 0, 0, 0, 0],
        ],
    )


def test_hessian_matrix_eigvals_3d(im3d):
    H = hessian_matrix(im3d)
    E = np.asarray(hessian_matrix_eigvals(H))
    # descending order
    e0, e1, e2 = E
    assert np.all(e0 >= e1) and np.all(e1 >= e2)

    E0, E1, E2 = E[:, E.shape[1] // 2]  # cross section
    row_center, col_center = np.asarray(E0.shape) // 2
    circles = [
        _circle_coords(row_center, col_center, radius, E0.shape)
        for radius in range(1, E0.shape[1] // 2 - 1)
    ]
    response0 = np.array([np.mean(E0[c]) for c in circles])
    response2 = np.array([np.mean(E2[c]) for c in circles])

    # eigenvalues negative just inside the sphere, positive just outside
    assert np.argmin(response2) < np.argmax(response0)
    assert np.min(response2) < 0
    assert np.max(response0) > 0


def test_hessian_matrix_det():
    image = np.zeros((5, 5))
    image[2, 2] = 1
    det = hessian_matrix_det(T(image), 5, approximate=False)
    assert_array_almost_equal(det, 0, decimal=3)


def test_hessian_matrix_det_3d(im3d):
    D = np.asarray(hessian_matrix_det(im3d))
    D0 = D[D.shape[0] // 2]
    row_center, col_center = np.asarray(D0.shape) // 2
    circles = [
        _circle_coords(row_center, col_center, r, D0.shape)
        for r in range(1, D0.shape[1] // 2 - 1)
    ]
    response = np.array([np.mean(D0[c]) for c in circles])
    lowest = np.argmin(response)
    highest = np.argmax(response)
    assert lowest < highest
    assert response[lowest] < 0
    assert response[highest] > 0


def test_shape_index():
    square = np.zeros((5, 5))
    square[2, 2] = 4
    s = np.asarray(shape_index(T(square), sigma=0.1))
    nan = np.nan
    assert_array_almost_equal(
        s,
        [
            [nan, nan, -0.5, nan, nan],
            [nan, 0, nan, 0, nan],
            [-0.5, nan, -1, nan, -0.5],
            [nan, 0, nan, 0, nan],
            [nan, nan, -0.5, nan, nan],
        ],
    )


def test_square_image():
    im = np.zeros((50, 50), dtype=float)
    im[:25, :25] = 1.0
    im = T(im)

    results = peak_local_max(
        corner_harris(im, method="k"), min_distance=10, threshold_rel=0
    )
    assert len(results) == 1

    results = peak_local_max(
        corner_harris(im, method="eps"), min_distance=10, threshold_rel=0
    )
    assert len(results) == 1

    results = peak_local_max(
        corner_shi_tomasi(im), min_distance=10, threshold_rel=0
    )
    assert len(results) == 1


def test_noisy_square_image():
    im = np.zeros((50, 50), dtype=float)
    im[:25, :25] = 1.0
    np.random.seed(seed=1234)
    im = im + np.random.uniform(size=im.shape) * 0.2
    im = T(im)

    results = peak_local_max(
        corner_harris(im, method="k"), min_distance=10, threshold_rel=0
    )
    assert len(results) == 1
    results = peak_local_max(
        corner_harris(im, method="eps"), min_distance=10, threshold_rel=0
    )
    assert len(results) == 1
    results = peak_local_max(
        corner_shi_tomasi(im, sigma=1.5), min_distance=10, threshold_rel=0
    )
    assert len(results) == 1


def test_squared_dot():
    # the sobel-based Harris response of a 4x4 square has four equal
    # maxima at its corners: exactly one peak survives, on the square
    im = np.zeros((50, 50))
    im[4:8, 4:8] = 1
    im = img_as_float(T(im))

    for detector in (corner_harris, corner_shi_tomasi):
        results = np.asarray(
            peak_local_max(
                detector(im), min_distance=10, threshold_rel=0,
                exclude_border=False,
            )
        )
        assert results.shape == (1, 2)
        assert all(4 <= v <= 7 for v in results[0])


def test_rotated_img():
    """Harris/Shi-Tomasi responses commute with transposition."""
    im = _astronaut_gray_like()
    im_rotated = im.T

    threshold_rel = 1e-8
    results = peak_local_max(
        corner_harris(im), min_distance=10, threshold_rel=threshold_rel
    )
    results_rotated = peak_local_max(
        corner_harris(im_rotated), min_distance=10,
        threshold_rel=threshold_rel,
    )
    assert_array_equal(
        np.sort(np.asarray(results)[:, 0]),
        np.sort(np.asarray(results_rotated)[:, 1]),
    )
    assert_array_equal(
        np.sort(np.asarray(results)[:, 1]),
        np.sort(np.asarray(results_rotated)[:, 0]),
    )

    results = peak_local_max(
        corner_shi_tomasi(im), min_distance=10, threshold_rel=threshold_rel
    )
    results_rotated = peak_local_max(
        corner_shi_tomasi(im_rotated), min_distance=10,
        threshold_rel=threshold_rel,
    )
    assert_array_equal(
        np.sort(np.asarray(results)[:, 0]),
        np.sort(np.asarray(results_rotated)[:, 1]),
    )
    assert_array_equal(
        np.sort(np.asarray(results)[:, 1]),
        np.sort(np.asarray(results_rotated)[:, 0]),
    )


def test_num_peaks():
    """peak_local_max returns exactly num_peaks peaks on a corner-rich
    response."""
    img_corners = corner_harris(_astronaut_gray_like((128, 128), seed=7))
    rng = np.random.RandomState(0)
    for i in range(8):
        n = int(rng.randint(1, 13))
        results = peak_local_max(
            img_corners, min_distance=10, threshold_rel=0, num_peaks=n
        )
        assert results.shape[0] == n


def test_corner_peaks():
    response = np.zeros((10, 10))
    response[2:5, 2:5] = 1
    response[8:10, 0:2] = 1
    response = T(response)

    corners = corner_peaks(
        response, exclude_border=False, min_distance=10, threshold_rel=0
    )
    assert corners.shape == (1, 2)

    corners = corner_peaks(
        response, exclude_border=False, min_distance=5, threshold_rel=0
    )
    assert corners.shape == (2, 2)

    corners = corner_peaks(response, exclude_border=False, min_distance=1)
    assert corners.shape == (5, 2)

    with pytest.warns(FutureWarning,
                      match="indices argument is deprecated"):
        corners = corner_peaks(
            response, exclude_border=False, min_distance=1, indices=False
        )
    assert int(torch.sum(corners)) == 5


def test_blank_image_nans():
    """Constant input must give a finite response for every detector."""
    detectors = [corner_harris, corner_shi_tomasi, corner_kitchen_rosenfeld]
    constant_image = Z((20, 20))
    for det in detectors:
        response = det(constant_image)
        assert bool(torch.all(torch.isfinite(response)))
    w, q = corner_foerstner(constant_image)
    assert bool(torch.all(torch.isfinite(w)))
    assert bool(torch.all(torch.isfinite(q)))

# ---------------------------------------------------------------------------
# skimage's peak suite
# ---------------------------------------------------------------------------


def _deprecated_indices(fn, *args, **kw):
    with pytest.warns(FutureWarning, match="indices argument is deprecated"):
        return fn(*args, **kw)


class TestPeakLocalMax:
    def test_trivial_case(self):
        trivial = Z((25, 25))
        peak_indices = peak.peak_local_max(trivial, min_distance=1)
        assert peak_indices.numel() == 0
        peaks = _deprecated_indices(
            peak.peak_local_max, trivial, min_distance=1, indices=False
        )
        assert bool(torch.all(peaks.bool() == trivial.bool()))

    def test_noisy_peaks(self):
        peak_locations = [(7, 7), (7, 13), (13, 7), (13, 13)]
        rng = np.random.RandomState(21)
        image = 0.8 * rng.rand(20, 20)
        for r, c in peak_locations:
            image[r, c] = 1
        peaks_detected = peak.peak_local_max(T(image),
                                             min_distance=5)
        assert len(peaks_detected) == len(peak_locations)
        for loc in np.asarray(peaks_detected):
            assert tuple(loc) in peak_locations

    def test_relative_threshold(self):
        image = np.zeros((5, 5), dtype=np.uint8)
        image[1, 1] = 10
        image[3, 3] = 20
        peaks = peak.peak_local_max(T(image), min_distance=1,
                                    threshold_rel=0.5)
        assert len(peaks) == 1
        assert_array_equal(peaks, [(3, 3)])

    def test_absolute_threshold(self):
        image = np.zeros((5, 5), dtype=np.uint8)
        image[1, 1] = 10
        image[3, 3] = 20
        peaks = peak.peak_local_max(T(image), min_distance=1,
                                    threshold_abs=10)
        assert len(peaks) == 1
        assert_array_equal(peaks, [(3, 3)])

    def test_constant_image(self):
        image = F((20, 20), 128, dtype=np.uint8)
        peaks = peak.peak_local_max(image, min_distance=1)
        assert len(peaks) == 0

    def test_flat_peak(self):
        image = np.zeros((5, 5), dtype=np.uint8)
        image[1:3, 1:3] = 10
        peaks = peak.peak_local_max(T(image), min_distance=1)
        assert len(peaks) == 4

    def test_sorted_peaks(self):
        image = np.zeros((5, 5), dtype=np.uint8)
        image[1, 1] = 20
        image[3, 3] = 10
        peaks = peak.peak_local_max(T(image), min_distance=1)
        assert np.asarray(peaks).tolist() == [[1, 1], [3, 3]]

        image = np.zeros((3, 10))
        image[1, (1, 3, 5, 7)] = (1, 2, 3, 4)
        peaks = peak.peak_local_max(T(image), min_distance=1)
        assert np.asarray(peaks).tolist() == [[1, 7], [1, 5], [1, 3], [1, 1]]

    def test_num_peaks(self):
        image = np.zeros((7, 7), dtype=np.uint8)
        image[1, 1] = 10
        image[1, 3] = 11
        image[1, 5] = 12
        image[3, 5] = 8
        image[5, 3] = 7
        image = T(image)
        assert (
            len(peak.peak_local_max(image, min_distance=1, threshold_abs=0))
            == 5
        )
        peaks_limited = np.asarray(
            peak.peak_local_max(
                image, min_distance=1, threshold_abs=0, num_peaks=2
            )
        )
        assert len(peaks_limited) == 2
        assert (1, 3) in map(tuple, peaks_limited)
        assert (1, 5) in map(tuple, peaks_limited)

        peaks_limited = np.asarray(
            peak.peak_local_max(
                image, min_distance=1, threshold_abs=0, num_peaks=4
            )
        )
        assert len(peaks_limited) == 4
        for want in [(1, 3), (1, 5), (1, 1), (3, 5)]:
            assert want in map(tuple, peaks_limited)

    def test_num_peaks_and_labels(self):
        image = np.zeros((7, 7), dtype=np.uint8)
        labels = T(np.full((7, 7), 20, dtype=np.uint8))
        image[1, 1] = 10
        image[1, 3] = 11
        image[1, 5] = 12
        image[3, 5] = 8
        image[5, 3] = 7
        image = T(image)
        peaks_limited = peak.peak_local_max(
            image, min_distance=1, threshold_abs=0, labels=labels
        )
        assert len(peaks_limited) == 5
        peaks_limited = peak.peak_local_max(
            image, min_distance=1, threshold_abs=0, labels=labels,
            num_peaks=2,
        )
        assert len(peaks_limited) == 2

    def test_num_peaks_tot_vs_labels_4quadrants(self):
        rng = np.random.RandomState(21)
        image = T(rng.uniform(size=(20, 30)))
        i, j = np.mgrid[0:20, 0:30]
        labels = T(1 + (i >= 10) + (j >= 15) * 2)
        result = peak.peak_local_max(
            image, labels=labels, min_distance=1, threshold_rel=0,
            num_peaks=np.inf, num_peaks_per_label=2,
        )
        assert len(result) == 8
        result = peak.peak_local_max(
            image, labels=labels, min_distance=1, threshold_rel=0,
            num_peaks=np.inf, num_peaks_per_label=1,
        )
        assert len(result) == 4
        result = peak.peak_local_max(
            image, labels=labels, min_distance=1, threshold_rel=0,
            num_peaks=2, num_peaks_per_label=2,
        )
        assert len(result) == 2

    def test_num_peaks3D(self):
        image = np.zeros((10, 10, 100))
        image[5, 5, ::5] = np.arange(20)
        peaks_limited = peak.peak_local_max(
            T(image), min_distance=1, num_peaks=2
        )
        assert len(peaks_limited) == 2

    def test_reorder_labels(self):
        rng = np.random.RandomState(21)
        image = T(rng.uniform(size=(40, 60)))
        i, j = np.mgrid[0:40, 0:60]
        labels = 1 + (i >= 20) + (j >= 30) * 2
        labels[labels == 4] = 5
        i, j = np.mgrid[-3:4, -3:4]
        footprint = i * i + j * j <= 9
        expected = np.zeros(image.shape, float)
        for imin, imax in ((0, 20), (20, 40)):
            for jmin, jmax in ((0, 30), (30, 60)):
                expected[imin:imax, jmin:jmax] = np.asarray(
                    ndi.maximum_filter(
                        image[imin:imax, jmin:jmax],
                        footprint=T(footprint),
                    )
                )
        expected = expected == np.asarray(image)
        result = _deprecated_indices(
            peak.peak_local_max, image, labels=T(labels),
            min_distance=1, threshold_rel=0,
            footprint=T(footprint), indices=False,
            exclude_border=False,
        )
        assert bool(torch.all(result == T(expected)))

    def test_indices_with_labels(self):
        rng = np.random.RandomState(21)
        image_np = rng.uniform(size=(40, 60))
        image = T(image_np)
        i, j = np.mgrid[0:40, 0:60]
        labels = T(1 + (i >= 20) + (j >= 30) * 2)
        i, j = np.mgrid[-3:4, -3:4]
        footprint = i * i + j * j <= 9
        expected = np.zeros(image.shape, float)
        for imin, imax in ((0, 20), (20, 40)):
            for jmin, jmax in ((0, 30), (30, 60)):
                expected[imin:imax, jmin:jmax] = np.asarray(
                    ndi.maximum_filter(
                        image[imin:imax, jmin:jmax],
                        footprint=T(footprint),
                    )
                )
        expected = np.column_stack(np.nonzero(expected == image_np))
        expected = expected[
            np.argsort(image_np[tuple(expected.T)])[::-1]
        ]
        result = peak.peak_local_max(
            image, labels=labels, min_distance=1, threshold_rel=0,
            footprint=T(footprint), exclude_border=False,
        )
        result = np.asarray(result)
        result = result[np.argsort(image_np[tuple(result.T)])[::-1]]
        assert (result == expected).all()

    def test_ndarray_indices_false(self):
        nd_image = np.zeros((5, 5, 5))
        nd_image[2, 2, 2] = 1
        peaks = _deprecated_indices(
            peak.peak_local_max, T(nd_image), min_distance=1,
            indices=False,
        )
        assert bool(torch.all(peaks == T(nd_image.astype(bool))))

    def test_ndarray_exclude_border(self):
        nd_image = np.zeros((5, 5, 5))
        nd_image[[1, 0, 0], [0, 1, 0], [0, 0, 1]] = 1
        nd_image[3, 0, 0] = 1
        nd_image[2, 2, 2] = 1
        expected = np.zeros_like(nd_image, dtype=bool)
        expected[2, 2, 2] = True
        expectedNoBorder = np.zeros_like(nd_image, dtype=bool)
        expectedNoBorder[2, 2, 2] = True
        expectedNoBorder[0, 0, 1] = True
        expectedNoBorder[3, 0, 0] = True
        img = T(nd_image)
        result = _deprecated_indices(
            peak.peak_local_max, img, min_distance=2, exclude_border=2,
            indices=False,
        )
        assert_array_equal(result, expected)
        assert_array_equal(
            _deprecated_indices(peak.peak_local_max, img, min_distance=2,
                                exclude_border=2, indices=False),
            _deprecated_indices(peak.peak_local_max, img, min_distance=2,
                                exclude_border=True, indices=False),
        )
        assert_array_equal(
            _deprecated_indices(peak.peak_local_max, img, min_distance=2,
                                exclude_border=0, indices=False),
            _deprecated_indices(peak.peak_local_max, img, min_distance=2,
                                exclude_border=False, indices=False),
        )
        assert_array_equal(
            _deprecated_indices(peak.peak_local_max, img, min_distance=2,
                                exclude_border=0, indices=False),
            expectedNoBorder,
        )
        assert_array_equal(
            _deprecated_indices(peak.peak_local_max, img,
                                exclude_border=False, indices=False),
            nd_image.astype(bool),
        )

    def test_empty(self):
        image = Z((10, 20))
        labels = Z((10, 20), np.int32)
        result = _deprecated_indices(
            peak.peak_local_max, image, labels=labels,
            footprint=O((3, 3), bool), min_distance=1,
            threshold_rel=0, indices=False, exclude_border=False,
        )
        assert bool(torch.all(~result))

    def test_empty_non2d_indices(self):
        image = Z((10, 10, 10))
        result = peak.peak_local_max(
            image, footprint=O((3, 3, 3), bool), min_distance=1,
            threshold_rel=0, exclude_border=False,
        )
        assert result.shape == (0, image.ndim)

    def test_one_point(self):
        image = np.zeros((10, 20))
        labels = np.zeros((10, 20), int)
        image[5, 5] = 1
        labels[5, 5] = 1
        result = _deprecated_indices(
            peak.peak_local_max, T(image),
            labels=T(labels), footprint=O((3, 3), bool),
            min_distance=1, threshold_rel=0, indices=False,
            exclude_border=False,
        )
        assert bool(torch.all(result == T(labels == 1)))

    def test_adjacent_and_same(self):
        image = np.zeros((10, 20))
        labels = np.zeros((10, 20), int)
        image[5, 5:6] = 1
        labels[5, 5:6] = 1
        result = _deprecated_indices(
            peak.peak_local_max, T(image),
            labels=T(labels), footprint=O((3, 3), bool),
            min_distance=1, threshold_rel=0, indices=False,
            exclude_border=False,
        )
        assert bool(torch.all(result == T(labels == 1)))

    def test_adjacent_and_different(self):
        image = np.zeros((10, 20))
        labels = np.zeros((10, 20), int)
        image[5, 5] = 1
        image[5, 6] = 0.5
        labels[5, 5:6] = 1
        expected = T(image == 1)
        result = _deprecated_indices(
            peak.peak_local_max, T(image),
            labels=T(labels), footprint=O((3, 3), bool),
            min_distance=1, threshold_rel=0, indices=False,
            exclude_border=False,
        )
        assert bool(torch.all(result == expected))
        result = _deprecated_indices(
            peak.peak_local_max, T(image),
            labels=T(labels), min_distance=1, threshold_rel=0,
            indices=False, exclude_border=False,
        )
        assert bool(torch.all(result == expected))

    def test_not_adjacent_and_different(self):
        image = np.zeros((10, 20))
        labels = np.zeros((10, 20), int)
        image[5, 5] = 1
        image[5, 8] = 0.5
        labels[image > 0] = 1
        expected = T(labels == 1)
        result = _deprecated_indices(
            peak.peak_local_max, T(image),
            labels=T(labels), footprint=O((3, 3), bool),
            min_distance=1, threshold_rel=0, indices=False,
            exclude_border=False,
        )
        assert bool(torch.all(result == expected))

    def test_two_objects(self):
        image = np.zeros((10, 20))
        labels = np.zeros((10, 20), int)
        image[5, 5] = 1
        image[5, 15] = 0.5
        labels[5, 5] = 1
        labels[5, 15] = 2
        expected = T(labels > 0)
        result = _deprecated_indices(
            peak.peak_local_max, T(image),
            labels=T(labels), footprint=O((3, 3), bool),
            min_distance=1, threshold_rel=0, indices=False,
            exclude_border=False,
        )
        assert bool(torch.all(result == expected))

    def test_adjacent_different_objects(self):
        image = np.zeros((10, 20))
        labels = np.zeros((10, 20), int)
        image[5, 5] = 1
        image[5, 6] = 0.5
        labels[5, 5] = 1
        labels[5, 6] = 2
        expected = T(labels > 0)
        result = _deprecated_indices(
            peak.peak_local_max, T(image),
            labels=T(labels), footprint=O((3, 3), bool),
            min_distance=1, threshold_rel=0, indices=False,
            exclude_border=False,
        )
        assert bool(torch.all(result == expected))

    def test_four_quadrants(self):
        rng = np.random.RandomState(21)
        image_np = rng.uniform(size=(20, 30))
        image = T(image_np)
        i, j = np.mgrid[0:20, 0:30]
        labels = 1 + (i >= 10) + (j >= 15) * 2
        i, j = np.mgrid[-3:4, -3:4]
        footprint = i * i + j * j <= 9
        expected = np.zeros(image.shape, float)
        for imin, imax in ((0, 10), (10, 20)):
            for jmin, jmax in ((0, 15), (15, 30)):
                expected[imin:imax, jmin:jmax] = np.asarray(
                    ndi.maximum_filter(
                        image[imin:imax, jmin:jmax],
                        footprint=T(footprint),
                    )
                )
        expected = expected == image_np
        result = _deprecated_indices(
            peak.peak_local_max, image, labels=T(labels),
            footprint=T(footprint), min_distance=1,
            threshold_rel=0, indices=False, exclude_border=False,
        )
        assert bool(torch.all(result == T(expected)))

    def test_disk(self):
        """img-1194 regression: footprint=[[1]] -> every point peaks."""
        rng = np.random.RandomState(21)
        image = T(rng.uniform(size=(10, 20)))
        footprint = T([[1]])
        result = _deprecated_indices(
            peak.peak_local_max, image,
            labels=O((10, 20), np.int32), footprint=footprint,
            min_distance=1, threshold_rel=0, threshold_abs=-1,
            indices=False, exclude_border=False,
        )
        assert bool(torch.all(result))
        result = _deprecated_indices(
            peak.peak_local_max, image, footprint=footprint,
            threshold_abs=-1, indices=False, exclude_border=False,
        )
        assert bool(torch.all(result))

    def test_3D(self):
        image = np.zeros((30, 30, 30))
        image[15, 15, 15] = 1
        image[5, 5, 5] = 1
        image = T(image)
        assert_array_equal(
            peak.peak_local_max(image, min_distance=10, threshold_rel=0),
            [[15, 15, 15]],
        )
        assert_array_equal(
            peak.peak_local_max(image, min_distance=6, threshold_rel=0),
            [[15, 15, 15]],
        )
        assert sorted(
            np.asarray(
                peak.peak_local_max(
                    image, min_distance=10, threshold_rel=0,
                    exclude_border=False,
                )
            ).tolist()
        ) == [[5, 5, 5], [15, 15, 15]]
        assert sorted(
            np.asarray(
                peak.peak_local_max(image, min_distance=5, threshold_rel=0)
            ).tolist()
        ) == [[5, 5, 5], [15, 15, 15]]

    def test_4D(self):
        image = np.zeros((30, 30, 30, 30))
        image[15, 15, 15, 15] = 1
        image[5, 5, 5, 5] = 1
        image = T(image)
        assert_array_equal(
            peak.peak_local_max(image, min_distance=10, threshold_rel=0),
            [[15, 15, 15, 15]],
        )
        assert_array_equal(
            peak.peak_local_max(image, min_distance=6, threshold_rel=0),
            [[15, 15, 15, 15]],
        )
        assert sorted(
            np.asarray(
                peak.peak_local_max(
                    image, min_distance=10, threshold_rel=0,
                    exclude_border=False,
                )
            ).tolist()
        ) == [[5, 5, 5, 5], [15, 15, 15, 15]]
        assert sorted(
            np.asarray(
                peak.peak_local_max(image, min_distance=5, threshold_rel=0)
            ).tolist()
        ) == [[5, 5, 5, 5], [15, 15, 15, 15]]

    def test_threshold_rel_default(self):
        image = np.ones((5, 5))
        image[2, 2] = 1
        assert len(peak.peak_local_max(T(image))) == 0
        image[2, 2] = 2
        assert_array_equal(
            peak.peak_local_max(T(image)), [[2, 2]]
        )
        image[2, 2] = 0
        with pytest.warns(RuntimeWarning, match="When min_distance < 1"):
            assert (
                len(
                    peak.peak_local_max(T(image), min_distance=0)
                )
                == image.size - 1
            )


@pytest.mark.parametrize(
    ["indices"],
    [[indices] for indices in itertools.product(range(5), range(5))],
)
def test_exclude_border(indices):
    image = np.zeros((5, 5))
    image[indices] = 1
    image = T(image)

    assert len(peak.peak_local_max(image, exclude_border=False)) == 1
    assert len(peak.peak_local_max(image, exclude_border=0)) == 1

    if indices[0] in (0, 4) or indices[1] in (0, 4):
        expected_peaks = 0
    else:
        expected_peaks = 1
    assert (
        len(peak.peak_local_max(image, min_distance=1, exclude_border=True))
        == expected_peaks
    )

    if indices[0] in (0, 4):
        expected_peaks = 0
    else:
        expected_peaks = 1
    assert (
        len(peak.peak_local_max(image, exclude_border=(1, 0)))
        == expected_peaks
    )

    if indices[1] in (0, 4):
        expected_peaks = 0
    else:
        expected_peaks = 1
    assert (
        len(peak.peak_local_max(image, exclude_border=(0, 1)))
        == expected_peaks
    )


def test_exclude_border_errors():
    image = Z((5, 5))
    with pytest.raises(ValueError):
        peak.peak_local_max(image, exclude_border=(1,))
    with pytest.raises(TypeError):
        peak.peak_local_max(image, exclude_border=1.0)
    with pytest.raises(ValueError):
        peak.peak_local_max(image, exclude_border=(1, "a"))
    with pytest.raises(ValueError):
        peak.peak_local_max(image, exclude_border=(1, -1))
    with pytest.raises(ValueError):
        peak.peak_local_max(image, exclude_border=-1)


class TestProminentPeaks:
    def test_isolated_peaks(self):
        image = np.zeros((15, 15))
        x0, y0, i0 = (12, 8, 1)
        x1, y1, i1 = (2, 2, 1)
        x2, y2, i2 = (5, 13, 1)
        image[y0, x0] = i0
        image[y1, x1] = i1
        image[y2, x2] = i2
        out = peak._prominent_peaks(T(image))
        assert len(out[0]) == 3
        for i, x, y in zip(*map(np.asarray, out)):
            assert i in (i0, i1, i2)
            assert x in (x0, x1, x2)
            assert y in (y0, y1, y2)

    def test_threshold(self):
        image = np.zeros((15, 15))
        x0, y0, i0 = (12, 8, 10)
        x1, y1, i1 = (2, 2, 8)
        x2, y2, i2 = (5, 13, 10)
        image[y0, x0] = i0
        image[y1, x1] = i1
        image[y2, x2] = i2
        out = peak._prominent_peaks(T(image), threshold=None)
        assert len(out[0]) == 3
        for i, x, y in zip(*map(np.asarray, out)):
            assert i in (i0, i1, i2)
            assert x in (x0, x1, x2)
        out = peak._prominent_peaks(T(image), threshold=9)
        assert len(out[0]) == 2
        for i, x, y in zip(*map(np.asarray, out)):
            assert i in (i0, i2)
            assert x in (x0, x2)
            assert y in (y0, y2)

    def test_peaks_in_contact(self):
        image = np.zeros((15, 15))
        x0, y0, i0 = (8, 8, 1)
        x1, y1, i1 = (7, 7, 1)  # the prominent peak
        x2, y2, i2 = (6, 6, 1)
        image[y0, x0] = i0
        image[y1, x1] = i1
        image[y2, x2] = i2
        out = peak._prominent_peaks(
            T(image), min_xdistance=3, min_ydistance=3
        )
        assert_array_equal(out[0], (i1,))
        assert_array_equal(out[1], (x1,))
        assert_array_equal(out[2], (y1,))

    def test_input_labels_unmodified(self):
        image = np.zeros((10, 20))
        labels = np.zeros((10, 20), int)
        image[5, 5] = 1
        labels[5, 5] = 3
        labels_j = T(labels)
        _deprecated_indices(
            peak.peak_local_max, T(image), labels=labels_j,
            footprint=O((3, 3), bool), min_distance=1,
            threshold_rel=0, indices=False, exclude_border=False,
        )
        assert bool(torch.all(labels_j == T(labels)))

    def test_many_objects(self):
        mask = np.zeros([500, 500], dtype=bool)
        x, y = np.indices((500, 500))
        x_c = x // 20 * 20 + 10
        y_c = y // 20 * 20 + 10
        mask[(x - x_c) ** 2 + (y - y_c) ** 2 < 8 ** 2] = True
        labels, num_objs = sndi.label(mask)
        dist = sndi.distance_transform_edt(mask)

        local_max = peak.peak_local_max(
            T(dist), min_distance=20, exclude_border=False,
            labels=T(labels),
        )
        assert len(local_max) == 625

# ---------------------------------------------------------------------------
# skimage's template suite
# ---------------------------------------------------------------------------


class TestMatchTemplate:
    def test_template(self):
        size = 100
        image = np.full((400, 400), 0.5)
        target = 0.1 * (np.tri(size) + np.tri(size)[::-1])
        target_positions = [(50, 50), (200, 200)]
        for x, y in target_positions:
            image[x:x + size, y:y + size] = target
        np.random.seed(1)
        image += 0.1 * np.random.uniform(size=(400, 400))

        result = match_template(T(image), T(target))
        positions = np.asarray(peak_local_max(result, min_distance=5))

        if len(positions) > 2:
            intensities = np.asarray(result)[tuple(positions.T)]
            i_maxsort = np.argsort(intensities)[::-1]
            positions = positions[i_maxsort][:2]
        positions = positions[np.argsort(positions[:, 0])]
        for xy_target, xy in zip(target_positions, positions):
            np.testing.assert_array_almost_equal(xy, xy_target)

    def test_normalization(self):
        n, N = 5, 20
        ipos, jpos = (2, 3)
        ineg, jneg = (12, 11)
        image = np.full((N, N), 0.5)
        image[ipos:ipos + n, jpos:jpos + n] = 1
        image[ineg:ineg + n, jneg:jneg + n] = 0
        template = np.zeros((n + 2, n + 2))
        template[1:1 + n, 1:1 + n] = 1

        result = np.asarray(
            match_template(T(image), T(template))
        )
        sorted_result = np.argsort(result.ravel())
        min_result = np.unravel_index(sorted_result[0], result.shape)
        max_result = np.unravel_index(sorted_result[-1], result.shape)
        assert np.all((np.asarray(min_result) + 1) == (ineg, jneg))
        assert np.all((np.asarray(max_result) + 1) == (ipos, jpos))
        assert np.allclose(result.ravel()[sorted_result[0]], -1)
        assert np.allclose(result.ravel()[sorted_result[-1]], 1)

    def test_no_nans(self):
        np.random.seed(1)
        image = 0.5 + 1e-9 * np.random.normal(size=(20, 20))
        template = np.ones((6, 6))
        template[:3, :] = 0
        result = match_template(T(image), T(template))
        assert not bool(torch.any(torch.isnan(result)))

    def test_switched_arguments(self):
        with pytest.raises(ValueError):
            match_template(O((3, 3)), O((5, 5)))

    def test_pad_input(self):
        template = 0.5 * np.asarray(diamond(2), float)
        image = 0.5 * np.ones((9, 19))
        mid = slice(2, 7)
        image[mid, :3] -= template[:, -3:]
        image[mid, 4:9] += template
        image[mid, -9:-4] -= template
        image[mid, -3:] += template[:, :3]

        result = np.asarray(match_template(
            T(image), T(template), pad_input=True,
            constant_values=float(image.mean()),
        ))
        sorted_result = np.argsort(result.ravel())
        i, j = np.unravel_index(sorted_result[:2], result.shape)
        np.testing.assert_array_equal(j, (12, 0))
        i, j = np.unravel_index(sorted_result[-2:], result.shape)
        np.testing.assert_array_equal(j, (18, 6))

    def test_3d(self):
        np.random.seed(1)
        template = np.random.rand(3, 3, 3)
        image = np.zeros((12, 12, 12))
        image[3:6, 5:8, 4:7] = template
        result = match_template(T(image), T(template))
        assert result.shape == (10, 10, 10)
        assert np.unravel_index(
            int(result.argmax()), result.shape
        ) == (3, 5, 4)

    def test_3d_pad_input(self):
        np.random.seed(1)
        template = np.random.rand(3, 3, 3)
        image = np.zeros((12, 12, 12))
        image[3:6, 5:8, 4:7] = template
        result = match_template(
            T(image), T(template), pad_input=True
        )
        assert result.shape == (12, 12, 12)
        assert np.unravel_index(
            int(result.argmax()), result.shape
        ) == (4, 6, 5)

    def test_padding_reflect(self):
        template = np.asarray(diamond(2), float)
        image = np.zeros((10, 10))
        image[2:7, :3] = template[:, -3:]
        result = match_template(
            T(image), T(template), pad_input=True,
            mode="reflect",
        )
        assert np.unravel_index(
            int(result.argmax()), result.shape
        ) == (4, 0)

    def test_wrong_input(self):
        with pytest.raises(ValueError):
            match_template(O((5, 5, 1)), O((3, 3)))
        with pytest.raises(ValueError):
            match_template(O((5, 5)), O((3, 3, 2)))
        with pytest.raises(ValueError):
            match_template(O((5, 5, 3, 3)), O((3, 3, 2)))

    def test_bounding_values(self):
        """Correlation scores stay in [-1, 1] on a textured image."""
        rs = np.random.RandomState(3)
        img = (rs.uniform(size=(96, 96)) > 0.7).astype(float)
        template = np.zeros((3, 3))
        template[1, 1] = 1
        result = match_template(T(img), T(template))
        assert float(result.max()) < 1 + 1e-7
        assert float(result.min()) > -1 - 1e-7

# ---------------------------------------------------------------------------
# skimage's daisy suite
# ---------------------------------------------------------------------------


assert_array_almost_equal = np.testing.assert_array_almost_equal


def _texture(n):
    yy, xx = np.mgrid[0:n, 0:n]
    rnd = np.random.RandomState(21)
    img = (
        0.4
        + 0.25 * np.sin(yy / 5.0)
        + 0.2 * np.cos(xx / 7.0)
        + 0.1 * rnd.rand(n, n)
    )
    return T(np.clip(img, 0, 1))


def test_daisy_color_image_unsupported_error():
    img = Z((20, 20, 3))
    with pytest.raises(ValueError):
        daisy(img)


def test_daisy_desc_dims():
    img = img_as_float(_texture(128))
    rings = 2
    histograms = 4
    orientations = 3
    descs = daisy(
        img, rings=rings, histograms=histograms,
        orientations=orientations
    )
    assert descs.shape[2] == (rings * histograms + 1) * orientations

    rings = 4
    histograms = 5
    orientations = 13
    descs = daisy(
        img, rings=rings, histograms=histograms,
        orientations=orientations
    )
    assert descs.shape[2] == (rings * histograms + 1) * orientations


def test_descs_shape():
    img = img_as_float(_texture(256))
    radius = 20
    step = 8
    descs = daisy(img, radius=radius, step=step)
    assert descs.shape[0] == math.ceil(
        (img.shape[0] - radius * 2) / float(step)
    )
    assert descs.shape[1] == math.ceil(
        (img.shape[1] - radius * 2) / float(step)
    )

    img = img[:-1, :-2]
    radius = 5
    step = 3
    descs = daisy(img, radius=radius, step=step)
    assert descs.shape[0] == math.ceil(
        (img.shape[0] - radius * 2) / float(step)
    )
    assert descs.shape[1] == math.ceil(
        (img.shape[1] - radius * 2) / float(step)
    )


def test_daisy_sigmas_and_radii():
    img = img_as_float(_texture(64))
    sigmas = [1, 2, 3]
    radii = [1, 2]
    daisy(img, sigmas=sigmas, ring_radii=radii)


def test_daisy_incompatible_sigmas_and_radii():
    img = img_as_float(_texture(64))
    sigmas = [1, 2]
    radii = [1, 2]
    with pytest.raises(ValueError):
        daisy(img, sigmas=sigmas, ring_radii=radii)


def test_daisy_normalization():
    img = img_as_float(_texture(64))

    descs = np.asarray(daisy(img, normalization="l1"))
    for i in range(descs.shape[0]):
        for j in range(descs.shape[1]):
            assert_array_almost_equal(np.sum(descs[i, j, :]), 1)
    descs_ = np.asarray(daisy(img))
    assert_array_almost_equal(descs, descs_)

    descs = np.asarray(daisy(img, normalization="l2"))
    for i in range(descs.shape[0]):
        for j in range(descs.shape[1]):
            dtmp = descs[i, j, :]
            assert_array_almost_equal(np.sqrt(np.sum(dtmp * dtmp)), 1)

    orientations = 8
    descs = np.asarray(
        daisy(img, orientations=orientations, normalization="daisy")
    )
    desc_dims = descs.shape[2]
    for i in range(descs.shape[0]):
        for j in range(descs.shape[1]):
            for k in range(0, desc_dims, orientations):
                dtmp = descs[i, j, k: k + orientations]
                assert_array_almost_equal(
                    np.sqrt(np.sum(dtmp * dtmp)), 1
                )

    img = Z((50, 50))
    descs = np.asarray(daisy(img, normalization="off"))
    for i in range(descs.shape[0]):
        for j in range(descs.shape[1]):
            assert_array_almost_equal(np.sum(descs[i, j, :]), 0)

    with pytest.raises(ValueError):
        daisy(img, normalization="does_not_exist")


def test_daisy_visualization():
    img = img_as_float(_texture(32))
    descs, descs_img = daisy(img, visualize=True)
    assert descs_img.shape == (32, 32, 3)

# ---------------------------------------------------------------------------
# more template and daisy cases
# ---------------------------------------------------------------------------


class TestMatchTemplateCases:
    def test_docstring_golden(self):
        template = np.zeros((3, 3))
        template[1, 1] = 1
        image = np.zeros((6, 6))
        image[1, 1] = 1
        image[4, 4] = -1
        r = np.round(
            np.asarray(feature.match_template(image, template)), 3
        )
        exp = np.array(
            [
                [1, -0.125, 0, 0],
                [-0.125, -0.125, 0, 0],
                [0, 0, 0.125, 0.125],
                [0, 0, 0.125, -1],
            ]
        )
        np.testing.assert_allclose(r, exp)

    def test_pad_input_center_match(self):
        template = np.zeros((3, 3))
        template[1, 1] = 1
        image = np.zeros((6, 6))
        image[1, 1] = 1
        image[4, 4] = -1
        rp = np.asarray(
            feature.match_template(image, template, pad_input=True)
        )
        assert rp.shape == image.shape
        assert rp[1, 1] == pytest.approx(1.0, abs=1e-6)
        assert rp[4, 4] == pytest.approx(-1.0, abs=1e-6)

    def test_locates_shifted_patch(self):
        rng = np.random.RandomState(0)
        image = rng.rand(64, 64)
        patch = image[20:30, 35:47]
        resp = np.asarray(feature.match_template(image, patch))
        assert np.unravel_index(np.argmax(resp), resp.shape) == (20, 35)
        assert resp.max() == pytest.approx(1.0, abs=1e-6)

    def test_3d(self):
        rng = np.random.RandomState(1)
        vol = rng.rand(20, 21, 22)
        patch = vol[5:9, 6:10, 7:11]
        resp = np.asarray(feature.match_template(vol, patch))
        assert np.unravel_index(np.argmax(resp), resp.shape) == (
            5, 6, 7,
        )

    def test_validation(self):
        with pytest.raises(ValueError):
            feature.match_template(np.zeros((4, 4)),
                                   np.zeros((5, 5)))
        with pytest.raises(ValueError):
            feature.match_template(np.zeros((4, 4)),
                                   np.zeros((2, 2, 2)))


class TestDaisyCases:
    def test_shapes_and_l1(self):
        rng = np.random.RandomState(0)
        img = rng.rand(64, 64)
        d = np.asarray(
            feature.daisy(img, step=8, radius=15, rings=2,
                          histograms=6, orientations=8)
        )
        assert d.shape == (5, 5, (2 * 6 + 1) * 8)
        np.testing.assert_allclose(d.sum(-1), 1, atol=1e-6)

    def test_l2_and_daisy_norms(self):
        rng = np.random.RandomState(1)
        img = rng.rand(48, 48)
        d2 = np.asarray(
            feature.daisy(img, step=8, rings=2, normalization="l2")
        )
        np.testing.assert_allclose(
            np.sqrt((d2 * d2).sum(-1)), 1, atol=1e-6
        )
        d3 = np.asarray(
            feature.daisy(img, step=8, rings=2,
                          normalization="daisy")
        )
        np.testing.assert_allclose(
            np.sqrt((d3[:, :, :8] ** 2).sum(-1)), 1, atol=1e-6
        )

    def test_param_validation(self):
        img = np.zeros((32, 32))
        with pytest.raises(ValueError):
            feature.daisy(img, normalization="bogus")
        with pytest.raises(ValueError):
            feature.daisy(
                img, sigmas=[1, 2], ring_radii=[2, 4, 6]
            )
        # visualize=True returns (descriptors, an (M, N, 3) rendering)
        descs, descs_img = feature.daisy(img, visualize=True)
        assert descs_img.shape == img.shape + (3,)

    def test_sigmas_ring_radii_override(self):
        rng = np.random.RandomState(2)
        img = rng.rand(40, 40)
        d = np.asarray(
            feature.daisy(
                img, step=10, sigmas=[1.0, 2.0],
                ring_radii=[5],
            )
        )
        # rings=1 -> (1*8+1)*8 = 72 dims; radius=5 -> 30x30 grid
        assert d.shape[-1] == (1 * 8 + 1) * 8


# ---------------------------------------------------------------------------
# definitions in numpy / scipy
# ---------------------------------------------------------------------------


def close(got, want, tol):
    got = np.asarray(H(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _smooth(shape, seed, sigma=1.5):
    return sndi.gaussian_filter(np.random.default_rng(seed).random(shape),
                                sigma)


@pytest.mark.parametrize("shape", [(19, 23), (9, 10, 11)])
@pytest.mark.parametrize("mode", ["constant", "reflect", "nearest"])
def test_structure_tensor_matches_scipy(shape, mode):
    """Gaussian-smoothed products of scipy's sobel derivatives, 'rc'
    order, row-major upper triangle."""
    x = np.random.default_rng(20).random(shape)
    d = [sndi.sobel(x, axis=i, mode=mode, cval=0.5) for i in range(x.ndim)]
    want = [sndi.gaussian_filter(a * b, 1.3, mode=mode, cval=0.5)
            for a, b in itertools.combinations_with_replacement(d, 2)]
    got = structure_tensor(T(x), sigma=1.3, mode=mode, cval=0.5, order="rc")
    for g, w in zip(got, want):
        close(g, w, 1e-12)


@pytest.mark.parametrize("shape", [(19, 23), (9, 10, 11)])
def test_hessian_matrix_matches_numpy_gradient(shape):
    """np.gradient twice of scipy's gaussian, the axes reversed ('rc')."""
    x = np.random.default_rng(21).random(shape)
    g = np.gradient(sndi.gaussian_filter(x, 1.2, mode="constant"))
    axes = list(range(x.ndim))[::-1]
    want = [np.gradient(g[a], axis=b)
            for a, b in itertools.combinations_with_replacement(axes, 2)]
    for gt, w in zip(hessian_matrix(T(x), sigma=1.2), want):
        close(gt, w, 1e-12)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_eigenvalues_match_numpy_eigvalsh(n):
    """The closed forms (2x2, 3x3) and eigvalsh (4x4) against numpy,
    descending, diagonal and repeated cases included."""
    rng = np.random.default_rng(22 + n)
    A = rng.standard_normal((50, n, n))
    M = A + np.swapaxes(A, 1, 2)
    M[0] = np.diag(np.arange(n, 0, -1.0))   # diagonal
    M[1] = np.eye(n) * 2.5                  # one repeated eigenvalue
    M[2] = 0.0
    elems = [T(M[:, i, j].copy()) for i in range(n) for j in range(i, n)]
    want = np.linalg.eigvalsh(M)[:, ::-1].T
    close(hessian_matrix_eigvals(elems), want, 1e-6 if n == 3 else 1e-12)
    close(structure_tensor_eigenvalues(elems), want, 1e-6 if n == 3
          else 1e-12)


def _box(img, r, c, rl, cl):
    """Box sums over [y + r, y + r + rl) x [x + c, x + c + cl), clipped
    to the image, for every pixel: the direct definition."""
    rows, cols = img.shape
    out = np.zeros_like(img)
    for y in range(rows):
        for x in range(cols):
            out[y, x] = img[max(0, y + r): max(0, min(rows, y + r + rl)),
                            max(0, x + c): max(0, min(cols, x + c + cl))
                            ].sum()
    return out


@pytest.mark.parametrize("sigma", [1, 3, 5.5])
def test_hessian_matrix_det_matches_box_sums(sigma):
    """SURF's determinant: box filters of the image by direct sums."""
    x = np.random.default_rng(25).random((13, 16))
    size = int(3 * sigma)
    size += size % 2 == 0
    s2, s3 = (size - 1) // 2, size // 3
    mid = -(s3 - 1) // 2
    b = lambda *a: _box(x, *a)  # noqa: E731
    dxx = (b(-s3 + 1, -s2, 2 * s3 - 1, s3) - 2 * b(-s3 + 1, mid, 2 * s3 - 1,
                                                    s3)
           + b(-s3 + 1, s2 - s3 + 1, 2 * s3 - 1, s3))
    dyy = (b(-s2, -s3 + 1, s3, 2 * s3 - 1) - 2 * b(mid, -s3 + 1, s3,
                                                    2 * s3 - 1)
           + b(s2 - s3 + 1, -s3 + 1, s3, 2 * s3 - 1))
    dxy = (b(-s3, -s3, s3, s3) - b(-s3, 1, s3, s3) - b(1, -s3, s3, s3)
           + b(1, 1, s3, s3))
    w = 1.0 / size ** 2
    want = dxx * w * dyy * w - 0.81 * (dxy * w) ** 2
    close(hessian_matrix_det(T(x), sigma), want, 1e-12)


def _ncc(image, template):
    """Normalized cross-correlation of every valid window, float64."""
    th, tw = template.shape
    t = template - template.mean()
    out = np.zeros((image.shape[0] - th + 1, image.shape[1] - tw + 1))
    for i in range(out.shape[0]):
        for j in range(out.shape[1]):
            w = image[i:i + th, j:j + tw]
            w = w - w.mean()
            den = np.sqrt((w * w).sum() * (t * t).sum())
            out[i, j] = (w * t).sum() / den if den > 1e-12 else 0.0
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint8])
def test_match_template_matches_direct_ncc(dtype):
    """match_template without padding is the normalized cross-correlation
    of every valid window; float64 within 1e-10, float32 and uint8 (in
    float32) within 1e-4, their window sums' cumulative rounding."""
    rng = np.random.default_rng(26)
    img = (rng.random((17, 21)) * 200).astype(dtype)
    tmpl = img[4:9, 6:12].astype(np.float64) + rng.random((5, 6))
    got = match_template(T(img), T(tmpl.astype(dtype)))
    assert got.dtype == (torch.float64 if dtype == np.float64
                         else torch.float32)
    want = _ncc(img.astype(np.float64), tmpl.astype(dtype).astype(
        np.float64))
    close(got, want, 1e-10 if dtype == np.float64 else 1e-4)


def test_match_template_modes_pad_as_numpy():
    """pad_input with each numpy.pad mode, a callable too: the direct
    correlation of the image padded by numpy.pad ('empty' pads with
    zeros, as jnp.pad does); a name numpy.pad lacks raises
    NotImplementedError, as jnp.pad does."""
    rng = np.random.default_rng(27)
    img = rng.random((12, 14))
    tmpl = rng.random((3, 4))

    def fill(row, width, axis, kwargs):
        row[:width[0]] = -0.5
        row[len(row) - width[1]:] = 2.0 + axis

    for mode in ("constant", "edge", "symmetric", "reflect", "wrap",
                 "maximum", "minimum", "mean", "median", "linear_ramp",
                 "empty", fill):
        got = match_template(T(img), T(tmpl), pad_input=True, mode=mode)
        padded = np.pad(img, [(3, 3), (4, 4)],
                        mode="constant" if mode == "empty" else mode)
        full = _ncc(padded, tmpl)
        # the window centred (floor) on each pixel
        d0, d1 = 1 + (3 - 1) // 2, 1 + (4 - 1) // 2
        want = full[d0:d0 + 12, d1:d1 + 14]
        close(got, want, 1e-10)
    with pytest.raises(NotImplementedError):
        match_template(T(img), T(tmpl), mode="nearest")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_peak_local_max_threshold_compares_in_image_dtype(dtype):
    """``threshold_abs`` compares in the image's dtype, as cupyimg_tpu's
    Python float does: a float64 peak 1e-10 above 0.1 counts (a float32
    threshold would round to 0.10000000149 and drop it), and in float32
    a peak at float32(0.1) does not count, one ulp above it does.  Held
    against numpy's definition, with and without labels and through
    corner_peaks, and against cupyimg_tpu with a one-pixel footprint
    (its threshold test alone: no maximum filter to compile)."""
    img = np.zeros((9, 11), dtype)
    img[4, 4] = (0.1 + 1e-10 if dtype == np.float64
                 else np.nextafter(np.float32(0.1), np.float32(1)))
    img[2, 7] = 0.1
    is_max = img == sndi.maximum_filter(img, size=3, mode="constant")
    want = np.argwhere(is_max & (img > dtype(0.1)))
    np.testing.assert_array_equal(want, [[4, 4]])
    alone = dict(footprint=np.ones((1, 1)), exclude_border=False,
                 threshold_abs=0.1)
    np.testing.assert_array_equal(
        np.asarray(jf.peak_local_max(img, **alone)), want)
    np.testing.assert_array_equal(H(peak_local_max(T(img), **alone)), want)
    for labels in (None, T(np.ones(img.shape, np.int64))):
        np.testing.assert_array_equal(H(peak_local_max(
            T(img), min_distance=1, threshold_abs=0.1, labels=labels)), want)
    np.testing.assert_array_equal(H(corner_peaks(
        T(img), min_distance=1, threshold_abs=0.1)), want)


def test_peak_local_max_matches_maximum_filter_definition():
    """Distinct values, min_distance 1: the pixels equal to their 3x3
    maximum (zero beyond the edge) above the minimum, the border row
    excluded, highest first."""
    x = np.random.default_rng(28).random((40, 45))
    is_max = (x == sndi.maximum_filter(x, size=3, mode="constant"))
    is_max &= x > x.min()
    is_max[[0, -1], :] = False
    is_max[:, [0, -1]] = False
    pts = np.argwhere(is_max)
    want = pts[np.argsort(-x[tuple(pts.T)], kind="stable")]
    got = peak_local_max(T(x), min_distance=1)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(H(got), want)


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64)
# ---------------------------------------------------------------------------


def test_named_calls_match_cupyimg_tpu():
    """The traceable calls as one jit program of cupyimg_tpu (float64 and
    float32 images): within 1e-12 of max|ref| for float64 (1e-10 for
    the 3-D Hessian's eigenvalues), 2e-6 for float32 (2e-5 for
    match_template)."""
    cases = [
        ("corner_kitchen_rosenfeld f32", lambda m, a, b, v:
         m.corner_kitchen_rosenfeld(b, mode="reflect"), 2e-6),
        ("hessian_matrix_eigvals 3-D", lambda m, a, b, v:
         m.hessian_matrix_eigvals(m.hessian_matrix(v, sigma=1.5)), 1e-10),
        ("shape_index f32", lambda m, a, b, v: m.shape_index(b, sigma=2),
         2e-6),
        ("match_template f32 pad", lambda m, a, b, v: m.match_template(
            b, b[5:12, 6:15], pad_input=True, mode="edge"), 2e-5),
        ("match_template median pad", lambda m, a, b, v: m.match_template(
            a, a[5:12, 6:15], pad_input=True, mode="median"), 1e-12),
        ("match_template f32 linear_ramp pad", lambda m, a, b, v:
         m.match_template(b, b[5:12, 6:15], pad_input=True,
                          mode="linear_ramp"), 2e-5),
        ("daisy daisy-norm", lambda m, a, b, v: m.daisy(
            a, step=3, radius=6, rings=1, histograms=4, orientations=2,
            normalization="daisy"), 1e-12),
    ]
    rng = np.random.default_rng(29)
    x = rng.random((30, 34))
    x32 = x.astype(np.float32)
    vol = rng.random((9, 10, 11))

    @jax.jit
    def ref(a, b, v):
        return [fn(jf, a, b, v) for _, fn, _ in cases]

    want = ref(jnp.asarray(x), jnp.asarray(x32), jnp.asarray(vol))
    for (name, fn, tol), w in zip(cases, want):
        got = fn(feature, T(x), T(x32), T(vol))
        w = np.asarray(w)
        assert H(got).dtype == w.dtype, name
        close(got, w, tol)


def test_public_names_match_cupyimg_tpu():
    """Every public name of cupyimg_tpu's feature package, the two
    registration aliases included."""
    assert set(jf.__all__) == set(feature.__all__)


# ---------------------------------------------------------------------------
# the card: the kernels serve the features (skip without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_cuda_float32_features_launch_the_kernels(cuda):
    from cupyimg_tpu_torch.ops import fused_fft as ff
    from cupyimg_tpu_torch.ops import fused_separable as fs

    x = _smooth((96, 128), 30).astype(np.float32)
    xc = T(x).cuda()
    corr, mm = fs.fused_separable_correlate, fs.fused_separable_minmax

    c0 = corr.launches
    close(corner_harris(xc).cpu(), H(corner_harris(T(x))), 1e-5)
    assert corr.launches - c0 == 5      # two sobels, three gaussians
    m0 = mm.launches
    np.testing.assert_array_equal(
        H(peak_local_max(xc, min_distance=3).cpu()),
        H(peak_local_max(T(x), min_distance=3)))
    assert mm.launches - m0 == 1
    f0 = ff.fft_rows.launches + ff.fft_strided.launches
    big = _smooth((600, 700), 31).astype(np.float32)
    close(match_template(T(big).cuda(), T(big[40:71, 50:81]).cuda()).cpu(),
          H(match_template(T(big), T(big[40:71, 50:81]))), 1e-4)
    assert ff.fft_rows.launches + ff.fft_strided.launches - f0 > 0
    c0 = corr.launches
    daisy(xc, step=8, radius=10)
    assert corr.launches - c0 == 4 * 8


@pytest.mark.parametrize("normalization", ["l1", "l2", "daisy", "off"])
def test_daisy_matches_numpy_definition(normalization):
    img = np.random.default_rng(32).random((40, 46))
    kw = dict(step=5, radius=9, rings=2, histograms=6, orientations=8)
    got = daisy(T(img), normalization=normalization, **kw)
    close(got, _daisy_reference(img, normalization=normalization, **kw),
          1e-12)
    got32 = daisy(T(img.astype(np.float32)), normalization=normalization,
                  **kw)
    assert got32.dtype == torch.float32
    close(got32, H(got), 1e-5)
