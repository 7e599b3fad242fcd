"""``skimage.transform`` of the torch port on CPU tensors.

- The warps, geometric-transform, pyramid and integral-image suites of
  skimage, with their literal expected numbers and synthetic stand-ins
  for skimage's bundled images.
- Full grids against scipy definitions: ``warp`` of an affine and of a
  projective map against ``scipy.ndimage.map_coordinates`` (every skimage
  mode, orders 0-5) with skimage's clip, ``resize`` against
  ``gaussian_filter`` then ``zoom(grid_mode=True)``, ``rotate`` against
  ``affine_transform``; ``integral_image`` against ``cumsum``.
- A named list against ``cupyimg_tpu`` on JAX-CPU (x64): the traceable
  calls as one jit program.
- The departures: ``resize(mode="non-existent")`` raises ValueError, the
  integral of an unsigned image is int64.
- The float32 warps run with every torch matmul entry point made to
  raise; the CUDA dispatch tests carry the ``cuda`` marker.

Tolerances: the suites' own decimals; float64 against scipy or
``cupyimg_tpu`` within 1e-12 of max|ref| (the spline orders above 1:
1e-10, a prefilter's recursion against scipy's); float32 against float64
references within 1e-5 of max|ref|.
"""

import math
import re
import textwrap
import warnings

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.skimage.transform as jt
from cupyimg_tpu_torch.core import dtypes
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.scipy.ndimage import map_coordinates
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float
from cupyimg_tpu_torch.skimage import transform as tf
from cupyimg_tpu_torch.skimage.transform import pyramids
from cupyimg_tpu_torch.skimage.transform._geometric import GeometricTransform
from cupyimg_tpu_torch.skimage.transform._warps import (
    _linear_polar_mapping,
    _log_polar_mapping,
    warp,
    warp_coords,
    rotate,
    resize,
    rescale,
    warp_polar,
    swirl,
    downscale_local_mean,
)
from cupyimg_tpu_torch.skimage.transform import (
    estimate_transform,
    matrix_transform,
    integral_image,
    integrate,
    EuclideanTransform,
    SimilarityTransform,
    AffineTransform,
    FundamentalMatrixTransform,
    EssentialMatrixTransform,
    ProjectiveTransform,
    PolynomialTransform,
    PiecewiseAffineTransform,
)

assert_almost_equal = np.testing.assert_almost_equal


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


def LS(start, stop, num):
    return torch.linspace(start, stop, num, dtype=torch.float64)


def cast(x, dtype):
    return x.to(dtypes.to_torch(dtype))


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)



# ---------------------------------------------------------------------------
# skimage's warps suite
# ---------------------------------------------------------------------------


def assert_array_equal(a, b):
    np.testing.assert_array_equal(H(a), H(b))


def assert_array_almost_equal(a, b, decimal=6):
    np.testing.assert_array_almost_equal(H(a), H(b), decimal=decimal)


def _checkerboard():
    """skimage.data.checkerboard stand-in: 200x200, 25-px squares."""
    idx = np.indices((200, 200)) // 25
    return T(((idx[0] + idx[1]) % 2).astype(np.float64))


def _rgb_like(shape=(128, 128), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(shape[0] // 4 + 2, shape[1] // 4 + 2, 3))
    up = np.kron(base, np.ones((4, 4, 1)))[: shape[0], : shape[1], :]
    return T(up.astype(np.float64))


def _aa_ring(shape, center, radius):
    """Anti-aliased circle perimeter (circle_perimeter_aa stand-in):
    intensity ramps linearly to 1 where the distance equals radius."""
    rr, cc = np.indices(shape)
    d = np.hypot(rr - center[0], cc - center[1])
    return np.clip(1.0 - np.abs(d - radius), 0.0, 1.0)


def _peaks_1d(profile):
    """Indices of strict local maxima above 10% of the global max."""
    p = np.asarray(profile)
    thresh = 0.1 * p.max()
    idx = [
        i
        for i in range(1, len(p) - 1)
        if p[i] > p[i - 1] and p[i] >= p[i + 1] and p[i] > thresh
    ]
    return np.asarray(idx)


def test_warp_tform():
    x = np.zeros((5, 5), dtype=np.double)
    x[2, 2] = 1
    x = T(x)
    theta = -np.pi / 2
    tform = SimilarityTransform(scale=1, rotation=theta, translation=(0, 4))

    x90 = warp(x, tform, order=1)
    assert_array_almost_equal(x90, np.rot90(np.asarray(x)))

    x90 = warp(x, tform.inverse, order=1)
    assert_array_almost_equal(x90, np.rot90(np.asarray(x)))


def test_warp_callable():
    x = np.zeros((5, 5), dtype=np.double)
    x[2, 2] = 1
    refx = np.zeros((5, 5), dtype=np.double)
    refx[1, 1] = 1

    def shift(xy):
        return xy + 1

    outx = warp(T(x), shift, order=1)
    assert_array_almost_equal(outx, refx)


def test_warp_matrix():
    x = np.zeros((5, 5), dtype=np.double)
    x[2, 2] = 1
    refx = np.zeros((5, 5), dtype=np.double)
    refx[1, 1] = 1

    matrix = T(
        [[1.0, 0, 1], [0, 1, 1], [0, 0, 1]]
    )
    outx = warp(T(x), matrix, order=1)
    assert_array_almost_equal(outx, refx)
    # orders above 1 work through the spline prefilter
    outx5 = warp(T(x), matrix, order=5)
    assert_array_almost_equal(outx5[1, 1], 1)


def test_warp_nd():
    for dim in range(2, 6):
        shape = dim * (5,)
        x = np.zeros(shape, dtype=np.double)
        x[dim * (2,)] = 1
        refx = np.zeros(shape, dtype=np.double)
        refx[dim * (1,)] = 1

        coord_grid = dim * (slice(0, 5, 1),)
        coords = T(np.array(np.mgrid[coord_grid]) + 1)

        outx = warp(T(x), coords, order=0, cval=0)
        assert_array_almost_equal(outx, refx)


def test_warp_clip():
    x = np.zeros((5, 5), dtype=np.double)
    x[2, 2] = 1
    x = T(x)

    outx = rescale(x, 3, order=3, clip=False, multichannel=False,
                   anti_aliasing=False, mode="constant")
    assert float(outx.min()) < 0

    outx = rescale(x, 3, order=3, clip=True, multichannel=False,
                   anti_aliasing=False, mode="constant")
    assert_array_almost_equal(float(outx.min()), 0)
    assert_array_almost_equal(float(outx.max()), 1)


def test_homography():
    x = np.zeros((5, 5), dtype=np.double)
    x[1, 1] = 1
    theta = -np.pi / 2
    M = np.asarray(
        [
            [np.cos(theta), -np.sin(theta), 0],
            [np.sin(theta), np.cos(theta), 4],
            [0, 0, 1],
        ]
    )
    x90 = warp(
        T(x),
        inverse_map=ProjectiveTransform(T(M)).inverse,
        order=1,
    )
    assert_array_almost_equal(x90, np.rot90(x))


def test_rotate():
    x = np.zeros((5, 5), dtype=np.double)
    x[1, 1] = 1
    x90 = rotate(T(x), 90)
    assert_array_almost_equal(x90, np.rot90(x))


def test_rotate_resize():
    x = Z((10, 10), dtype=np.float64)
    x45 = rotate(x, 45, resize=False)
    assert x45.shape == (10, 10)
    x45 = rotate(x, 45, resize=True)
    # new dimension should be d = sqrt(2 * (10/2)^2)
    assert x45.shape == (14, 14)


def test_rotate_center():
    x = np.zeros((10, 10), dtype=np.double)
    x[4, 4] = 1
    refx = np.zeros((10, 10), dtype=np.double)
    refx[2, 5] = 1
    x20 = rotate(T(x), 20, order=0, center=(0, 0))
    assert_array_almost_equal(x20, refx)
    x0 = rotate(x20, -20, order=0, center=(0, 0))
    assert_array_almost_equal(x0, x)


def test_rotate_resize_center():
    x = np.zeros((10, 10), dtype=np.double)
    x[0, 0] = 1
    x45 = rotate(T(x), 45, resize=True, center=(3, 3), order=0)
    assert x45.shape == (14, 14)


def test_rotate_resize_90():
    x90 = rotate(Z((470, 230), dtype=np.float64), 90, resize=True)
    assert x90.shape == (230, 470)


def test_rescale():
    # same scale factor
    x = np.zeros((5, 5), dtype=np.double)
    x[1, 1] = 1
    scaled = rescale(T(x), 2, order=0, multichannel=False,
                     anti_aliasing=False, mode="constant")
    ref = np.zeros((10, 10))
    ref[2:4, 2:4] = 1
    assert_array_almost_equal(scaled, ref)

    # different scale factors
    scaled = rescale(T(x), (2, 1), order=0, multichannel=False,
                     anti_aliasing=False, mode="constant")
    ref = np.zeros((10, 5))
    ref[2:4, 1] = 1
    assert_array_almost_equal(scaled, ref)


def test_rescale_invalid_scale():
    x = Z((10, 10, 3))
    with pytest.raises(ValueError):
        rescale(x, (2, 2), multichannel=False, anti_aliasing=False,
                mode="constant")
    with pytest.raises(ValueError):
        rescale(x, (2, 2, 2), multichannel=True, anti_aliasing=False,
                mode="constant")


def test_rescale_multichannel():
    # 1D + channels
    x = Z((8, 3), dtype=np.float64)
    scaled = rescale(x, 2, order=0, multichannel=True, anti_aliasing=False,
                     mode="constant")
    assert scaled.shape == (16, 3)
    # 2D
    scaled = rescale(x, 2, order=0, multichannel=False, anti_aliasing=False,
                     mode="constant")
    assert scaled.shape == (16, 6)

    # 2D + channels
    x = Z((8, 8, 3), dtype=np.float64)
    scaled = rescale(x, 2, order=0, multichannel=True, anti_aliasing=False,
                     mode="constant")
    assert scaled.shape == (16, 16, 3)
    # 3D
    scaled = rescale(x, 2, order=0, multichannel=False, anti_aliasing=False,
                     mode="constant")
    assert scaled.shape == (16, 16, 6)

    # 3D + channels
    x = Z((8, 8, 8, 3), dtype=np.float64)
    scaled = rescale(x, 2, order=0, multichannel=True, anti_aliasing=False,
                     mode="constant")
    assert scaled.shape == (16, 16, 16, 3)
    # 4D
    scaled = rescale(x, 2, order=0, multichannel=False, anti_aliasing=False,
                     mode="constant")
    assert scaled.shape == (16, 16, 16, 6)


def test_rescale_multichannel_multiscale():
    x = Z((5, 5, 3), dtype=np.float64)
    scaled = rescale(x, (2, 1), order=0, multichannel=True,
                     anti_aliasing=False, mode="constant")
    assert scaled.shape == (10, 5, 3)


def test_rescale_multichannel_defaults():
    x = Z((8, 3), dtype=np.float64)
    scaled = rescale(x, 2, order=0, anti_aliasing=False, mode="constant")
    assert scaled.shape == (16, 6)

    x = Z((8, 8, 3), dtype=np.float64)
    scaled = rescale(x, 2, order=0, anti_aliasing=False, mode="constant")
    assert scaled.shape == (16, 16, 6)


def test_resize2d():
    x = np.zeros((5, 5), dtype=np.double)
    x[1, 1] = 1
    resized = resize(T(x), (10, 10), order=0,
                     anti_aliasing=False, mode="constant")
    ref = np.zeros((10, 10))
    ref[2:4, 2:4] = 1
    assert_array_almost_equal(resized, ref)


def test_resize3d_keep():
    # keep 3rd dimension
    x = np.zeros((5, 5, 3), dtype=np.double)
    x[1, 1, :] = 1
    resized = resize(T(x), (10, 10), order=0,
                     anti_aliasing=False, mode="constant")
    with pytest.raises(ValueError):
        resize(T(x), (10,), order=0, anti_aliasing=False,
               mode="constant")
    ref = np.zeros((10, 10, 3))
    ref[2:4, 2:4, :] = 1
    assert_array_almost_equal(resized, ref)
    resized = resize(T(x), (10, 10, 3), order=0,
                     anti_aliasing=False, mode="constant")
    assert_array_almost_equal(resized, ref)


def test_resize3d_resize():
    # resize 3rd dimension
    x = np.zeros((5, 5, 3), dtype=np.double)
    x[1, 1, :] = 1
    resized = resize(T(x), (10, 10, 1), order=0,
                     anti_aliasing=False, mode="constant")
    ref = np.zeros((10, 10, 1))
    ref[2:4, 2:4] = 1
    assert_array_almost_equal(resized, ref)


def test_resize3d_2din_3dout():
    # 3D output with 2D input
    x = np.zeros((5, 5), dtype=np.double)
    x[1, 1] = 1
    resized = resize(T(x), (10, 10, 1), order=0,
                     anti_aliasing=False, mode="constant")
    ref = np.zeros((10, 10, 1))
    ref[2:4, 2:4] = 1
    assert_array_almost_equal(resized, ref)


def test_resize2d_4d():
    # resize with extra output dimensions
    x = np.zeros((5, 5), dtype=np.double)
    x[1, 1] = 1
    out_shape = (10, 10, 1, 1)
    resized = resize(T(x), out_shape, order=0,
                     anti_aliasing=False, mode="constant")
    ref = np.zeros(out_shape)
    ref[2:4, 2:4, ...] = 1
    assert_array_almost_equal(resized, ref)


def test_resize_nd():
    for dim in range(1, 6):
        shape = 2 + np.arange(dim) * 2
        x = O(tuple(int(s) for s in shape))
        out_shape = np.asarray(shape) * 1.5
        resized = resize(x, out_shape, order=0, mode="reflect",
                         anti_aliasing=False)
        assert resized.shape == tuple(int(1.5 * s) for s in shape)
        assert bool(torch.all(resized == 1))


def test_resize3d_bilinear():
    # bilinear 3rd dimension
    x = np.zeros((5, 5, 2), dtype=np.double)
    x[1, 1, 0] = 0
    x[1, 1, 1] = 1
    resized = resize(T(x), (10, 10, 1), order=1,
                     mode="constant", anti_aliasing=False)
    ref = np.zeros((10, 10, 1))
    ref[1:5, 1:5, :] = 0.03125
    ref[1:5, 2:4, :] = 0.09375
    ref[2:4, 1:5, :] = 0.09375
    ref[2:4, 2:4, :] = 0.28125
    assert_array_almost_equal(resized, ref)


def test_resize_dtype():
    x = Z((5, 5))
    x_f32 = cast(x, np.float32)
    x_u8 = cast(x, np.uint8)
    x_b = cast(x, bool)

    assert resize(x, (10, 10), preserve_range=False).dtype == x.dtype
    assert resize(x, (10, 10), preserve_range=True).dtype == x.dtype
    assert resize(x_u8, (10, 10), preserve_range=False).dtype == torch.float64
    assert resize(x_u8, (10, 10), preserve_range=True).dtype == torch.float64
    assert resize(x_b, (10, 10), preserve_range=False).dtype == torch.float64
    assert resize(x_b, (10, 10), preserve_range=True).dtype == torch.float64
    assert resize(x_f32, (10, 10), preserve_range=False).dtype == x_f32.dtype
    assert resize(x_f32, (10, 10), preserve_range=True).dtype == x_f32.dtype


def test_swirl():
    # a binary checkerboard round-trips at 0.016 in scipy itself (skimage's
    # bundled board has soft edges): bound 0.02
    image = img_as_float(_checkerboard())

    swirl_params = {"radius": 80, "rotation": 0, "order": 2,
                    "mode": "reflect"}
    swirled = swirl(image, strength=10, **swirl_params)
    unswirled = swirl(swirled, strength=-10, **swirl_params)
    assert float(torch.mean(torch.abs(image - unswirled))) < 0.02

    swirl_params.pop("mode")
    swirled = swirl(image, strength=10, **swirl_params)
    unswirled = swirl(swirled, strength=-10, **swirl_params)
    assert (
        float(torch.mean(torch.abs(image[1:-1, 1:-1] - unswirled[1:-1, 1:-1])))
        < 0.02
    )


def test_const_cval_out_of_range():
    img = T(np.random.RandomState(0).randn(100, 100))
    cval = -10
    warped = warp(img, AffineTransform(translation=(10, 10)), cval=cval)
    assert int(torch.sum(warped == cval)) == (2 * 100 * 10 - 10 * 10)


def test_warp_identity():
    img = img_as_float(_rgb_like(seed=1)[..., 0])
    assert img.ndim == 2
    assert bool(torch.allclose(img, warp(img, AffineTransform(rotation=0))))
    assert not bool(
        torch.allclose(img, warp(img, AffineTransform(rotation=0.1)))
    )

    rgb_img = torch.stack([img, torch.zeros_like(img), img], dim=-1)
    warped_rgb_img = warp(rgb_img, AffineTransform(rotation=0.1))
    assert bool(
        torch.allclose(rgb_img, warp(rgb_img, AffineTransform(rotation=0)))
    )
    assert not bool(torch.allclose(rgb_img, warped_rgb_img))
    # no cross-talk between bands
    assert bool(torch.all(0 == warped_rgb_img[:, :, 1]))


def test_warp_coords_example():
    image = cast(_rgb_like((128, 128), seed=2), np.float32)
    assert image.shape[2] == 3
    tform = SimilarityTransform(translation=(0, -10))
    coords = warp_coords(tform, (30, 30, 3))
    map_coordinates(image[:, :, 0], coords[:2])


def test_downsize():
    x = np.zeros((10, 10), dtype=np.double)
    x[2:4, 2:4] = 1
    scaled = resize(T(x), (5, 5), order=0, anti_aliasing=False,
                    mode="constant")
    assert scaled.shape == (5, 5)
    assert float(scaled[1, 1]) == 1
    assert float(scaled[2:, :].sum()) == 0
    assert float(scaled[:, 2:].sum()) == 0


def test_downsize_anti_aliasing():
    x = np.zeros((10, 10), dtype=np.double)
    x[2, 2] = 1
    scaled = resize(T(x), (5, 5), order=1, anti_aliasing=True,
                    mode="constant")
    assert scaled.shape == (5, 5)
    assert bool(torch.all(scaled[:3, :3] > 0))
    assert float(scaled[3:, :].sum()) == 0
    assert float(scaled[:, 3:].sum()) == 0

    sigma = 0.125
    out_size = (5, 5)
    for mode in ["constant", "edge", "symmetric", "reflect", "wrap"]:
        resize(T(x), out_size, order=1, mode=mode,
               anti_aliasing=True, anti_aliasing_sigma=sigma)
    with pytest.raises(ValueError):
        resize(T(x), out_size, order=1, mode="non-existent",
               anti_aliasing=True, anti_aliasing_sigma=sigma)


def test_downsize_anti_aliasing_invalid_stddev():
    x = Z((10, 10), dtype=np.float64)
    with pytest.raises(ValueError):
        resize(x, (5, 5), order=0, anti_aliasing=True,
               anti_aliasing_sigma=-1, mode="constant")
    with pytest.warns(UserWarning,
                      match="Anti-aliasing standard deviation greater"):
        resize(x, (5, 15), order=0, anti_aliasing=True,
               anti_aliasing_sigma=(1, 1), mode="reflect")


def test_downscale():
    x = np.zeros((10, 10), dtype=np.double)
    x[2:4, 2:4] = 1
    scaled = rescale(T(x), 0.5, order=0, anti_aliasing=False,
                     multichannel=False, mode="constant")
    assert scaled.shape == (5, 5)
    assert float(scaled[1, 1]) == 1
    assert float(scaled[2:, :].sum()) == 0
    assert float(scaled[:, 2:].sum()) == 0


def test_downscale_anti_aliasing():
    x = np.zeros((10, 10), dtype=np.double)
    x[2, 2] = 1
    scaled = rescale(T(x), 0.5, order=1, anti_aliasing=True,
                     multichannel=False, mode="constant")
    assert scaled.shape == (5, 5)
    assert bool(torch.all(scaled[:3, :3] > 0))
    assert float(scaled[3:, :].sum()) == 0
    assert float(scaled[:, 3:].sum()) == 0


def test_downscale_local_mean():
    image1 = torch.arange(4 * 6).reshape(4, 6)
    out1 = downscale_local_mean(image1, (2, 3))
    assert_array_equal([[4.0, 7.0], [16.0, 19.0]], out1)

    image2 = torch.arange(5 * 8).reshape(5, 8)
    out2 = downscale_local_mean(image2, (4, 5))
    assert_array_equal([[14.0, 10.8], [8.5, 5.7]], out2)


def test_invalid():
    with pytest.raises(ValueError):
        warp(O((4, 3, 3, 3)), SimilarityTransform())


def test_inverse():
    tform = SimilarityTransform(scale=0.5, rotation=0.1)
    inverse_tform = SimilarityTransform(
        matrix=np.linalg.inv(tform.params)
    )
    image = torch.arange(10 * 10, dtype=torch.float64).reshape(10, 10)
    assert_array_almost_equal(
        warp(image, inverse_tform), warp(image, tform.inverse)
    )


def test_slow_warp_nonint_oshape():
    image = T(np.random.RandomState(1).rand(5, 5))
    with pytest.raises(ValueError):
        warp(image, lambda xy: xy, output_shape=(13.1, 19.5))
    warp(image, lambda xy: xy, output_shape=(13.0001, 19.9999))


def test_keep_range():
    image = LS(0, 2, 25).reshape(5, 5)
    out = rescale(image, 2, preserve_range=False, clip=True, order=0,
                  mode="constant", multichannel=False, anti_aliasing=False)
    assert float(out.min()) == 0
    assert float(out.max()) == 2

    out = rescale(image, 2, preserve_range=True, clip=True, order=0,
                  mode="constant", multichannel=False, anti_aliasing=False)
    assert float(out.min()) == 0
    assert float(out.max()) == 2

    out = rescale(cast(image, np.uint8), 2, preserve_range=False,
                  mode="constant", multichannel=False, anti_aliasing=False,
                  clip=True, order=0)
    assert float(out.min()) == 0
    assert float(out.max()) == 2 / 255.0


def test_zero_image_size():
    with pytest.raises(ValueError):
        warp(Z(0), SimilarityTransform())
    with pytest.raises(ValueError):
        warp(Z((0, 10)), SimilarityTransform())
    with pytest.raises(ValueError):
        warp(Z((10, 0)), SimilarityTransform())
    with pytest.raises(ValueError):
        warp(Z((10, 10, 0)), SimilarityTransform())


def test_linear_polar_mapping():
    output_coords = T(
        [
            [0, 0], [0, 90], [0, 180], [0, 270],
            [99, 0], [99, 180], [99, 270], [99, 45],
        ],
        dtype=np.float64,
    )
    ground_truth = np.asarray(
        [
            [100, 100], [100, 100], [100, 100], [100, 100],
            [199, 100], [1, 100], [100, 1],
            [170.00357134, 170.00357134],
        ]
    )
    k_angle = 360 / (2 * np.pi)
    k_radius = 1
    center = (100, 100)
    coords = _linear_polar_mapping(output_coords, k_angle, k_radius, center)
    np.testing.assert_allclose(np.asarray(coords), ground_truth, atol=1e-6)


def test_log_polar_mapping():
    output_coords = T(
        [
            [0, 0], [0, 90], [0, 180], [0, 270],
            [99, 0], [99, 180], [99, 270], [99, 45],
        ],
        dtype=np.float64,
    )
    ground_truth = np.asarray(
        [
            [101, 100], [100, 101], [99, 100], [100, 99],
            [195.4992586, 100], [4.5007414, 100], [100, 4.5007414],
            [167.52817336, 167.52817336],
        ]
    )
    k_angle = 360 / (2 * np.pi)
    k_radius = 100 / np.log(100)
    center = (100, 100)
    coords = _log_polar_mapping(output_coords, k_angle, k_radius, center)
    np.testing.assert_allclose(np.asarray(coords), ground_truth, atol=1e-6)


def test_linear_warp_polar():
    radii = [5, 10, 15, 20]
    image = np.zeros((51, 51))
    for rad in radii:
        image += _aa_ring((51, 51), (25, 25), rad)
    warped = warp_polar(T(image), radius=25)
    profile = warped.mean(axis=0)
    peaks = _peaks_1d(profile)
    assert len(peaks) > 0
    assert all(peak in radii for peak in peaks)


def test_log_warp_polar():
    radii = [
        np.exp(2), np.exp(3), np.exp(4), np.exp(5),
        np.exp(5) - 1, np.exp(5) + 1,
    ]
    radii = [int(x) for x in radii]
    image = np.zeros((301, 301))
    for rad in radii:
        image += _aa_ring((301, 301), (150, 150), rad)
    warped = warp_polar(T(image), radius=200, scaling="log")
    profile = warped.mean(axis=0)
    peaks_coord = np.sort(_peaks_1d(profile))
    gaps = peaks_coord[1:] - peaks_coord[:-1]
    big_gaps = [g for g in gaps if g > 5]  # consecutive e^k ring spacings
    assert len(big_gaps) >= 3
    assert all(37 <= g <= 41 for g in big_gaps)


def test_invalid_scaling_polar():
    with pytest.raises(ValueError):
        warp_polar(Z((10, 10)), (5, 5), scaling="invalid")
    with pytest.raises(ValueError):
        warp_polar(Z((10, 10)), (5, 5), scaling=None)


def test_invalid_dimensions_polar():
    with pytest.raises(ValueError):
        warp_polar(Z((10, 10, 3)), (5, 5))
    with pytest.raises(ValueError):
        warp_polar(Z((10, 10)), (5, 5), multichannel=True)
    with pytest.raises(ValueError):
        warp_polar(Z((10, 10, 10, 3)), (5, 5), multichannel=True)


def test_bool_img_rescale():
    img = np.ones((12, 18), dtype=bool)
    img[2:-2, 4:-4] = False
    res = rescale(T(img), 0.5)
    expected = np.ones((6, 9))
    expected[1:-1, 2:-2] = False
    assert_array_equal(res, expected)


def test_bool_img_resize():
    img = np.ones((12, 18), dtype=bool)
    img[2:-2, 4:-4] = False
    res = resize(T(img), (6, 9))
    expected = np.ones((6, 9))
    expected[1:-1, 2:-2] = False
    assert_array_equal(res, expected)


def test_bool_array_warnings():
    img = Z((10, 10), dtype=bool)
    with pytest.warns(FutureWarning, match="Input image dtype is bool"):
        rescale(img, 0.5, anti_aliasing=True)
    with pytest.warns(FutureWarning, match="Input image dtype is bool"):
        resize(img, (5, 5), anti_aliasing=True)
    with pytest.warns(FutureWarning, match="Input image dtype is bool"):
        rescale(img, 0.5, order=1)
    with pytest.warns(FutureWarning, match="Input image dtype is bool"):
        resize(img, (5, 5), order=1)


# ---------------------------------------------------------------------------
# skimage's geometric suite
# ---------------------------------------------------------------------------


SRC = T(
    [
        [-12.3705, -10.5075],
        [-10.7865, 15.4305],
        [8.6985, 10.8675],
        [11.4975, -9.5715],
        [7.8435, 7.4835],
        [-5.3325, 6.5025],
        [6.7905, -6.3765],
        [-6.1695, -0.8235],
    ]
)
DST = T(
    [
        [0, 0],
        [0, 5800],
        [4900, 5800],
        [4900, 0],
        [4479, 4580],
        [1176, 3660],
        [3754, 790],
        [1024, 1931],
    ],
    dtype=np.float64,
)

_EPI_SRC = np.asarray(
    [
        1.839035, 1.924743, 0.543582, 0.375221,
        0.473240, 0.142522, 0.964910, 0.598376,
        0.102388, 0.140092, 15.994343, 9.622164,
        0.285901, 0.430055, 0.091150, 0.254594,
    ]
).reshape(-1, 2)
_EPI_DST = np.asarray(
    [
        1.002114, 1.129644, 1.521742, 1.846002,
        1.084332, 0.275134, 0.293328, 0.588992,
        0.839509, 0.087290, 1.779735, 1.116857,
        0.878616, 0.602447, 0.642616, 1.028681,
    ]
).reshape(-1, 2)


def test_estimate_transform():
    for tform in (
        "euclidean",
        "similarity",
        "affine",
        "projective",
        "polynomial",
    ):
        estimate_transform(tform, SRC[:2, :], DST[:2, :])
    with pytest.raises(ValueError):
        estimate_transform("foobar", SRC[:2, :], DST[:2, :])


def test_matrix_transform():
    tform = AffineTransform(scale=(0.1, 0.5), rotation=2)
    assert_array_equal(tform(SRC), matrix_transform(SRC, tform.params))


def test_euclidean_estimation():
    # exact solution
    tform = estimate_transform("euclidean", SRC[:2, :], SRC[:2, :] + 10)
    assert_array_almost_equal(tform(SRC[:2, :]), SRC[:2, :] + 10)
    assert_array_almost_equal(tform.params[0, 0], tform.params[1, 1])
    assert_array_almost_equal(tform.params[0, 1], -tform.params[1, 0])

    # over-determined
    tform2 = estimate_transform("euclidean", SRC, DST)
    assert_array_almost_equal(tform2.inverse(tform2(SRC)), SRC)
    assert_array_almost_equal(tform2.params[0, 0], tform2.params[1, 1])
    assert_array_almost_equal(tform2.params[0, 1], -tform2.params[1, 0])

    # via estimate method
    tform3 = EuclideanTransform()
    tform3.estimate(SRC, DST)
    assert_array_almost_equal(tform3.params, tform2.params)


def test_euclidean_init():
    # init with implicit parameters
    rotation = 1
    translation = (1, 1)
    tform = EuclideanTransform(rotation=rotation, translation=translation)
    assert_array_almost_equal(tform.rotation, rotation)
    assert_array_almost_equal(tform.translation, translation)

    # init with transformation matrix
    tform2 = EuclideanTransform(tform.params)
    assert_array_almost_equal(tform2.rotation, rotation)
    assert_array_almost_equal(tform2.translation, translation)

    # special case for rotation=0
    rotation = 0
    translation = (1, 1)
    tform = EuclideanTransform(rotation=rotation, translation=translation)
    assert_array_almost_equal(tform.rotation, rotation)
    assert_array_almost_equal(tform.translation, translation)

    # special case for rotation=90deg
    rotation = np.pi / 2
    translation = (1, 1)
    tform = EuclideanTransform(rotation=rotation, translation=translation)
    assert_array_almost_equal(tform.rotation, rotation)
    assert_array_almost_equal(tform.translation, translation)


def test_similarity_estimation():
    # exact solution
    tform = estimate_transform("similarity", SRC[:2, :], DST[:2, :])
    assert_array_almost_equal(tform(SRC[:2, :]), DST[:2, :])
    assert_array_almost_equal(tform.params[0, 0], tform.params[1, 1])
    assert_array_almost_equal(tform.params[0, 1], -tform.params[1, 0])

    # over-determined
    tform2 = estimate_transform("similarity", SRC, DST)
    assert_array_almost_equal(tform2.inverse(tform2(SRC)), SRC)
    assert_array_almost_equal(tform2.params[0, 0], tform2.params[1, 1])
    assert_array_almost_equal(tform2.params[0, 1], -tform2.params[1, 0])

    # via estimate method
    tform3 = SimilarityTransform()
    tform3.estimate(SRC, DST)
    assert_array_almost_equal(tform3.params, tform2.params)


def test_similarity_init():
    # init with implicit parameters
    scale = 0.1
    rotation = 1
    translation = (1, 1)
    tform = SimilarityTransform(
        scale=scale, rotation=rotation, translation=translation
    )
    assert_array_almost_equal(tform.scale, scale)
    assert_array_almost_equal(tform.rotation, rotation)
    assert_array_almost_equal(tform.translation, translation)

    # init with transformation matrix
    tform2 = SimilarityTransform(tform.params)
    assert_array_almost_equal(tform2.scale, scale)
    assert_array_almost_equal(tform2.rotation, rotation)
    assert_array_almost_equal(tform2.translation, translation)

    # special case for rotation=0
    scale = 0.1
    rotation = 0
    translation = (1, 1)
    tform = SimilarityTransform(
        scale=scale, rotation=rotation, translation=translation
    )
    assert_array_almost_equal(tform.scale, scale)
    assert_array_almost_equal(tform.rotation, rotation)
    assert_array_almost_equal(tform.translation, translation)

    # special case for rotation=90deg
    scale = 0.1
    rotation = np.pi / 2
    translation = (1, 1)
    tform = SimilarityTransform(
        scale=scale, rotation=rotation, translation=translation
    )
    assert_array_almost_equal(tform.scale, scale)
    assert_array_almost_equal(tform.rotation, rotation)
    assert_array_almost_equal(tform.translation, translation)

    # rotation not exactly 90deg but very close
    scale = 1.0
    rotation = np.pi / 2
    translation = (0, 0)
    params = np.array(
        [
            [0, -1, 1.33226763e-15],
            [1, 2.22044605e-16, -1.33226763e-15],
            [0, 0, 1],
        ]
    )
    tform = SimilarityTransform(params)
    assert_array_almost_equal(tform.scale, scale)
    assert_array_almost_equal(tform.rotation, rotation)
    assert_array_almost_equal(tform.translation, translation)


def test_affine_estimation():
    # exact solution
    tform = estimate_transform("affine", SRC[:3, :], DST[:3, :])
    assert_array_almost_equal(tform(SRC[:3, :]), DST[:3, :])

    # over-determined
    tform2 = estimate_transform("affine", SRC, DST)
    assert_array_almost_equal(tform2.inverse(tform2(SRC)), SRC)

    # via estimate method
    tform3 = AffineTransform()
    tform3.estimate(SRC, DST)
    assert_array_almost_equal(tform3.params, tform2.params)


def test_affine_init():
    # init with implicit parameters
    scale = (0.1, 0.13)
    rotation = 1
    shear = 0.1
    translation = (1, 1)
    tform = AffineTransform(
        scale=scale, rotation=rotation, shear=shear,
        translation=translation
    )
    assert_array_almost_equal(tform.scale, scale)
    assert_array_almost_equal(tform.rotation, rotation)
    assert_array_almost_equal(tform.shear, shear)
    assert_array_almost_equal(tform.translation, translation)

    # init with transformation matrix
    tform2 = AffineTransform(tform.params)
    assert_array_almost_equal(tform2.scale, scale)
    assert_array_almost_equal(tform2.rotation, rotation)
    assert_array_almost_equal(tform2.shear, shear)
    assert_array_almost_equal(tform2.translation, translation)

    # scalar vs. tuple scale arguments
    assert_array_almost_equal(
        AffineTransform(scale=0.5).scale,
        AffineTransform(scale=(0.5, 0.5)).scale,
    )


def test_piecewise_affine():
    tform = PiecewiseAffineTransform()
    tform.estimate(SRC, DST)
    # each single affine transform is exactly estimated
    assert_array_almost_equal(tform(SRC), DST)
    assert_array_almost_equal(tform.inverse(DST), SRC)


def test_fundamental_matrix_estimation():
    tform = estimate_transform("fundamental", _EPI_SRC, _EPI_DST)

    # Reference values obtained using COLMAP SfM library
    tform_ref = np.asarray(
        [
            [-0.217859, 0.419282, -0.0343075],
            [-0.0717941, 0.0451643, 0.0216073],
            [0.248062, -0.429478, 0.0221019],
        ]
    )
    # null-vector sign is implementation-defined; compare up to sign
    got = np.asarray(tform.params)
    if np.sign(got[0, 0]) != np.sign(tform_ref[0, 0]):
        got = -got
    assert_array_almost_equal(got, tform_ref, 6)


def test_fundamental_matrix_residuals():
    essential_matrix_tform = EssentialMatrixTransform(
        rotation=np.eye(3), translation=np.asarray([1, 0, 0])
    )
    tform = FundamentalMatrixTransform()
    tform.params = essential_matrix_tform.params
    src = np.asarray([[0, 0], [0, 0], [0, 0]])
    dst = np.asarray([[2, 0], [2, 1], [2, 2]])
    assert_array_almost_equal(
        tform.residuals(src, dst) ** 2, np.asarray([0, 0.5, 2])
    )


def test_fundamental_matrix_forward():
    essential_matrix_tform = EssentialMatrixTransform(
        rotation=np.eye(3), translation=np.array([1, 0, 0])
    )
    tform = FundamentalMatrixTransform()
    tform.params = essential_matrix_tform.params
    src = np.asarray([[0, 0], [0, 1], [1, 1]])
    assert_array_almost_equal(
        tform(src), np.asarray([[0, -1, 0], [0, -1, 1], [0, -1, 1]])
    )


def test_fundamental_matrix_inverse():
    essential_matrix_tform = EssentialMatrixTransform(
        rotation=np.eye(3), translation=np.array([1, 0, 0])
    )
    tform = FundamentalMatrixTransform()
    tform.params = essential_matrix_tform.params
    src = np.asarray([[0, 0], [0, 1], [1, 1]])
    assert_array_almost_equal(
        tform.inverse(src),
        np.asarray([[0, 1, 0], [0, 1, -1], [0, 1, -1]]),
    )


def test_essential_matrix_init():
    tform = EssentialMatrixTransform(
        rotation=np.eye(3), translation=np.array([0, 0, 1])
    )
    assert_array_equal(
        tform.params,
        np.asarray([0, -1, 0, 1, 0, 0, 0, 0, 0]).reshape(3, 3),
    )


def test_essential_matrix_estimation():
    tform = estimate_transform("essential", _EPI_SRC, _EPI_DST)

    # Reference values obtained using COLMAP SfM library
    tform_ref = np.asarray(
        [
            [-0.0811666, 0.255449, -0.0478999],
            [-0.192392, -0.0531675, 0.119547],
            [0.177784, -0.22008, -0.015203],
        ]
    )
    got = np.asarray(tform.params)
    if np.sign(got[0, 0]) != np.sign(tform_ref[0, 0]):
        got = -got
    assert_array_almost_equal(got, tform_ref, 6)


def test_essential_matrix_forward():
    tform = EssentialMatrixTransform(
        rotation=np.eye(3), translation=np.array([1, 0, 0])
    )
    src = np.array([[0, 0], [0, 1], [1, 1]])
    assert_array_almost_equal(
        tform(src), np.asarray([[0, -1, 0], [0, -1, 1], [0, -1, 1]])
    )


def test_essential_matrix_inverse():
    tform = EssentialMatrixTransform(
        rotation=np.eye(3), translation=np.array([1, 0, 0])
    )
    src = np.asarray([[0, 0], [0, 1], [1, 1]])
    assert_array_almost_equal(
        tform.inverse(src),
        np.asarray([[0, 1, 0], [0, 1, -1], [0, 1, -1]]),
    )


def test_essential_matrix_residuals():
    tform = EssentialMatrixTransform(
        rotation=np.eye(3), translation=np.array([1, 0, 0])
    )
    src = np.asarray([[0, 0], [0, 0], [0, 0]])
    dst = np.asarray([[2, 0], [2, 1], [2, 2]])
    assert_array_almost_equal(
        tform.residuals(src, dst) ** 2, np.asarray([0, 0.5, 2])
    )


def test_projective_estimation():
    # exact solution
    tform = estimate_transform("projective", SRC[:4, :], DST[:4, :])
    assert_array_almost_equal(tform(SRC[:4, :]), DST[:4, :])

    # over-determined
    tform2 = estimate_transform("projective", SRC, DST)
    assert_array_almost_equal(tform2.inverse(tform2(SRC)), SRC)

    # via estimate method
    tform3 = ProjectiveTransform()
    tform3.estimate(SRC, DST)
    assert_array_almost_equal(tform3.params, tform2.params)


def test_projective_init():
    tform = estimate_transform("projective", SRC, DST)
    # init with transformation matrix
    tform2 = ProjectiveTransform(tform.params)
    assert_array_almost_equal(tform2.params, tform.params)


def test_polynomial_estimation():
    # over-determined
    tform = estimate_transform("polynomial", SRC, DST, order=10)
    assert_array_almost_equal(tform(SRC), DST, 6)

    # via estimate method
    tform2 = PolynomialTransform()
    tform2.estimate(SRC, DST, order=10)
    assert_array_almost_equal(tform2.params, tform.params)


def test_polynomial_init():
    tform = estimate_transform("polynomial", SRC, DST, order=10)
    # init with transformation parameters
    tform2 = PolynomialTransform(tform.params)
    assert_array_almost_equal(tform2.params, tform.params)


def test_polynomial_default_order():
    tform = estimate_transform("polynomial", SRC, DST)
    tform2 = estimate_transform("polynomial", SRC, DST, order=2)
    assert_array_almost_equal(tform2.params, tform.params)


def test_polynomial_inverse():
    with pytest.raises(Exception):
        PolynomialTransform().inverse(0)


def test_union():
    tform1 = SimilarityTransform(scale=0.1, rotation=0.3)
    tform2 = SimilarityTransform(scale=0.1, rotation=0.9)
    tform3 = SimilarityTransform(scale=0.1 ** 2, rotation=0.3 + 0.9)
    tform = tform1 + tform2
    assert_array_almost_equal(tform.params, tform3.params)

    tform1 = AffineTransform(scale=(0.1, 0.1), rotation=0.3)
    tform2 = SimilarityTransform(scale=0.1, rotation=0.9)
    tform3 = SimilarityTransform(scale=0.1 ** 2, rotation=0.3 + 0.9)
    tform = tform1 + tform2
    assert_array_almost_equal(tform.params, tform3.params)
    assert tform.__class__ == ProjectiveTransform

    tform = AffineTransform(scale=(0.1, 0.1), rotation=0.3)
    assert_array_almost_equal(
        (tform + tform.inverse).params, np.eye(3)
    )

    tform1 = SimilarityTransform(scale=0.1, rotation=0.3)
    tform2 = SimilarityTransform(scale=0.1, rotation=0.9)
    tform3 = SimilarityTransform(scale=0.1 * 1 / 0.1, rotation=0.3 - 0.9)
    tform = tform1 + tform2.inverse
    assert_array_almost_equal(tform.params, tform3.params)


def test_union_differing_types():
    tform1 = SimilarityTransform()
    tform2 = PolynomialTransform()
    with pytest.raises(TypeError):
        tform1.__add__(tform2)


def test_geometric_tform():
    tform = GeometricTransform()
    with pytest.raises(NotImplementedError):
        tform(0)
    with pytest.raises(NotImplementedError):
        tform.inverse(0)
    with pytest.raises(NotImplementedError):
        tform.__add__(0)

    # See skimage gh-3926
    rng = np.random.RandomState(0)
    for i in range(20):
        # generate a random homography
        H = rng.rand(3, 3) * 100
        H[2, H[2] == 0] += np.finfo(float).eps
        H /= H[2, 2]

        # craft src coords that hit the w == 0 plane
        src = np.array(
            [
                [(H[2, 1] + 1) / -H[2, 0], 1],
                [1, (H[2, 0] + 1) / -H[2, 1]],
                [1, 1],
            ]
        )

        tform = ProjectiveTransform(H)
        dst = tform(src)
        # dst coords must be finite numeric values
        assert np.isfinite(np.asarray(dst)).all()


def test_invalid_input():
    with pytest.raises(ValueError):
        ProjectiveTransform(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        AffineTransform(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        SimilarityTransform(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        EuclideanTransform(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        AffineTransform(matrix=np.zeros((2, 3)), scale=1)
    with pytest.raises(ValueError):
        SimilarityTransform(matrix=np.zeros((2, 3)), scale=1)
    with pytest.raises(ValueError):
        EuclideanTransform(
            matrix=np.zeros((2, 3)), translation=(0, 0)
        )
    with pytest.raises(ValueError):
        PolynomialTransform(np.zeros((3, 3)))
    with pytest.raises(ValueError):
        FundamentalMatrixTransform(matrix=np.zeros((3, 2)))
    with pytest.raises(ValueError):
        EssentialMatrixTransform(matrix=np.zeros((3, 2)))

    with pytest.raises(ValueError):
        EssentialMatrixTransform(rotation=np.zeros((3, 2)))
    with pytest.raises(ValueError):
        EssentialMatrixTransform(
            rotation=np.zeros((3, 3)), translation=np.asarray([1, 0, 0])
        )
    with pytest.raises(ValueError):
        EssentialMatrixTransform(rotation=np.eye(3))
    with pytest.raises(ValueError):
        EssentialMatrixTransform(
            rotation=np.eye(3), translation=np.zeros((2,))
        )
    with pytest.raises(ValueError):
        EssentialMatrixTransform(
            rotation=np.eye(3), translation=np.zeros((3,))
        )


def test_degenerate():
    src = dst = Z((10, 2))

    tform = SimilarityTransform()
    tform.estimate(src, dst)
    assert np.all(np.isnan(np.asarray(tform.params)))

    tform = AffineTransform()
    tform.estimate(src, dst)
    assert np.all(np.isnan(np.asarray(tform.params)))

    tform = ProjectiveTransform()
    tform.estimate(src, dst)
    assert np.all(np.isnan(np.asarray(tform.params)))

    # See skimage gh-3926
    tform = ProjectiveTransform()
    rng = np.random.RandomState(1)
    for i in range(20):
        # degenerate: all points on a single line
        src = rng.rand(4, 2) * 100
        dst = rng.rand(4, 2) * 100
        src[:, 1] = rng.rand()
        ok = tform.estimate(src, dst)
        assert not ok or np.isfinite(np.asarray(tform.params)).all()


def test_projective_repr():
    tform = ProjectiveTransform()
    want = (
        re.escape(
            textwrap.dedent(
                """
        <ProjectiveTransform(matrix=
            [[1., 0., 0.],
             [0., 1., 0.],
             [0., 0., 1.]]) at
        """
            ).strip()
        )
        + " 0x[a-f0-9]+"
        + re.escape(">")
    )
    # allow whitespace before each number (numpy version differences)
    want = want.replace("0\\.", " *0\\.")
    want = want.replace("1\\.", " *1\\.")
    assert re.match(want, repr(tform))


def test_projective_str():
    tform = ProjectiveTransform()
    want = re.escape(
        textwrap.dedent(
            """
        <ProjectiveTransform(matrix=
            [[1., 0., 0.],
             [0., 1., 0.],
             [0., 0., 1.]])>
        """
        ).strip()
    )
    want = want.replace("0\\.", " *0\\.")
    want = want.replace("1\\.", " *1\\.")
    assert re.match(want, str(tform))


# ---------------------------------------------------------------------------
# skimage's pyramid suite
# ---------------------------------------------------------------------------


def _synthetic_astronaut():
    yy, xx = np.mgrid[0:512, 0:512]
    r = 128 + 80 * np.sin(yy / 19.0) + 47 * np.cos(xx / 31.0)
    g = np.rot90(r)
    b = 255.0 * (yy + xx) / 1022.0
    img = np.stack([r, g, b], axis=-1)
    # hit the exact 0/255 endpoints so ptp() checks see the full range
    img.reshape(-1, 3)[0] = [0, 0, 0]
    img.reshape(-1, 3)[-1] = [255, 255, 255]
    return np.clip(img, 0, 255).astype(np.uint8)


image = T(_synthetic_astronaut())
image_gray = image[..., 0]
_rng = np.random.RandomState(42)


def test_pyramid_reduce_rgb():
    rows, cols, dim = image.shape
    out = pyramids.pyramid_reduce(image, downscale=2, multichannel=True)
    assert_array_equal(out.shape, (rows / 2, cols / 2, dim))


def test_pyramid_reduce_gray():
    rows, cols = image_gray.shape
    out1 = pyramids.pyramid_reduce(
        image_gray, downscale=2, multichannel=False
    )
    assert_array_equal(out1.shape, (rows / 2, cols / 2))
    assert_almost_equal(float(np.ptp(np.asarray(out1))), 1.0, decimal=2)
    out2 = pyramids.pyramid_reduce(
        image_gray, downscale=2, multichannel=False, preserve_range=True
    )
    assert_almost_equal(
        float(np.ptp(np.asarray(out2)))
        / float(np.ptp(np.asarray(image_gray))),
        1.0,
        decimal=2,
    )


def test_pyramid_reduce_nd():
    for ndim in [1, 2, 3, 4]:
        img = T(_rng.randn(*((8,) * ndim)))
        out = pyramids.pyramid_reduce(
            img, downscale=2, multichannel=False
        )
        expected_shape = np.asarray(img.shape) / 2
        assert_array_equal(out.shape, expected_shape)


def test_pyramid_expand_rgb():
    rows, cols, dim = image.shape
    out = pyramids.pyramid_expand(image, upscale=2, multichannel=True)
    assert_array_equal(out.shape, (rows * 2, cols * 2, dim))


def test_pyramid_expand_gray():
    rows, cols = image_gray.shape
    out = pyramids.pyramid_expand(
        image_gray, upscale=2, multichannel=False
    )
    assert_array_equal(out.shape, (rows * 2, cols * 2))


def test_pyramid_expand_nd():
    for ndim in [1, 2, 3, 4]:
        img = T(_rng.randn(*((4,) * ndim)))
        out = pyramids.pyramid_expand(img, upscale=2, multichannel=False)
        expected_shape = np.asarray(img.shape) * 2
        assert_array_equal(out.shape, expected_shape)


def test_build_gaussian_pyramid_rgb():
    rows, cols, dim = image.shape
    pyramid = pyramids.pyramid_gaussian(
        image, downscale=2, multichannel=True
    )
    for layer, out in enumerate(pyramid):
        layer_shape = (rows / 2 ** layer, cols / 2 ** layer, dim)
        assert_array_equal(out.shape, layer_shape)


def test_build_gaussian_pyramid_gray():
    rows, cols = image_gray.shape
    pyramid = pyramids.pyramid_gaussian(
        image_gray, downscale=2, multichannel=False
    )
    for layer, out in enumerate(pyramid):
        layer_shape = (rows / 2 ** layer, cols / 2 ** layer)
        assert_array_equal(out.shape, layer_shape)


def test_build_gaussian_pyramid_nd():
    for ndim in [1, 2, 3, 4]:
        img = T(_rng.randn(*((8,) * ndim)))
        original_shape = np.asarray(img.shape)
        pyramid = pyramids.pyramid_gaussian(
            img, downscale=2, multichannel=False
        )
        for layer, out in enumerate(pyramid):
            layer_shape = original_shape / 2 ** layer
            assert_array_equal(out.shape, layer_shape)


def test_build_laplacian_pyramid_rgb():
    rows, cols, dim = image.shape
    pyramid = pyramids.pyramid_laplacian(
        image, downscale=2, multichannel=True
    )
    for layer, out in enumerate(pyramid):
        layer_shape = (rows / 2 ** layer, cols / 2 ** layer, dim)
        assert_array_equal(out.shape, layer_shape)


def test_build_laplacian_pyramid_nd():
    for ndim in [1, 2, 3, 4]:
        img = T(_rng.randn(*(16,) * ndim))
        original_shape = np.asarray(img.shape)
        pyramid = pyramids.pyramid_laplacian(
            img, downscale=2, multichannel=False
        )
        for layer, out in enumerate(pyramid):
            layer_shape = original_shape / 2 ** layer
            assert_array_equal(out.shape, layer_shape)


def test_laplacian_pyramid_max_layers():
    for downscale in [2, 3, 5, 7]:
        img = T(_rng.randn(32, 8))
        pyramid = pyramids.pyramid_laplacian(
            img, downscale=downscale, multichannel=False
        )
        max_layer = int(np.ceil(math.log(np.max(img.shape), downscale)))
        for layer, out in enumerate(pyramid):
            if layer < max_layer:
                # should not reach size 1 on all axes before the last level
                assert np.max(out.shape) > 1

        # total number of images is max_layer + 1
        assert max_layer == layer

        # final layer should be size 1 on all axes
        assert out.shape == (1, 1)


def test_check_factor():
    with pytest.raises(ValueError):
        pyramids._check_factor(0.99)
    with pytest.raises(ValueError):
        pyramids._check_factor(-2)


@pytest.mark.parametrize(
    "dtype, expected",
    zip(
        ["float32", "float64", "uint8", "int64"],
        ["float32", "float64", "float64", "float64"],
    ),
)
def test_pyramid_gaussian_dtype_support(dtype, expected):
    img = cast(T(_rng.randn(32, 8)), dtype)
    pyramid = pyramids.pyramid_gaussian(img)

    assert all([im.dtype == dtypes.to_torch(expected) for im in pyramid])


# ---------------------------------------------------------------------------
# integral images
# ---------------------------------------------------------------------------


class TestIntegral:
    def setup_method(self):
        rng = np.random.RandomState(0)
        self.x = (rng.rand(50, 50) * 255).astype(np.uint8)
        self.s = integral_image(T(self.x))

    def test_validity(self):
        rng = np.random.RandomState(1)
        y = (rng.rand(50, 50) * 255).astype(np.uint8)
        assert_array_equal(
            np.asarray(integral_image(T(y)))[-1, -1], y.sum()
        )

    def test_basic(self):
        x, s = self.x, self.s
        assert_array_equal(
            x[12:24, 10:20].sum(),
            np.asarray(integrate(s, (12, 10), (23, 19))),
        )
        assert_array_equal(
            x[:20, :20].sum(), np.asarray(integrate(s, (0, 0), (19, 19)))
        )
        assert_array_equal(
            x[:20, 10:20].sum(), np.asarray(integrate(s, (0, 10), (19, 19)))
        )
        assert_array_equal(
            x[10:20, :20].sum(), np.asarray(integrate(s, (10, 0), (19, 19)))
        )

    def test_single(self):
        x, s = self.x, self.s
        assert_array_equal(x[0, 0], np.asarray(integrate(s, (0, 0), (0, 0))))
        assert_array_equal(
            x[10, 10], np.asarray(integrate(s, (10, 10), (10, 10)))
        )

    def test_vectorized_integrate(self):
        x, s = self.x, self.s
        r0 = np.array([12, 0, 0, 10, 0, 10, 30])
        c0 = np.array([10, 0, 10, 0, 0, 10, 31])
        r1 = np.array([23, 19, 19, 19, 0, 10, 49])
        c1 = np.array([19, 19, 19, 19, 0, 10, 49])
        expected = np.array([x[12:24, 10:20].sum(),
                             x[:20, :20].sum(),
                             x[:20, 10:20].sum(),
                             x[10:20, :20].sum(),
                             x[0, 0],
                             x[10, 10],
                             x[30:, 31:].sum()])
        start_pts = [(r0[i], c0[i]) for i in range(len(r0))]
        end_pts = [(r1[i], c1[i]) for i in range(len(r0))]
        assert_array_equal(
            expected, np.asarray(integrate(s, start_pts, end_pts))
        )


def _img(shape=(32, 37), seed=0):
    return np.random.RandomState(seed).rand(*shape)


class TestGeometric:
    def test_similarity_estimate_exact(self):
        rng = np.random.RandomState(0)
        src = rng.rand(10, 2) * 20
        t_true = tf.SimilarityTransform(
            scale=1.3, rotation=0.4, translation=(2.0, -3.0)
        )
        dst = np.asarray(t_true(src))
        t_est = tf.estimate_transform("similarity", src, dst)
        np.testing.assert_allclose(t_est.params, t_true.params, atol=1e-9)
        assert t_est.scale == pytest.approx(1.3)
        assert t_est.rotation == pytest.approx(0.4)

    def test_euclidean_estimate(self):
        rng = np.random.RandomState(1)
        src = rng.rand(8, 2) * 10
        t_true = tf.EuclideanTransform(rotation=-0.3, translation=(1.0, 4.0))
        dst = np.asarray(t_true(src))
        t_est = tf.estimate_transform("euclidean", src, dst)
        np.testing.assert_allclose(t_est.params, t_true.params, atol=1e-9)

    def test_affine_estimate(self):
        rng = np.random.RandomState(2)
        src = rng.rand(12, 2) * 10
        t_true = tf.AffineTransform(
            scale=(1.2, 0.9), rotation=0.2, shear=0.1, translation=(3, -2)
        )
        dst = np.asarray(t_true(src))
        t_est = tf.estimate_transform("affine", src, dst)
        np.testing.assert_allclose(t_est.params, t_true.params, atol=1e-8)

    def test_projective_estimate(self):
        rng = np.random.RandomState(3)
        src = rng.rand(10, 2) * 10
        m = np.array([[1.1, 0.2, 1.0], [-0.1, 0.95, 2.0], [0.001, 0.002, 1]])
        t_true = tf.ProjectiveTransform(m)
        dst = np.asarray(t_true(src))
        t_est = tf.estimate_transform("projective", src, dst)
        np.testing.assert_allclose(
            t_est.params / t_est.params[2, 2], m / m[2, 2], atol=1e-6
        )

    def test_inverse_roundtrip(self):
        t = tf.AffineTransform(scale=(1.5, 0.7), rotation=0.3,
                               translation=(5, 6))
        pts = np.random.RandomState(4).rand(7, 2) * 10
        back = np.asarray(t.inverse(np.asarray(t(pts))))
        np.testing.assert_allclose(back, pts, atol=1e-9)

    def test_compose(self):
        t1 = tf.SimilarityTransform(scale=2.0)
        t2 = tf.SimilarityTransform(translation=(1, 2))
        t = t1 + t2
        pts = np.array([[1.0, 1.0]])
        np.testing.assert_allclose(
            np.asarray(t(pts)), [[3.0, 4.0]], atol=1e-12
        )

    def test_polynomial_estimate(self):
        rng = np.random.RandomState(5)
        src = rng.rand(20, 2) * 10
        t_true = tf.AffineTransform(scale=(1.1, 0.9), translation=(1, 2))
        dst = np.asarray(t_true(src))
        t_poly = tf.estimate_transform("polynomial", src, dst, order=1)
        np.testing.assert_allclose(
            np.asarray(t_poly(src)), dst, atol=1e-7
        )

    def test_fundamental_epipolar_constraint(self):
        rng = np.random.RandomState(6)
        # synthetic stereo pair: 3D points projected into two views
        pts3 = rng.rand(20, 3) * 5 + np.array([0, 0, 10])
        R = tf.EuclideanTransform(rotation=0.1).params[:2, :2]
        R3 = np.eye(3)
        R3[:2, :2] = R
        t = np.array([1.0, 0.2, 0.1])
        src = pts3[:, :2] / pts3[:, 2:]
        cam2 = (pts3 @ R3.T) + t
        dst = cam2[:, :2] / cam2[:, 2:]
        f = tf.FundamentalMatrixTransform()
        assert f.estimate(src, dst)
        res = f.residuals(src, dst)
        assert np.max(np.abs(res)) < 1e-6

    def test_essential_matrix_construction(self):
        R = np.eye(3)
        t = np.array([1.0, 0, 0])
        e = tf.EssentialMatrixTransform(rotation=R, translation=t)
        assert e.params.shape == (3, 3)

    def test_matrix_transform(self):
        m = np.eye(3)
        m[0, 2] = 2
        out = np.asarray(tf.matrix_transform([[1.0, 1.0]], m))
        np.testing.assert_allclose(out, [[3.0, 1.0]], atol=1e-12)


class TestWarps:
    def test_warp_identity(self):
        x = _img()
        out = np.asarray(tf.warp(x, tf.AffineTransform()))
        np.testing.assert_allclose(out, x, atol=1e-9)

    def test_warp_translation_matches_shift(self):
        x = _img()
        t = tf.AffineTransform(translation=(2, 3))  # x=col shift 2, row 3
        out = np.asarray(tf.warp(x, t, order=1))
        exp = sndi.shift(x, (-3, -2), order=1, mode="constant")
        np.testing.assert_allclose(out, exp, atol=1e-8)

    def test_warp_coords_array(self):
        x = _img()
        rows, cols = np.meshgrid(
            np.arange(32), np.arange(37), indexing="ij"
        )
        coords = np.stack([rows + 1.5, cols], 0)
        out = np.asarray(tf.warp(x, coords, order=1))
        exp = sndi.shift(x, (-1.5, 0), order=1, mode="constant")
        np.testing.assert_allclose(out, exp, atol=1e-8)

    def test_rotate_90(self):
        x = _img()
        out = np.asarray(tf.rotate(x, 90.0, resize=True, order=0))
        assert out.shape == (37, 32)

    def test_rotate_matches_scipy(self):
        x = _img((40, 40), 1)
        got = np.asarray(tf.rotate(x, 35.0, order=1))
        exp = sndi.rotate(x, 35.0, reshape=False, order=1)
        interior = (slice(12, 28), slice(12, 28))
        np.testing.assert_allclose(got[interior], exp[interior], atol=1e-12)

    def test_rotate_roundtrip_smooth(self):
        r, c = np.mgrid[0:40, 0:40]
        x = np.sin(r / 6.0) * np.cos(c / 7.0) * 0.5 + 0.5
        out = np.asarray(
            tf.rotate(tf.rotate(x, 35.0, order=3), -35.0, order=3)
        )
        interior = (slice(14, 26), slice(14, 26))
        np.testing.assert_allclose(out[interior], x[interior], atol=0.01)

    def test_resize_downsample(self):
        x = _img((32, 32), 2)
        out = np.asarray(tf.resize(x, (16, 16)))
        assert out.shape == (16, 16)
        assert abs(out.mean() - x.mean()) < 0.01

    def test_resize_upsample_exact_for_constant(self):
        x = np.full((8, 8), 0.7)
        out = np.asarray(tf.resize(x, (16, 16), order=1))
        np.testing.assert_allclose(out, 0.7, atol=1e-9)

    def test_rescale(self):
        x = _img((20, 30), 3)
        out = np.asarray(tf.rescale(x, 0.5))
        assert out.shape == (10, 15)

    def test_rescale_multichannel(self):
        x = _img((20, 30), 4)[..., None] * np.ones(3)
        out = np.asarray(tf.rescale(x, 0.5, multichannel=True))
        assert out.shape == (10, 15, 3)

    def test_swirl_roundtrip_center(self):
        x = _img((40, 40), 5)
        sw = np.asarray(
            tf.swirl(x, strength=2, radius=20, mode="reflect")
        )
        assert sw.shape == x.shape
        # corner beyond the swirl radius is nearly unchanged
        np.testing.assert_allclose(sw[0, :4], x[0, :4], atol=1e-2)

    def test_warp_polar_shape(self):
        x = _img((40, 40), 6)
        out = np.asarray(tf.warp_polar(x))
        assert out.shape[0] == 360

    def test_warp_polar_rotation_shifts_rows(self):
        # a rotated image should produce a row-shifted polar image
        x = _img((64, 64), 7)
        p1 = np.asarray(tf.warp_polar(x, radius=24))
        x_rot = np.asarray(tf.rotate(x, 30.0, order=1))
        p2 = np.asarray(tf.warp_polar(x_rot, radius=24))
        shifted = np.roll(p1, -30, axis=0)
        mask = slice(5, 20)
        corr = np.corrcoef(p2[:, mask].ravel(), shifted[:, mask].ravel())[0, 1]
        assert corr > 0.8

    def test_downscale_local_mean(self):
        x = np.arange(16.0).reshape(4, 4)
        out = np.asarray(tf.downscale_local_mean(x, (2, 2)))
        exp = np.array([[2.5, 4.5], [10.5, 12.5]])
        np.testing.assert_allclose(out, exp, rtol=1e-12)


class TestIntegralPyramids:
    def test_integral_image(self):
        x = np.random.RandomState(0).rand(10, 12)
        ii = np.asarray(tf.integral_image(x))
        np.testing.assert_allclose(
            ii, x.cumsum(0).cumsum(1), rtol=1e-10
        )

    def test_integrate(self):
        x = np.random.RandomState(1).rand(10, 12)
        ii = tf.integral_image(x)
        got = float(tf.integrate(ii, (2, 3), (5, 7))[0])
        exp = x[2:6, 3:8].sum()
        np.testing.assert_allclose(got, exp, rtol=1e-9)

    def test_integrate_from_zero(self):
        x = np.random.RandomState(2).rand(8, 8)
        ii = tf.integral_image(x)
        got = float(tf.integrate(ii, (0, 0), (3, 3))[0])
        np.testing.assert_allclose(got, x[:4, :4].sum(), rtol=1e-9)

    def test_pyramid_gaussian(self):
        x = _img((32, 32), 8)
        layers = list(tf.pyramid_gaussian(x, max_layer=2))
        assert len(layers) == 3
        assert layers[1].shape == (16, 16)
        assert layers[2].shape == (8, 8)

    def test_pyramid_laplacian_reconstruction(self):
        x = _img((16, 16), 9)
        layers = list(tf.pyramid_laplacian(x, max_layer=2))
        assert layers[0].shape == (16, 16)
        assert layers[1].shape == (8, 8)

    def test_pyramid_expand(self):
        x = _img((8, 8), 10)
        out = np.asarray(tf.pyramid_expand(x, 2))
        assert out.shape == (16, 16)


def test_warp_mode_translation_legacy():
    """numpy.pad's mode names map to the legacy ndimage modes ('wrap' is
    the period-(n-1) wrap, 'constant' the legacy constant): scipy's
    map_coordinates on the forward matrix (warp's inverse-map
    convention) and skimage's clip are the definition."""

    rng = np.random.RandomState(53)
    modemap = {"constant": "constant", "edge": "nearest",
               "symmetric": "reflect", "reflect": "mirror",
               "wrap": "wrap"}
    x = rng.rand(14, 17)
    t = tf.SimilarityTransform(rotation=0.3, translation=(1.7, -2.1),
                               scale=1.1)
    M = np.asarray(t.params)
    r, c = np.mgrid[0:14, 0:17].astype(float)
    src_x = M[0, 0] * c + M[0, 1] * r + M[0, 2]
    src_y = M[1, 0] * c + M[1, 1] * r + M[1, 2]
    for skmode, ndmode in modemap.items():
        for order in (0, 1, 3):
            got = np.asarray(tf.warp(T(x), t, order=order,
                                     mode=skmode, cval=0.4))
            exp = sndi.map_coordinates(x, np.stack([src_y, src_x]),
                                       order=order, mode=ndmode,
                                       cval=0.4)
            lo, hi = x.min(), x.max()
            if skmode == "constant":
                lo, hi = min(lo, 0.4), max(hi, 0.4)
            np.testing.assert_allclose(got, np.clip(exp, lo, hi),
                                       atol=5e-5,
                                       err_msg=f"{skmode} o{order}")


# ---------------------------------------------------------------------------
# grids against scipy definitions
# ---------------------------------------------------------------------------

SK_TO_NDI = {"constant": "constant", "edge": "nearest",
             "symmetric": "reflect", "reflect": "mirror", "wrap": "wrap"}


def close(got, want, tol):
    got = np.asarray(H(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _clipped(ref, x, mode, cval):
    lo, hi = x.min(), x.max()
    if mode == "constant":
        lo, hi = min(lo, cval), max(hi, cval)
    return np.clip(ref, lo, hi)


def _smooth_image(shape, seed):
    rng = np.random.default_rng(seed)
    return sndi.gaussian_filter(rng.random(shape), 1.0)


@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("mode", list(SK_TO_NDI))
@pytest.mark.parametrize("kind", ["affine", "projective"])
def test_warp_matches_map_coordinates(kind, mode, order):
    """warp(x, tform) is map_coordinates at tform(output (col, row)) in
    the legacy ndimage mode, clipped to the input's range."""
    x = _smooth_image((17, 19), 3)
    if kind == "affine":
        t = AffineTransform(scale=(1.1, 0.95), rotation=0.3, shear=0.1,
                            translation=(1.5, -2.0))
    else:
        t = ProjectiveTransform(np.array([[1.05, 0.1, -1.0],
                                          [-0.08, 0.97, 2.0],
                                          [0.004, -0.003, 1.0]]))
    M = t.params
    r, c = np.mgrid[0:17, 0:19].astype(float)
    w = M[2, 0] * c + M[2, 1] * r + M[2, 2]
    src_x = (M[0, 0] * c + M[0, 1] * r + M[0, 2]) / w
    src_y = (M[1, 0] * c + M[1, 1] * r + M[1, 2]) / w
    want = sndi.map_coordinates(x, np.stack([src_y, src_x]), order=order,
                                mode=SK_TO_NDI[mode], cval=0.25)
    got = warp(T(x), t, order=order, mode=mode, cval=0.25)
    assert got.dtype == torch.float64
    close(got, _clipped(want, x, mode, 0.25), 1e-12 if order < 2 else 1e-10)


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("mode", list(SK_TO_NDI))
@pytest.mark.parametrize("out_shape", [(9, 7), (31, 40)])
def test_resize_matches_gaussian_then_zoom(out_shape, mode, order):
    """resize is gaussian_filter with sigma max(0, (factor - 1) / 2) when
    it shrinks, then zoom(grid_mode=True), clipped."""
    x = _smooth_image((18, 21), 4)
    nd = SK_TO_NDI[mode]
    factors = np.array(x.shape) / np.array(out_shape)
    ref = x
    if np.any(factors > 1):
        ref = sndi.gaussian_filter(x, np.maximum(0, (factors - 1) / 2),
                                   mode=nd, cval=0.0)
    with warnings.catch_warnings():
        # scipy warns about grid_mode with the legacy modes
        warnings.simplefilter("ignore")
        want = sndi.zoom(ref, 1 / factors, order=order, mode=nd, cval=0.0,
                         grid_mode=True)
    got = resize(T(x), out_shape, order=order, mode=mode)
    close(got, _clipped(want, ref, mode, 0.0),
          1e-12 if order < 2 else 1e-10)


@pytest.mark.parametrize("angle", [30, -75, 180])
@pytest.mark.parametrize("order", [0, 1, 3])
def test_rotate_matches_affine_transform(angle, order):
    """rotate about the centre (and resize=True's bounding box) is
    affine_transform of the inverse rotation in (row, col)."""
    x = _smooth_image((15, 22), 5)
    rows, cols = x.shape
    a = np.deg2rad(angle)
    for resize_ in (False, True):
        got = rotate(T(x), angle, resize=resize_, order=order)
        center = np.array([(rows - 1) / 2, (cols - 1) / 2])
        # output (r, c) -> input: rotate by +angle about the centre in
        # (x, y) = (c, r), i.e. the inverse map of a counter-clockwise turn
        m = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
        out_shape = x.shape
        out_center = center
        if resize_:
            corners = np.array([[0, 0], [0, cols - 1], [rows - 1, cols - 1],
                                [rows - 1, 0]], float) - center
            rot = corners @ np.linalg.inv(m).T
            ext = rot.max(0) - rot.min(0) + 1
            out_shape = tuple(int(v) for v in np.around(ext))
            out_center = center + rot.min(0) + (center - center)
            out_center = -rot.min(0)
        offset = center - m @ out_center
        want = sndi.affine_transform(x, m, offset=offset,
                                     output_shape=out_shape, order=order,
                                     mode="constant", cval=0.0)
        assert tuple(got.shape) == out_shape
        close(got, _clipped(want, x, "constant", 0.0), 1e-9)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.int32,
                                   np.float32, np.float64, bool])
def test_integral_image_matches_cumsum(dtype):
    """The integral of every dtype equals numpy's cumsum over both axes;
    unsigned and bool images give int64 (skimage: uint64), signed
    integers int64, floats float64."""
    rng = np.random.default_rng(6)
    x = (rng.random((13, 17, 3)) * 200).astype(dtype)
    got = integral_image(T(x))
    want = x.astype(np.float64).cumsum(0).cumsum(1).cumsum(2)
    kind = np.dtype(dtype).kind
    assert got.dtype == (torch.float64 if kind == "f" else torch.int64)
    np.testing.assert_array_equal(H(got).astype(np.float64), want)


def test_integral_image_of_uint8_and_uint16_is_int64():
    """The recorded departure: torch has no uint64 cumsum (nor uint64
    arithmetic on the card), so the integral of an unsigned image is
    int64 where skimage and cupyimg_tpu give uint64; the values agree
    below 2^63."""
    for dtype, top in ((np.uint8, 255), (np.uint16, 65535)):
        x = np.full((40, 50), top, dtype)
        ii = integral_image(T(x))
        assert ii.dtype == torch.int64
        assert int(ii[-1, -1]) == 40 * 50 * top
        assert int(integrate(ii, (10, 10), (19, 29))[0]) == 10 * 20 * top


def test_resize_unknown_mode_raises_value_error_before_filtering(
        monkeypatch):
    """The recorded repair: a mode that is neither skimage's nor
    ndimage's raises ValueError, as skimage's, and no filter runs first
    (cupyimg_tpu raises RuntimeError from the gaussian's mode check)."""
    from cupyimg_tpu_torch.skimage.transform import _warps

    def refuse(*args, **kwargs):
        raise AssertionError("a filter ran before the mode check")

    monkeypatch.setattr(_warps.ndi, "gaussian_filter", refuse)
    monkeypatch.setattr(_warps.ndi, "zoom", refuse)
    x = Z((10, 10))
    for call in (lambda: resize(x, (5, 5), mode="non-existent",
                                anti_aliasing=True),
                 lambda: rescale(x, 0.5, mode="non-existent"),
                 lambda: warp(x, AffineTransform(), mode="non-existent"),
                 lambda: pyramids.pyramid_reduce(x, mode="bogus")):
        with pytest.raises(ValueError, match="Unknown mode"):
            call()
    # the ndimage names pass through
    assert _warps._to_ndimage_mode("grid-wrap") == "grid-wrap"
    assert _warps._to_ndimage_mode("symmetric") == "reflect"


def test_no_matmul_in_float32_warps(monkeypatch):
    """Every float32 warp runs with torch's matmul entry points made to
    raise: the coordinates are multiply-adds, so no TF32 can reach
    them on the card."""
    def refuse(*args, **kwargs):
        raise AssertionError("matmul in a warp")

    x = T(_smooth_image((24, 28), 7).astype(np.float32))
    rgb = T(np.random.default_rng(8).random((16, 18, 3)).astype(np.float32))
    src = np.random.default_rng(9).random((12, 2)) * 20
    pw = PiecewiseAffineTransform()
    pw.estimate(src, src + 0.5)
    for name in ("matmul", "mm", "bmm", "einsum", "tensordot", "inner",
                 "mv", "addmm"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    monkeypatch.setattr(torch.Tensor, "matmul", refuse)
    P = ProjectiveTransform(np.array([[1, 0.1, 2], [0.2, 0.9, 3],
                                      [0.001, 0.002, 1]]))
    outs = [
        warp(x, AffineTransform(rotation=0.3, translation=(2, 1)), order=3),
        warp(x, P), warp(x, P.inverse), warp(rgb, P), warp(x, pw),
        warp(x, np.array([[1.0, 0, 1], [0, 1, 1], [0, 0, 1]])),
        rotate(x, 30, resize=True, order=3), resize(x, (12, 14)),
        resize(x, (50, 60), order=3), rescale(rgb, 0.5, multichannel=True),
        swirl(x, strength=2, radius=10), warp_polar(x),
        warp_polar(rgb, multichannel=True, scaling="log"),
        pyramids.pyramid_reduce(x), pyramids.pyramid_expand(x),
        P(T(src)), PolynomialTransform()(T(src)),
        matrix_transform(T(src), P.params),
    ]
    outs += list(pyramids.pyramid_gaussian(x, max_layer=3))
    outs += list(pyramids.pyramid_laplacian(x, max_layer=3))
    assert all(torch.isfinite(o).all() for o in outs)


def test_float32_warps_stay_float32_and_match_float64():
    """A float32 image keeps float32 through every warp (the card's
    kernels serve float32) and agrees with the float64 call within 1e-5
    of max|ref|."""
    x = _smooth_image((24, 28), 10)
    P = ProjectiveTransform(np.array([[1, 0.1, 2], [0.2, 0.9, 3],
                                      [0.001, 0.002, 1]]))
    calls = [
        lambda im: warp(im, P, order=1),
        lambda im: warp(im, AffineTransform(rotation=0.2), order=3),
        lambda im: rotate(im, 30, order=1),
        lambda im: resize(im, (12, 13)),
        lambda im: rescale(im, 1.7, order=3),
        lambda im: swirl(im, strength=2, radius=15),
        lambda im: warp_polar(im),
        lambda im: pyramids.pyramid_reduce(im),
    ]
    for call in calls:
        got = call(T(x.astype(np.float32)))
        assert got.dtype == torch.float32
        close(got, H(call(T(x))), 1e-5)


def test_warp_coords_matches_numpy_grid():
    """warp_coords of a callable: float64 (row, col[, channel]) maps of
    the callable at every output (col, row) point."""
    def shear(xy):
        return torch.stack([xy[:, 0] + 0.5 * xy[:, 1], xy[:, 1] - 2], -1)

    c = warp_coords(shear, (4, 6))
    r, cc = np.mgrid[0:4, 0:6].astype(float)
    np.testing.assert_array_equal(H(c), np.stack([r - 2, cc + 0.5 * r]))
    c3 = warp_coords(shear, (4, 6, 3))
    assert c3.dtype == torch.float64 and tuple(c3.shape) == (3, 4, 6, 3)
    np.testing.assert_array_equal(H(c3[2]), np.broadcast_to(
        np.arange(3.0), (4, 6, 3)))


def test_estimate_transform_on_tensors_and_params_on_host():
    """Tensors are accepted by the fits; params stay float64 numpy."""
    rng = np.random.default_rng(11)
    src = rng.random((30, 2)) * 50
    for kind in ("euclidean", "similarity", "affine", "projective",
                 "polynomial"):
        t = (EuclideanTransform(rotation=0.4, translation=(2, -3))
             if kind == "euclidean" else
             SimilarityTransform(scale=1.3, rotation=0.4,
                                 translation=(2, -3)))
        dst = H(t(T(src)))
        est = estimate_transform(kind, T(src), T(dst))
        assert isinstance(est.params, np.ndarray)
        assert est.params.dtype == np.float64
        np.testing.assert_allclose(H(est(T(src))), dst, atol=1e-8)
    np.testing.assert_allclose(est.residuals(src, dst), 0, atol=1e-8)


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64)
# ---------------------------------------------------------------------------


def test_named_calls_match_cupyimg_tpu():
    """The traceable calls as one jit program of cupyimg_tpu, float64 and
    float32: within 1e-12 (1e-10 above order 1) of max|ref| for float64,
    2e-6 for float32."""
    P = np.array([[1, 0.1, 2], [0.2, 0.9, 3], [0.001, 0.002, 1]])
    aff = dict(scale=(1.1, 0.9), rotation=0.2, translation=(2, -1))
    cases = [
        ("warp affine o3 edge", lambda m, a, b, c: m.warp(
            a, m.AffineTransform(**aff), order=3, mode="edge"), 1e-10),
        ("warp projective f32", lambda m, a, b, c: m.warp(
            b, m.ProjectiveTransform(P), order=1), 2e-6),
        ("rotate f32 o3", lambda m, a, b, c: m.rotate(b, 30, order=3),
         2e-6),
        ("resize anti-aliased", lambda m, a, b, c: m.resize(
            a, (13, 15), anti_aliasing=True), 1e-12),
        ("resize up f32 o3", lambda m, a, b, c: m.resize(
            b, (45, 50), order=3, mode="symmetric"), 2e-6),
        ("rescale rgb", lambda m, a, b, c: m.rescale(
            c, 0.5, multichannel=True), 1e-12),
        ("swirl", lambda m, a, b, c: m.swirl(a, strength=3, radius=20),
         1e-12),
        ("warp_polar log", lambda m, a, b, c: m.warp_polar(
            a, scaling="log"), 1e-12),
        ("pyramid_reduce", lambda m, a, b, c: m.pyramid_reduce(a), 1e-12),
        ("pyramid_expand f32 o3", lambda m, a, b, c: m.pyramid_expand(
            b, order=3), 2e-6),
        ("integral_image f32", lambda m, a, b, c: m.integral_image(b),
         1e-12),
        ("downscale_local_mean", lambda m, a, b, c: m.downscale_local_mean(
            a, (3, 4)), 1e-12),
    ]
    rng = np.random.default_rng(12)
    x = rng.random((30, 34))
    x32 = x.astype(np.float32)
    rgb = rng.random((20, 22, 3))

    @jax.jit
    def ref(a, b, c):
        return [fn(jt, a, b, c) for _, fn, _ in cases]

    want = ref(jnp.asarray(x), jnp.asarray(x32), jnp.asarray(rgb))
    for (name, fn, tol), w in zip(cases, want):
        got = fn(tf, T(x), T(x32), T(rgb))
        w = np.asarray(w)
        assert H(got).dtype == w.dtype, name
        close(got, w, tol)


# ---------------------------------------------------------------------------
# the card: the kernels serve the warps (skip without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["warp affine", "warp projective",
                                  "rotate o3", "resize", "pyramid_reduce"])
def test_cuda_float32_warps_launch_the_kernels(cuda, name):
    from cupyimg_tpu_torch.ops import fused_separable as fs
    from cupyimg_tpu_torch.ops import spline_gather as sg

    x = _smooth_image((64, 80), 13).astype(np.float32)
    P = ProjectiveTransform(np.array([[1, 0.1, 2], [0.2, 0.9, 3],
                                      [0.001, 0.002, 1]]))
    calls = {
        "warp affine": (lambda im: warp(im, AffineTransform(rotation=0.2)),
                        1, 0),
        "warp projective": (lambda im: warp(im, P), 1, 0),
        "rotate o3": (lambda im: rotate(im, 30, order=3), 1, 2),
        "resize": (lambda im: resize(im, (32, 40)), 1, 1),
        "pyramid_reduce": (lambda im: pyramids.pyramid_reduce(im), 1, 1),
    }
    fn, gathers, b1 = calls[name]
    g0, s0 = sg.launches, fs.fused_separable_correlate.launches
    got = fn(T(x).cuda())
    assert sg.launches - g0 == gathers
    assert fs.fused_separable_correlate.launches - s0 == b1
    close(got.cpu(), H(fn(T(x))), 1e-5)


@pytest.mark.parametrize("name", [
    "skimage.transform", "skimage.transform._geometric",
    "skimage.transform._warps", "skimage.transform.integral",
    "skimage.transform.pyramids"])
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
                        "ndi", "util", "warnings"}

    assert public(jmod) - public(tmod) == set()
