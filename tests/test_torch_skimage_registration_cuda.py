"""The card serves the float32 calls of ``skimage.registration``,
``skimage.segmentation``, the pipelines, ``convolve_separable`` and the
public 1-d correlations: on
CUDA tensors they launch the port's kernels as planned and agree with
the same calls on CPU tensors (the plain versions).  Every test carries
the ``cuda`` marker and skips without a card; this file imports no JAX.

Tolerances: 1e-5 of max|ref| for the filters and pipelines; the flows
within 1e-3 of max|flow| (float32 sums of the window filters and the
gather in another order, through each pixel's 2x2 solve); the
correlations within 1e-12 (float64 and complex128); the level sets
exactly; the 1-d filters under the default ``dtype_mode`` (float64
sums, no launch) within one float32 unit in the last place of each of
scipy's values, plus 1e-9 of max|input| for float64 sums in another
order.
"""

import numpy as np
import pytest
import torch

import cupyimg_tpu_torch
from cupyimg_tpu_torch import models
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage import registration as reg
from cupyimg_tpu_torch.skimage import segmentation as seg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _smooth(shape, seed):
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(np.random.RandomState(seed).rand(*shape), 2)
    return x.astype(np.float32)


def _counts():
    """Every kernel's launches: B1's correlation and min/max, the
    two-stage and pair morphology, B2, B3, the gather and the FFT."""
    from cupyimg_tpu_torch.ops import fused_dense as fd
    from cupyimg_tpu_torch.ops import fused_fft as ff
    from cupyimg_tpu_torch.ops import fused_rank as fr
    from cupyimg_tpu_torch.ops import fused_separable as fs
    from cupyimg_tpu_torch.ops import spline_gather as sg

    return {"b1": fs.fused_separable_correlate.launches,
            "minmax": fs.fused_separable_minmax.launches,
            "morph": fs.fused_separable_open_close.launches
            + fs.fused_separable_morph_pair.launches,
            "b2": fd.fused_dense_correlate.launches,
            "b3": fr.fused_rank_filter.launches, "gather": sg.launches,
            "fft": ff.fft_rows.launches + ff.fft_strided.launches}


def _close(got, ref, tol):
    got, ref = got.cpu().double().numpy(), ref.double().numpy()
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


# a 64^2 pair: a two-level pyramid (one reduce an image: a gaussian and a
# resize) and the flow resized once between the levels make b1 2 and
# gather 3; then the solvers' launches on the two levels
_CALLS = {
    # TV-L1, tol 0 (no early stop), 2 warps a level: a gather and a median
    "tvl1": (lambda x, y: reg.optical_flow_tvl1(
        x, y, num_warp=2, tol=0, prefilter=True), 1e-3,
        {"b1": 2, "gather": 3 + 4, "b3": 4}),
    # iLK, 2 warps a level: a gather and five window sums a warp
    "ilk": (lambda x, y: reg.optical_flow_ilk(x, y, num_warp=2), 1e-3,
            {"b1": 2 + 20, "gather": 3 + 4}),
    "ilk_gaussian": (lambda x, y: reg.optical_flow_ilk(
        x, y, num_warp=2, gaussian=True, prefilter=True), 1e-3,
        {"b1": 2 + 20, "gather": 3 + 4, "b3": 4}),
    # torch.fft and a complex128 product: no launch
    "phase_cross_correlation": (lambda x, y: reg.phase_cross_correlation(
        x, y, upsample_factor=20)[0], 1e-12, {}),
    "masked": (lambda x, y: reg.phase_cross_correlation(
        x, y, reference_mask=x > 0.45), 1e-12, {}),
    # one gaussian derivative an axis
    "inverse_gaussian_gradient": (
        lambda x, y: seg.inverse_gaussian_gradient(x, sigma=2.0), 1e-5,
        {"b1": 2}),
    "chan_vese": (lambda x, y: seg.morphological_chan_vese(
        x.double(), 5), 0, {}),
    # a prefilter and a zoom a channel
    "mark_boundaries": (lambda x, y: seg.mark_boundaries(
        x, (x > 0.5).to(torch.int32), mode="subpixel"), 1e-5,
        {"b1": 3, "gather": 3}),
    # a gaussian and a sobel an axis
    "edge_enhance_pipeline": (lambda x, y: models.edge_enhance_pipeline(x),
                              1e-5, {"b1": 3}),
    # accumulating in float32: the public 1-d correlation is one launch,
    # convolve_separable one an axis
    "correlate1d": (lambda x, y: ndi.correlate1d(
        x, [0.25, 0.5, 0.25, 0.1], axis=0, mode="constant",
        dtype_mode="float"), 1e-5, {"b1": 1}),
    "convolve_separable": (lambda x, y: cupyimg_tpu_torch.convolve_separable(
        x, np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16, dtype_mode="float"),
        1e-5, {"b1": 2}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_CALLS))
def test_cuda_float32_calls_launch_the_kernels(cuda, name):
    fn, tol, want = _CALLS[name]
    x = torch.from_numpy(_smooth((64, 64), 1))
    y = torch.from_numpy(np.roll(_smooth((64, 64), 1), (1, -2), (0, 1)))
    before = _counts()
    got = fn(x.cuda(), y.cuda())
    delta = {k: v - before[k] for k, v in _counts().items()}
    assert delta == {k: want.get(k, 0) for k in delta}
    ref = fn(x, y)
    assert got.dtype == ref.dtype
    if tol == 0:
        assert torch.equal(got.cpu(), ref)
    else:
        _close(got, ref, tol)


# the default dtype_mode ("ndimage") sums in float64 as scipy does, on
# the plain path: on an offset image a float32 sum misses scipy's
# values by up to thousands of units in their last place (laplace)
_NDIMAGE_1D = {
    "correlate1d": lambda m, x: m.correlate1d(x, [0.25, 0.5, 0.25, 0.1],
                                              axis=0, mode="constant"),
    "convolve1d": lambda m, x: m.convolve1d(x, [1.0, -3.0, 0.5], axis=1),
    "gaussian_filter1d": lambda m, x: m.gaussian_filter1d(x, 1.5, axis=0),
    "laplace": lambda m, x: m.laplace(x),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_NDIMAGE_1D))
def test_cuda_float32_1d_filters_keep_float64_sums(cuda, name):
    import scipy.ndimage as sndi

    x = _smooth((64, 64), 2) * 1000 + 1e5
    before = _counts()
    got = _NDIMAGE_1D[name](ndi, torch.from_numpy(x).cuda())
    assert {k: v - before[k] for k, v in _counts().items()} == dict.fromkeys(
        before, 0)
    ref = _NDIMAGE_1D[name](sndi, x)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.cpu().numpy(), ref,
                               rtol=float(np.finfo(np.float32).eps),
                               atol=1e-9 * float(np.abs(x).max()))
