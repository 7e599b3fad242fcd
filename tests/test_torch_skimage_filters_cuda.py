"""The card serves the float32 calls of ``skimage.filters``,
``feature.canny`` and ``restoration.richardson_lucy``: on CUDA tensors
they launch the port's kernels as planned and agree with the same calls
on CPU tensors (the plain versions).  Every test carries the ``cuda``
marker and skips without a card; this file imports no JAX.

Tolerances: 1e-5 of max|ref| (frangi 1e-3: its measures divide by
eigenvalues near zero, where float32 sums in another order move them);
canny's edges may differ at two pixels (ties of the non-maximum
suppression).
"""

import numpy as np
import pytest
import torch

from cupyimg_tpu_torch.skimage import filters, restoration
from cupyimg_tpu_torch.skimage.feature import canny


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _img(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, ref, tol):
    got, ref = got.cpu().double().numpy(), ref.double().numpy()
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["canny", "gaussian", "unsharp_mask",
                                  "median", "window", "frangi",
                                  "richardson_lucy"])
def test_cuda_float32_filters_launch_the_kernels(cuda, name):
    from cupyimg_tpu_torch.ops import fused_dense as fd
    from cupyimg_tpu_torch.ops import fused_rank as fr
    from cupyimg_tpu_torch.ops import fused_separable as fs
    from cupyimg_tpu_torch.ops import spline_gather as sg

    psf = torch.ones((5, 5)) / 25
    calls = {
        "canny": (lambda im: canny(im, 1.5), {"b1": 1}),
        "gaussian": (lambda im: filters.gaussian(im, 2), {"b1": 1}),
        "unsharp_mask": (lambda im: filters.unsharp_mask(im, 2, 1),
                         {"b1": 1}),
        "median": (lambda im: filters.median(im), {"b3": 1}),
        "window": (lambda im: filters.window(
            "hann", (64, 80), device=im.device), {"gather": 1}),
        "frangi": (lambda im: filters.frangi(im, sigmas=[1, 2]), {"b1": 2}),
        "richardson_lucy": (lambda im: restoration.richardson_lucy(
            im, psf.to(im.device), 3), {"b2": 6}),
    }
    fn, want = calls[name]

    def counts():
        return {"b1": fs.fused_separable_correlate.launches,
                "b2": fd.fused_dense_correlate.launches,
                "b3": fr.fused_rank_filter.launches, "gather": sg.launches}

    x = torch.from_numpy(_img((64, 80), 17))
    before = counts()
    got = fn(x.cuda())
    delta = {k: v - before[k] for k, v in counts().items()}
    assert delta == {k: want.get(k, 0) for k in delta}
    ref = fn(x)
    assert got.dtype == ref.dtype
    if got.dtype == torch.bool:
        assert int((got.cpu() != ref).sum()) <= 2
    else:
        _close(got, ref, 1e-3 if name == "frangi" else 1e-5)
