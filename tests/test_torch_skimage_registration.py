"""``skimage.registration`` of the torch port on CPU tensors.

- The registration suites: exact Fourier-shift oracles for
  ``phase_cross_correlation`` (integer shifts exactly, subpixel shifts
  within 0.05 pixel, 2-D to 4-D, Fourier-space input), the masked
  normalized cross-correlation's range and autocorrelation peak, the
  TV-L1 and iLK flows of known translations (within 0.1 pixel) and of
  the suite's sine flow (mean error under 0.5 pixel), and their errors.
- Padfield's published pairs of ``tests/data/registration`` (read with
  PIL): the masked registration gives their shifts exactly.
- A named list against ``cupyimg_tpu`` on JAX-CPU (x64) on 64^2 float64
  inputs: the upsampled phase cross-correlation (shifts within 1e-12,
  error and phase within 1e-9), the masked correlation (within 1e-12,
  its unique maximum giving the same shift), the TV-L1 and iLK solvers
  on the fine level of a two-level pyramid, started from the port's
  coarse level (within 1e-9 of max|flow|: the same float64 arithmetic
  in another order; iLK's 2x2 solves are Cramer's rule here, LU there).
  The pyramid and the flow's resize between the levels are the port's,
  fed to both packages: the JAX package's eager pyramid costs seconds of
  compiles, and the port's pyramid is held to ``cupyimg_tpu`` in the
  transform suite.
- No float32 or complex64 matrix product serves a call of the slice:
  torch's matmul entry points refuse such operands (float64 and
  complex128 pass) during the float32 calls of registration,
  segmentation, the pipelines and ``convolve_separable``.
- The CUDA dispatch tests are in
  ``test_torch_skimage_registration_cuda.py``.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax

import cupyimg_tpu_torch
from cupyimg_tpu_torch import models
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.skimage import feature, segmentation
from cupyimg_tpu_torch.skimage import registration as reg
from cupyimg_tpu_torch.skimage.registration import _optical_flow as tflow
from cupyimg_tpu_torch.skimage.registration._masked_phase_cross_correlation \
    import cross_correlate_masked
from cupyimg_tpu_torch.skimage.registration._phase_cross_correlation import (
    _upsampled_dft,
)
from cupyimg_tpu_torch.skimage.transform import warp

DATA = os.path.join(os.path.dirname(__file__), "data", "registration")


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """numpy and list inputs go to the CPU here (the library's default
    device is CUDA)."""
    monkeypatch.setattr(config, "device", "cpu")


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _smooth(seed=0, n=64):
    rng = np.random.RandomState(seed)
    return sndi.gaussian_filter(rng.rand(n, n), 2)


def _fourier_shift(img, shift):
    """``img`` shifted by ``shift`` (its spectrum's phase ramp)."""
    F = np.fft.fftn(img)
    freqs = [np.fft.fftfreq(n).reshape([-1 if i == ax else 1
                                        for i in range(img.ndim)])
             for ax, n in enumerate(img.shape)]
    phase = sum(s * f for s, f in zip(shift, freqs))
    return F * np.exp(-2j * np.pi * phase)


def _shifted(img, shift):
    return np.real(np.fft.ifftn(_fourier_shift(img, shift)))


def _camera():
    """A textured 256^2 stand-in for skimage's camera."""
    yy, xx = np.mgrid[0:256, 0:256]
    rnd = np.random.RandomState(11)
    return (np.sin(yy / 13.0) * 80 + np.cos(xx / 9.0) * 70
            + np.sin((xx + 2 * yy) / 31.0) * 50 + rnd.rand(256, 256) * 20)


def _binary_blobs(length, n_dim):
    vol = np.random.RandomState(5).rand(*((length,) * n_dim))
    vol = sndi.gaussian_filter(vol, sigma=length / 16.0)
    return (vol > np.percentile(vol, 50)).astype(np.float64)


# ---------------------------------------------------------------------------
# phase_cross_correlation
# ---------------------------------------------------------------------------


def test_integer_shift_is_exact():
    ref = _smooth()
    mov = np.roll(ref, (5, -3), axis=(0, 1))
    shifts, error, phase = reg.phase_cross_correlation(ref, mov)
    assert shifts.dtype == torch.float64
    np.testing.assert_array_equal(H(shifts), [-5.0, 3.0])
    assert float(error) < 1e-5
    assert abs(float(phase)) < 1e-4


@pytest.mark.parametrize("shift", [(1.25, -2.75), (-0.4, 0.6)])
def test_subpixel_shift(shift):
    ref = _smooth()
    shifts, _, _ = reg.phase_cross_correlation(ref, _shifted(ref, shift),
                                               upsample_factor=20)
    np.testing.assert_allclose(H(shifts), [-shift[0], -shift[1]], atol=0.05)


def test_fourier_space_and_aliases():
    ref = _smooth()
    mov = np.roll(ref, (2, 1), axis=(0, 1))
    shifts = reg.phase_cross_correlation(np.fft.fftn(ref), np.fft.fftn(mov),
                                         space="fourier", return_error=False)
    np.testing.assert_array_equal(H(shifts), [-2.0, -1.0])
    shifts, _, _ = feature.register_translation(ref, mov)
    np.testing.assert_array_equal(H(shifts), [-2.0, -1.0])
    mask = np.ones(ref.shape, bool)
    mask[:, :10] = False
    np.testing.assert_array_equal(
        H(feature.masked_register_translation(ref, mov, mask)), [-2.0, -1.0])


def test_errors():
    with pytest.raises(ValueError):
        reg.phase_cross_correlation(np.zeros((8, 8)), np.zeros((9, 9)))
    with pytest.raises(ValueError):
        reg.phase_cross_correlation(np.zeros((8, 8)), np.zeros((8, 8)),
                                    space="hyperbolic")
    with pytest.raises(ValueError):  # dimensionality mismatch
        reg.phase_cross_correlation(np.ones((5, 5)), np.ones((5, 5, 1)))
    a = _smooth()
    b = a.copy()
    b[3, 3] = np.nan
    with pytest.raises(ValueError, match="NaN values found"):
        reg.phase_cross_correlation(a, b)
    with pytest.raises(ValueError):
        _upsampled_dft(torch.ones((4, 4)), upsampled_region_size=[3, 2, 1, 4])
    with pytest.raises(ValueError):
        _upsampled_dft(torch.ones((4, 4)), 3, axis_offsets=[3, 2, 1, 4])


def test_masked_dispatch_and_singleton_axis():
    ref = _smooth()
    mov = np.roll(ref, (5, -3), axis=(0, 1))
    mask = np.ones_like(ref, bool)
    mask[:, :10] = False
    sh = reg.phase_cross_correlation(ref, mov, reference_mask=mask,
                                     moving_mask=mask)
    np.testing.assert_array_equal(H(sh), [-5.0, 3.0])
    row = ref[0:1]
    shifts = reg.phase_cross_correlation(row, np.roll(row, 4, axis=1),
                                         return_error=False)
    assert float(shifts[0]) == 0.0


def test_correlation_suite_2d():
    """The suite's camera cases: pixel precision in Fourier space, then
    subpixel precision from Fourier and real (complex) input."""
    cam = _camera()
    F = np.fft.fftn(cam)
    result, _, _ = reg.phase_cross_correlation(
        F, _fourier_shift(cam, (-7, 12)), space="fourier")
    np.testing.assert_allclose(H(result), [7, -12])
    sub = (-2.4, 1.32)
    result, _, _ = reg.phase_cross_correlation(
        F, _fourier_shift(cam, sub), upsample_factor=100, space="fourier")
    np.testing.assert_allclose(H(result), [2.4, -1.32], atol=0.05)
    result, _, _ = reg.phase_cross_correlation(
        cam, np.fft.ifftn(_fourier_shift(cam, sub)), upsample_factor=100)
    np.testing.assert_allclose(H(result), [2.4, -1.32], atol=0.05)
    # a single column: no shift along the singleton axis
    col = np.fft.fftn(cam[:, 15]).reshape((-1, 1))
    shifted = col * np.exp(-2j * np.pi * -2.4 * np.fft.fftfreq(256))[:, None]
    result, _, _ = reg.phase_cross_correlation(
        col, shifted, upsample_factor=20, space="fourier")
    np.testing.assert_allclose(H(result), [2.4, 0], atol=0.05)


@pytest.mark.parametrize("ndim, shift, upsample", [
    (3, (-2.0, 1.0, 5.0), 1), (3, (-2.3, 1.7, 5.4), 100),
    (4, (-2.0, 1.0, 5.0, -3), 1), (4, (-2.3, 1.7, 5.4, -3.2), 10)])
def test_nd_input(ndim, shift, upsample):
    phantom = _binary_blobs(32 if ndim == 3 else 16, ndim)
    result, _, _ = reg.phase_cross_correlation(
        np.fft.fftn(phantom), _fourier_shift(phantom, shift),
        upsample_factor=upsample, space="fourier")
    np.testing.assert_allclose(H(result), -np.asarray(shift), atol=0.05)


def test_single_precision_error_and_phase():
    """float32 images: the upsampled DFT is rounded once to complex64, so
    the error and the phase are float32 (``cupyimg_tpu`` promotes them
    to float64 through its float64 offsets); the shifts are float64."""
    ref = _smooth().astype(np.float32)
    mov = np.roll(ref, (5, -3), axis=(0, 1))
    for factor in (1, 20):
        shifts, error, phase = reg.phase_cross_correlation(
            ref, mov, upsample_factor=factor)
        assert shifts.dtype == torch.float64
        assert error.dtype == phase.dtype == torch.float32
        np.testing.assert_array_equal(H(shifts), [-5.0, 3.0])


def test_upsampled_dft_matches_a_direct_dft():
    """The upsampled DFT at integer offsets equals the DFT evaluated on
    the region directly (numpy), in complex128; single-precision data
    is rounded once to complex64."""
    rng = np.random.default_rng(3)
    data = rng.random((6, 7)) + 1j * rng.random((6, 7))
    got = _upsampled_dft(torch.from_numpy(data), (4, 5), 2, (1.5, -0.5))
    k = [np.fft.fftfreq(n, 2) for n in data.shape]
    ref = np.zeros((4, 5), complex)
    for a in range(4):
        for b in range(5):
            ph = np.exp(-2j * np.pi * ((a - 1.5) * k[0][:, None]
                                       + (b + 0.5) * k[1][None, :]))
            ref[a, b] = (data * ph).sum()
    np.testing.assert_allclose(H(got), ref, rtol=0, atol=1e-12)
    single = _upsampled_dft(torch.from_numpy(data.astype(np.complex64)),
                            (4, 5), 2, (1.5, -0.5))
    assert single.dtype == torch.complex64
    np.testing.assert_allclose(H(single), ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# masked normalized cross-correlation
# ---------------------------------------------------------------------------


def test_cross_correlate_masked_suite():
    x = _smooth(3, 32)
    m = np.ones_like(x, bool)
    out = H(cross_correlate_masked(x, x, m, m, axes=(0, 1), mode="full"))
    assert out.dtype == np.float64
    assert out.max() == pytest.approx(1.0, abs=1e-6)
    assert np.unravel_index(np.argmax(out), out.shape) == (31, 31)
    x = _smooth(4, 32)
    assert cross_correlate_masked(x, x, m, m, axes=(0, 1),
                                  mode="same").shape == x.shape
    out = H(cross_correlate_masked(_smooth(5, 32), _smooth(6, 32), m, m))
    assert out.min() >= -1 and out.max() <= 1
    with pytest.raises(ValueError):
        cross_correlate_masked(np.zeros((4, 4)), np.zeros((4, 4)),
                               np.ones((4, 4)), np.ones((4, 4)), mode="bogus")
    with pytest.raises(ValueError):
        cross_correlate_masked(np.zeros((4, 4), complex), np.zeros((4, 4)),
                               np.ones((4, 4)), np.ones((4, 4)))
    with pytest.raises(ValueError):  # image and mask shapes differ
        reg.phase_cross_correlation(np.zeros((4, 4)), np.zeros((4, 4)),
                                    reference_mask=np.ones((4, 5), bool))


@pytest.mark.parametrize("xi, yi", [(75, 75), (-130, 130), (130, 130)])
def test_masked_registration_padfield_data(xi, yi):
    """Padfield's published pairs: (shift_x, shift_y) equals (-xi, yi)
    exactly."""
    Image = pytest.importorskip("PIL.Image")

    def load(kind):
        return np.asarray(Image.open(os.path.join(
            DATA, f"{kind}X{xi:d}Y{yi:d}.png")).convert("L"),
            dtype=np.float32)

    fixed, moving = load("Original"), load("Transformed")
    shift_y, shift_x = H(reg.phase_cross_correlation(
        torch.from_numpy(fixed), torch.from_numpy(moving),
        reference_mask=fixed != 0, moving_mask=moving != 0,
        overlap_ratio=0.1))
    assert (shift_x, shift_y) == (-xi, yi)


# ---------------------------------------------------------------------------
# optical flow
# ---------------------------------------------------------------------------


def _sin_flow_gen(image0, max_motion=4.5, npics=5):
    """The suite's ground truth: a sine first component, and the image
    warped by it."""
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in image0.shape],
                                indexing="ij")).astype(np.float64)
    gt_flow = np.zeros_like(grid)
    gt_flow[0] = max_motion * np.sin(grid[0] / grid[0].max() * npics * np.pi)
    image1 = H(warp(torch.from_numpy(image0), torch.from_numpy(grid - gt_flow),
                    mode="nearest"))
    return gt_flow, image1


@pytest.mark.parametrize("solver", ["tvl1", "ilk", "ilk_gaussian"])
def test_uniform_translation(solver):
    ref = _smooth()
    mov = _shifted(ref, (1.25, -2.75))
    if solver == "tvl1":
        flow = reg.optical_flow_tvl1(ref, mov)
    else:
        flow = reg.optical_flow_ilk(ref, mov, radius=7, num_warp=5,
                                    gaussian=solver == "ilk_gaussian")
    inner = H(flow)[:, 16:-16, 16:-16].reshape(2, -1).mean(1)
    np.testing.assert_allclose(inner, (1.25, -2.75), atol=0.1)


def test_2d_motion_and_dtypes():
    """The suite's sine flow at 256^2: mean error under half a pixel,
    the float32 and float64 flows within 1e-3 of each other (mean)."""
    image0 = np.random.RandomState(0).normal(size=(256, 256))
    gt_flow, image1 = _sin_flow_gen(image0)
    flow64 = reg.optical_flow_tvl1(image0, image1, attachment=5,
                                   dtype=np.float64)
    flow32 = reg.optical_flow_tvl1(image0, image1, attachment=5,
                                   dtype=torch.float32)
    assert flow64.dtype == torch.float64 and flow32.dtype == torch.float32
    assert np.abs(H(flow64) - gt_flow).mean() < 0.5
    assert np.abs(H(flow64) - H(flow32)).mean() < 1e-3


@pytest.mark.parametrize("shape", [(256, 256), (32, 32, 32)])
def test_no_motion(shape):
    img = np.random.RandomState(0).normal(size=shape)
    assert np.all(H(reg.optical_flow_tvl1(img, img)) == 0)


def test_flow_dtypes_and_validation():
    ref = _smooth()
    flow = reg.optical_flow_ilk(ref, ref, radius=3, num_warp=1,
                                dtype=np.float32)
    assert flow.shape == (2,) + ref.shape and flow.dtype == torch.float32
    # float16 flows (cupyimg_tpu's iLK raises: no float16 LU): the solves
    # run in float32
    mov = _shifted(ref, (0.5, 0.5))
    for half in (reg.optical_flow_ilk(ref, mov, radius=5, num_warp=2,
                                      dtype=torch.float16),
                 reg.optical_flow_tvl1(ref, mov, dtype=np.float16)):
        assert half.dtype == torch.float16
        inner = H(half.float())[:, 16:-16, 16:-16].reshape(2, -1).mean(1)
        np.testing.assert_allclose(inner, (0.5, 0.5), atol=0.1)
    with pytest.raises(ValueError):
        reg.optical_flow_tvl1(np.zeros((8, 8)), np.zeros((9, 9)))
    for dtype in (np.int32, np.int64, torch.int32):
        with pytest.raises(ValueError):
            reg.optical_flow_ilk(np.zeros((8, 8)), np.zeros((8, 8)),
                                 dtype=dtype)


def test_ilk_closed_form_solves_match_numpy():
    """Cramer's rule on 1-3 axes and the float64 LU above, against
    numpy's solve; singular systems give 0."""
    rng = np.random.default_rng(4)
    for n in (1, 2, 3, 4):
        m = rng.standard_normal((5, 6, n, n))
        A = m @ np.swapaxes(m, -1, -2) + 0.1 * np.eye(n)
        A[0, 0] = 0  # singular
        b = rng.standard_normal((5, 6, n))
        ref = np.linalg.solve(np.where(
            np.abs(np.linalg.det(A))[..., None, None] < 1e-14, np.eye(n), A),
            b[..., None])[..., 0]
        ref[0, 0] = 0
        tri = {(i, j): torch.from_numpy(A[..., i, j]) for i in range(n)
               for j in range(i, n)}
        got = tflow._solve(tri, torch.from_numpy(np.moveaxis(b, -1, 0)),
                     torch.float64)
        np.testing.assert_allclose(np.moveaxis(H(got), 0, -1), ref,
                                   rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64)
# ---------------------------------------------------------------------------


def test_phase_cross_correlation_matches_cupyimg_tpu():
    """The upsampled correlation of a subpixel shift and the masked
    correlation, as one jit program; the masked maximum is unique, so
    both packages' shifts average one position."""
    from cupyimg_tpu.skimage.registration._masked_phase_cross_correlation \
        import cross_correlate_masked as jccm
    from cupyimg_tpu.skimage.registration._phase_cross_correlation import (
        _pcc_core,
    )

    ref = _smooth(7)
    mov = _shifted(ref, (2.3, -1.6))
    mask = np.ones(ref.shape, bool)
    mask[:, :12] = False
    mask[50:, :] = False
    want = jax.jit(lambda a, b, m: (
        _pcc_core(a, b, 20, True, False)[:3],
        jccm(b, a, m, m, axes=(0, 1))))(ref, mov, mask)
    (jshift, jerr, jphase), jxc = jax.tree_util.tree_map(np.asarray, want)

    shifts, err, phase = reg.phase_cross_correlation(ref, mov,
                                                     upsample_factor=20)
    # XLA may turn the division by the factor into a product
    np.testing.assert_allclose(H(shifts), jshift, rtol=0, atol=1e-12)
    np.testing.assert_allclose([float(err), float(phase)], [jerr, jphase],
                               rtol=0, atol=1e-9)
    xc = H(cross_correlate_masked(mov, ref, mask, mask, axes=(0, 1)))
    np.testing.assert_allclose(xc, jxc, rtol=0, atol=1e-12)
    peak = np.argwhere(jxc == jxc.max())
    assert len(peak) == 1
    got = H(reg.phase_cross_correlation(ref, mov, reference_mask=mask,
                                        moving_mask=mask))
    np.testing.assert_array_equal(got, -(peak[0] - np.asarray(ref.shape)
                                         + 1))


def test_optical_flows_match_cupyimg_tpu():
    """TV-L1 (one warp of one iteration) and iLK (one warp) over the two
    levels of a 64^2 float64 pair's pyramid: the port's whole call equals
    its coarse-to-fine levels, and its fine level equals
    ``cupyimg_tpu``'s solver on the same inputs (the coarse level runs
    the same code at half the size; each JAX solver costs a second of
    compiles a shape)."""
    from cupyimg_tpu.skimage.registration import _optical_flow as jflow

    from cupyimg_tpu_torch.skimage.registration._optical_flow_utils import (
        get_pyramid,
        resize_flow,
    )

    ref = _smooth(8)
    mov = _shifted(ref, (1.3, -0.8))
    tv = dict(attachment=15, tightness=0.3, num_warp=1, num_iter=1,
              tol=1e-4, prefilter=False)
    lk = dict(radius=3, num_warp=1, gaussian=False, prefilter=False)
    (c0, c1), (f0, f1) = zip(get_pyramid(torch.from_numpy(ref)),
                             get_pyramid(torch.from_numpy(mov)))
    assert f0.shape == (64, 64) and c0.shape == (32, 32)
    solvers = (("_tvl1", tv, reg.optical_flow_tvl1),
               ("_ilk", lk, reg.optical_flow_ilk))
    starts, fines = [], []
    for solve, kw, full in solvers:
        coarse = getattr(tflow, solve)(c0, c1, torch.zeros(
            (2, 32, 32), dtype=torch.float64), **kw)
        starts.append(resize_flow(coarse, (64, 64)))
        fines.append(getattr(tflow, solve)(f0, f1, starts[-1], **kw))
        np.testing.assert_array_equal(
            H(full(ref, mov, dtype=np.float64, **kw)), H(fines[-1]))
    # the two JAX solvers compile side by side (their compiles release
    # the interpreter lock)
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(getattr(jflow, solve), H(f0), H(f1), H(start),
                            **kw)
                for (solve, kw, _), start in zip(solvers, starts)]
        wants = [np.asarray(job.result()) for job in jobs]
    for fine, want in zip(fines, wants):
        np.testing.assert_allclose(H(fine), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
        assert np.abs(want).max() > 0.5


# ---------------------------------------------------------------------------
# no single-precision matrix product in the slice
# ---------------------------------------------------------------------------


def test_no_single_precision_matmul_in_the_slice(monkeypatch):
    """torch's matmul entry points refuse float32, float16 and complex64
    operands (TF32 could serve them on the card) and pass float64 and
    complex128 through, during the slice's float32 calls."""
    single = (torch.float16, torch.bfloat16, torch.float32, torch.complex64)
    passed = []

    def guard(fn):
        def guarded(*args, **kwargs):
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, torch.Tensor):
                    if a.dtype in single:
                        raise AssertionError(f"a {a.dtype} matmul")
                    passed.append(a.dtype)
            return fn(*args, **kwargs)
        return guarded

    for name in ("matmul", "mm", "bmm", "einsum", "tensordot", "inner",
                 "mv", "addmm", "baddbmm"):
        monkeypatch.setattr(torch, name, guard(getattr(torch, name)))
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        guard(torch.Tensor.__matmul__))
    monkeypatch.setattr(torch.Tensor, "matmul", guard(torch.Tensor.matmul))

    ref = _smooth(9, 48).astype(np.float32)
    mov = _shifted(ref, (1.5, -0.7)).astype(np.float32)
    x, y = torch.from_numpy(ref), torch.from_numpy(mov)
    mask = torch.ones(ref.shape, dtype=torch.bool)
    mask[:, :6] = False
    shifts, _, _ = reg.phase_cross_correlation(x, y, upsample_factor=20)
    np.testing.assert_allclose(H(shifts), [-1.5, 0.7], atol=0.05)
    # the upsampled DFT's products ran, in complex128
    assert passed and set(passed) == {torch.complex128}
    outs = [
        reg.phase_cross_correlation(x, y, reference_mask=mask),
        reg.optical_flow_tvl1(x, y, num_warp=2, prefilter=True),
        reg.optical_flow_ilk(x, y, num_warp=2, gaussian=True),
        segmentation.morphological_chan_vese(x, 3),
        segmentation.morphological_geodesic_active_contour(
            segmentation.inverse_gaussian_gradient(x), 3, balloon=-1),
        segmentation.mark_boundaries(x, (x > 0.5).to(torch.int32),
                                     mode="subpixel"),
        models.edge_enhance_pipeline(x),
        cupyimg_tpu_torch.convolve_separable(x, np.array([1.0, 2.0, 1.0])),
    ]
    assert all(torch.isfinite(o.double()).all() for o in outs)
