"""``skimage.metrics`` of the torch port on CPU tensors.

- skimage's structural-similarity and simple-metrics suites, with a
  synthetic stand-in for skimage's camera image (the suite's two
  oracles that are values of the real camera image are left out).
- Definitions in numpy/scipy: the MSE, NRMSE and PSNR over dtypes, and
  SSIM from scipy's uniform or gaussian filters in float64, with its
  gradient against central differences.
- A named list against ``cupyimg_tpu`` on JAX-CPU (x64) as one jit
  program.

Tolerances: the suites' own decimals; against numpy/scipy and
``cupyimg_tpu`` within 1e-12 relative (float64, SSIM's gradient against
central differences within 1e-5 of its largest value).
"""

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.skimage.metrics as jm
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.skimage import metrics as tmetrics
from cupyimg_tpu_torch.skimage.metrics import (
    mean_squared_error,
    normalized_root_mse,
    peak_signal_noise_ratio,
    structural_similarity,
)
from cupyimg_tpu_torch.skimage._shared._warnings import expected_warnings

assert_equal = np.testing.assert_array_equal
assert_almost_equal = np.testing.assert_array_almost_equal


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """numpy inputs go to the CPU here (the library's default device is
    CUDA)."""
    monkeypatch.setattr(config, "device", "cpu")


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _synthetic_camera():
    """Deterministic uint8 stand-in for skimage.data.camera()."""
    yy, xx = np.mgrid[0:512, 0:512]
    img = (
        128
        + 90 * np.sin(yy / 23.0)
        + 60 * np.cos(xx / 17.0)
        + 40 * np.sin((xx + yy) / 41.0)
    )
    rnd = np.random.RandomState(99)
    img = img + 10 * rnd.rand(512, 512)
    return np.clip(img, 0, 255).astype(np.uint8)


np.random.seed(5)
cam = _synthetic_camera()
sigma = 20.0
noise = sigma * np.random.randn(*cam.shape)
cam_noisy = np.clip(cam.astype(np.float64) + noise, 0, 255).astype(cam.dtype)


# ---------------------------------------------------------------- SSIM


def test_structural_similarity_patch_range():
    N = 51
    rstate = np.random.RandomState(1234)
    X = (rstate.rand(N, N) * 255).astype(np.uint8)
    Y = (rstate.rand(N, N) * 255).astype(np.uint8)

    assert float(structural_similarity(X, Y, win_size=N)) < 0.1
    assert_equal(float(structural_similarity(X, X, win_size=N)), 1)


def test_structural_similarity_image():
    N = 100
    rstate = np.random.RandomState(1234)
    X = (rstate.rand(N, N) * 255).astype(np.uint8)
    Y = (rstate.rand(N, N) * 255).astype(np.uint8)

    S0 = float(structural_similarity(X, X, win_size=3))
    assert_equal(S0, 1)

    S1 = float(structural_similarity(X, Y, win_size=3))
    assert S1 < 0.3

    S2 = float(structural_similarity(X, Y, win_size=11, gaussian_weights=True))
    assert S2 < 0.3

    mssim0, S3 = structural_similarity(X, Y, full=True)
    assert S3.shape == X.shape
    mssim = structural_similarity(X, Y)
    assert_equal(float(mssim0), float(mssim))

    assert_equal(float(structural_similarity(X, X)), 1.0)


@pytest.mark.parametrize("seed", [1, 2, 3, 5, 8, 13])
def test_structural_similarity_grad(seed):
    N = 30
    rnd = np.random.RandomState(seed)
    X = rnd.rand(N, N) * 255
    Y = rnd.rand(N, N) * 255

    f = float(structural_similarity(X, Y, data_range=255))
    g = structural_similarity(X, Y, data_range=255, gradient=True)

    assert f < 0.05
    assert float(g[0]) < 0.05
    assert np.all(np.asarray(g[1]) < 0.05)

    mssim, grad, s = structural_similarity(
        X, Y, data_range=255, gradient=True, full=True
    )
    assert np.all(np.asarray(grad) < 0.05)


def test_structural_similarity_dtype():
    N = 30
    rstate = np.random.RandomState(1234)
    X = rstate.rand(N, N)
    Y = rstate.rand(N, N)

    S1 = float(structural_similarity(X, Y))

    X = (X * 255).astype(np.uint8)
    Y = (X * 255).astype(np.uint8)

    S2 = float(structural_similarity(X, Y))

    assert S1 < 0.15
    assert S2 < 0.15


def test_structural_similarity_multichannel():
    N = 100
    rstate = np.random.RandomState(0)
    X = (rstate.rand(N, N) * 255).astype(np.uint8)
    Y = (rstate.rand(N, N) * 255).astype(np.uint8)

    S1 = structural_similarity(X, Y, win_size=3)

    # replicate across three channels: identical value
    Xc = np.tile(X[..., np.newaxis], (1, 1, 3))
    Yc = np.tile(Y[..., np.newaxis], (1, 1, 3))
    S2 = structural_similarity(Xc, Yc, multichannel=True, win_size=3)
    assert_almost_equal(float(S1), float(S2))

    m, S3 = structural_similarity(Xc, Yc, multichannel=True, full=True)
    assert S3.shape == Xc.shape

    m, grad = structural_similarity(Xc, Yc, multichannel=True, gradient=True)
    assert grad.shape == Xc.shape

    m, grad, S3 = structural_similarity(
        Xc, Yc, multichannel=True, full=True, gradient=True
    )
    assert grad.shape == Xc.shape
    assert S3.shape == Xc.shape

    # fail if win_size exceeds any non-channel dimension
    with pytest.raises(ValueError):
        structural_similarity(Xc, Yc, win_size=7, multichannel=False)


def test_structural_similarity_nD():
    N = 10
    rstate = np.random.RandomState(3)
    for ndim in range(1, 5):
        # [N] * 5 whatever the loop variable, as skimage's suite
        xsize = [N] * 5
        X = (rstate.rand(*xsize) * 255).astype(np.uint8)
        Y = (rstate.rand(*xsize) * 255).astype(np.uint8)

        mssim = float(structural_similarity(X, Y, win_size=3))
        assert mssim < 0.05


def test_structural_similarity_multichannel_chelsea():
    # color-image stand-in: three channels of the synthetic camera
    rstate = np.random.RandomState(7)
    Xc = np.stack(
        [
            cam,
            np.roll(cam, 5, axis=0),
            np.roll(cam, -3, axis=1),
        ],
        axis=-1,
    )
    Yc = np.clip(
        Xc.astype(np.float64) + 15.0 * rstate.randn(*Xc.shape), 0, 255
    ).astype(Xc.dtype)

    # multichannel result should be the mean of per-channel results
    mssim = structural_similarity(Xc, Yc, multichannel=True)
    mssim_sep = [
        float(structural_similarity(Yc[..., c], Xc[..., c]))
        for c in range(Xc.shape[-1])
    ]
    assert_almost_equal(float(mssim), np.mean(mssim_sep))

    assert_equal(
        float(structural_similarity(Xc, Xc, multichannel=True)), 1.0
    )


def test_mssim_mixed_dtype():
    mssim = structural_similarity(cam, cam_noisy)
    with expected_warnings(["Inputs have mismatched dtype"]):
        mssim_mixed = structural_similarity(
            cam, cam_noisy.astype(np.float32)
        )
    assert_almost_equal(float(mssim), float(mssim_mixed))

    # no warning when the user supplies data_range
    mssim_mixed = structural_similarity(
        cam, cam_noisy.astype(np.float32), data_range=255
    )
    assert_almost_equal(float(mssim), float(mssim_mixed))


def test_invalid_input():
    X = np.zeros((9, 9), dtype=np.double)
    Y = np.zeros((8, 8), dtype=np.double)
    with pytest.raises(ValueError):
        structural_similarity(X, Y)
    with pytest.raises(ValueError):
        structural_similarity(X, X, win_size=X.shape[0] + 1)
    with pytest.raises(ValueError):
        structural_similarity(X, X, K1=-0.1)
    with pytest.raises(ValueError):
        structural_similarity(X, X, K2=-0.1)
    with pytest.raises(ValueError):
        structural_similarity(X, X, sigma=-1.0)


# ------------------------------------------------------- simple metrics


def test_PSNR_float():
    p_uint8 = peak_signal_noise_ratio(cam, cam_noisy)
    camf = cam / 255.0
    cam_noisyf = cam_noisy / 255.0
    p_float64 = peak_signal_noise_ratio(camf, cam_noisyf, data_range=1)
    assert_almost_equal(float(p_uint8), float(p_float64), decimal=5)

    # mixed precision inputs
    p_mixed = peak_signal_noise_ratio(
        camf, (cam_noisy.astype(np.float32)) / 255.0, data_range=1
    )
    assert_almost_equal(float(p_mixed), float(p_float64), decimal=4)

    # mismatched dtype warns when data_range is unspecified
    with expected_warnings(["Inputs have mismatched dtype"]):
        p_mixed = peak_signal_noise_ratio(
            camf, (cam_noisy.astype(np.float32)) / 255.0
        )
    assert_almost_equal(float(p_mixed), float(p_float64), decimal=4)


def test_PSNR_errors():
    with pytest.raises(ValueError):
        peak_signal_noise_ratio(cam, cam[:-1, :])


def test_NRMSE():
    x = np.ones(4)
    y = np.asarray([0.0, 2.0, 2.0, 2.0])
    assert_equal(
        float(normalized_root_mse(y, x, normalization="mean")),
        1 / np.mean(y),
    )
    assert_equal(
        float(normalized_root_mse(y, x, normalization="euclidean")),
        1 / np.sqrt(3),
    )
    assert_equal(
        float(normalized_root_mse(y, x, normalization="min-max")),
        1 / (y.max() - y.min()),
    )

    # mixed precision inputs are allowed
    assert_almost_equal(
        float(
            normalized_root_mse(
                y, x.astype(np.float32), normalization="min-max"
            )
        ),
        1 / (y.max() - y.min()),
    )


def test_NRMSE_no_int_overflow():
    camf = cam.astype(np.float32)
    cam_noisyf = cam_noisy.astype(np.float32)
    assert_almost_equal(
        float(mean_squared_error(cam, cam_noisy)),
        float(mean_squared_error(camf, cam_noisyf)),
    )
    assert_almost_equal(
        float(normalized_root_mse(cam, cam_noisy)),
        float(normalized_root_mse(camf, cam_noisyf)),
        decimal=5,
    )


def test_NRMSE_errors():
    x = np.ones(4)
    with pytest.raises(ValueError):
        normalized_root_mse(x[:-1], x)
    with pytest.raises(ValueError):
        normalized_root_mse(x, x, normalization="foo")


class TestMetrics:
    def setup_method(self):
        rng = np.random.RandomState(0)
        self.a = rng.rand(32, 32)
        self.b = np.clip(self.a + rng.randn(32, 32) * 0.1, 0, 1)

    def test_mse(self):
        got = float(tmetrics.mean_squared_error(self.a, self.b))
        np.testing.assert_allclose(got, np.mean((self.a - self.b) ** 2),
                                   rtol=1e-10)

    def test_nrmse(self):
        got = float(tmetrics.normalized_root_mse(self.a, self.b))
        exp = np.sqrt(np.mean((self.a - self.b) ** 2)) / np.sqrt(
            np.mean(self.a ** 2)
        )
        np.testing.assert_allclose(got, exp, rtol=1e-10)

    def test_psnr(self):
        got = float(
            tmetrics.peak_signal_noise_ratio(self.a, self.b, data_range=1.0)
        )
        exp = 10 * np.log10(1.0 / np.mean((self.a - self.b) ** 2))
        np.testing.assert_allclose(got, exp, rtol=1e-10)

    def test_ssim_identity(self):
        s = float(tmetrics.structural_similarity(self.a, self.a,
                                                data_range=1.0))
        assert s == pytest.approx(1.0)

    def test_ssim_decreases_with_noise(self):
        s1 = float(tmetrics.structural_similarity(self.a, self.b,
                                                 data_range=1.0))
        worse = np.clip(self.a + np.random.RandomState(1).randn(32, 32) * 0.3,
                        0, 1)
        s2 = float(tmetrics.structural_similarity(self.a, worse,
                                                 data_range=1.0))
        assert 0 < s2 < s1 < 1

    def test_ssim_known_value(self):
        """SSIM of an image vs itself + constant shift c:
        analytic: (2*mu*(mu+c)+C1)/(mu^2+(mu+c)^2+C1) * (2*v+C2)/(2*v+C2)."""
        x = self.a
        c = 0.1
        y = x + c
        s = float(tmetrics.structural_similarity(x, y, data_range=1.0))
        # luminance term only penalty; structure/contrast identical
        assert 0.9 < s < 1.0

    def test_ssim_full(self):
        s, S = tmetrics.structural_similarity(self.a, self.b, data_range=1.0,
                                             full=True)
        assert np.asarray(S).shape == self.a.shape

    def test_ssim_gaussian_weights(self):
        s = float(
            tmetrics.structural_similarity(
                self.a, self.b, data_range=1.0, gaussian_weights=True
            )
        )
        assert 0 < s < 1

    def test_ssim_multichannel(self):
        a = np.stack([self.a] * 3, -1)
        b = np.stack([self.b] * 3, -1)
        s = float(
            tmetrics.structural_similarity(a, b, data_range=1.0,
                                          multichannel=True)
        )
        s_single = float(
            tmetrics.structural_similarity(self.a, self.b, data_range=1.0)
        )
        np.testing.assert_allclose(s, s_single, rtol=1e-10)


# ---------------------------------------------------------------------------
# definitions in numpy / scipy
# ---------------------------------------------------------------------------


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16,
                                   np.float32, np.float64])
def test_simple_metrics_match_numpy(dtype):
    """MSE, NRMSE (three norms) and PSNR in numpy's promotion of the
    dtypes with float32; the dtype range as PSNR's default."""
    rng = np.random.default_rng(40)
    hi = 1.0 if np.dtype(dtype).kind == "f" else min(
        np.iinfo(dtype).max, 3000)
    a = (rng.random((23, 31)) * hi).astype(dtype)
    b = np.clip(a + rng.standard_normal(a.shape) * hi * 0.05, 0, hi
                ).astype(dtype)
    ft = np.promote_types(dtype, np.float32)
    af, bf = a.astype(ft), b.astype(ft)
    mse = np.mean((af - bf) ** 2)
    got = mean_squared_error(T(a), T(b))
    assert H(got).dtype == ft
    np.testing.assert_allclose(float(got), mse, rtol=1e-6)
    for norm, den in (("euclidean", np.sqrt(np.mean(af * af))),
                      ("min-max", af.max() - af.min()),
                      ("mean", af.mean())):
        np.testing.assert_allclose(
            float(normalized_root_mse(T(a), T(b), normalization=norm)),
            np.sqrt(mse) / den, rtol=1e-6)
    dmax = 1.0 if np.dtype(dtype).kind == "f" else np.iinfo(dtype).max
    drange = dmax if a.min() >= 0 else dmax - (
        -1.0 if np.dtype(dtype).kind == "f" else np.iinfo(dtype).min)
    np.testing.assert_allclose(float(peak_signal_noise_ratio(T(a), T(b))),
                               10 * np.log10(drange ** 2 / mse), rtol=1e-6)


def _ssim_reference(x, y, win, gaussian, data_range):
    """SSIM in float64 with scipy's filters (sample covariance)."""
    if gaussian:
        filt = lambda v: sndi.gaussian_filter(v, 1.5, truncate=3.5)  # noqa
        win = 2 * int(3.5 * 1.5 + 0.5) + 1
    else:
        filt = lambda v: sndi.uniform_filter(v, win)  # noqa: E731
    n = win ** x.ndim
    cov = n / (n - 1)
    ux, uy = filt(x), filt(y)
    vx = cov * (filt(x * x) - ux * ux)
    vy = cov * (filt(y * y) - uy * uy)
    vxy = cov * (filt(x * y) - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux * ux + uy * uy + c1) * (vx + vy + c2)))
    pad = (win - 1) // 2
    return s[tuple(slice(pad, -pad) for _ in range(x.ndim))].mean(), s


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("shape", [(40, 47), (14, 15, 16)])
def test_ssim_matches_scipy_definition(shape, gaussian):
    rng = np.random.default_rng(41)
    x = rng.random(shape)
    y = np.clip(x + rng.standard_normal(shape) * 0.1, 0, 1)
    want, s = _ssim_reference(x, y, 7, gaussian, 1.0)
    got, full = structural_similarity(T(x), T(y), data_range=1.0,
                                      gaussian_weights=gaussian, full=True)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    np.testing.assert_allclose(H(full), s, rtol=0, atol=1e-12)
    f32 = structural_similarity(T(x.astype(np.float32)),
                                T(y.astype(np.float32)), data_range=1.0,
                                gaussian_weights=gaussian)
    assert f32.dtype == torch.float64


def test_ssim_gradient_matches_central_differences():
    """The gradient with respect to im2 (Avanaki's formula, which takes
    the population covariance and the mean over the whole SSIM image)
    against central differences of that mean."""
    rng = np.random.default_rng(42)
    x = rng.random((16, 18))
    y = np.clip(x + rng.standard_normal(x.shape) * 0.2, 0, 1)
    _, grad = structural_similarity(T(x), T(y), data_range=1.0,
                                    gradient=True,
                                    use_sample_covariance=False)

    def mean_s(yy):
        f = lambda v: sndi.uniform_filter(v, 7)  # noqa: E731
        ux, uy = f(x), f(yy)
        vx, vy, vxy = f(x * x) - ux * ux, f(yy * yy) - uy * uy, (
            f(x * yy) - ux * uy)
        c1, c2 = 0.01 ** 2, 0.03 ** 2
        return ((2 * ux * uy + c1) * (2 * vxy + c2) / (
            (ux * ux + uy * uy + c1) * (vx + vy + c2))).mean()

    h = 1e-6
    sel = (slice(0, 16, 3), slice(0, 18, 3))
    num = np.zeros_like(y)
    for i in range(0, 16, 3):
        for j in range(0, 18, 3):
            yp, ym = y.copy(), y.copy()
            yp[i, j] += h
            ym[i, j] -= h
            num[i, j] = (mean_s(yp) - mean_s(ym)) / (2 * h)
    scale = np.abs(num[sel]).max()
    np.testing.assert_allclose(H(grad)[sel], num[sel], rtol=0,
                               atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64)
# ---------------------------------------------------------------------------


def test_named_calls_match_cupyimg_tpu():
    """MSE, NRMSE, PSNR with a given range and SSIM (uniform and gaussian,
    full and gradient) as one jit program: within 1e-12 relative."""
    rng = np.random.default_rng(43)
    x = rng.random((24, 27))
    y = np.clip(x + rng.standard_normal(x.shape) * 0.1, 0, 1)
    cases = [
        ("mean_squared_error", lambda m, a, b: m.mean_squared_error(a, b)),
        ("normalized_root_mse", lambda m, a, b: m.normalized_root_mse(
            a, b, normalization="min-max")),
        ("peak_signal_noise_ratio", lambda m, a, b:
         m.peak_signal_noise_ratio(a, b, data_range=1.0)),
        ("structural_similarity full", lambda m, a, b:
         m.structural_similarity(a, b, data_range=1.0, full=True)[1]),
        ("structural_similarity gaussian gradient", lambda m, a, b:
         m.structural_similarity(a, b, data_range=1.0, gradient=True,
                                 gaussian_weights=True)[1]),
    ]

    @jax.jit
    def ref(a, b):
        return [fn(jm, a, b) for _, fn in cases]

    want = ref(jnp.asarray(x), jnp.asarray(y))
    for (name, fn), w in zip(cases, want):
        got = H(fn(tmetrics, T(x), T(y)))
        w = np.asarray(w)
        assert got.dtype == w.dtype, name
        np.testing.assert_allclose(got, w, rtol=1e-12, atol=1e-15,
                                   err_msg=name)


@pytest.mark.parametrize("name", [
    "skimage.metrics", "skimage.metrics.simple_metrics",
    "skimage.metrics._structural_similarity"])
def test_public_names_match_cupyimg_tpu(name):
    import importlib
    import types

    jmod = importlib.import_module("cupyimg_tpu." + name)
    tmod = importlib.import_module("cupyimg_tpu_torch." + name)

    def public(mod):
        names = set(getattr(mod, "__all__", ())) | {
            n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}
        return names - {"annotations", "np", "jnp", "jax", "torch"}

    assert public(jmod) - public(tmod) == set()
