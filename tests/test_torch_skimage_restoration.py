"""``skimage.restoration`` of the torch port on CPU tensors.

- skimage's restoration suites: ``uft``'s unitary transforms, the
  Wiener-Hunt deconvolutions and Richardson-Lucy on circular blurs,
  total-variation denoising and the J-invariant denoiser calibration,
  with synthetic stand-ins for skimage's bundled images.
- The goldens of ``tests/data/restoration``: ``wiener`` (both forms) and
  ``richardson_lucy`` within the reference suite's rtol of 1e-3.
- Numpy definitions: ``uft`` against ``numpy.fft`` with the 1/sqrt(N)
  scale, Chambolle's iteration transcribed in numpy.
- A named list against ``cupyimg_tpu`` on JAX-CPU (x64): ``wiener`` and
  ``richardson_lucy`` as one jit program, and ``unsupervised_wiener``
  with the same seeded ``RandomState`` (eager: the sampler reads its
  norms on the host).
- The CUDA dispatch test is in ``test_torch_skimage_filters_cuda.py``.

Tolerances: float64 within 1e-12 of max|ref| (the sampler's chains and
mean within 1e-8 relative: each gamma draw scales with a norm computed
in another order); float32 within 2e-6 of max|ref|.
"""

import os

import numpy as np
import pytest
import scipy.ndimage as sndi
import scipy.signal as ss
import torch

import jax
import jax.numpy as jnp

from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.skimage import restoration as rest
from cupyimg_tpu_torch.skimage.metrics import structural_similarity
from cupyimg_tpu_torch.skimage.restoration import uft
from cupyimg_tpu_torch.skimage.restoration.j_invariant import (
    _generate_grid_slice,
    _interpolate_image,
    _invariant_denoise,
)

DATA = os.path.join(os.path.dirname(__file__), "data", "restoration")


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """numpy and list inputs go to the CPU here (the library's default
    device is CUDA)."""
    monkeypatch.setattr(config, "device", "cpu")


def T(x, dtype=None):
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=dtype))


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, ref, tol):
    """|got - ref| <= tol * max|ref| (tol itself where ref is all 0)."""
    got, ref = H(got), np.asarray(H(ref))
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _image(seed=0, n=64):
    rng = np.random.RandomState(seed)
    img = sndi.gaussian_filter(rng.rand(n, n), 1)
    return (img - img.min()) / np.ptp(img)


def _psf():
    psf = np.outer(ss.windows.gaussian(7, 1), ss.windows.gaussian(7, 1))
    return psf / psf.sum()


def _circular_blur(img, psf):
    """A circular convolution with a centred PSF: the Fourier
    diagonalisation's model exactly."""
    tf = H(uft.ir2tf(T(psf), img.shape, is_real=False))
    return np.real(np.fft.ifftn(np.fft.fftn(img) * tf))


# ---------------------------------------------------------------------------
# uft
# ---------------------------------------------------------------------------


def test_uft_unitary_and_roundtrip():
    x = np.ones((3, 3, 3))
    out = H(uft.ufftn(T(x)))
    assert np.allclose(x.sum() / np.sqrt(x.size), out[0, 0, 0])
    y = np.random.RandomState(0).rand(8, 9)
    assert np.allclose(np.sum(np.abs(H(uft.ufft2(T(y)))) ** 2),
                       np.sum(y ** 2))
    y = np.random.RandomState(1).rand(8, 9)
    np.testing.assert_allclose(H(uft.uifft2(uft.ufft2(T(y)))).real, y,
                               atol=1e-12)
    np.testing.assert_allclose(H(uft.uirfft2(uft.urfft2(T(y)),
                                             shape=y.shape)), y, atol=1e-12)
    # an odd last axis needs its size
    assert uft.uirfft2(uft.urfft2(T(y))).shape == (8, 8)


@pytest.mark.parametrize("shape, dim", [((6, 7), None), ((4, 5, 6), None),
                                        ((4, 5, 6), 2), ((9,), 1)])
def test_uft_matches_numpy(shape, dim):
    x = np.random.default_rng(len(shape)).random(shape)
    d = len(shape) if dim is None else dim
    axes = tuple(range(-d, 0))
    n = np.prod([shape[a] for a in axes])
    close(uft.ufftn(T(x), dim), np.fft.fftn(x, axes=axes) / np.sqrt(n),
          1e-12)
    close(uft.uifftn(T(x), dim), np.fft.ifftn(x, axes=axes) * np.sqrt(n),
          1e-12)
    r = np.fft.rfftn(x, axes=axes) / np.sqrt(n)
    close(uft.urfftn(T(x), dim), r, 1e-12)
    close(uft.uirfftn(T(r), dim, shape=[shape[a] for a in axes]), x, 1e-12)


def test_ir2tf_laplacian_and_quad_norm_goldens():
    out = H(uft.ir2tf(T(np.ones((2, 2))), (2, 2)))
    np.testing.assert_allclose(out.real, [[4, 0], [0, 0]], atol=1e-12)
    assert uft.ir2tf(T(np.ones((2, 2))), (512, 512)).shape == (512, 257)
    assert uft.ir2tf(T(np.ones((2, 2))), (512, 512),
                     is_real=False).shape == (512, 512)
    tf, ir = uft.laplacian(2, (32, 32))
    np.testing.assert_array_equal(H(ir), [[0, -1, 0], [-1, 4, -1],
                                          [0, -1, 0]])
    np.testing.assert_allclose(H(tf), H(uft.ir2tf(ir, (32, 32))), atol=1e-12)
    # the transfer function of a 3-D psf over the last two axes
    psf = np.random.default_rng(3).random((2, 3, 3))
    pad = np.zeros((2, 8, 9))
    pad[:, :3, :3] = psf
    want = np.fft.rfftn(np.roll(pad, (-1, -1), axis=(1, 2)), axes=(1, 2))
    close(uft.ir2tf(T(psf), (2, 8, 9), dim=2), want, 1e-12)
    inp = T(np.ones((5, 5)))
    assert float(uft.image_quad_norm(uft.ufft2(inp))) == pytest.approx(25.0)
    assert float(uft.image_quad_norm(uft.urfft2(inp))) == pytest.approx(25.0)


# ---------------------------------------------------------------------------
# wiener, unsupervised_wiener, richardson_lucy
# ---------------------------------------------------------------------------


def test_wiener_suite():
    img, psf = _image(), _psf()
    blurred = _circular_blur(img, psf)
    dec = H(rest.wiener(T(blurred), T(psf), 1e-12, clip=False))
    np.testing.assert_allclose(dec, img, atol=1e-5)
    tf = uft.ir2tf(T(psf), img.shape, is_real=True)
    dec = H(rest.wiener(T(blurred), tf, 1e-12, clip=False))
    np.testing.assert_allclose(dec, img, atol=1e-5)
    dec = H(rest.wiener(T(_circular_blur(img * 10, psf)), T(psf), 0.01))
    assert dec.max() <= 1.0 and dec.min() >= -1.0
    noisy = blurred + 0.05 * np.random.RandomState(2).standard_normal(
        img.shape)
    sharp = H(rest.wiener(T(noisy), T(psf), 1e-10, clip=False))
    reg = H(rest.wiener(T(noisy), T(psf), 0.5, clip=False))
    assert np.mean((reg - img) ** 2) < np.mean((sharp - img) ** 2)


def test_wiener_matches_a_numpy_definition():
    """conj(H) / (|H|^2 + balance |L|^2) applied in numpy's FFT, the
    complex form's clip on the real part as skimage's."""
    img = _image(5, 24)
    psf = _psf()
    h = np.zeros(img.shape)
    h[:7, :7] = psf
    h = np.fft.fftn(np.roll(h, (-3, -3), axis=(0, 1)))
    lap = np.zeros(img.shape)
    lap[:3, :3] = [[0, -1, 0], [-1, 4, -1], [0, -1, 0]]
    lap = np.fft.fftn(np.roll(lap, (-1, -1), axis=(0, 1)))
    want = np.real(np.fft.ifftn(np.conj(h) / (np.abs(h) ** 2 + 0.1 * np.abs(
        lap) ** 2) * np.fft.fftn(img * 3)))
    close(rest.wiener(T(img * 3), T(psf), 0.1, clip=False), want, 1e-12)
    got = rest.wiener(T(img * 3), T(psf), 0.1, is_real=False)
    assert got.dtype == torch.complex128
    close(got.real, np.clip(want, -1, 1), 1e-12)


@pytest.fixture(scope="module")
def degraded():
    return np.load(os.path.join(DATA, "degraded_input.npy"))


def test_restoration_goldens(degraded):
    """The reference suite's goldens, rtol 1e-3."""
    psf = T(np.ones((5, 5)) / 25)
    golden = np.load(os.path.join(DATA, "camera_wiener.npy"))
    np.testing.assert_allclose(H(rest.wiener(T(degraded), psf, 0.05)),
                               golden, rtol=1e-3)
    _, laplacian = uft.laplacian(2, degraded.shape)
    otf = uft.ir2tf(psf, degraded.shape, is_real=False)
    got = rest.wiener(T(degraded), otf, 0.05, reg=laplacian, is_real=False)
    np.testing.assert_allclose(H(got).real, golden, rtol=1e-3)
    got = rest.richardson_lucy(T(degraded), psf, 5)
    np.testing.assert_allclose(H(got), np.load(os.path.join(
        DATA, "camera_rl.npy")), rtol=1e-3)
    restored, _ = rest.unsupervised_wiener(
        T(degraded), psf, user_params={"rng": np.random.RandomState(5),
                                       "max_iter": 40})
    assert np.median(np.abs(H(restored) - golden)) < 0.05


def test_richardson_lucy_suite():
    img, psf = _image(), _psf()
    blurred = ss.fftconvolve(img, psf, "same")
    rl = H(rest.richardson_lucy(T(blurred), T(psf), iterations=200,
                                clip=False))
    assert np.abs(rl - img)[8:-8, 8:-8].mean() < 0.02
    spike = np.zeros((16, 16))
    spike[8, 8] = 1.0
    out = H(rest.richardson_lucy(T(ss.fftconvolve(spike, np.ones((3, 3)) / 9,
                                                  "same")),
                                 T(np.ones((3, 3)) / 9), iterations=5,
                                 filter_epsilon=1e-6))
    assert np.isfinite(out).all()
    out = H(rest.richardson_lucy(T(ss.fftconvolve(img * 3, psf, "same")),
                                 T(psf), 10))
    assert out.max() <= 1.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
@pytest.mark.parametrize("eps", [None, 1e-3])
def test_richardson_lucy_matches_a_numpy_definition(dtype, eps):
    """est *= convolve(image / convolve(est, psf), psf mirrored), in the
    image's type promoted with float32."""
    x = _image(6, 20)
    x = (x * 200).astype(dtype) if dtype == np.uint8 else x.astype(dtype)
    psf = np.outer([1, 2, 1], [1, 3, 3, 1]).astype(np.float64) / 32
    ft = np.promote_types(dtype, np.float32)
    image, p = x.astype(np.float64), psf
    est = np.full(x.shape, 0.5)
    for _ in range(4):
        conv = ss.convolve(est, p, mode="same", method="direct")
        rel = image / conv
        if eps:
            rel = np.where(conv < eps, 0, rel)
        est = est * ss.convolve(rel, p[::-1, ::-1], mode="same",
                                method="direct")
    got = rest.richardson_lucy(T(x), T(psf), 4, clip=False,
                               filter_epsilon=eps)
    assert got.dtype == T(np.zeros(1, ft)).dtype
    close(got, est, 2e-6 if ft == np.float32 else 1e-12)


def test_unsupervised_wiener_suite():
    img, psf = _image(), _psf()
    noisy = _circular_blur(img, psf) + 0.02 * np.random.RandomState(
        3).standard_normal(img.shape)
    seen = []
    dec, chains = rest.unsupervised_wiener(
        T(noisy), T(psf), user_params={"rng": np.random.RandomState(4),
                                       "max_iter": 80,
                                       "callback": seen.append},
        clip=False)
    assert len(chains["noise"]) > 2
    assert len(chains["prior"]) == len(chains["noise"]) == len(seen) + 1
    assert np.mean((H(dec) - img) ** 2) < np.mean((noisy - img) ** 2)
    tf = uft.ir2tf(T(psf), img.shape, is_real=False)
    dec_c, _ = rest.unsupervised_wiener(
        T(noisy), tf, is_real=False,
        user_params={"rng": np.random.RandomState(4), "max_iter": 40})
    assert dec_c.dtype == torch.complex128
    assert float(dec_c.real.max()) <= 1 and float(dec_c.real.min()) >= -1


# ---------------------------------------------------------------------------
# total-variation denoising
# ---------------------------------------------------------------------------


def _np_tv_chambolle(image, weight, eps=2e-4, n_iter_max=200):
    """Chambolle's projection, transcribed from skimage in numpy."""
    ndim = image.ndim
    p = np.zeros((ndim,) + image.shape)
    g = np.zeros_like(p)
    d = np.zeros_like(image)
    i = 0
    out = image
    while i < n_iter_max:
        if i > 0:
            d = -p.sum(0)
            for ax in range(ndim):
                sl = [slice(None)] * ndim
                sl2 = [slice(None)] * ndim
                sl[ax], sl2[ax] = slice(1, None), slice(None, -1)
                d[tuple(sl)] += p[(ax,) + tuple(sl2)]
            out = image + d
        else:
            out = image
        E = (d ** 2).sum()
        for ax in range(ndim):
            g[ax] = np.concatenate([np.diff(out, axis=ax), np.zeros_like(
                np.take(out, [0], axis=ax))], axis=ax)
        norm = np.sqrt((g ** 2).sum(axis=0))[np.newaxis]
        E += weight * norm.sum()
        tau = 1.0 / (2.0 * ndim)
        norm = norm * tau / weight + 1.0
        p = (p - tau * g) / norm
        E /= float(image.size)
        if i == 0:
            E_init = E
            E_previous = E
        elif np.abs(E_previous - E) < eps * E_init:
            break
        else:
            E_previous = E
        i += 1
    return out


def _astro_gray():
    yy, xx = np.mgrid[0:64, 0:64]
    rnd = np.random.RandomState(3)
    img = (0.5 + 0.22 * np.sin(yy / 9.0) + 0.18 * np.cos(xx / 6.0)
           + 0.06 * rnd.rand(64, 64))
    return np.clip(img, 0, 1)


@pytest.mark.parametrize("shape", [(40,), (24, 25), (9, 10, 11),
                                   (5, 6, 5, 6)])
@pytest.mark.parametrize("weight", [0.05, 0.3])
def test_denoise_tv_matches_numpy(shape, weight):
    x = np.random.default_rng(len(shape)).random(shape)
    close(rest.denoise_tv_chambolle(T(x), weight=weight),
          _np_tv_chambolle(x, weight), 1e-10)


def test_denoise_tv_suite():
    img = _astro_gray()
    noisy = np.clip(img + 0.5 * img.std() * np.random.RandomState(
        1234).rand(*img.shape), 0, 1)
    den = H(rest.denoise_tv_chambolle(T(noisy), weight=0.1))
    grad = sndi.morphological_gradient(noisy, size=(3, 3))
    grad_d = sndi.morphological_gradient(den, size=(3, 3))
    assert np.sqrt((grad_d ** 2).sum()) < np.sqrt((grad ** 2).sum())
    astro = np.stack([img, np.roll(img, 3, axis=0), np.roll(img, -2, axis=1)],
                     axis=-1)
    d0 = rest.denoise_tv_chambolle(T(astro[..., 0]), weight=0.1)
    d = rest.denoise_tv_chambolle(T(astro), weight=0.1, multichannel=True)
    np.testing.assert_allclose(H(d[..., 0]), H(d0))
    astro3 = np.tile(astro[:32, :32, np.newaxis, :], [1, 1, 2, 1])
    astro3[:, :, 0, :] = 2 * astro3[:, :, 0, :]
    d0 = rest.denoise_tv_chambolle(T(astro3[..., 0]), weight=0.1)
    d = rest.denoise_tv_chambolle(T(astro3), weight=0.1, multichannel=True)
    np.testing.assert_allclose(H(d[..., 0]), H(d0))
    u8 = T((img * 255).astype(np.uint8))
    den = rest.denoise_tv_chambolle(u8, weight=0.1)
    assert den.dtype == torch.float64
    assert float(den.max()) <= 1.0 and float(den.min()) >= 0.0


@pytest.mark.parametrize("shape", [(1000,), (20, 20, 20), (8, 8, 8, 8)])
def test_denoise_tv_smooths_integer_images(shape):
    rng = np.random.RandomState(0)
    if len(shape) == 1:
        x = 125 + 100 * np.sin(np.linspace(0, 8 * np.pi, shape[0]))
        x = np.clip(x + 20 * rng.rand(x.size), 0, 255)
    elif len(shape) == 3:
        xx, yy, zz = np.ogrid[0:20, 0:20, 0:20]
        x = 100.0 * ((xx - 11) ** 2 + (yy - 10) ** 2 + (zz - 8) ** 2 < 16)
        x = np.clip(x + 60 + 20 * rng.rand(*shape), 0, 255)
    else:
        x = 255 * rng.rand(*shape)
    res = rest.denoise_tv_chambolle(T(x.astype(np.uint8)), weight=0.1)
    assert res.dtype == torch.float64
    assert float(res.std()) * 255 < x.std()


def test_denoise_tv_weighting():
    img2d = np.clip(_astro_gray() + 0.15 * np.random.RandomState(
        1234).standard_normal((64, 64)), 0, 1)
    img4d = np.tile(img2d[..., None, None], (1, 1, 2, 2))
    d2 = rest.denoise_tv_chambolle(T(img2d), weight=0.2)
    d4 = rest.denoise_tv_chambolle(T(img4d), weight=0.2)
    assert float(structural_similarity(d2, d4[:, :, 0, 0])) > 0.95


# ---------------------------------------------------------------------------
# J-invariant calibration
# ---------------------------------------------------------------------------


def _synthetic(shape, seed=11):
    rng = np.random.RandomState(seed)
    return np.clip(sndi.gaussian_filter(rng.rand(*shape), 3.0) * 2.0, 0, 1)


def test_calibrate_denoiser_suite():
    img = np.zeros((32, 32))
    img[8:24, 8:24] = 1.0
    noisy = img + 0.2 * np.random.RandomState(9).standard_normal(img.shape)
    f, (tested, losses) = rest.calibrate_denoiser(
        T(noisy), rest.denoise_tv_chambolle, {"weight": [0.001, 0.1]},
        extra_output=True)
    assert len(tested) == 2 and len(losses) == 2
    assert tested[int(np.argmin(losses))]["weight"] == 0.1
    out = H(f(T(noisy)))
    assert np.mean((out - img) ** 2) < np.mean((noisy - img) ** 2)
    noisy = np.random.RandomState(10).rand(16, 16)
    f = rest.calibrate_denoiser(T(noisy), rest.denoise_tv_chambolle,
                                {"weight": [0.05]}, approximate_loss=False)
    assert f(T(noisy)).shape == noisy.shape


@pytest.mark.parametrize("shape, sigma", [((48, 48), 0.1), ((16, 16, 16),
                                                           0.17)])
def test_invariant_denoise_improves_mse(shape, sigma):
    clean = _synthetic(shape) / (1 if len(shape) == 2 else 2)
    noisy = clean + sigma * np.random.RandomState(12).standard_normal(shape)
    den = H(_invariant_denoise(T(noisy), rest.denoise_tv_chambolle,
                               denoiser_kwargs={"weight": sigma}))
    assert np.mean((den - clean) ** 2) < np.mean((noisy - clean) ** 2)


def test_j_invariant_pieces_match_definitions():
    """The neighbour mean is scipy's mirror convolution; the grid slices
    tile the image; each pixel of the invariant output comes from the
    pass where it was replaced by its neighbours' mean."""
    x = np.random.default_rng(4).random((10, 11))
    k = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]]) / 4.0
    close(_interpolate_image(T(x)), sndi.convolve(x, k, mode="mirror"),
          1e-12)
    rgb = np.random.default_rng(5).random((6, 7, 3))
    close(_interpolate_image(T(rgb), multichannel=True),
          sndi.convolve(rgb, k[..., None], mode="mirror"), 1e-12)
    hits = np.zeros((10, 11), int)
    for idx in range(9):
        hits[_generate_grid_slice((10, 11), offset=idx, stride=3)] += 1
    assert (hits == 1).all()
    interp = sndi.convolve(x, k, mode="mirror")
    got = _invariant_denoise(T(x), lambda im: im * 2, stride=3)
    close(got, 2 * interp, 1e-12)


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64)
# ---------------------------------------------------------------------------


def test_named_calls_match_cupyimg_tpu():
    """wiener (real and complex forms) and float32 richardson_lucy as one
    jit program of cupyimg_tpu: within 1e-12 of max|ref| for float64,
    2e-6 for float32."""
    import cupyimg_tpu.skimage.restoration as jr

    rng = np.random.default_rng(21)
    x = _image(7, 30)
    x32 = x.astype(np.float32)
    psf = _psf()
    psf32 = (np.ones((5, 5)) / 25).astype(np.float32)
    cases = [
        ("wiener", lambda m, a, b: m.wiener(a, psf, 0.05), 1e-12),
        ("wiener complex", lambda m, a, b: m.wiener(
            a, psf, 0.2, is_real=False, clip=False), 1e-12),
        ("richardson_lucy f32", lambda m, a, b: m.richardson_lucy(
            b, psf32, 4, filter_epsilon=0.05), 2e-6),
    ]
    x = x + 0.01 * rng.standard_normal(x.shape)

    @jax.jit
    def ref(a, b):
        return [fn(jr, a, b) for _, fn, _ in cases]

    want = ref(jnp.asarray(x), jnp.asarray(x32))
    for (name, fn, tol), w in zip(cases, want):
        got = fn(rest, T(x), T(x32))
        w = np.asarray(w)
        assert H(got).dtype == w.dtype, name
        close(got, w, tol)


def test_unsupervised_wiener_matches_cupyimg_tpu():
    """The same seeded RandomState drives both samplers: the same chain
    and posterior mean within 1e-8 relative."""
    import cupyimg_tpu.skimage.restoration as jr

    img, psf = _image(8, 24), _psf()
    noisy = _circular_blur(img, psf) + 0.03 * np.random.RandomState(
        8).standard_normal(img.shape)
    params = dict(max_iter=5, min_iter=1, burnin=1, threshold=1e-12)
    want, wchains = jr.unsupervised_wiener(
        jnp.asarray(noisy), jnp.asarray(psf),
        user_params=dict(params, rng=np.random.RandomState(9)))
    got, chains = rest.unsupervised_wiener(
        T(noisy), T(psf), user_params=dict(params,
                                           rng=np.random.RandomState(9)))
    for key in ("noise", "prior"):
        np.testing.assert_allclose(chains[key], wchains[key], rtol=1e-8)
    close(got, np.asarray(want), 1e-8)
