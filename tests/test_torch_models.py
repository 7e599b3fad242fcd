"""The pipelines (``cupyimg_tpu_torch.models``), the root helpers
(``convolve_separable``, ``__version__``) and ``_misc`` of the torch port
on CPU tensors.

- ``edge_enhance_pipeline`` against ``tests/test_models.py``'s scipy
  composition (rtol and atol 2e-4, float32) in 2-D and 3-D, and against
  ``cupyimg_tpu`` on JAX-CPU (x64; one jit program) within 1e-5 of
  max|ref| (float32 sums in another order).
- ``richardson_lucy_step``: a flat estimate is a fixed point, and one
  step equals its numpy definition (``numpy.fft``) within 1e-12.
- ``convolve_separable`` against scipy's ``convolve1d`` per axis
  (float64 within 1e-12, float32 within 2e-6 of max|ref|), with its
  keyword arguments and errors.
- ``cache_source`` writes the profile of a call into its directory.
- The public names of ``models``, ``_misc`` and the package root match
  ``cupyimg_tpu``'s but for the JAX-only ``get_hlo`` (the sharded
  pipeline is held in ``test_torch_parallel.py``).
"""

import os

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu_torch
from cupyimg_tpu_torch import _misc, models
from cupyimg_tpu_torch.core.config import config


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """numpy and list inputs go to the CPU here (the library's default
    device is CUDA)."""
    monkeypatch.setattr(config, "device", "cpu")


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _vol(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _edge_reference(x, sigma=1.5, amount=0.7):
    sm = sndi.gaussian_filter(x.astype(np.float64), sigma)
    grad = np.zeros_like(sm)
    for ax in range(x.ndim):
        d = sndi.sobel(sm, axis=ax)
        grad += d * d
    return (1 + amount) * x - amount * sm + 0.1 * np.sqrt(grad)


@pytest.mark.parametrize("shape, sigma, amount", [
    ((24, 25), 1.5, 0.7), ((9, 10, 11), 1.0, 0.5), ((30, 31), 3.0, 1.2)])
def test_edge_enhance_matches_scipy_composition(shape, sigma, amount):
    x = _vol(shape, len(shape))
    got = models.edge_enhance_pipeline(torch.from_numpy(x), sigma=sigma,
                                       amount=amount)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(H(got), _edge_reference(x, sigma, amount),
                               rtol=2e-4, atol=2e-4)
    # a float64 volume stays float64
    x64 = x.astype(np.float64)
    got = models.edge_enhance_pipeline(x64, sigma, amount)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(H(got), _edge_reference(x64, sigma, amount),
                               rtol=0, atol=1e-12)


def test_edge_enhance_matches_cupyimg_tpu():
    x = _vol((40, 41), 2)
    want = np.asarray(jax.jit(_jax_models().edge_enhance_pipeline)(
        jnp.asarray(x)))
    got = H(models.edge_enhance_pipeline(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _jax_models():
    import cupyimg_tpu.models as jmodels

    return jmodels


def test_richardson_lucy_step():
    est = torch.full((16, 16), 2.0, dtype=torch.float64)
    psf = np.zeros((16, 16))
    psf[:3, :3] = 1.0 / 9.0
    psf = np.roll(psf, (-1, -1), (0, 1))
    pf = np.fft.rfftn(psf)
    out = models.richardson_lucy_step(est, est, pf, np.conj(pf))
    np.testing.assert_allclose(H(out), 2.0, rtol=1e-6)
    # one step on random data against numpy.fft
    rng = np.random.default_rng(3)
    image, estimate = rng.random((12, 15)), rng.random((12, 15)) + 0.5
    pf = np.fft.rfftn(rng.random((12, 15)))
    s, axes = estimate.shape, (0, 1)
    conv = np.fft.irfftn(np.fft.rfftn(estimate) * pf, s=s, axes=axes)
    want = estimate * np.fft.irfftn(
        np.fft.rfftn(image / (conv + 1e-12)) * np.conj(pf), s=s, axes=axes)
    got = models.richardson_lucy_step(image, torch.from_numpy(estimate), pf,
                                      np.conj(pf))
    np.testing.assert_allclose(H(got), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_convolve_separable_matches_scipy(dtype):
    rng = np.random.default_rng(4)
    x = rng.random((14, 15, 16)).astype(dtype)
    w = np.array([1.0, -2.0, 4.0, 0.5])
    tol = 1e-12 if dtype == np.float64 else 2e-6

    def ref(filters, axes, **kw):
        y = x.astype(np.float64)
        for ax, f in zip(axes, filters):
            y = sndi.convolve1d(y, f, axis=ax, **kw)
        return y

    def close(got, want):
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(H(got), want, rtol=0,
                                   atol=tol * np.abs(want).max())

    t = torch.from_numpy(x)
    close(cupyimg_tpu_torch.convolve_separable(t, w), ref([w] * 3, (0, 1, 2)))
    fs = [np.array([1.0, 2.0, 1.0]), np.array([0.25, 0.5, 0.25, 1.0])]
    close(cupyimg_tpu_torch.convolve_separable(t, fs, axes=(2, 0)),
          ref(fs, (2, 0)))
    close(cupyimg_tpu_torch.convolve_separable(t, w, axes=[1],
                                               mode="constant", cval=2.0),
          ref([w], (1,), mode="constant", cval=2.0))
    with pytest.raises(ValueError):
        cupyimg_tpu_torch.convolve_separable(t, [w, w])
    with pytest.raises(ValueError):
        cupyimg_tpu_torch.convolve_separable(t, np.ones((3, 3)))


def test_cache_source_writes_a_profile(tmp_path):
    x = torch.from_numpy(_vol((10, 11), 5))
    with _misc.cache_source(str(tmp_path)) as dump:
        path = dump("convolve", cupyimg_tpu_torch.convolve_separable, x,
                    np.array([1.0, 2.0, 1.0]))
    assert path == os.path.join(str(tmp_path), "convolve")
    text = open(path + ".profile.txt").read()
    assert "aten::" in text
    assert issubclass(_misc.PerformanceWarning, UserWarning)


def test_public_names_match_cupyimg_tpu():
    import cupyimg_tpu
    import cupyimg_tpu._misc as jmisc

    assert cupyimg_tpu_torch.__version__ == cupyimg_tpu.__version__
    assert cupyimg_tpu_torch.convolve_separable is _misc.convolve_separable
    assert set(_misc.__all__) == set(jmisc.__all__) - {"get_hlo"}
    jm = _jax_models()
    names = {n for n in dir(jm) if not n.startswith("_")}
    assert {n for n in dir(models) if not n.startswith("_")} == names
