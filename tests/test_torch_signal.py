"""The signal slice of the torch port (``scipy.signal``'s FFT-domain
convolution, ``hilbert``, ``resample`` and ``scipy.ndimage``'s Fourier
filters) against scipy, on CPU tensors: grids of function x mode x method
x dtype x rank, milliseconds a case, with the error classes; then a short
named list against ``cupyimg_tpu`` (JAX-CPU, x64), each test's JAX calls
as one jit program.

Tolerances: 5e-4 * max|ref| for float32 (the JAX suite's convolution
tolerance), 1e-10 * max|ref| for float64 and complex128, exact for
integer and bool results.  A bool product by FFT rounds before the cast
(as ``cupyimg_tpu`` does), where scipy casts the float result directly,
so FFT noise of 1e-16 turns True there; and scipy's direct method takes
bool only in 1-D.  Bool results are held against the nonzero entries of
scipy's direct integer result.
"""

import functools

import numpy as np
import pytest
import scipy.fft
import scipy.ndimage as sndi
import scipy.signal as ss
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.scipy.ndimage as jndi
import cupyimg_tpu.scipy.signal as jsig
import cupyimg_tpu_torch.scipy.ndimage as ndi
import cupyimg_tpu_torch.scipy.signal as sig
from cupyimg_tpu_torch.core import dtypes

SHAPES = {1: ((61,), (9,)), 2: ((23, 30), (4, 5)), 3: ((20, 9, 7), (3, 2, 4))}
DTYPES = ["float32", "float64", "complex128", "int64", "bool"]
MODES = ["full", "same", "valid"]


def _operands(ndim, dtype, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for shape in SHAPES[ndim]:
        if dtype == "bool":
            v = rng.random(shape) > 0.5
        elif dtype == "int64":
            v = rng.integers(-5, 6, shape)
        elif dtype == "complex128":
            v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape).astype(dtype)
        out.append(v)
    return out


def _check(got, ref, exact_dtype=True):
    got_np = got.numpy()
    assert got_np.shape == ref.shape
    if exact_dtype:
        assert got_np.dtype == ref.dtype, (got_np.dtype, ref.dtype)
    kind = np.dtype(ref.dtype).kind
    if kind in "iub" and got_np.dtype.kind in "iub":
        np.testing.assert_array_equal(got_np, ref)
        return
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    single = ref.dtype in (np.float32, np.complex64)
    np.testing.assert_allclose(got_np, ref,
                               atol=(5e-4 if single else 1e-10) * scale)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# against scipy: the convolution family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fn", ["fftconvolve", "oaconvolve"])
def test_fft_family_matches_scipy(fn, mode, dtype, ndim):
    a, b = _operands(ndim, dtype)
    ref = getattr(ss, fn)(a, b, mode=mode)
    _check(getattr(sig, fn)(*_t(a, b), mode=mode), ref)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", ["auto", "direct", "fft"])
@pytest.mark.parametrize("fn", ["convolve", "correlate"])
def test_convolve_correlate_match_scipy(fn, method, mode, dtype, ndim):
    a, b = _operands(ndim, dtype, seed=1)
    for x, y in ((a, b), (b, a)):  # swapped: valid mode swaps back
        if dtype == "bool":  # scipy's direct bool: nonzero of the sum
            ref = getattr(ss, fn)(x.astype(np.int64), y.astype(np.int64),
                                  mode=mode, method="direct") != 0
        else:
            ref = getattr(ss, fn)(x, y, mode=mode, method=method)
        _check(getattr(sig, fn)(*_t(x, y), mode=mode, method=method), ref)


@pytest.mark.parametrize("axes", [0, 1, [0, 2], [-1], None])
@pytest.mark.parametrize("fn", ["fftconvolve", "oaconvolve"])
def test_axes_match_scipy(fn, axes):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((30, 6, 11))
    conv = {0, 1, 2} if axes is None else {d % 3 for d in np.atleast_1d(axes)}
    # a free axis keeps a's length, or 1 (broadcast) on axis 1
    b = rng.standard_normal([(3, 4, 2)[d] if d in conv else
                             (1 if d == 1 else a.shape[d]) for d in range(3)])
    for mode in MODES:
        ref = getattr(ss, fn)(a, b, mode=mode, axes=axes)
        _check(getattr(sig, fn)(*_t(a, b), mode=mode, axes=axes), ref)


@pytest.mark.parametrize("fn", ["fftconvolve", "oaconvolve", "convolve",
                                "correlate"])
def test_scalars_and_equal_shapes(fn):
    got = getattr(sig, fn)(torch.tensor(2.0), torch.tensor(3.0))
    assert float(got) == 6.0
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((2, 17, 13))
    _check(getattr(sig, fn)(*_t(a, b)), getattr(ss, fn)(a, b))


@pytest.mark.parametrize("fn", ["fftconvolve", "oaconvolve"])
@pytest.mark.parametrize("dtypes_", [("float32", "float32"),
                                     ("float32", "float64"),
                                     ("int32", "float32"), ("bool", "bool")])
def test_zero_size_fft_family(fn, dtypes_):
    """An empty operand gives an empty 1-D result of the promoted dtype
    (as cupyimg_tpu; scipy's is float64 whatever the inputs)."""
    a = np.zeros((0, 5), dtypes_[0])
    b = np.ones((2, 2), dtypes_[1])
    ref = getattr(ss, fn)(a, b)
    got = getattr(sig, fn)(*_t(a, b))
    assert tuple(got.shape) == ref.shape == (0,)
    assert dtypes.to_numpy(got.dtype) == np.promote_types(*dtypes_)
    got = getattr(sig, fn)(*_t(b, a))
    assert tuple(got.shape) == (0,)


@pytest.mark.parametrize("call", [
    lambda s, a: s.fftconvolve(a, a[0]),                  # ranks differ
    lambda s, a: s.oaconvolve(a, a[0]),
    lambda s, a: s.convolve(a, a[0]),
    lambda s, a: s.correlate(a, a[0]),
    lambda s, a: s.fftconvolve(a, a, axes=[]),
    lambda s, a: s.fftconvolve(a[:5, :3], a[:3, :5], axes=0),
    lambda s, a: s.convolve(a[:5, :3], a[:3, :5], mode="valid"),
    lambda s, a: s.correlate(a[:5, :3], a[:3, :5], mode="valid"),
    lambda s, a: s.fftconvolve(a, a[:3, :3], mode="nope"),
    lambda s, a: s.convolve(a, a[:3, :3], method="nope"),
    lambda s, a: s.correlate(a, a[:3, :3], method="nope"),
    lambda s, a: s.hilbert(a + 1j),
    lambda s, a: s.hilbert(a, N=0),
    lambda s, a: s.hilbert2(a + 1j),
    lambda s, a: s.hilbert2(a, axes=(0, 0)),
    lambda s, a: s.hilbert2(a, N=(3, 0)),
    lambda s, a: s.resample(a, 5, domain="space"),
    lambda s, a: s.resample(a, 5, window=np.ones(3)),
])
def test_errors_match_scipy(call):
    a = np.random.default_rng(6).standard_normal((8, 9))
    with pytest.raises(ValueError):
        call(ss, a)
    with pytest.raises(ValueError):
        call(sig, torch.from_numpy(a) if not np.iscomplexobj(a) else a)


@pytest.mark.parametrize("shapes,dtype", [
    (((1000,), (100,)), "float64"), (((1000,), (10,)), "float64"),
    (((300, 300), (31, 31)), "float32"), (((300, 300), (3, 3)), "float32"),
    (((64, 64, 64), (5, 5, 5)), "float64"), (((50, 50), (50, 50)), "float64"),
    (((4096,), (257,)), "float32"), (((1000,), (100,)), "bool"),
])
@pytest.mark.parametrize("mode", MODES)
def test_choose_conv_method_matches_cupyimg_tpu(shapes, dtype, mode):
    """The operation-count rule of cupyimg_tpu off the TPU (an older
    scipy's; scipy 1.17 weighs the counts by mode and rank, and picks
    otherwise in some of these cases: ROADMAP C)."""
    a = np.ones(shapes[0], dtype)
    b = np.ones(shapes[1], dtype)
    assert sig.choose_conv_method(*_t(a, b), mode=mode) == (
        jsig.choose_conv_method(a, b, mode=mode))


def test_choose_conv_method_integer_overflow_and_measure():
    a = np.full(1000, 2 ** 40, np.int64)
    b = np.full(100, 2 ** 10, np.int64)
    assert sig.choose_conv_method(*_t(a, b)) == "direct" == (
        ss.choose_conv_method(a, b))
    method, times = sig.choose_conv_method(*_t(np.ones(500), np.ones(50)),
                                           measure=True)
    assert method in ("fft", "direct") and set(times) == {"fft", "direct"}


def test_next_fast_len_matches_scipy():
    for n in list(range(1, 1100)) + [4126, 4194560, 2 ** 20 + 1, 99991]:
        assert sig.next_fast_len(n) == scipy.fft.next_fast_len(n, real=True)


# ---------------------------------------------------------------------------
# against scipy: hilbert, hilbert2, resample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
@pytest.mark.parametrize("n,N,axis", [(64, None, -1), (63, None, 0),
                                      (64, 50, 0), (63, 80, -1)])
def test_hilbert_matches_scipy(n, N, axis, dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((n, 5)) * 4).astype(dtype)
    _check(sig.hilbert(*_t(x), N=N, axis=axis), ss.hilbert(x, N=N, axis=axis))
    if axis == -1:
        xt = np.ascontiguousarray(x[:, 0])
        _check(sig.hilbert(*_t(xt), N=N), ss.hilbert(xt, N=N))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N,axes", [(None, (-2, -1)), (16, (0, 1)),
                                    ((9, 12), (1, 0)), (None, (0, 2))])
def test_hilbert2_matches_scipy(N, axes, dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((11, 10, 3) if axes == (0, 2) else (11, 10))
    x = x.astype(dtype)
    _check(sig.hilbert2(*_t(x), N=N, axes=axes),
           ss.hilbert2(x, N=N, axes=axes))


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
@pytest.mark.parametrize("n,num", [(60, 40), (60, 90), (61, 40), (61, 90),
                                   (60, 60), (64, 31)])
@pytest.mark.parametrize("window", [None, "hann", "array", "callable"])
def test_resample_matches_scipy(n, num, window, dtype):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, 3))
    if dtype == "complex128":
        x = x + 1j * rng.standard_normal((n, 3))
    x = x.astype(dtype)
    w = {"array": rng.random(n),
         "callable": lambda f: np.exp(-np.abs(f))}.get(window, window)
    ref = ss.resample(x, num, axis=0, window=w)
    _check(sig.resample(*_t(x), num, axis=0, window=w), ref)
    ref = ss.resample(x.T, num, axis=1)
    _check(sig.resample(*_t(x.T), num, axis=1), ref)


def test_resample_time_positions_and_freq_domain():
    rng = np.random.default_rng(10)
    x = rng.standard_normal(50)
    t = np.linspace(0.0, 2.0, 50)
    ref_y, ref_t = ss.resample(x, 70, t=t)
    got_y, got_t = sig.resample(*_t(x), 70, t=torch.from_numpy(t))
    _check(got_y, ref_y)
    _check(got_t, ref_t)
    X = np.fft.fft(x)
    _check(sig.resample(*_t(X), 35, domain="freq"),
           ss.resample(X, 35, domain="freq"))


# ---------------------------------------------------------------------------
# against scipy: scipy.ndimage's Fourier filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128", "int32"])
@pytest.mark.parametrize("shape,n,axis", [((40,), -1, -1), ((24, 13), 24, 1),
                                          ((24, 13), -1, 0),
                                          ((8, 10, 6), 10, -1)])
@pytest.mark.parametrize("fn,arg", [("fourier_gaussian", 2.5),
                                    ("fourier_uniform", 3.0),
                                    ("fourier_shift", 1.7),
                                    ("fourier_ellipsoid", 4.0)])
def test_fourier_filters_match_scipy(fn, arg, shape, n, axis, dtype):
    rng = np.random.default_rng(12)
    x = rng.standard_normal(shape) * 5
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal(shape)
    x = x.astype(dtype)
    ref = getattr(sndi, fn)(x, arg, n=n, axis=axis)
    got = getattr(ndi, fn)(*_t(x), arg, n=n, axis=axis)
    _check(got, ref)


def test_bessel_j1_matches_scipy():
    """The jinc's J1 to double precision, across both Cephes branches
    (torch.special.bessel_j1 is off by up to 5e-7 for 5 < x < 10)."""
    import scipy.special

    from cupyimg_tpu_torch.scipy.ndimage.fourier import _bessel_j1

    x = np.concatenate([np.linspace(0.0, 60.0, 6001), [4.999999, 5.000001,
                                                       1e3, 1e5]])
    got = _bessel_j1(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, scipy.special.j1(x), rtol=0, atol=1e-12)


def test_fourier_output_dtype_and_errors():
    x = torch.ones(4, 5, dtype=torch.float32)
    assert ndi.fourier_gaussian(x, 1, output=np.float64).dtype == (
        torch.float64)
    assert ndi.fourier_shift(x, 1, output=torch.complex64).dtype == (
        torch.complex64)
    with pytest.raises(NotImplementedError):
        ndi.fourier_uniform(x, 2, output=torch.empty(4, 5))
    with pytest.raises(NotImplementedError):
        ndi.fourier_ellipsoid(torch.ones(2, 2, 2, 2), 2)
    assert ndi.fourier_ellipsoid(torch.ones(0, 4), 2).shape == (0, 4)
    with pytest.raises(RuntimeError):
        ndi.fourier_gaussian(x, [1, 2, 3])


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64): a short named list, one jit program
# per test
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(13)
_A = _RNG.standard_normal((40, 37))
_K = _RNG.standard_normal((6, 5))
_X1 = _RNG.standard_normal(300)
_H1 = _RNG.standard_normal(21)
_S = np.fft.rfft2(_RNG.standard_normal((32, 30)))


def _signal_calls(m, a, k, x1, h1, s):
    return (
        m[0].fftconvolve(a, k, mode="same"),
        m[0].oaconvolve(x1, h1, mode="full"),
        m[0].oaconvolve(a, k, mode="valid"),
        m[0].convolve(a, k, mode="full", method="direct"),
        m[0].correlate(x1, h1, mode="same", method="fft"),
        m[0].hilbert(x1),
        m[0].resample(x1, 210),
        m[1].fourier_gaussian(s, 2.0, n=30),
        m[1].fourier_ellipsoid(s, 5.0, n=30),
        m[1].fourier_shift(s, (1.5, -2.0), n=30),
    )


def test_named_calls_match_cupyimg_tpu():
    args = (_A, _K, _X1, _H1, _S)
    want = jax.jit(functools.partial(_signal_calls, (jsig, jndi)))(
        *[jnp.asarray(v) for v in args])
    got = _signal_calls((sig, ndi), *_t(*args))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-10 * scale)
