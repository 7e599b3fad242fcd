"""The direct and polyphase half of the torch port's ``scipy.signal``
(``upfirdn``, ``resample_poly``, ``convolve2d``/``correlate2d``,
``wiener``) and ``correlate1d``/``convolve1d``'s ``crop=False``, on CPU
tensors: grids against scipy (milliseconds a case), the error classes,
then a short named list against ``cupyimg_tpu`` (JAX-CPU, x64) in one jit
program.

Tolerances: 1e-10 of max|ref| for float64 and complex128, 1e-5 for
float32 (5e-4, the JAX suite's convolution tolerance, for the 2-D
convolutions), exact for integer results.  scipy 1.17 rejects bool in
``convolve2d``; the port computes it as ``cupyimg_tpu`` does (a named
case).  Where ``cupyimg_tpu`` and scipy give different dtypes the port
gives the narrower one (ROADMAP C): ``wiener`` of float32 data is
float32 (scipy: float64), and ``resample_poly`` of float32 data is
float32 (``cupyimg_tpu``: float64).
"""

import functools

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.scipy.ndimage as jndi
import cupyimg_tpu.scipy.signal as jsig
import cupyimg_tpu_torch.scipy.ndimage as ndi
import cupyimg_tpu_torch.scipy.signal as sig
from cupyimg_tpu_torch.scipy.signal import upfirdn_out_len
from cupyimg_tpu_torch.scipy.signal._upfirdn import upfirdn_modes

UP_DOWN = [(1, 1), (2, 3), (3, 2), (1, 4), (5, 1), (4, 6)]


def _close(got, ref, single=False, exact_dtype=True):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if exact_dtype:
        assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref)
        return
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=(1e-5 if single else 1e-10) * scale)


# ---------------------------------------------------------------------------
# upfirdn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("up_down", UP_DOWN)
@pytest.mark.parametrize("mode", upfirdn_modes)
def test_upfirdn_modes_match_scipy(mode, up_down):
    up, down = up_down
    rng = np.random.default_rng(1)
    cval = 0.5 if mode == "constant" else 0
    for n, taps in ((2, 3), (5, 26), (16, 8), (37, 1)):
        x = rng.standard_normal((3, n))
        h = rng.standard_normal(taps)
        got = sig.upfirdn(torch.from_numpy(h), torch.from_numpy(x), up, down,
                          mode=mode, cval=cval)
        _close(got, ss.upfirdn(h, x, up, down, mode=mode, cval=cval))


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_upfirdn_axes_match_scipy(axis):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 5, 6))
    h = rng.standard_normal(7)
    for up, down in UP_DOWN:
        got = sig.upfirdn(torch.from_numpy(h), torch.from_numpy(x), up, down,
                          axis=axis)
        _close(got, ss.upfirdn(h, x, up, down, axis=axis))


@pytest.mark.parametrize("xdt", ["float32", "float64", "complex64",
                                 "complex128", "float16", "uint8", "int32"])
@pytest.mark.parametrize("hdt", ["float32", "float64", "complex128"])
def test_upfirdn_dtypes_match_scipy(xdt, hdt):
    x = np.arange(40).reshape(4, 10).astype(xdt)
    h = (np.arange(5) - 1.5).astype(hdt)
    for up, down in ((1, 2), (2, 1), (3, 2)):
        got = sig.upfirdn(torch.from_numpy(h), torch.from_numpy(x), up, down)
        ref = ss.upfirdn(h, x, up, down)
        single = got.dtype in (torch.float32, torch.complex64)
        _close(got, ref, single=single)


def test_upfirdn_out_len_and_options():
    for n, taps, up, down in ((1000, 101, 2, 3), (7, 3, 1, 4), (1, 5, 3, 1)):
        assert upfirdn_out_len(taps, n, up, down) == len(ss.upfirdn(
            np.ones(taps), np.zeros(n), up, down))
    x = torch.arange(20.0, dtype=torch.float64)
    h = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    full = sig.upfirdn(h, x, 3, 2)
    assert torch.equal(sig.upfirdn(h, x, 3, 2, mode="zero"), full)
    assert torch.equal(sig.upfirdn(h, x, 3, 2, mode="periodic"),
                       sig.upfirdn(h, x, 3, 2, mode="wrap"))
    assert torch.equal(sig.upfirdn(h, x, 3, 2, offset=4), full[4:])
    assert torch.equal(sig.upfirdn(h, x, 3, 2, crop=True), full[:30])
    assert torch.equal(sig.upfirdn(h, x, 3, 2, offset=1, crop=True,
                                   take=7), full[1:8])


def test_upfirdn_errors():
    x, h = torch.zeros(8), torch.ones(3)
    with pytest.raises(NotImplementedError):
        sig.upfirdn(h, x, prepadded=True)
    with pytest.raises(NotImplementedError):
        sig.upfirdn(h, x, out=torch.zeros(10))
    with pytest.raises(ValueError):
        sig.upfirdn(torch.ones((2, 2)), x)
    with pytest.raises(ValueError):
        sig.upfirdn(torch.ones(0), x)
    with pytest.raises(ValueError):
        sig.upfirdn(h, x, up=0)
    with pytest.raises(ValueError):
        sig.upfirdn(h, x, mode="bogus")
    with pytest.raises(ValueError):
        sig.upfirdn(h, torch.zeros(1), mode="line")


def test_upfirdn_one_sample_line_smooth_raise_as_cupyimg_tpu():
    """ROADMAP C: modes 'line' and 'smooth' on a one-sample signal raise
    ValueError in the port and in ``cupyimg_tpu`` (scipy 1.17 returns
    ``[3.]`` for the call below; scipy is not called in mode 'reflect' on
    one sample, where it dies of SIGFPE)."""
    for mode in ("line", "smooth"):
        with pytest.raises(ValueError, match="at least 2 samples"):
            sig.upfirdn(torch.ones(2, dtype=torch.float64),
                        torch.tensor([3.0], dtype=torch.float64), 2, 3,
                        mode=mode)
        with pytest.raises(ValueError, match="at least 2 samples"):
            jsig.upfirdn(np.ones(2), np.array([3.0]), 2, 3, mode=mode)


# ---------------------------------------------------------------------------
# resample_poly
# ---------------------------------------------------------------------------


PADTYPES = ["constant", "mean", "median", "minimum", "maximum"] + [
    m for m in upfirdn_modes if m != "constant"]


@pytest.mark.parametrize("padtype", PADTYPES)
def test_resample_poly_padtypes_match_scipy(padtype):
    rng = np.random.default_rng(3)
    kw = dict(padtype=padtype)
    if padtype == "constant":
        kw["cval"] = 0.5
    for up, down in ((2, 3), (3, 1), (1, 4), (7, 3)):
        for axis, shape in ((0, (40, 3)), (-1, (2, 33))):
            for dt in ("float64", "float32", "int32"):
                x = (rng.standard_normal(shape) * 4).astype(dt)
                got = sig.resample_poly(torch.from_numpy(x), up, down,
                                        axis=axis, **kw)
                ref = ss.resample_poly(x, up, down, axis=axis, **kw)
                _close(got, ref, single=dt == "float32")


def test_resample_poly_windows_and_identity():
    x = np.random.default_rng(4).standard_normal(50)
    xt = torch.from_numpy(x)
    for w in ("hamming", ("kaiser", 2.0), np.hanning(21), list(np.hanning(11)),
              np.arange(9)):
        _close(sig.resample_poly(xt, 3, 2, window=w),
               ss.resample_poly(x, 3, 2, window=w))
    _close(sig.resample_poly(xt, 4, 4), x)
    with pytest.raises(ValueError):
        sig.resample_poly(xt, 0, 2)
    with pytest.raises(ValueError):
        sig.resample_poly(xt, 2, 3, padtype="mean", cval=1.0)
    with pytest.raises(ValueError):
        sig.resample_poly(xt, 2, 3, padtype="bogus")
    with pytest.raises(ValueError):
        sig.resample_poly(xt, 2, 3, window=np.ones((3, 3)))


def test_resample_poly_float32_stays_float32():
    """ROADMAP C: the narrower dtype.  scipy casts its firwin window to a
    float32 signal's dtype and returns float32; ``cupyimg_tpu`` keeps the
    window in float64, which promotes the result."""
    x = np.random.default_rng(5).standard_normal(64).astype(np.float32)
    got = sig.resample_poly(torch.from_numpy(x), 2, 3)
    ref = ss.resample_poly(x, 2, 3)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    spec = jax.ShapeDtypeStruct(x.shape, x.dtype)
    assert jax.eval_shape(lambda v: jsig.resample_poly(v, 2, 3),
                          spec).dtype == np.float64
    _close(got, ref, single=True)


# ---------------------------------------------------------------------------
# convolve2d / correlate2d / wiener
# ---------------------------------------------------------------------------


SHAPES_2D = [((13, 11), (4, 3)), ((5, 6), (7, 9)), ((12, 12), (5, 5)),
             ((3, 20), (2, 4))]


def _operand(shape, dtype, rng):
    if dtype in ("int64", "uint8"):
        return rng.integers(0, 6, shape).astype(dtype)
    if dtype == "complex128":
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128",
                                   "int64", "uint8"])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm", "circular",
                                      "symmetric"])
@pytest.mark.parametrize("fn", ["convolve2d", "correlate2d"])
def test_conv2d_match_scipy(fn, boundary, mode, dtype):
    rng = np.random.default_rng(6)
    fill = 0.7 if dtype in ("float32", "float64", "complex128") else 2
    for s1, s2 in SHAPES_2D:
        if mode == "valid" and not (
                all(a >= b for a, b in zip(s1, s2))
                or all(b >= a for a, b in zip(s1, s2))):
            continue
        a, b = _operand(s1, dtype, rng), _operand(s2, dtype, rng)
        kw = dict(mode=mode, boundary=boundary, fillvalue=fill)
        got = getattr(sig, fn)(torch.from_numpy(a), torch.from_numpy(b),
                               **kw)
        ref = getattr(ss, fn)(a, b, **kw)
        if dtype == "float32":
            scale = max(float(np.abs(ref).max()), 1e-30)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, atol=5e-4 * scale)
        else:
            _close(got, ref)


_ONES44, _ONES22 = np.ones((4, 4)), np.ones((2, 2))


@pytest.mark.parametrize("name, a, b, kw", [
    ("convolve2d", np.ones(4), np.ones(2), {}),
    ("convolve2d", _ONES44, _ONES22, dict(boundary="bogus")),
    ("correlate2d", _ONES44, _ONES22, dict(mode="bogus")),
    ("convolve2d", _ONES44, _ONES22, dict(fillvalue=[1, 2])),
    ("convolve2d", _ONES44, _ONES22, dict(fillvalue=1j)),
    ("correlate2d", np.ones((4, 2)), np.ones((2, 4)), dict(mode="valid")),
])
def test_conv2d_errors_match_scipy(name, a, b, kw):
    with pytest.raises(ValueError):
        getattr(ss, name)(a, b, **kw)
    with pytest.raises(ValueError):
        getattr(sig, name)(torch.from_numpy(a), torch.from_numpy(b), **kw)


def test_conv2d_complex_fill_without_imaginary_part():
    """ROADMAP C: a complex ``fillvalue`` with a zero imaginary part fills
    a real product as its real part, as in ``cupyimg_tpu`` (which raises
    only for a nonzero imaginary part); scipy 1.17 raises."""
    a = np.random.default_rng(10).standard_normal((6, 7))
    b = np.ones((3, 2))
    with pytest.raises(ValueError):
        ss.convolve2d(a, b, fillvalue=2 + 0j)
    got = sig.convolve2d(torch.from_numpy(a), torch.from_numpy(b),
                         fillvalue=2 + 0j)
    _close(got, ss.convolve2d(a, b, fillvalue=2.0))


@pytest.mark.parametrize("dtype", ["float64", "int32", "complex128"])
@pytest.mark.parametrize("mysize", [None, 3, (3, 5), 7])
def test_wiener_matches_scipy(mysize, dtype):
    rng = np.random.default_rng(7)
    x = _operand((20, 17), "float64", rng) * 3
    if dtype == "int32":
        x = x.astype(np.int32)
    elif dtype == "complex128":
        x = x + 0j
    for noise in (None, 0.3):
        got = sig.wiener(torch.from_numpy(x), mysize, noise)
        _close(got, ss.wiener(x, mysize, noise).astype(
            np.complex128 if dtype == "complex128" else np.float64))


def test_wiener_float32_stays_float32():
    """ROADMAP C: the narrower dtype.  ``cupyimg_tpu`` keeps float32 data
    float32; scipy returns float64."""
    x = np.random.default_rng(8).standard_normal((30, 25)).astype(np.float32)
    got = sig.wiener(torch.from_numpy(x), 5)
    ref = ss.wiener(x, 5)
    assert got.dtype == torch.float32 and ref.dtype == np.float64
    spec = jax.ShapeDtypeStruct(x.shape, x.dtype)
    assert jax.eval_shape(lambda v: jsig.wiener(v, 5), spec).dtype == (
        np.float32)
    _close(got, ref.astype(np.float32), single=True)


# ---------------------------------------------------------------------------
# correlate1d / convolve1d crop=False
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["correlate1d", "convolve1d"])
def test_full_correlate1d_matches_numpy(fn):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 11))
    for w in (np.array([1.0, 2.0, 0.0, -1.0]), rng.standard_normal(5),
              np.array([1.0, 2j, -1.0])):
        for axis in (0, 1):
            got = getattr(ndi, fn)(torch.from_numpy(x), w, axis=axis,
                                   mode="constant", crop=False,
                                   backend="ignored")
            npfn = np.correlate if fn == "correlate1d" else np.convolve
            ref = np.apply_along_axis(lambda v: npfn(v, w, "full"), axis, x)
            if fn == "correlate1d" and np.iscomplexobj(w):
                ref = np.apply_along_axis(lambda v: npfn(v, w, "full"),
                                          axis, x + 0j)
            _close(got, ref, exact_dtype=False)


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64): a short named list, one jit program
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(13)
_A = _RNG.standard_normal((23, 21))
_B = (_RNG.random((9, 10)) > 0.5)
_K = _RNG.standard_normal((4, 5))
_KB = _RNG.random((3, 2)) > 0.5
_X1 = _RNG.standard_normal(300)
_H1 = _RNG.standard_normal(21)
_X2 = _RNG.standard_normal((7, 40))


def _poly_calls(m, a, b, x1, h1, x2, k, kb):
    return (
        m[0].upfirdn(h1, x1, 3, 2, mode="antireflect"),
        m[0].upfirdn(h1, x2, 2, 5, axis=1, mode="smooth", offset=3,
                     crop=True),
        m[0].upfirdn(h1, x2, 1, 3, axis=0, mode="line", take=2),
        m[0].resample_poly(x1, 5, 3, padtype="median"),
        m[0].resample_poly(x2, 2, 3, axis=1, padtype="wrap"),
        m[0].convolve2d(a, k, "same", "symm"),
        m[0].correlate2d(a, k, "full", "wrap"),
        m[0].correlate2d(k, a, "valid"),
        m[0].convolve2d(b, kb, "same"),
        m[0].wiener(a, (3, 5)),
        m[1].correlate1d(a, h1[:6], axis=0, mode="mirror", crop=False),
        m[1].convolve1d(a, h1[:5], axis=1, mode="wrap", crop=False),
    )


def test_named_calls_match_cupyimg_tpu():
    args = (_A, _B, _X1, _H1, _X2)
    want = jax.jit(functools.partial(_poly_calls, (jsig, jndi), k=_K,
                                     kb=_KB))(*[jnp.asarray(v) for v in args])
    got = _poly_calls((sig, ndi), *[torch.from_numpy(v) for v in args],
                      k=torch.from_numpy(_K), kb=torch.from_numpy(_KB))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10 * scale)
