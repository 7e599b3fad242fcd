"""The ``numpy`` gap-fillers of the torch port on CPU tensors, against
numpy: the histogram family (the cases of ``test_numpy_histogram_suite``),
``gradient`` (those of ``test_numpy_gradient_stats_suite``), 1-d
``convolve``/``correlate`` over dtype x mode x sizes, ``quantile`` over
dtype x q x method x axis, ``ravel_multi_index``, ``apply_along_axis``,
``ndim``, and ``dtype_mode="numpy"`` of the ndimage correlations against
scipy; then a short named list against ``cupyimg_tpu`` (JAX-CPU, x64),
its JAX calls as one jit program.

Tolerances: histograms, counts and edges exactly (dtype included), the
weighted and density ones within 1e-6 relative (float16 weights 2e-3);
integer convolutions exactly, float64 and complex128 within 1e-10
relative, float32 within 1e-6 of max|ref|; ``quantile`` exactly (its
indices and weights are numpy's own); ``gradient`` exactly or within
1e-12 relative (float64); ``dtype_mode="numpy"``'s as its test states.
"""

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch
from numpy.testing import assert_array_almost_equal, assert_array_equal

import jax
import jax.numpy as jnp

import cupyimg_tpu.numpy as jnpx
import cupyimg_tpu.scipy.ndimage as jndi
import cupyimg_tpu_torch.numpy as tnp
import cupyimg_tpu_torch.scipy.ndimage as ndi
from cupyimg_tpu_torch.numpy.lib import gradient

_ALL_DTYPES = [np.float16, np.float32, np.float64, np.int8, np.int16,
               np.int32, np.int64, np.uint8, np.uint16, np.uint32]
_FLOAT_DTYPES = [np.float16, np.float32, np.float64]
_INT_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
               np.uint32]


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def shaped_arange(shape, dtype):
    n = int(np.prod(shape))
    return np.arange(1, n + 1).reshape(shape).astype(dtype)


def check_pair(got, ref, exact_dtype=True, **kw):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.numpy()
        if exact_dtype:
            assert g.dtype == r.dtype, (g.dtype, r.dtype)
        if kw:
            np.testing.assert_allclose(g, r, **kw)
        else:
            assert_array_equal(g, r)


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", _ALL_DTYPES)
@pytest.mark.parametrize("case", ["default", "same_value", "int_bins",
                                  "array_bins", "empty", "density"])
def test_histogram_matches_numpy(case, dtype):
    x = shaped_arange((10,), dtype)
    if case == "default":
        check_pair(tnp.histogram(T(x)), np.histogram(x))
    elif case == "same_value":
        x = np.zeros(10, dtype)
        check_pair(tnp.histogram(T(x), 3), np.histogram(x, 3))
    elif case == "int_bins":
        check_pair(tnp.histogram(T(x), 4), np.histogram(x, 4))
    elif case == "array_bins":
        bins = shaped_arange((3,), dtype)
        check_pair(tnp.histogram(T(x), T(bins)), np.histogram(x, bins))
    elif case == "empty":
        x = np.array([], dtype)
        check_pair(tnp.histogram(T(x)), np.histogram(x))
    else:
        y, edges = tnp.histogram(T(x), density=True)
        area = float((y * torch.diff(edges)).sum())
        np.testing.assert_allclose(area, 1)
        check_pair((y, edges), np.histogram(x, density=True), rtol=1e-6)


@pytest.mark.parametrize("case", ["count", "uint64_edges", "float_edges",
                                  "density", "dd"])
def test_histogram_uint64_above_2_63_matches_numpy(case):
    """uint64 values of 2^63 and above bin as numpy's: count bins and
    other edges in float64, uint64 edges exactly."""
    x = np.array([3, 2**63 - 1, 2**63, 2**63 + 2**40, 2**64 - 1, 2**62,
                  2**63 + 7], np.uint64)
    if case == "count":
        check_pair(tnp.histogram(T(x), 5), np.histogram(x, 5))
    elif case == "uint64_edges":
        e = np.array([0, 2**63, 2**63 + 8, 2**64 - 1], np.uint64)
        check_pair(tnp.histogram(T(x), T(e)), np.histogram(x, e))
    elif case == "float_edges":
        e = np.array([0.0, 2.0**63, 1.5 * 2.0**63, 2.0**64])
        check_pair(tnp.histogram(T(x), e), np.histogram(x, e))
    elif case == "density":
        check_pair(tnp.histogram(T(x), 4, density=True),
                   np.histogram(x, 4, density=True), rtol=1e-12)
    else:
        s = np.stack([x, x[::-1]], axis=1)
        h, e = tnp.histogramdd(T(s), (3, 2))
        rh, re = np.histogramdd(s, (3, 2))
        assert_array_equal(h.numpy(), rh)
        check_pair(e, re)


@pytest.mark.parametrize("dtype", _FLOAT_DTYPES)
@pytest.mark.parametrize("case", ["lower", "upper", "density",
                                  "weights_density"])
def test_histogram_range_matches_numpy(case, dtype):
    a = np.arange(10, dtype=dtype) + 0.5
    if case == "lower":
        h, b = tnp.histogram(T(a), range=[0, 9])
        assert int(h.sum()) == 9
        check_pair((h, b), np.histogram(a, range=[0, 9]))
    elif case == "upper":
        h, b = tnp.histogram(T(a), range=[1, 10])
        assert int(h.sum()) == 9
        check_pair((h, b), np.histogram(a, range=[1, 10]))
    elif case == "density":
        h, b = tnp.histogram(T(a), range=[1, 9], density=True)
        np.testing.assert_allclose(float((h * torch.diff(b)).sum()), 1)
        check_pair((h, b), np.histogram(a, range=[1, 9], density=True),
                   rtol=1e-6)
    else:
        w = np.arange(10, dtype=dtype) + 0.5
        h, b = tnp.histogram(T(a), range=[1, 9], weights=T(w), density=True)
        np.testing.assert_allclose(float((h * torch.diff(b)).sum()), 1)
        np.testing.assert_allclose(
            h.numpy(),
            np.histogram(a, range=[1, 9], weights=w, density=True)[0],
            rtol=2e-3 if dtype == np.float16 else 1e-6)


def test_histogram_invalid_arguments_raise_as_numpy():
    with pytest.raises(ValueError):
        tnp.histogram(T(np.arange(10)), range=[1, 9, 15])
    with pytest.raises(TypeError):
        tnp.histogram(T(np.arange(10)), range=10)
    with pytest.raises(ValueError):  # range reversed
        tnp.histogram(T(np.arange(10.0)), range=[5, 1])
    with pytest.raises(ValueError):
        tnp.histogram(T(np.array([0.0, np.inf])))
    with pytest.raises(ValueError):
        tnp.histogram(T(np.arange(10)), bins=0)
    with pytest.raises(TypeError):
        tnp.histogram(T(np.arange(10)), bins=2.5)
    with pytest.raises(NotImplementedError):  # as cupyimg_tpu
        tnp.histogram(T(np.arange(10)), bins="auto")


@pytest.mark.parametrize("dtype", _ALL_DTYPES)
def test_histogram_weights_and_bins_checks(dtype):
    a = np.arange(10, dtype=dtype) + 0.5
    with pytest.raises(ValueError):
        tnp.histogram(T(a), range=[1, 9],
                      weights=T(np.arange(11, dtype=dtype) + 0.5))
    with pytest.raises(ValueError):
        tnp.histogram(T(shaped_arange((10,), dtype)),
                      T(np.array([1, 3, 2], dtype)))
    a = np.arange(10, dtype=dtype)
    h, _ = tnp.histogram(T(a), weights=T(np.ones(10, int)))
    assert h.dtype == torch.int64
    assert_array_equal(h.numpy(), np.histogram(a, weights=np.ones(10, int))[0])
    h, _ = tnp.histogram(T(a), weights=T(np.ones(10, float)))
    assert h.dtype == torch.float64
    assert_array_equal(h.numpy(), np.histogram(a, weights=np.ones(10))[0])


def test_histogram_weights_basic():
    rng = np.random.RandomState(5)
    v = rng.rand(100)
    w = np.ones(100) * 5
    a, _ = tnp.histogram(T(v))
    na, _ = tnp.histogram(T(v), density=True)
    wa, _ = tnp.histogram(T(v), weights=T(w))
    nwa, _ = tnp.histogram(T(v), weights=T(w), density=True)
    assert_array_almost_equal(a.numpy() * 5, wa.numpy())
    assert_array_almost_equal(na.numpy(), nwa.numpy())


@pytest.mark.parametrize("dtype", _FLOAT_DTYPES)
def test_histogram_float_weights(dtype):
    v = np.linspace(0, 10, 10, dtype=dtype)
    w = np.concatenate((np.zeros(5, dtype=dtype), np.ones(5, dtype=dtype)))
    wa, wb = tnp.histogram(T(v), bins=np.arange(11), weights=T(w))
    assert_array_almost_equal(wa.numpy(), w)
    ref = np.histogram(v, bins=np.arange(11), weights=w)
    assert_array_equal(wb.numpy(), ref[1])
    # float weights sum in at least float32 (cupyimg_tpu's rule)
    assert wa.dtype == torch.float32 if dtype == np.float16 else (
        wa.numpy().dtype == ref[0].dtype)


@pytest.mark.parametrize("dtype", _INT_DTYPES)
def test_histogram_int_weights(dtype):
    v = np.asarray([1, 2, 2, 4], dtype=dtype)
    w = np.asarray([4, 3, 2, 1], dtype=dtype)
    wa, wb = tnp.histogram(T(v), bins=4, weights=T(w))
    assert_array_equal(wa.numpy(), [4, 5, 0, 1])
    assert wa.dtype == torch.int64
    assert_array_equal(wb.numpy(), np.histogram(v, bins=4, weights=w)[1])
    wa, wb = tnp.histogram(T(v), bins=4, weights=T(w), density=True)
    assert_array_almost_equal(wa.numpy(),
                              np.asarray([4, 5, 0, 1]) / 10.0 / 3.0 * 4)
    a, _ = tnp.histogram(
        T(np.arange(9, dtype=dtype)), T(np.asarray([0, 1, 3, 6, 10], dtype)),
        weights=T(np.asarray([2, 1, 1, 1, 1, 1, 1, 1, 1], dtype=dtype)),
        density=True)
    assert_array_almost_equal(a.numpy(), [0.2, 0.1, 0.1, 0.075])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("bins", [2, np.asarray([0, 2, 3])])
def test_histogram_complex_weights(dtype, bins):
    values = np.asarray([1.3, 2.5, 2.3])
    weights = (np.asarray([1, -1, 2]) + 1j * np.asarray([2, 1, 2])).astype(
        dtype)
    got = tnp.histogram(T(values), bins=bins, weights=T(weights))
    check_pair(got, np.histogram(values, bins=bins, weights=weights),
               rtol=1e-6)


def test_histogram_complex_data_raises():
    with pytest.raises(NotImplementedError):
        tnp.histogram(T(np.ones(3, complex)))


def test_histogramdd_matches_numpy():
    """Counts as numpy's (numpy returns them as float64; the port, as
    ``cupyimg_tpu``, as int64: ROADMAP C)."""
    rng = np.random.RandomState(3)
    x = rng.rand(100, 3)
    h, e = tnp.histogramdd(T(x), bins=4)
    nh, ne = np.histogramdd(x, bins=4)
    assert h.dtype == torch.int64
    assert_array_equal(h.numpy(), nh)
    for a, b in zip(e, ne):
        assert_array_equal(a.numpy(), b)
    x = rng.rand(200, 2)
    w = rng.rand(200)
    h, _ = tnp.histogramdd(T(x), bins=(3, 5), weights=T(w), density=True)
    np.testing.assert_allclose(
        h.numpy(), np.histogramdd(x, bins=(3, 5), weights=w,
                                  density=True)[0], rtol=1e-10)
    x = rng.rand(100, 2) * 4 - 1
    rngs = [(0, 2), (-1, 3)]
    h, _ = tnp.histogramdd(T(x), bins=4, range=rngs)
    assert_array_equal(h.numpy(), np.histogramdd(x, bins=4, range=rngs)[0])
    xs = [rng.rand(50), rng.rand(50)]
    h, _ = tnp.histogramdd([T(v) for v in xs], bins=5)
    assert_array_equal(h.numpy(), np.histogramdd(xs, bins=5)[0])
    with pytest.raises(ValueError):
        tnp.histogramdd(T(rng.rand(10, 2)), bins=[3, 4, 5])
    with pytest.raises(ValueError):
        tnp.histogramdd(T(rng.rand(10, 2)), range=[(0, 1)])
    with pytest.raises(ValueError):
        tnp.histogramdd(T(rng.rand(10, 2)), weights=T(np.ones(9)))


def test_histogram2d_matches_numpy():
    rng = np.random.RandomState(7)
    x, y = rng.rand(100), rng.rand(100)
    w = rng.rand(100)
    for bins in (6, (4, 5), np.linspace(0, 1, 7)):
        h, ex, ey = tnp.histogram2d(T(x), T(y), bins=bins)
        nh, nex, ney = np.histogram2d(x, y, bins=bins)
        assert_array_equal(h.numpy(), nh)
        assert_array_equal(ex.numpy(), nex)
        assert_array_equal(ey.numpy(), ney)
    h = tnp.histogram2d(T(x), T(y), bins=(4, 5), weights=T(w))[0]
    np.testing.assert_allclose(
        h.numpy(), np.histogram2d(x, y, bins=(4, 5), weights=w)[0],
        rtol=1e-10)


# ---------------------------------------------------------------------------
# gradient
# ---------------------------------------------------------------------------


def _g(*args, **kw):
    out = gradient(*args, **kw)
    if isinstance(out, list):
        return [o.numpy() for o in out]
    return out.numpy()


def test_gradient_basic_and_args():
    v = [[1, 1], [3, 4]]
    dx = [np.asarray([[2.0, 3.0], [2.0, 3.0]]),
          np.asarray([[0.0, 0.0], [1.0, 1.0]])]
    for g, d in zip(_g(T(np.asarray(v))), dx):
        assert_array_equal(g, d)
    for g, d in zip(_g(T(np.asarray(v)), axis=(1, 0)), dx[::-1]):
        assert_array_equal(g, d)
    assert_array_equal(_g(T(np.asarray(v)), axis=-1), dx[1])
    for g, d in zip(_g(T(np.asarray(v)), 2, 3, axis=(1, 0)),
                    [dx[1] / 2.0, dx[0] / 3.0]):
        assert_array_equal(g, d)
    f_2d = T(np.arange(25).reshape(5, 5))
    x = torch.cumsum(torch.ones(5, dtype=torch.float64), 0)
    gradient(T(np.arange(5)), 3.0)
    gradient(T(np.arange(5)), torch.tensor(3.0))
    gradient(T(np.arange(5)), x)
    gradient(f_2d, [1.0, 2.0, 5.0, 9.0, 11.0], [1.0, 2.0, 5.0, 9.0, 11.0])
    gradient(f_2d, x, 2)
    gradient(f_2d, x, axis=1)
    with pytest.raises(ValueError, match=".*scalars or 1d"):
        gradient(f_2d, torch.stack([x] * 2, dim=-1), 1)


def test_gradient_bad_arguments_raise_as_numpy():
    f_2d = T(np.arange(25).reshape(5, 5))
    x = torch.cumsum(torch.ones(5, dtype=torch.float64), 0)
    for args in ((x, torch.ones(2)), (1, torch.ones(2)),
                 (torch.ones(2), torch.ones(2))):
        with pytest.raises(ValueError):
            gradient(f_2d, *args)
    for args, kw in (((x,), {}), ((x,), {"axis": (0, 1)}), ((x, x, x), {}),
                     ((1, 1, 1), {}), ((x, x), {"axis": 1}),
                     ((1, 1), {"axis": 1})):
        with pytest.raises(TypeError):
            gradient(f_2d, *args, **kw)
    with pytest.raises(np.exceptions.AxisError):
        gradient(f_2d, axis=3)
    with pytest.raises(np.exceptions.AxisError):
        gradient(f_2d, axis=-3)
    with pytest.raises(ValueError):
        gradient(f_2d, axis=(0, 0))
    with pytest.raises(ValueError):
        gradient(f_2d, edge_order=3)
    gradient(T(np.arange(2)), edge_order=1)
    gradient(T(np.arange(3)), edge_order=2)
    for n, eo in [(0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]:
        with pytest.raises(ValueError):
            gradient(T(np.arange(n)), edge_order=eo)


@pytest.mark.parametrize("edge_order", [1, 2])
@pytest.mark.parametrize("spacing", ["none", "scalar", "even", "uneven",
                                     "mixed"])
def test_gradient_spacing_matches_numpy(spacing, edge_order):
    f = np.array([0, 2.0, 3.0, 4.0, 5.0, 5.0])
    f = np.tile(f, (6, 1)) + f.reshape(-1, 1)
    x_uneven = np.array([0.0, 0.5, 1.0, 3.0, 5.0, 7.0])
    x_even = np.arange(6.0)
    args = {"none": (), "scalar": (1.5,), "even": (x_even, x_even),
            "uneven": (x_uneven, x_uneven), "mixed": (x_even, x_uneven)}[
        spacing]
    targs = [T(a) if isinstance(a, np.ndarray) else a for a in args]
    got = _g(T(f), *targs, edge_order=edge_order)
    ref = np.gradient(f, *args, edge_order=edge_order)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12)
    if len(args) == 2:  # one axis at a time
        for ax in (0, 1):
            g = _g(T(f), targs[ax], axis=ax, edge_order=edge_order)
            r = np.gradient(f, args[ax], axis=ax, edge_order=edge_order)
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12)


def test_gradient_second_order_and_dtypes():
    x = np.linspace(0, 1, 10)
    y = 2 * x ** 3 + 4 * x ** 2 + 2 * x
    analytical = 6 * x ** 2 + 8 * x + 2
    err = np.abs(_g(T(y), x[1] - x[0], edge_order=2) / analytical - 1)
    assert np.all(err < 0.03)
    rng = np.random.RandomState(11)
    f = rng.rand(7, 9)
    spacing = np.sort(rng.rand(9)) * 3 + 0.1
    for eo in (1, 2):
        for g, r in zip(_g(T(f), 2.0, T(spacing), edge_order=eo),
                        np.gradient(f, 2.0, spacing, edge_order=eo)):
            np.testing.assert_allclose(g, r, rtol=1e-12)
    for dt in [np.float16, np.float32, np.float64, np.int32, np.uint8,
               np.bool_]:
        a = np.array([1, 2, 3, 5], dtype=dt)
        g = _g(T(a))
        r = np.gradient(a) if dt != np.bool_ else np.gradient(a.astype(float))
        assert g.dtype == r.dtype
        assert_array_equal(g, r)


# ---------------------------------------------------------------------------
# convolve / correlate and dtype_mode="numpy"
# ---------------------------------------------------------------------------


def _operands(dtype, n, k, seed):
    rng = np.random.default_rng(seed)
    a, v = rng.random(n) * 100, rng.random(k) * 100
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.random(n) * 100
        v = v - 2j * rng.random(k) * 100
    return a.astype(dtype), v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32,
                                   np.float64, np.complex128])
@pytest.mark.parametrize("sizes", [(10, 4), (4, 10), (5, 5), (7, 1)])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("func", ["convolve", "correlate"])
def test_convolve_correlate_match_numpy(func, mode, sizes, dtype):
    """Value and dtype: integers wrap as numpy's (uint8 products of
    operands up to 99 overflow)."""
    a, v = _operands(dtype, *sizes, seed=sizes[0] * 7 + sizes[1])
    got = getattr(tnp, func)(T(a), T(v), mode).numpy()
    ref = getattr(np, func)(a, v, mode)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if np.dtype(dtype).kind in "iu":
        assert_array_equal(got, ref)
    elif dtype == np.float32:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_convolve_mixed_dtypes_and_errors_match_numpy():
    a = np.arange(1, 9, dtype=np.uint8) * 30
    for v in (np.array([3, -2, 1], np.int8), np.array([0.5, 2.0]),
              np.array([1, 2], np.int64)):
        got = tnp.convolve(T(a), T(v)).numpy()
        ref = np.convolve(a, v)
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    with pytest.raises(ValueError):
        tnp.convolve(T(np.ones((2, 2))), T(np.ones(2)))
    with pytest.raises(ValueError):
        tnp.correlate(T(np.ones(0)), T(np.ones(2)))
    with pytest.raises(ValueError):
        tnp.convolve(T(np.ones(4)), T(np.ones(2)), mode="bogus")


# the weights' second dtype for each input dtype: a promotion to a
# wider integer, to float32 from an integer, to float64, to complex128
_MIXED_WEIGHTS = {np.uint8: np.int8, np.int16: np.float32,
                  np.float16: np.float64, np.float32: np.float64,
                  np.complex64: np.complex128}


def _scipy_numpy_mode(name, x, w):
    """scipy's correlation in numpy's dtype rule: integers exactly in
    int64 and wrapped to the promoted type (modular arithmetic), floats
    and complex in double precision."""
    out = np.promote_types(x.dtype, w.dtype)
    wide = (np.int64 if out.kind in "iu" else
            np.complex128 if out.kind == "c" else np.float64)
    ref = getattr(sndi, name)(x.astype(wide), w.astype(wide),
                              mode="constant")
    return ref.astype(out) if out.kind in "iu" else ref


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float16,
                                   np.float32, np.complex64])
def test_dtype_mode_numpy_in_the_ndimage_correlations(dtype):
    """``dtype_mode="numpy"`` against scipy: the output is
    ``np.promote_types(input, weights)``, integers wrap as numpy's
    (exactly), float16 accumulates in float32 (within 0.5 ulp of float16
    plus 1e-6 relative of the double result), float32 and complex64
    within 1e-5 of max|ref|, float64 and complex128 within 1e-12 relative; ``output``
    raises ValueError (``cupyimg_tpu``'s rule)."""
    rng = np.random.default_rng(3)

    def draw(shape, dt):
        v = rng.random(shape) * 20
        if np.dtype(dt).kind == "c":
            v = v - 1j * rng.random(shape) * 20
        return v.astype(dt)

    x = draw((6, 7), dtype)
    for wdt in (dtype, _MIXED_WEIGHTS[dtype]):
        w1, w2 = draw(3, wdt), draw((3, 2), wdt)
        out = np.promote_types(dtype, wdt)
        for name, w in (("correlate1d", w1), ("convolve1d", w1),
                        ("correlate", w2), ("convolve", w2)):
            fn = getattr(ndi, name)
            got = fn(T(x), w, mode="constant", dtype_mode="numpy").numpy()
            assert got.dtype == out, (name, wdt, got.dtype)
            ref = _scipy_numpy_mode(name, x, w)
            if out.kind in "iu":
                assert_array_equal(got, ref)
            elif out == np.float16:
                half_ulp = np.spacing(np.abs(ref).astype(np.float16)) / 2
                assert np.all(np.abs(got.astype(np.float64) - ref)
                              <= half_ulp + 1e-6 * np.abs(ref))
            elif out in (np.float32, np.complex64):
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=1e-5 * np.abs(ref).max())
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-12)
            with pytest.raises(ValueError):
                fn(T(x), w, output=np.float64, dtype_mode="numpy")


# ---------------------------------------------------------------------------
# quantile, ravel_multi_index, apply_along_axis, ndim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64,
                                   np.int32, np.uint8])
@pytest.mark.parametrize("method", ["linear", "lower", "higher",
                                    "midpoint", "nearest"])
def test_quantile_matches_numpy(method, dtype):
    """Exactly, dtype included: numpy's indices, weights and dtypes."""
    x = (np.random.default_rng(5).random((40, 7, 3)) * 50).astype(dtype)
    for q in (0.3, [0.1, 0.5, 0.99], np.array([0.0, 1.0, 0.25]),
              np.float32(0.37), 1, [0, 1]):
        for axis in (None, 0, 1, (0, 2), -1):
            for keepdims in (False, True):
                got = tnp.quantile(T(x), q, axis=axis, method=method,
                                   keepdims=keepdims).numpy()
                ref = np.quantile(x, q, axis=axis, method=method,
                                  keepdims=keepdims)
                assert got.dtype == np.asarray(ref).dtype
                assert got.shape == np.shape(ref)
                assert_array_equal(got, ref)


def test_quantile_nan_and_errors_match_numpy():
    x = np.array([[1.0, np.nan, 3.0], [1.0, 2.0, 3.0]])
    assert_array_equal(tnp.quantile(T(x), 0.5, axis=1).numpy(),
                       np.quantile(x, 0.5, axis=1))
    for q in (-0.1, [0.5, 1.5]):
        with pytest.raises(ValueError):
            tnp.quantile(T(x), q)
    with pytest.raises(ValueError):
        tnp.quantile(T(x), 0.5, method="hazen")  # not in jnp.quantile


def test_ravel_multi_index_apply_along_axis_ndim_match_numpy():
    idx = (np.array([0, 1, 2]), np.array([2, 1, 0]))
    for order in ("C", "F"):
        got = tnp.ravel_multi_index(tuple(T(i) for i in idx), (3, 4),
                                    order=order)
        assert got.dtype == torch.int64
        assert_array_equal(got.numpy(),
                           np.ravel_multi_index(idx, (3, 4), order=order))
    bad = (np.array([0, 3]), np.array([-1, 5]))
    for mode in ("wrap", "clip", ("clip", "wrap")):
        assert_array_equal(
            tnp.ravel_multi_index(tuple(T(i) for i in bad), (3, 4),
                                  mode=mode).numpy(),
            np.ravel_multi_index(bad, (3, 4), mode=mode))
    with pytest.raises(ValueError):
        tnp.ravel_multi_index(tuple(T(i) for i in bad), (3, 4))
    x = np.random.RandomState(4).randn(4, 5, 3)
    for axis in (0, 1, -1):
        got = tnp.apply_along_axis(lambda r: r.sum(), axis, T(x))
        np.testing.assert_allclose(
            got.numpy(), np.apply_along_axis(np.sum, axis, x), rtol=1e-12)
        got = tnp.apply_along_axis(
            lambda r, k: torch.stack([r.min(), r.max() * k]), axis, T(x), 2)
        ref = np.apply_along_axis(
            lambda r, k: np.stack([r.min(), r.max() * k]), axis, x, 2)
        assert_array_equal(got.numpy(), ref)
    assert tnp.ndim([[1, 2]]) == 2 and tnp.ndim(T(x)) == 3
    assert tnp.ndim(3.0) == 0


# ---------------------------------------------------------------------------
# against cupyimg_tpu
# ---------------------------------------------------------------------------


def test_named_calls_match_cupyimg_tpu():
    """A short named list against ``cupyimg_tpu`` on JAX-CPU (x64); the
    traceable calls run as one jit program, the histogram (its range check
    syncs) eagerly; with them ``dtype_mode="numpy"`` of ``correlate``
    (uint8) and ``correlate1d`` (float32).  Exactly, but float32
    convolutions within 1e-6 of max|ref| and the gradient within 1e-12
    relative."""
    rng = np.random.default_rng(9)
    a32 = rng.random(50).astype(np.float32)
    v32 = rng.random(7).astype(np.float32)
    ai = (rng.random(20) * 100).astype(np.int32)
    vi = (rng.random(5) * 100).astype(np.int32)
    f = rng.random((6, 8))
    sp = np.sort(rng.random(8)) * 2 + 0.1
    # dtype_mode="numpy" of the n-d correlations: uint8 wrapping in its
    # own type, and float32 data with float32 weights
    xu = (rng.random((7, 9)) * 60).astype(np.uint8)
    wu = (rng.random((3, 2)) * 9).astype(np.uint8)
    x32 = rng.random((7, 9)).astype(np.float32)
    w32 = rng.random(4).astype(np.float32)

    @jax.jit
    def jax_calls(a32, v32, ai, vi, f, sp, xu, x32):
        return (jnpx.convolve(a32, v32, "same"),
                jnpx.correlate(ai, vi, "full"),
                jnpx.gradient(f, 1.5, sp, edge_order=2),
                jnpx.quantile(f, jnp.asarray([0.2, 0.7]), axis=1),
                jndi.correlate(xu, wu, mode="constant", dtype_mode="numpy"),
                jndi.correlate1d(x32, w32, axis=0, mode="mirror",
                                 dtype_mode="numpy"))

    jc, jr, (jg0, jg1), jq, jnu, jn32 = jax_calls(a32, v32, ai, vi, f, sp,
                                                  xu, x32)
    got = ndi.correlate(T(xu), wu, mode="constant",
                        dtype_mode="numpy").numpy()
    assert got.dtype == np.asarray(jnu).dtype == np.uint8
    assert_array_equal(got, jnu)
    got = ndi.correlate1d(T(x32), w32, axis=0, mode="mirror",
                          dtype_mode="numpy").numpy()
    assert got.dtype == np.asarray(jn32).dtype == np.float32
    np.testing.assert_allclose(got, jn32, rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jn32)).max())
    got = tnp.convolve(T(a32), T(v32), "same").numpy()
    assert got.dtype == np.asarray(jc).dtype
    np.testing.assert_allclose(got, jc, rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jc)).max())
    got = tnp.correlate(T(ai), T(vi), "full").numpy()
    assert got.dtype == np.asarray(jr).dtype
    assert_array_equal(got, jr)
    for g, r in zip(tnp.gradient(T(f), 1.5, T(sp), edge_order=2),
                    (jg0, jg1)):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12)
    np.testing.assert_allclose(
        tnp.quantile(T(f), np.asarray([0.2, 0.7]), axis=1).numpy(), jq,
        rtol=1e-12)
    x = rng.random(300)
    w = (rng.random(300) * 5).astype(np.int32)
    jh, je = jnpx.histogram(jnp.asarray(x), bins=12, weights=jnp.asarray(w))
    th, te = tnp.histogram(T(x), bins=12, weights=T(w))
    assert th.numpy().dtype == np.asarray(jh).dtype
    assert_array_equal(th.numpy(), jh)
    assert_array_equal(te.numpy(), je)
