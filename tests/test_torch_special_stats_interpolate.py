"""``scipy.special`` (the convex-analysis functions), ``scipy.stats.entropy``
and ``scipy.interpolate`` (``RegularGridInterpolator``, ``interpn``) of
the torch port on CPU tensors: against scipy over grids of values with
their ``inf``/``nan`` cases and dtypes, the expected values of
``test_numpy_gradient_stats_suite`` (entropy) and ``test_interpolate_suite``;
then a short named list against ``cupyimg_tpu`` (JAX-CPU, x64) as one
jit program.

Tolerances: float64 within 1e-12 relative (NaN and inf in place), float32
within 1e-6; the suite's hard-coded values to its decimals; nearest
interpolation exactly.
"""

import itertools

import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as spst
import torch
from numpy.testing import assert_array_almost_equal, assert_array_equal
from scipy.interpolate import RegularGridInterpolator as SpRGI
from scipy.interpolate import interpn as sp_interpn

import jax
import jax.numpy as jnp

import cupyimg_tpu.scipy.interpolate as jinterp
import cupyimg_tpu.scipy.special as jspecial
import cupyimg_tpu.scipy.stats as jstats
import cupyimg_tpu_torch.scipy.special as special
from cupyimg_tpu_torch.core.config import config
import cupyimg_tpu_torch.scipy.stats as stats
from cupyimg_tpu_torch.scipy.interpolate import RegularGridInterpolator
from cupyimg_tpu_torch.scipy.interpolate import interpn


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


_X = np.array([-np.inf, -2.0, -0.5, 0.0, 1e-30, 0.3, 1.0, 2.5, 1e30,
               np.inf, np.nan])
#: ratios that over- and underflow in float64
_X64 = np.concatenate([_X, [1e-300, 1e300]])


def _agree(got, ref, rtol=1e-12):
    got = got.numpy()
    assert got.dtype == np.asarray(ref).dtype, (got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64,
                                   np.float16])
def test_entr_matches_scipy(dtype):
    with np.errstate(over="ignore"):
        x = np.arange(-3, 5).astype(dtype) if np.dtype(dtype).kind != "f" \
            else np.array(_X64 if dtype == np.float64 else _X, dtype=dtype)
    _agree(special.entr(T(x)), sps.entr(x),
           rtol=1e-6 if dtype != np.float64 else 1e-12)


@pytest.mark.parametrize("name", ["kl_div", "rel_entr", "huber",
                                  "pseudo_huber"])
@pytest.mark.parametrize("dtypes", [(np.float64, np.float64),
                                    (np.float32, np.float32),
                                    (np.float32, np.float64),
                                    (np.int32, np.float64)])
def test_two_argument_functions_match_scipy(name, dtypes):
    x = _X64 if dtypes == (np.float64, np.float64) else _X
    a, b = np.meshgrid(x, x, indexing="ij")
    if np.dtype(dtypes[0]).kind == "i":
        a = np.tile(np.arange(-2, 9)[:, None], (1, x.size))
    a, b = a.astype(dtypes[0]), b.astype(dtypes[1])
    with np.errstate(all="ignore"):
        ref = getattr(sps, name)(a, b)
    fp32 = np.result_type(*dtypes) == np.float32
    _agree(getattr(special, name)(T(a), T(b)), ref,
           rtol=1e-6 if fp32 else 1e-12)


def test_special_broadcasts_and_takes_scalars():
    r = np.linspace(-3, 3, 7)
    _agree(special.huber(1.5, T(r)), sps.huber(1.5, r))
    _agree(special.pseudo_huber(T(np.array([[0.5], [2.0]])), T(r)),
           sps.pseudo_huber(np.array([[0.5], [2.0]]), r))
    _agree(special.kl_div(T(r), 0.5), sps.kl_div(r, 0.5))


# ---------------------------------------------------------------------------
# stats.entropy
# ---------------------------------------------------------------------------


PK = np.array([[0.1, 0.2], [0.6, 0.3], [0.3, 0.5]])
QK = np.array([[0.2, 0.1], [0.3, 0.6], [0.5, 0.3]])


def test_entropy_suite_values():
    pk, qk = T(np.array([0.5, 0.2, 0.3])), T(np.array([0.1, 0.25, 0.65]))
    assert float(stats.entropy(pk, pk)) == 0.0
    assert float(stats.entropy(pk, qk)) >= 0.0
    assert abs(float(stats.entropy(T(np.ones(16)), base=2.0)) - 4.0) < 1e-5
    q2 = np.ones(16)
    q2[:8] = 2.0
    s1 = float(stats.entropy(T(np.ones(16)), T(q2)))
    s2 = float(stats.entropy(T(np.ones(16)), T(q2), base=2.0))
    assert abs(s1 / s2 - np.log(2.0)) < 1e-5
    assert_array_almost_equal(float(stats.entropy(T(np.array([0, 1, 2])))),
                              0.63651416829481278, decimal=12)
    assert_array_almost_equal(stats.entropy(T(PK), T(QK)).numpy(),
                              [0.1933259, 0.18609809])
    q0 = QK.copy()
    q0[0, 0] = 0.0
    assert_array_almost_equal(stats.entropy(T(PK), T(q0)).numpy(),
                              [np.inf, 0.18609809])
    p0 = PK.copy()
    p0[0, 0] = 0.0
    assert_array_almost_equal(stats.entropy(T(p0), T(q0)).numpy(),
                              [0.17403988, 0.18609809])
    assert_array_almost_equal(stats.entropy(T(PK), axis=1).numpy(),
                              [0.63651417, 0.63651417, 0.66156324])
    assert_array_almost_equal(stats.entropy(T(PK), T(QK), axis=1).numpy(),
                              [0.231049, 0.231049, 0.127706])
    assert_array_almost_equal(stats.entropy(T(PK.T)).numpy(),
                              stats.entropy(T(PK), axis=1).numpy())
    with pytest.raises(ValueError):
        stats.entropy(T(PK), T(QK[:2]))


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("base", [None, 2.0, 10])
@pytest.mark.parametrize("with_qk", [False, True])
def test_entropy_matches_scipy(with_qk, base, axis):
    rng = np.random.default_rng(4)
    pk = rng.random((5, 6))
    qk = rng.random((5, 6)) if with_qk else None
    got = stats.entropy(T(pk), None if qk is None else T(qk), base=base,
                        axis=axis)
    _agree(got, spst.entropy(pk, qk, base=base, axis=axis))


# ---------------------------------------------------------------------------
# interpolate
# ---------------------------------------------------------------------------


def _sample_4d(values_axis3=(0.0, 0.5, 1.0), points=None):
    points = points or [(0.0, 0.5, 1.0)] * 4
    v = np.asarray(values_axis3)
    values = (v[:, None, None, None] + v[None, :, None, None] * 10
              + v[None, None, :, None] * 100 + v[None, None, None, :] * 1000)
    return points, values


POINTS_2 = [(0.0, 0.5, 1.0)] * 2 + [(0.0, 5.0, 10.0)] * 2
SAMPLE = np.array([[0.1, 0.1, 1.0, 0.9], [0.2, 0.1, 0.45, 0.8],
                   [0.5, 0.5, 0.5, 0.5]])
OUT = np.array([[-0.1, -0.1, -0.1, -0.1], [1.1, 1.1, 1.1, 1.1],
                [21, 2.1, -1.1, -11], [2.1, 2.1, -1.1, -1.1]])


def test_rgi_suite_values(monkeypatch):
    points, values = _sample_4d()
    interp = RegularGridInterpolator(points, T(values))
    assert_array_almost_equal(interp(T(SAMPLE)).numpy(),
                              [1001.1, 846.2, 555.5])
    assert_array_almost_equal(
        interp(T(np.array([[0.0] * 4, [1.0] * 4]))).numpy(), [0.0, 1111.0])
    near = RegularGridInterpolator(points, T(values), method="nearest")
    for s, want in [([0.1, 0.1, 0.9, 0.9], 1100.0),
                    ([0.1, 0.1, 0.1, 0.1], 0.0),
                    ([0.0, 0.0, 0.0, 0.0], 0.0),
                    ([1.0, 1.0, 1.0, 1.0], 1111.0),
                    ([0.1, 0.4, 0.6, 0.9], 1055.0)]:
        assert_array_almost_equal(near(T(np.array(s))).numpy(), want)
    extrap = RegularGridInterpolator(points, T(values), bounds_error=False,
                                     fill_value=None)
    assert_array_almost_equal(extrap(T(OUT), method="nearest").numpy(),
                              [0.0, 1111.0, 11.0, 11.0])
    assert_array_almost_equal(extrap(T(OUT), method="linear").numpy(),
                              [-111.1, 1222.1, -11068.0, -1186.9])
    p2, v2 = _sample_4d(points=POINTS_2)
    extrap2 = RegularGridInterpolator(p2, T(v2), bounds_error=False,
                                      fill_value=None)
    assert_array_almost_equal(extrap2(T(OUT), method="nearest").numpy(),
                              [0.0, 11.0, 11.0, 11.0])
    assert_array_almost_equal(extrap2(T(OUT), method="linear").numpy(),
                              [-12.1, 133.1, -1069.0, -97.9])
    assert_array_almost_equal(
        RegularGridInterpolator(p2, T(v2))(
            T(np.array([0.1, 0.1, 10.0, 9.0]))).numpy(), 1001.1)
    fill = RegularGridInterpolator(points, T(values), bounds_error=False,
                                   fill_value=np.nan)
    for m in ("nearest", "linear"):
        assert np.isnan(fill(T(OUT[[0, 1, 3]]), method=m).numpy()).all()
    # lists (which go to config.device), complex values
    monkeypatch.setattr(config, "device", "cpu")
    v1 = RegularGridInterpolator(points, values.tolist())(SAMPLE.tolist())
    np.testing.assert_allclose(v1.numpy(), interp(T(SAMPLE)).numpy())
    cv = values - 2j * values
    for m in ("linear", "nearest"):
        z = RegularGridInterpolator(points, T(cv), method=m)(T(SAMPLE))
        re = RegularGridInterpolator(points, T(values), method=m)(T(SAMPLE))
        np.testing.assert_allclose(z.numpy(), (re - 2j * re).numpy())


def test_rgi_errors_match_scipy():
    v = np.add.outer(np.array([0.0, 0.5, 1.0]), np.array([0.0, 5.0, 10.0]))
    for points in ([(0.0, 0.5, 1.0), (0.0, 1.0, 0.5)],
                   [((0.0, 0.5, 1.0),), (0.0, 0.5, 1.0)],
                   [(0.0, 0.5, 0.75, 1.0), (0.0, 0.5, 1.0)],
                   [(0.0, 0.5, 1.0)] * 3):
        with pytest.raises(ValueError):
            RegularGridInterpolator(points, T(v))
        with pytest.raises(ValueError):
            SpRGI(points, v)
    good = [(0.0, 0.5, 1.0)] * 2
    with pytest.raises(ValueError):
        RegularGridInterpolator(good, T(v), method="undefmethod")
    with pytest.raises(ValueError):
        RegularGridInterpolator(good, T(v), fill_value=1 + 2j)
    RegularGridInterpolator(good, T(v), fill_value=1)
    interp = RegularGridInterpolator(good, T(v))
    with pytest.raises(ValueError):
        interp(T(np.zeros((2, 2))), "undefmethod")
    with pytest.raises(ValueError):
        interp(T(np.zeros((2, 3))))
    for bad in ([[0.0, 1.1]], [[-0.1, 0.5]], [[0.5, 0.5], [1.0, 1.0001]]):
        with pytest.raises(ValueError):
            interp(T(np.array(bad)))
        with pytest.raises(ValueError):
            SpRGI(good, v)(np.array(bad))
    with pytest.raises(ValueError):
        interpn(good, T(v), T(np.zeros((1, 2))), method="cubic")


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
@pytest.mark.parametrize("values_dtype", [np.float64, np.float32, np.int32])
@pytest.mark.parametrize("bounds", ["raise", "fill", "extrapolate"])
def test_rgi_matches_scipy(bounds, values_dtype, ndim, method):
    rng = np.random.default_rng(ndim * 10 + len(method))
    shape = (5, 6, 4, 3)[:ndim]
    points = [np.sort(rng.random(n)) * (k + 1) for k, n in enumerate(shape)]
    values = (rng.random(shape + (2,)) * 10).astype(values_dtype)
    lo = np.array([p[0] for p in points])
    hi = np.array([p[-1] for p in points])
    xi = lo + (hi - lo) * rng.random((7, 3, ndim))
    kw = {"bounds_error": True}
    if bounds != "raise":
        xi[0, 0] = lo - 0.3
        xi[1, 1] = hi + 0.2
        kw = {"bounds_error": False,
              "fill_value": -7.0 if bounds == "fill" else None}
    got = RegularGridInterpolator(points, T(values), method=method,
                                  **kw)(T(xi))
    ref = SpRGI(points, values, method=method, **kw)(xi)
    assert got.shape == ref.shape
    if method == "nearest":
        assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    got = interpn(points, T(values), T(xi), method=method, **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_interpn_suite_shapes():
    p2, v2 = _sample_4d(points=POINTS_2)
    s = T(np.array([0.1, 0.1, 10.0, 9.0]))
    np.testing.assert_allclose(interpn(p2, T(v2), s, bounds_error=False),
                               interpn(p2, T(v2), s[None],
                                       bounds_error=False))
    assert_array_almost_equal(
        interpn(p2, T(v2), T(np.array([[0.1, -0.1, 10.1, 9.0]])),
                bounds_error=False, fill_value=999.99).numpy(), 999.99)
    rng = np.random.RandomState(1234)
    sample = rng.rand(2, 3, 4)
    v1 = interpn(p2, T(v2), T(sample), method="nearest", bounds_error=False)
    assert v1.shape == (2, 3)
    x = np.array([0.5, 2.0, 3.0, 4.0, 5.5])
    z = np.array([[1, 2, 1, 2, 1], [1, 2, 1, 2, 1], [1, 2, 3, 2, 1],
                  [1, 2, 2, 2, 1], [1, 2, 1, 2, 1]])
    xi, yi = np.linspace(0, 1, 2), np.linspace(0, 3, 3)
    for method in ("nearest", "linear"):
        v1 = interpn((x, x), T(z), (T(xi[:, None]), T(yi[None, :])),
                     method=method, bounds_error=False)
        assert v1.shape == (2, 3)
        ref = sp_interpn((x, x), z, (xi[:, None], yi[None, :]),
                         method=method, bounds_error=False)
        np.testing.assert_allclose(v1.numpy(), ref, equal_nan=True)
    values = rng.rand(3, 3, 3, 3, 6)
    sample = rng.rand(7, 11, 4)
    for method in ("nearest", "linear"):
        v = interpn(p2, T(values), T(sample), method=method,
                    bounds_error=False)
        assert v.shape == (7, 11, 6)
        np.testing.assert_allclose(
            v.numpy(), sp_interpn(p2, values, sample, method=method,
                                  bounds_error=False))


def test_named_calls_match_cupyimg_tpu():
    """Against ``cupyimg_tpu`` (JAX-CPU, x64): the special functions and
    entropy as one jit program, and one interpolator of each method
    (their host checks run eagerly).  Within 1e-12 relative; NaN and inf
    in place, but for ``entr(nan)``: ``cupyimg_tpu`` gives -inf, the port
    and scipy NaN, so the list holds no NaN."""
    rng = np.random.default_rng(6)
    x = np.array([-1.0, 0.0, 0.25, 1.0, 3.0, np.inf])
    y = np.array([0.5, 0.0, 0.0, 2.0, -1.0, 1.0])
    pk = rng.random((4, 5))

    @jax.jit
    def jax_calls(x, y, pk):
        return (jspecial.entr(x), jspecial.kl_div(x, y),
                jspecial.rel_entr(x, y), jspecial.huber(y, x),
                jspecial.pseudo_huber(y, x),
                jstats.entropy(pk, pk[::-1], base=2.0, axis=1))

    want = jax_calls(x, y, pk)
    got = (special.entr(T(x)), special.kl_div(T(x), T(y)),
           special.rel_entr(T(x), T(y)), special.huber(T(y), T(x)),
           special.pseudo_huber(T(y), T(x)),
           stats.entropy(T(pk), T(pk[::-1]), base=2.0, axis=1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, equal_nan=True)
    points = [np.linspace(0, 3, 4), np.array([0.0, 0.5, 2.0, 2.5, 4.0])]
    values = rng.random((4, 5))
    xi = rng.random((6, 2)) * [3, 4]
    for method in ("linear", "nearest"):
        w = jinterp.RegularGridInterpolator(points, jnp.asarray(values),
                                            method=method)(jnp.asarray(xi))
        g = RegularGridInterpolator(points, T(values), method=method)(T(xi))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12)
