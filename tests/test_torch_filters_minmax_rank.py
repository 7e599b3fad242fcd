"""correlate/convolve, the min/max, rank and generic filters of the torch
port against cupyimg_tpu (JAX on the CPU, x64 as tests/conftest.py sets
it), and against scipy where noted.

The same numpy inputs, made from a seed, go to both packages.  On CPU
tensors the port takes the plain torch paths that cupyimg_tpu takes off
the TPU, so:

- min/max/rank/median/percentile results agree exactly (order
  statistics of the same values);
- correlate/convolve agree to atol 1e-12 in float64 accumulation (the
  default ``dtype_mode="ndimage"``, float32 inputs included) and to
  2e-6 * sum|w| under ``dtype_mode="float"`` with float32 data;
- integer outputs agree exactly.
"""

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax.numpy as jnp

import cupyimg_tpu.scipy.ndimage as jndi
import cupyimg_tpu_torch.scipy.ndimage as tndi
from cupyimg_tpu_torch.core import dtypes
from cupyimg_tpu.scipy.ndimage import filters as jfilters
from cupyimg_tpu_torch.ops import fused_dense, fused_rank, fused_separable
from cupyimg_tpu_torch.scipy.ndimage import filters as tfilters

# one 3-D and one 2-D shape throughout: the JAX package's eager ops
# compile once per shape
SHAPE3 = (8, 9, 10)
SHAPE2 = (10, 12)
CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
W3 = np.random.RandomState(10).randn(3, 2, 4)
W2 = np.random.RandomState(11).randn(4, 3)


def _input(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.randint(0, 120, shape).astype(dtype)
    return rng.rand(*shape).astype(dtype)


def _both(name, x, *args, **kwargs):
    """(port result as numpy, cupyimg_tpu result as numpy)."""
    got = getattr(tndi, name)(torch.from_numpy(x), *args, **kwargs)
    exp = getattr(jndi, name)(jnp.asarray(x), *args, **kwargs)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    return got.numpy(), np.asarray(exp)


def _check(got, exp, atol=0.0):
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if atol == 0:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=0, atol=atol)


def test_exports_every_filter_of_the_reference():
    assert sorted(tfilters.__all__) == sorted(jfilters.__all__)
    assert len(tfilters.__all__) == 24
    for name in jfilters.__all__:
        assert callable(getattr(tndi, name))


CORR_CALLS = [
    ("correlate", (W3,), {}),
    ("correlate", (W3,), {"mode": "constant", "cval": 0.4,
                          "origin": (1, 0, -2)}),
    ("convolve", (W3,), {"mode": "mirror", "origin": (-1, 0, 1)}),
    ("convolve", (W2,), {"axes": (2, 0), "mode": "grid-wrap"}),
    ("correlate", (W2,), {"axes": (0, 1), "mode": "nearest"}),
    ("correlate", (np.ones((2, 3, 2), bool),), {"mode": "wrap"}),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name, args, kwargs", CORR_CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CORR_CALLS)])
def test_correlate_convolve_float_parity(name, args, kwargs, dtype):
    x = _input(SHAPE3, dtype, 0)
    _check(*_both(name, x, *args, **kwargs), 1e-12 if dtype == np.float64
           else 2e-6)


def test_correlate_float_dtype_mode_matches_scipy():
    """dtype_mode="float": float32 accumulation (the route that goes to
    the dense kernel on the card), against scipy in float64."""
    x = _input(SHAPE3, np.float32, 1)
    got, exp = _both("correlate", x, W3, mode="reflect", dtype_mode="float")
    tol = 2e-6 * np.abs(W3).sum()
    _check(got, exp, tol)
    np.testing.assert_allclose(
        got, sndi.correlate(x.astype(np.float64), W3), rtol=0, atol=tol)


@pytest.mark.parametrize("name, dtype, output, weights", [
    ("correlate", np.int32, None, W2[..., None]),
    ("convolve", np.uint8, None, np.array([[[1, -2], [3, 1]]])),
    ("correlate", np.uint8, np.int16, np.array([[[1.5, -2.0]]])),
    ("convolve", np.float32, np.uint8, W2[None]),
])
def test_correlate_convolve_integer_outputs_exact(name, dtype, output,
                                                  weights):
    x = _input(SHAPE3, dtype, 2)
    _check(*_both(name, x, weights, output=output))


def test_correlate_complex_weights():
    x = _input(SHAPE2, np.float64, 3)
    w = W2 + 1j * W2[::-1]
    _check(*_both("correlate", x, w, mode="reflect"), 1e-12)
    _check(*_both("convolve", x, w, mode="constant"), 1e-12)


MINMAX_CALLS = [
    ("minimum_filter", (), {"size": 3}),
    ("maximum_filter", (), {"size": (2, 1, 4), "origin": (-1, 0, 1),
                            "mode": ("wrap", "reflect", "constant"),
                            "cval": 0.5}),
    ("minimum_filter", (), {"footprint": np.ones((3, 3, 3), bool)}),
    ("maximum_filter", (), {"footprint": CROSS, "axes": (0, 2),
                            "mode": "mirror"}),
    ("minimum_filter", (), {"footprint": np.array([[[1, 0, 1]]], bool),
                            "mode": "constant", "cval": -1.0,
                            "origin": (0, 0, 1)}),
    ("maximum_filter", (), {"size": (3, 4), "axes": (1, 2),
                            "mode": "grid-mirror"}),
    ("minimum_filter1d", (4,), {"axis": 1, "origin": 1, "mode": "nearest"}),
    ("maximum_filter1d", (3,), {"axis": 0, "mode": "constant", "cval": 2.0}),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.uint8])
@pytest.mark.parametrize("name, args, kwargs", MINMAX_CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(MINMAX_CALLS)])
def test_minmax_parity_exact(name, args, kwargs, dtype):
    x = _input(SHAPE3, dtype, 4)
    _check(*_both(name, x, *args, **kwargs))


def test_minmax_output_dtype_and_size_one_copy():
    x = _input(SHAPE2, np.float64, 5)
    _check(*_both("maximum_filter", x, size=3, output=np.float32))
    got = tndi.minimum_filter(torch.from_numpy(x), size=1)
    assert torch.equal(got, torch.from_numpy(x))
    assert got.data_ptr() != torch.from_numpy(x).data_ptr()


@pytest.mark.parametrize("dtype", [np.float64, np.int32])
def test_minmax_with_structure_matches_reference(dtype):
    """The additive-structure branch that grey morphology calls."""
    x = _input(SHAPE2, dtype, 6)
    structure = np.array([[0.0, 1.5, 0.0], [2.0, 0.5, -1.0]])
    for is_min in (True, False):
        got = tfilters._min_or_max_filter(
            torch.from_numpy(x), None, None, structure, None, "reflect", 0.0,
            0, is_min)
        exp = jfilters._min_or_max_filter(
            jnp.asarray(x), None, None, structure, None, "reflect", 0.0, 0,
            is_min)
        _check(got.numpy(), np.asarray(exp))


RANK_CALLS = [
    ("median_filter", (), {"size": 3}),
    ("median_filter", (), {"footprint": CROSS[None], "mode": "constant",
                           "cval": 7.0}),
    ("rank_filter", (2,), {"size": (2, 2, 3), "origin": (-1, 0, 1),
                           "mode": "wrap"}),
    ("rank_filter", (-3,), {"footprint": np.ones((2, 3), bool),
                            "axes": (2, 0), "mode": "mirror"}),
    ("percentile_filter", (30,), {"size": (1, 5, 3), "mode": "nearest"}),
    ("percentile_filter", (-20,), {"footprint": CROSS, "axes": (1, 2)}),
    ("rank_filter", (0,), {"footprint": CROSS[None]}),  # min route
    ("percentile_filter", (100,), {"size": 3}),  # max route
    ("median_filter", (), {"size": (3, 5, 5), "mode": "grid-wrap"}),  # 75
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.uint8])
@pytest.mark.parametrize("name, args, kwargs", RANK_CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(RANK_CALLS)])
def test_rank_parity_exact(name, args, kwargs, dtype):
    x = _input(SHAPE3, dtype, 7)
    _check(*_both(name, x, *args, **kwargs))


def test_rank_output_dtype():
    x = _input(SHAPE2, np.int32, 8)
    _check(*_both("median_filter", x, size=3, output=np.float64))
    _check(*_both("rank_filter", x, 5, size=(3, 4), output=np.int16))


def test_rank_filters_match_scipy():
    x = _input((30, 41), np.float32, 9)
    np.testing.assert_array_equal(
        tndi.median_filter(torch.from_numpy(x), 5).numpy(),
        sndi.median_filter(x, 5))
    np.testing.assert_array_equal(
        tndi.percentile_filter(torch.from_numpy(x), 30, size=(4, 3),
                               mode="constant", cval=0.3).numpy(),
        sndi.percentile_filter(x, 30, size=(4, 3), mode="constant",
                               cval=0.3))


def test_generic_filter_parity():
    x = _input(SHAPE3, np.float64, 10)
    got = tndi.generic_filter(
        torch.from_numpy(x), lambda w, a: (w * w).sum() - a, size=(2, 3, 2),
        mode="mirror", extra_arguments=(0.5,))
    exp = jndi.generic_filter(
        jnp.asarray(x), lambda w, a: jnp.sum(w * w) - a, size=(2, 3, 2),
        mode="mirror", extra_arguments=(0.5,))
    _check(got.numpy(), np.asarray(exp), 1e-12)
    got = tndi.generic_filter(torch.from_numpy(x), lambda w: w.max(),
                              footprint=CROSS[None], output=np.float32)
    exp = jndi.generic_filter(jnp.asarray(x), lambda w: jnp.max(w),
                              footprint=CROSS[None], output=np.float32)
    _check(got.numpy(), np.asarray(exp))


def test_generic_filter1d_parity():
    x = _input(SHAPE3, np.float64, 11)

    def box(line, n, scale=1.0):  # works on torch and jax arrays alike
        return sum(line[k: k + line.shape[0] - 2] for k in range(n)) * scale

    got = tndi.generic_filter1d(torch.from_numpy(x), box, 3, axis=1,
                                origin=1, mode="wrap", extra_arguments=(3,),
                                extra_keywords={"scale": 0.5})
    exp = jndi.generic_filter1d(jnp.asarray(x), box, 3, axis=1, origin=1,
                                mode="wrap", extra_arguments=(3,),
                                extra_keywords={"scale": 0.5})
    _check(got.numpy(), np.asarray(exp), 1e-12)


ERRORS = [
    ("minimum_filter", (), {"footprint": np.zeros((3, 3), bool)}, ValueError),
    ("median_filter", (), {"footprint": np.zeros((3, 3), bool)}, ValueError),
    ("rank_filter", (9,), {"size": 3}, RuntimeError),
    ("rank_filter", (-10,), {"size": 3}, RuntimeError),
    ("rank_filter", (1.0,), {"size": 3}, TypeError),
    ("percentile_filter", (101,), {"size": 3}, RuntimeError),
    ("percentile_filter", (-101,), {"size": 3}, RuntimeError),
    ("correlate", (np.ones(3),), {}, RuntimeError),
    ("convolve", (np.ones((3, 3, 3)),), {}, RuntimeError),
    ("correlate", (np.ones((3, 3)),), {"origin": 2}, ValueError),
    ("maximum_filter", (), {}, RuntimeError),
    ("maximum_filter", (), {"footprint": np.ones(3, bool)}, RuntimeError),
    ("minimum_filter", (), {"size": 3, "mode": "bogus"}, RuntimeError),
    ("median_filter", (), {"size": 3, "origin": 2}, ValueError),
    ("generic_filter1d", (lambda v: v, 0), {}, RuntimeError),
]


@pytest.mark.parametrize("name, args, kwargs, exc", ERRORS,
                         ids=[f"{e[0]}-{i}" for i, e in enumerate(ERRORS)])
def test_error_parity(name, args, kwargs, exc):
    x = _input(SHAPE2, np.float64, 12)
    with pytest.raises(exc):
        getattr(jndi, name)(jnp.asarray(x), *args, **kwargs)
    with pytest.raises(exc):
        getattr(tndi, name)(torch.from_numpy(x), *args, **kwargs)


def test_numpy_dtype_mode_is_not_ported_yet():
    """Named when ``dtype_mode="numpy"`` raised NotImplementedError (the
    name is kept so that the test stays traceable); the mode is ported
    now, so this holds its rule against scipy: the output dtype is
    ``np.promote_types(input, weights)`` (float64 within 1e-12 relative,
    float32 within 1e-6 of max|ref|) and ``output`` raises ValueError,
    as ``cupyimg_tpu``'s."""
    x = _input(SHAPE2, np.float32, 14)
    for w, rtol in ((np.ones((3, 3)), 1e-12), (W2.astype(np.float32), 0)):
        got = tndi.correlate(torch.from_numpy(x), w, dtype_mode="numpy")
        out = np.promote_types(x.dtype, w.dtype)
        assert got.dtype == dtypes.to_torch(out)
        ref = sndi.correlate(x.astype(np.float64), w.astype(np.float64))
        np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                                   atol=0 if rtol else 1e-6 * abs(ref).max())
    with pytest.raises(ValueError, match="output"):
        tndi.correlate(torch.from_numpy(x), np.ones((3, 3)),
                       output=np.float32, dtype_mode="numpy")


def test_size_and_footprint_warns_like_the_reference():
    x = _input(SHAPE2, np.float64, 13)
    with pytest.warns(UserWarning, match="ignoring size"):
        got = tndi.median_filter(torch.from_numpy(x), size=3, footprint=CROSS)
    np.testing.assert_array_equal(
        got.numpy(), tndi.median_filter(torch.from_numpy(x),
                                        footprint=CROSS).numpy())


def test_cpu_tensors_launch_no_kernel():
    counters = (fused_dense.fused_dense_correlate,
                fused_rank.fused_rank_filter,
                fused_separable.fused_separable_minmax)
    before = [c.launches for c in counters]
    x = torch.rand(12, 14)
    tndi.correlate(x, W2, dtype_mode="float")
    tndi.minimum_filter(x, 3)
    tndi.median_filter(x, 3)
    assert [c.launches for c in counters] == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name, args, kwargs, counter, dtype", [
    ("correlate", (W2,), {"dtype_mode": "float"},
     fused_dense.fused_dense_correlate, np.float32),
    ("convolve", (np.ones((3, 3)),), {"dtype_mode": "float",
                                       "mode": "constant"},
     fused_dense.fused_dense_correlate, np.float32),
    ("minimum_filter", (), {"size": 5}, fused_separable.fused_separable_minmax,
     np.float32),
    ("maximum_filter", (), {"size": (3, 9)},
     fused_separable.fused_separable_minmax, np.float32),
    ("median_filter", (), {"size": 5}, fused_rank.fused_rank_filter,
     np.float32),
    ("rank_filter", (2,), {"footprint": CROSS}, fused_rank.fused_rank_filter,
     np.int32),
    ("percentile_filter", (30,), {"size": 4}, fused_rank.fused_rank_filter,
     np.float32),
])
def test_cuda_call_launches_its_kernel_once(cuda, name, args, kwargs,
                                            counter, dtype):
    x = _input((40, 70), dtype, 14)
    before = counter.launches
    y = getattr(tndi, name)(torch.from_numpy(x).cuda(), *args, **kwargs)
    assert counter.launches == before + 1
    kwargs = {k: v for k, v in kwargs.items() if k != "dtype_mode"}
    exp = getattr(sndi, name)(x, *args, **kwargs)
    np.testing.assert_allclose(y.cpu().numpy(), exp, rtol=0, atol=1e-4)
