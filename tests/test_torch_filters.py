"""The separable scipy.ndimage filters of the torch port against
cupyimg_tpu (JAX on the CPU, x64 as tests/conftest.py sets it).

The same numpy inputs, made from a seed, go to both packages.  On CPU
tensors the port takes the per-axis path that cupyimg_tpu takes off the
TPU, in the same operation order, so:

- float64 inputs agree to atol 1e-12;
- float32 inputs to atol 2e-6;
- integer outputs exactly (the symmetric tap fold and the int64 wrap of
  ``_cast_output`` reproduce scipy's truncation).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cupyimg_tpu.scipy.ndimage as jndi
import cupyimg_tpu_torch.scipy.ndimage as tndi
from cupyimg_tpu_torch import config
from cupyimg_tpu_torch.ops import fused_separable as fs

ATOL = {np.float64: 1e-12, np.float32: 2e-6}
# One 3-D and one 2-D shape throughout: the JAX package's eager ops
# compile once per shape, so shared shapes keep the file fast.
SHAPE3 = (8, 9, 10)
SHAPE2 = (10, 12)


def _both(name, x, *args, **kwargs):
    """(port result as numpy, cupyimg_tpu result as numpy)."""
    got = getattr(tndi, name)(torch.from_numpy(x), *args, **kwargs)
    exp = getattr(jndi, name)(jnp.asarray(x), *args, **kwargs)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    return got.numpy(), np.asarray(exp)


def _check(got, exp, atol):
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if atol == 0:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=0, atol=atol)


CALLS = [
    ("correlate1d", ([0.2, -1.0, 0.5, 3.0],), {"axis": 1, "origin": 1}),
    ("convolve1d", ([1.0, 2.0, -0.5],), {"axis": 0, "mode": "wrap"}),
    ("uniform_filter1d", (4,), {"axis": -1, "mode": "mirror"}),
    ("uniform_filter", (), {"size": (3, 5, 2), "mode": "nearest"}),
    ("gaussian_filter1d", (1.3,), {"axis": 2, "order": 1}),
    ("gaussian_filter", (1.1,), {"mode": "grid-wrap"}),
    ("prewitt", (), {"axis": 0}),
    ("sobel", (), {"axis": 1, "mode": "grid-mirror"}),
    ("laplace", (), {"mode": "constant", "cval": 0.3}),
    ("gaussian_laplace", (0.9,), {}),
    ("gaussian_gradient_magnitude", (1.2,), {"mode": "reflect"}),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name, args, kwargs", CALLS, ids=[c[0] for c in CALLS])
def test_float_parity(name, args, kwargs, dtype):
    x = np.random.RandomState(0).rand(*SHAPE3).astype(dtype)
    _check(*_both(name, x, *args, **kwargs), ATOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_generic_filters_parity(dtype):
    x = np.random.RandomState(1).rand(*SHAPE2).astype(dtype)

    def d2(xx, axis, output, mode, cval, lib):
        return lib.correlate1d(xx, [1.0, -2.0, 1.0], axis, output, mode, cval)

    def d1(xx, axis, output, mode, cval, lib):
        return lib.sobel(xx, axis, output, mode, cval)

    for generic, deriv in (("generic_laplace", d2),
                           ("generic_gradient_magnitude", d1)):
        got = getattr(tndi, generic)(
            torch.from_numpy(x), deriv, mode="mirror",
            extra_arguments=(tndi,))
        exp = getattr(jndi, generic)(
            jnp.asarray(x), deriv, mode="mirror", extra_arguments=(jndi,))
        _check(got.numpy(), np.asarray(exp), ATOL[dtype])


INT_CALLS = [
    ("uniform_filter", (), {"size": 3}, np.uint8, None),
    ("uniform_filter1d", (5,), {"axis": 0}, np.int16, None),
    ("gaussian_filter", (1.5,), {}, np.uint8, None),
    ("sobel", (), {"axis": 0}, np.uint8, None),  # wraps negative -> uint8
    ("prewitt", (), {}, np.int32, np.int8),
    ("laplace", (), {}, np.int16, None),
    ("correlate1d", ([1.0, 3.0, 1.0],), {"axis": 1}, np.int32, np.uint16),
    ("gaussian_gradient_magnitude", (1.0,), {}, np.uint8, None),
]


@pytest.mark.parametrize(
    "name, args, kwargs, dtype, output", INT_CALLS,
    ids=[f"{c[0]}-{np.dtype(c[3]).name}" for c in INT_CALLS],
)
def test_integer_parity_exact(name, args, kwargs, dtype, output):
    x = np.random.RandomState(2).randint(0, 200, SHAPE3).astype(dtype)
    if output is not None:
        kwargs = dict(kwargs, output=output)
    _check(*_both(name, x, *args, **kwargs), 0)


def test_bool_input_follows_cupyimg_tpu_not_scipy():
    """A recorded departure (ROADMAP C), not a fault: on a bool mask the
    correlation filters give True wherever the float result is nonzero,
    as cupyimg_tpu does; SciPy keeps only outputs that reach 1.  The port
    follows cupyimg_tpu element for element, and the two differ from
    SciPy here: on this 7x9 mask both packages give 63 True for each
    call, SciPy 1 for uniform_filter(b, 3) and 0 for gaussian_filter(b,
    1)."""
    import jax
    import scipy.ndimage as sndi

    b = np.random.default_rng(0).random((7, 9)) > 0.5
    calls = (("uniform_filter", 3), ("gaussian_filter", 1))
    exps = jax.jit(lambda a: tuple(getattr(jndi, name)(a, arg)
                                   for name, arg in calls))(jnp.asarray(b))
    for (name, arg), exp in zip(calls, exps):
        got = getattr(tndi, name)(torch.from_numpy(b), arg).numpy()
        _check(got, np.asarray(exp), 0)
        assert got.dtype == np.bool_ and int(got.sum()) == 63
        sp = getattr(sndi, name)(b, arg)
        assert sp.dtype == np.bool_ and not np.array_equal(got, sp)
        assert int(sp.sum()) == {"uniform_filter": 1,
                                 "gaussian_filter": 0}[name]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_axes_origins_and_mixed_modes(dtype):
    x = np.random.RandomState(3).rand(*SHAPE3).astype(dtype)
    for name, args, kwargs in [
        ("uniform_filter", (), {"size": (3, 4), "axes": (0, 2),
                                "origin": (1, -1)}),
        ("uniform_filter", (), {"size": 3,
                                "mode": ("wrap", "mirror", "constant"),
                                "cval": 0.5}),
        ("gaussian_filter", ((0.8, 1.5),), {"axes": (2, 1),
                                            "mode": ("nearest", "reflect")}),
        ("gaussian_filter", (1.0,), {"order": (0, 1, 2), "radius": 2}),
        ("gaussian_laplace", (1.0,), {"axes": (0, 1)}),
        ("gaussian_gradient_magnitude", (0.7,), {"axes": (1, 2)}),
        ("laplace", (), {"axes": (2,), "mode": ("wrap",)}),
        ("sobel", (), {"mode": ["nearest", "wrap", "mirror"]}),
    ]:
        _check(*_both(name, x, *args, **kwargs), ATOL[dtype])


@pytest.mark.parametrize("name, args", [
    ("uniform_filter", (5,)),
    ("gaussian_filter", (1.4,)),
    ("sobel", ()),
    ("prewitt", ()),
])
def test_constant_mode_cval_gate(name, args):
    """Nonzero cval in constant mode: the taps of uniform/gaussian sum to
    1 (extend-once is exact), sobel/prewitt's do not (per-axis re-extension
    is what scipy does).  Both packages agree with scipy either way."""
    import scipy.ndimage as sndi

    x = np.random.RandomState(4).rand(*SHAPE2).astype(np.float64)
    got, exp = _both(name, x, *args, mode="constant", cval=0.7)
    _check(got, exp, 1e-12)
    np.testing.assert_allclose(
        got, getattr(sndi, name)(x, *args, mode="constant", cval=0.7),
        rtol=0, atol=1e-12,
    )


def test_slice_uniform_filter_headline_shape():
    """The slice as a whole: uniform_filter(size=5) on a (24, 20, 40)
    float32 volume against cupyimg_tpu and scipy."""
    import scipy.ndimage as sndi

    x = np.random.RandomState(5).rand(24, 20, 40).astype(np.float32)
    got, exp = _both("uniform_filter", x, size=5)
    _check(got, exp, 2e-6)
    np.testing.assert_allclose(
        got, sndi.uniform_filter(x.astype(np.float64), size=5), atol=2e-6
    )


@pytest.mark.parametrize("name, args, kwargs, exc", [
    ("uniform_filter", (3,), {"mode": "bogus"}, RuntimeError),
    ("gaussian_filter", (1.0,), {"mode": "bogus"}, RuntimeError),
    ("correlate1d", ([1.0, 2.0, 1.0],), {"mode": "bogus"}, RuntimeError),
    ("uniform_filter", (3,), {"origin": 2}, ValueError),
    ("correlate1d", ([1.0, 2.0, 1.0],), {"origin": -2}, ValueError),
    ("uniform_filter1d", (3,), {"origin": 2}, ValueError),
    ("uniform_filter", (3,), {"output": np.zeros(SHAPE2)},
     NotImplementedError),
    ("sobel", (), {"output": np.zeros(SHAPE2)}, NotImplementedError),
])
def test_error_parity(name, args, kwargs, exc):
    x = np.random.RandomState(6).rand(*SHAPE2)
    with pytest.raises(exc):
        getattr(jndi, name)(jnp.asarray(x), *args, **kwargs)
    with pytest.raises(exc):
        getattr(tndi, name)(torch.from_numpy(x), *args, **kwargs)


def test_tensor_output_raises():
    x = torch.rand(6, 7)
    with pytest.raises(NotImplementedError):
        tndi.gaussian_filter(x, 1.0, output=torch.zeros(6, 7))


def test_numpy_input_goes_to_config_device(monkeypatch):
    x = np.random.RandomState(7).rand(6, 7)
    monkeypatch.setattr(config, "device", "cpu")
    y = tndi.uniform_filter(x, 3)
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    monkeypatch.setattr(config, "device", "cuda")
    if torch.cuda.is_available():
        assert tndi.uniform_filter(x, 3).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tndi.uniform_filter(x, 3)


def test_cpu_float32_takes_the_per_axis_path():
    before = fs.fused_separable_correlate.launches
    tndi.gaussian_filter(torch.rand(8, 9, 10), 1.0)
    assert fs.fused_separable_correlate.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name, args, kwargs", [
    ("uniform_filter", (), {"size": 5}),
    ("gaussian_filter", (1.5,), {}),
    ("sobel", (), {}),
    ("prewitt", (), {"axis": 0}),
])
def test_cuda_float32_launches_the_kernel_once(cuda, name, args, kwargs):
    import scipy.ndimage as sndi

    x = np.random.RandomState(8).rand(20, 24, 40).astype(np.float32)
    before = fs.fused_separable_correlate.launches
    y = getattr(tndi, name)(torch.from_numpy(x).cuda(), *args, **kwargs)
    assert fs.fused_separable_correlate.launches == before + 1
    exp = getattr(sndi, name)(x.astype(np.float64), *args, **kwargs)
    np.testing.assert_allclose(y.cpu().numpy(), exp, rtol=0, atol=1e-5 * 32)
