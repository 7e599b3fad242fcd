"""``skimage._shared`` of the torch port (``utils``, ``_warnings``,
``coord``, ``fft``) on CPU tensors, the cases of
``test_shared_utils_warnings_suite``; ``ensure_spacing`` against a direct
numpy definition (a point survives unless an earlier survivor lies within
``spacing``) over norms, strictness, ``max_out`` and small blocks, and
against ``cupyimg_tpu``; and the public names of the slice's sixteen JAX
modules, each present at the same path in the port.

Tolerances: exact throughout (the thinning is a host decision on exact
distance comparisons).
"""

import importlib
import os
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cupyimg_tpu.skimage._shared.coord import ensure_spacing as jensure
from cupyimg_tpu_torch.skimage._shared import coord, fft
from cupyimg_tpu_torch.skimage._shared._warnings import (
    all_warnings,
    expected_warnings,
)
from cupyimg_tpu_torch.skimage._shared.utils import (
    _supported_float_type,
    _validate_interpolation_order,
    change_default_value,
    check_nD,
    check_random_state,
    check_shape_equality,
    convert_to_float,
    deprecate_kwarg,
    deprecated,
    get_bound_method_class,
    remove_arg,
    safe_as_int,
    skimage_deprecation,
)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_change_default_value():
    @change_default_value("arg1", new_value=-1, changed_version="0.12")
    def foo(arg0, arg1=0, arg2=1):
        """Expected docstring"""
        return arg0, arg1, arg2

    @change_default_value("arg1", new_value=-1, changed_version="0.12",
                          warning_msg="Custom warning message")
    def bar(arg0, arg1=0, arg2=1):
        """Expected docstring"""
        return arg0, arg1, arg2

    with pytest.warns(FutureWarning) as record:
        assert foo(0) == (0, 0, 1)
        assert bar(0) == (0, 0, 1)
    assert str(record[0].message) == (
        "The new recommended value for arg1 is -1. Until "
        "version 0.12, the default arg1 value is 0. From "
        "version 0.12, the arg1 default value will be -1. "
        "To avoid this warning, please explicitly set arg1 value.")
    assert str(record[1].message) == "Custom warning message"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert foo(0, 2) == (0, 2, 1)
        assert foo(0, arg1=0) == (0, 0, 1)
        assert foo.__name__ == "foo"
        if sys.flags.optimize < 2:
            assert foo.__doc__ == "Expected docstring"


def test_deprecate_kwarg_remove_arg_and_deprecated():
    @deprecate_kwarg({"old_arg1": "new_arg1"})
    def foo(arg0, new_arg1=1, arg2=None):
        """Expected docstring"""
        return arg0, new_arg1, arg2

    @deprecate_kwarg({"old_arg1": "new_arg1"},
                     warning_msg="Custom warning message")
    def bar(arg0, new_arg1=1, arg2=None):
        return arg0, new_arg1, arg2

    with pytest.warns(FutureWarning) as record:
        assert foo(0, old_arg1=1) == (0, 1, None)
        assert bar(0, old_arg1=1) == (0, 1, None)
    assert str(record[0].message) == (
        "'old_arg1' is a deprecated argument name for `foo`. Please use "
        "'new_arg1' instead.")
    assert str(record[1].message) == "Custom warning message"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert foo(0) == (0, 1, None)
        assert foo(0, 2) == (0, 2, None)
        assert foo(0, 1, 2) == (0, 1, 2)
        assert foo(0, new_arg1=1, arg2=2) == (0, 1, 2)
        assert foo(0, arg2=2) == (0, 1, 2)
        assert foo.__name__ == "foo"
        if sys.flags.optimize < 2:
            assert foo.__doc__ == "Expected docstring"

    @remove_arg("arg1", changed_version="0.12", help_msg="Some indication")
    def baz(arg0, arg1=0, arg2=1):
        return arg0, arg1, arg2

    with pytest.warns(FutureWarning, match="arg1 argument is deprecated.*"
                                           "Some indication"):
        assert baz(0, 1) == (0, 1, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert baz(0) == (0, 0, 1)

    @deprecated(alt_func="new_f", removed_version="0.20")
    def old_f(x):
        """Doc."""
        return x + 1

    with pytest.warns(skimage_deprecation,
                      match="``old_f`` is deprecated and will be removed "
                            "in version 0.20. Use ``new_f`` instead."):
        assert old_f(1) == 2
    assert old_f.__doc__.startswith("**Deprecated function**.")
    with pytest.raises(skimage_deprecation):
        deprecated(behavior="raise")(old_f.__wrapped__)(1)


def test_checks_and_conversions():
    z = np.random.random(200 ** 2).reshape((200, 200))
    with pytest.raises(ValueError):
        check_nD(T(z[10:30, 30:10]), 2)  # empty
    with pytest.raises(ValueError):
        check_nD(T(z), [3, 4])
    check_nD(T(z), [2, 3])
    check_nD(z.tolist(), 2)
    with pytest.raises(ValueError):
        check_shape_equality(T(z), T(z[:5]))
    check_shape_equality(T(z), T(z))
    assert safe_as_int(7.0) == 7
    assert safe_as_int(19.9999).tolist() == 20
    np.testing.assert_array_equal(safe_as_int(T(np.array([1.0, 2.0004]))),
                                  [1, 2])
    with pytest.raises(ValueError):
        safe_as_int(7.1)
    with pytest.raises(ValueError):
        safe_as_int([1.0, 2.5])
    u8 = T(np.array([0, 255], np.uint8))
    assert convert_to_float(u8, False).tolist() == [0.0, 1.0]
    assert convert_to_float(u8, True).tolist() == [0.0, 255.0]
    f32 = T(np.array([2.0], np.float32))
    assert convert_to_float(f32, True) is f32
    for dt, want in ((np.float16, np.float32), (np.float32, np.float32),
                     (np.float64, np.float64), (np.uint8, np.float64),
                     (torch.float32, np.float32)):
        assert _supported_float_type(dt) == want
    assert _supported_float_type(np.complex64, True) == np.complex64
    assert _supported_float_type(np.complex128, True) == np.complex128
    with pytest.raises(ValueError):
        _supported_float_type(np.complex64)
    rs = check_random_state(3)
    assert isinstance(rs, np.random.RandomState)
    assert check_random_state(rs) is rs
    assert check_random_state(None) is np.random.mtrand._rand
    with pytest.raises(ValueError):
        check_random_state("seed")

    class K:
        def m(self):
            return 1

    assert get_bound_method_class(K().m) is K


@pytest.mark.parametrize("dtype", [bool, int, np.uint8, np.uint16, float,
                                   np.float32, np.float64, torch.bool])
@pytest.mark.parametrize("order", [None, -1, 0, 1, 2, 3, 4, 5, 6])
def test_validate_interpolation_order(dtype, order):
    is_bool = dtype in (bool, torch.bool)
    if order is None:
        assert _validate_interpolation_order(dtype, None) == (
            0 if is_bool else 1)
    elif order < 0 or order > 5:
        with pytest.raises(ValueError):
            _validate_interpolation_order(dtype, order)
    elif is_bool and order != 0:
        with expected_warnings(["Input image dtype is bool"]):
            assert _validate_interpolation_order(dtype, order) == order
    else:
        assert _validate_interpolation_order(dtype, order) == order


@pytest.fixture
def strictness_env():
    old = os.environ.pop("SKIMAGE_TEST_STRICT_WARNINGS", None)
    yield
    if old is not None:
        os.environ["SKIMAGE_TEST_STRICT_WARNINGS"] = old
    else:
        os.environ.pop("SKIMAGE_TEST_STRICT_WARNINGS", None)


@pytest.mark.parametrize("strictness", [None, "1", "true", "True", "TRUE",
                                        "0", "false", "False", "FALSE"])
def test_expected_warnings_strictness(strictness_env, strictness):
    if strictness is not None:
        os.environ["SKIMAGE_TEST_STRICT_WARNINGS"] = strictness
    strict = strictness in (None, "1", "true", "True", "TRUE")
    if strict:
        with pytest.raises(ValueError):
            with expected_warnings(["some warnings"]):
                pass
        with pytest.raises(ValueError, match="Unexpected warning"):
            with expected_warnings(["some warnings"]):
                warnings.warn("other")
    else:
        with expected_warnings(["some warnings"]):
            pass
    with expected_warnings(["some warnings", None]):
        warnings.warn("some warnings here")
        warnings.warn("anything")
    with expected_warnings(["\\A\\Z"]):
        pass
    with pytest.raises(ValueError):
        with expected_warnings("a string"):
            pass
    with all_warnings() as w:
        warnings.warn("x")
        warnings.warn("x")
    assert len(w) == 2


# ---------------------------------------------------------------------------
# coord.ensure_spacing, fft
# ---------------------------------------------------------------------------


def _spacing_reference(pts, spacing, p, strict):
    pts = np.asarray(pts, float)
    keep = []
    for i, q in enumerate(pts):
        d = np.abs(pts[keep] - q)
        dist = d.max(axis=-1) if np.isinf(p) else (d ** p).sum(-1) ** (1 / p)
        close = dist < spacing if strict else dist <= spacing
        if not close.any():
            keep.append(i)
    return pts[keep]


@pytest.mark.parametrize("p_norm", [1, 2, np.inf])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("block", [None, 7])
def test_ensure_spacing_matches_definition(p_norm, strict, block,
                                           monkeypatch):
    if block is not None:  # blocks of a few rows each
        monkeypatch.setattr(coord, "_BLOCK_ELEMENTS", block * 60)
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 30, (60, 2)).astype(float)
    pts[5] = pts[4] + [3, 0]  # exactly `spacing` apart
    for spacing in (1, 3, 7.5):
        got = coord.ensure_spacing(T(pts), spacing, p_norm, strict=strict)
        want = _spacing_reference(pts, spacing, p_norm, strict)
        np.testing.assert_array_equal(got.numpy(), want)
    got = coord.ensure_spacing(T(pts), 3, p_norm, max_out=5, strict=strict)
    np.testing.assert_array_equal(
        got.numpy(), _spacing_reference(pts, 3, p_norm, strict)[:5])


def test_ensure_spacing_matches_cupyimg_tpu_and_edge_cases():
    rng = np.random.default_rng(4)
    pts = rng.random((40, 3)) * 20
    got = coord.ensure_spacing(T(pts), 4.0, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jensure(jnp.asarray(pts), 4.0,
                                                     2)))
    one_d = coord.ensure_spacing(T(np.array([0.0, 0.5, 2.0, 2.2])), 1)
    assert one_d.shape == (2, 1)
    assert coord.ensure_spacing(T(np.zeros((0, 2))), 1).shape == (0, 2)
    ints = coord.ensure_spacing(T(np.array([[0, 0], [0, 1], [5, 5]])), 2)
    assert ints.dtype == torch.int64 and ints.tolist() == [[0, 0], [5, 5]]


def test_fft_module_and_next_fast_len():
    assert fft.fftmodule is torch.fft
    assert [fft.next_fast_len(n) for n in (7, 13, 97, 1000, 1025)] == [
        8, 15, 100, 1000, 1080]


# ---------------------------------------------------------------------------
# the slice's names
# ---------------------------------------------------------------------------

SLICE_7 = [
    "numpy", "numpy.core", "numpy.core.fromnumeric", "numpy.core.multiarray",
    "numpy.core.numeric", "numpy.lib", "numpy.lib.shape_base",
    "numpy.lib.function_base", "numpy.lib.histograms", "scipy.special",
    "scipy.special._convex_analysis", "scipy.stats",
    "scipy.stats.distributions", "scipy.interpolate",
    "scipy.interpolate.interpolate", "skimage", "skimage.util",
    "skimage.util.dtype", "skimage.util.shape", "skimage.util._invert",
    "skimage.util.noise", "skimage.util._map_array", "skimage._shared",
    "skimage._shared._warnings", "skimage._shared.utils",
    "skimage._shared.coord", "skimage._shared.fft",
]


def _public(mod):
    """A module's ``__all__``, else its public names that are not
    modules."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("name", SLICE_7)
def test_public_names_match_cupyimg_tpu(name):
    jmod = importlib.import_module("cupyimg_tpu." + name)
    tmod = importlib.import_module("cupyimg_tpu_torch." + name)
    # names the JAX module only imports for itself
    own = {"annotations", "jax", "jnp", "lax", "np", "operator",
           "itertools", "math", "functools", "sys", "warnings", "numbers",
           "os", "re", "contextmanager", "torch"}
    missing = (_public(jmod) - own) - _public(tmod)
    assert not missing, f"{name}: {sorted(missing)}"
