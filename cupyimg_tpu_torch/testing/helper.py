"""Dual-backend test oracle.

The counterpart of ``cupyimg_tpu.testing.helper``: a decorated test body
runs twice, once with ``xp=torch`` (and ``scp=cupyimg_tpu_torch.scipy``)
and once with ``xp=numpy`` (and ``scp=scipy``), and the results, the
port's brought to numpy, are compared, including *error equivalence*:
if either half raises, both must, with exceptions of the same class.
"""

from __future__ import annotations

import functools
import itertools
import traceback

import numpy as np

__all__ = [
    "numpy_torch_allclose",
    "numpy_cupyimg_allclose",
    "numpy_cupyimg_array_almost_equal",
    "numpy_cupyimg_array_almost_equal_nulp",
    "numpy_cupyimg_array_max_ulp",
    "numpy_cupyimg_array_equal",
    "numpy_cupyimg_array_list_equal",
    "numpy_cupyimg_array_less",
    "numpy_cupyimg_equal",
    "numpy_cupyimg_raises",
    "for_dtypes",
    "product",
    "assert_allclose",
]


def product(parameter_dicts):
    """Cartesian product of parameter dicts (cupy.testing.product analog)."""
    keys = list(parameter_dicts.keys())
    out = []
    for values in itertools.product(*(parameter_dicts[k] for k in keys)):
        out.append(dict(zip(keys, values)))
    return out


def _host(a):
    """A result as numpy: tensors to the host, sequences element-wise."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    if isinstance(a, (list, tuple)):
        return type(a)(_host(v) for v in a)
    return a


def assert_allclose(actual, desired, rtol=1e-7, atol=0, err_msg=""):
    np.testing.assert_allclose(
        np.asarray(_host(actual)), np.asarray(_host(desired)), rtol=rtol,
        atol=atol, err_msg=err_msg,
    )


_ACCEPTABLE_ERRORS = (Exception,)


def _call_backend(impl, self_args, kwargs, xp, scp, scipy_name):
    kw = dict(kwargs)
    kw["xp"] = xp
    if scipy_name is not None:
        kw[scipy_name] = scp
    try:
        return impl(*self_args, **kw), None
    except _ACCEPTABLE_ERRORS as e:
        return None, e


def _both(impl, args, kwargs, scipy_name):
    """((port result, port error), (numpy result, numpy error))."""
    import scipy as _scipy
    import torch

    import cupyimg_tpu_torch.scipy as _tscipy

    port = _call_backend(impl, args, kwargs, torch, _tscipy, scipy_name)
    ref = _call_backend(impl, args, kwargs, np, _scipy, scipy_name)
    return port, ref


def _check_error_equivalence(port_error, np_error, accept_error):
    if not accept_error:
        if port_error is not None:
            raise AssertionError(
                "torch backend raised but errors not accepted:\n"
                + "".join(
                    traceback.format_exception(
                        type(port_error), port_error,
                        port_error.__traceback__
                    )
                )
            )
        raise AssertionError(
            f"numpy backend raised but errors not accepted: {np_error!r}"
        )
    if accept_error is True:
        accepted = Exception
    else:
        accepted = accept_error
    if port_error is None or np_error is None:
        raise AssertionError(
            f"only one backend raised: torch={port_error!r} "
            f"numpy={np_error!r}"
        )
    if not isinstance(port_error, accepted):
        raise AssertionError(
            f"torch error not of accepted type: {port_error!r}")
    if not isinstance(np_error, accepted):
        raise AssertionError(f"numpy error not of accepted type: {np_error!r}")
    if type(port_error) is not type(np_error):
        raise AssertionError(
            f"the backends raised different errors: torch={port_error!r} "
            f"numpy={np_error!r}"
        )


def _dual_backend(compare, scipy_name=None, accept_error=False):
    """Build a dual-run decorator with a custom comparison of each pair of
    results (as numpy arrays)."""

    def decorator(impl):
        @functools.wraps(impl)
        def wrapper(*args, **kwargs):
            (port_result, port_error), (np_result, np_error) = _both(
                impl, args, kwargs, scipy_name)
            if np_error is not None or port_error is not None:
                _check_error_equivalence(port_error, np_error, accept_error)
                return
            if np_result is None and port_result is None:
                return  # test asserted internally
            assert port_result is not None and np_result is not None, (
                "one backend returned None: "
                f"torch={port_result!r} numpy={np_result!r}"
            )
            t_res = _host(port_result if isinstance(port_result, tuple)
                          else (port_result,))
            n_res = (np_result if isinstance(np_result, tuple)
                     else (np_result,))
            assert len(t_res) == len(n_res)
            for t, n in zip(t_res, n_res):
                compare(np.asarray(t), np.asarray(n))

        return wrapper

    return decorator


def numpy_torch_allclose(
    rtol=1e-7,
    atol=0,
    err_msg="",
    scipy_name=None,
    name="xp",
    accept_error=False,
):
    """Decorator running a test vs numpy/scipy and comparing results.

    The test function receives ``xp`` (numpy or torch) and, when
    ``scipy_name`` is given, that kwarg bound to ``scipy`` or
    ``cupyimg_tpu_torch.scipy``.
    """

    def compare(t, n):
        assert_allclose(t, n, rtol=rtol, atol=atol, err_msg=err_msg)

    return _dual_backend(compare, scipy_name, accept_error)


def numpy_cupyimg_allclose(
    rtol=1e-7, atol=0, err_msg="", scipy_name=None, name="xp",
    accept_error=False, **ignored,
):
    """Run the test with xp=torch and xp=numpy; assert allclose."""
    return numpy_torch_allclose(
        rtol=rtol, atol=atol, err_msg=err_msg, scipy_name=scipy_name,
        name=name, accept_error=accept_error,
    )


def numpy_cupyimg_array_almost_equal(
    decimal=6, err_msg="", scipy_name=None, accept_error=False,
    **ignored,
):
    def compare(t, n):
        np.testing.assert_array_almost_equal(
            t, n, decimal=decimal, err_msg=err_msg
        )

    return _dual_backend(compare, scipy_name, accept_error)


def numpy_cupyimg_array_almost_equal_nulp(
    nulp=1, scipy_name=None, accept_error=False, **ignored
):
    def compare(t, n):
        np.testing.assert_array_almost_equal_nulp(t, n, nulp=nulp)

    return _dual_backend(compare, scipy_name, accept_error)


def numpy_cupyimg_array_max_ulp(
    maxulp=1, dtype=None, scipy_name=None, accept_error=False,
    **ignored,
):
    def compare(t, n):
        np.testing.assert_array_max_ulp(t, n, maxulp=maxulp,
                                        dtype=dtype)

    return _dual_backend(compare, scipy_name, accept_error)


def numpy_cupyimg_array_equal(
    err_msg="", scipy_name=None, accept_error=False, strides_check=False,
    **ignored,
):
    def compare(t, n):
        np.testing.assert_array_equal(t, n, err_msg=err_msg)

    return _dual_backend(compare, scipy_name, accept_error)


def numpy_cupyimg_array_list_equal(
    err_msg="", scipy_name=None, **ignored
):
    def compare(t, n):
        np.testing.assert_array_equal(t, n, err_msg=err_msg)

    return _dual_backend(compare, scipy_name, False)


def numpy_cupyimg_array_less(
    err_msg="", scipy_name=None, accept_error=False, **ignored
):
    def compare(t, n):
        np.testing.assert_array_less(t, n, err_msg=err_msg)

    return _dual_backend(compare, scipy_name, accept_error)


def numpy_cupyimg_equal(scipy_name=None, **ignored):
    def compare(t, n):
        assert (t == n).all(), f"results differ: {t!r} != {n!r}"

    return _dual_backend(compare, scipy_name, False)


def numpy_cupyimg_raises(
    scipy_name=None, accept_error=Exception, **ignored
):
    """Both backends must raise an (equivalent) error."""

    def decorator(impl):
        @functools.wraps(impl)
        def wrapper(*args, **kwargs):
            (_, port_error), (_, np_error) = _both(impl, args, kwargs,
                                                   scipy_name)
            _check_error_equivalence(port_error, np_error, accept_error)

        return wrapper

    return decorator


def for_dtypes(dtypes, name="dtype"):
    """Parameterize a test over dtypes (numpy scalar types)."""

    def decorator(impl):
        @functools.wraps(impl)
        def wrapper(*args, **kwargs):
            for dtype in dtypes:
                try:
                    kwargs[name] = np.dtype(dtype).type
                    impl(*args, **kwargs)
                except Exception:
                    print(f"dtype is {dtype}")
                    raise

        return wrapper

    return decorator
