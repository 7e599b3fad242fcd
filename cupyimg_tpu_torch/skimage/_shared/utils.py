"""Shared validation and conversion helpers of the skimage layer
(skimage/_shared/utils.py) on torch tensors: the shape, integer, float and
interpolation-order checks, the deprecation decorators and
``check_random_state`` (numpy's ``RandomState``, as skimage's)."""

from __future__ import annotations

import functools
import inspect
import sys
import warnings

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float

__all__ = [
    "check_shape_equality",
    "safe_as_int",
    "convert_to_float",
    "warn",
    "_validate_interpolation_order",
    "_supported_float_type",
]


def warn(message, category=UserWarning, stacklevel=2):
    """``warnings.warn`` with skimage's defaults."""
    warnings.warn(message, category=category, stacklevel=stacklevel)


def check_shape_equality(im1, im2):
    """Raise ValueError unless the two images have the same shape."""
    if not im1.shape == im2.shape:
        raise ValueError("Input images must have the same dimensions.")


def _host(val):
    return val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else (
        np.asarray(val))


def safe_as_int(val, atol=1e-3):
    """``val`` rounded to int64 (a host numpy value), raising ValueError
    where it is not within ``atol`` of an integer."""
    val = _host(val)
    mod = val % 1
    # the distance to the nearest integer (19.9999 -> 0.0001)
    mod = np.where(mod > 0.5, 1 - mod, mod)
    try:
        np.testing.assert_allclose(mod, 0, atol=atol)
    except AssertionError:
        raise ValueError(f"Integer argument required but received {val}, "
                         f"check inputs.")
    return np.round(val).astype(np.int64)


def convert_to_float(image, preserve_range):
    """A floating image: ``img_as_float``, or with ``preserve_range`` the
    values as they are (integers as float64)."""
    image = util.as_tensor(image)
    if preserve_range:
        if image.is_floating_point():
            return image
        return image.to(torch.float64)
    return img_as_float(image)


def _np_dtype(dtype):
    return dtypes.to_numpy(dtype) if isinstance(dtype, torch.dtype) else (
        np.dtype(dtype))


def _validate_interpolation_order(image_dtype, order):
    """The spline order (default: 0 for bool images, else 1), checked to
    lie in 0-5; bool images with order > 0 warn FutureWarning."""
    is_bool = _np_dtype(image_dtype) == bool
    if order is None:
        return 0 if is_bool else 1
    if order < 0 or order > 5:
        raise ValueError(
            "Spline interpolation order has to be in the range 0-5.")
    if is_bool and order != 0:
        warnings.warn(
            "Input image dtype is bool. Interpolation is not defined "
            "with bool data type. Please set order to 0 or explicitly "
            "cast input image to another data type. Starting from "
            "version 0.19 a ValueError will be raised instead of this "
            "warning.",
            FutureWarning,
            stacklevel=2,
        )
    return order


def _supported_float_type(input_dtype, allow_complex=False):
    """The float type skimage computes in: float16 and float32 give
    float32, complex64 stays, other complex types give complex128,
    everything else float64 (numpy types)."""
    input_dtype = _np_dtype(input_dtype)
    if not allow_complex and input_dtype.kind == "c":
        raise ValueError("complex valued input is not supported")
    if input_dtype in (np.float16, np.float32):
        return np.float32
    if input_dtype == np.complex64:
        return np.complex64
    if input_dtype.kind == "c":
        return np.complex128
    return np.float64


def check_nD(array, ndim, arg_name="image"):
    """Raise ValueError unless ``array`` is non-empty with one of the
    dimensionalities ``ndim`` (an int or a list)."""
    if not hasattr(array, "ndim"):
        array = np.asarray(array)
    size = array.numel() if isinstance(array, torch.Tensor) else array.size
    msg_incorrect_dim = "The parameter `%s` must be a %s-dimensional array"
    msg_empty_array = "The parameter `%s` cannot be an empty array"
    if isinstance(ndim, int):
        ndim = [ndim]
    if size == 0:
        raise ValueError(msg_empty_array % (arg_name))
    if array.ndim not in ndim:
        raise ValueError(msg_incorrect_dim
                         % (arg_name, "-or-".join([str(n) for n in ndim])))


class skimage_deprecation(Warning):
    """skimage's own deprecation class (Python silences
    DeprecationWarning by default)."""


class change_default_value:
    """Decorator that warns FutureWarning when a parameter's default,
    which will change, is used."""

    def __init__(self, arg_name, *, new_value, changed_version,
                 warning_msg=None):
        self.arg_name = arg_name
        self.new_value = new_value
        self.warning_msg = warning_msg
        self.changed_version = changed_version

    def __call__(self, func):
        parameters = inspect.signature(func).parameters
        arg_idx = list(parameters.keys()).index(self.arg_name)
        old_value = parameters[self.arg_name].default

        if self.warning_msg is None:
            self.warning_msg = (
                f"The new recommended value for {self.arg_name} is "
                f"{self.new_value}. Until version {self.changed_version}, "
                f"the default {self.arg_name} value is {old_value}. "
                f"From version {self.changed_version}, the {self.arg_name} "
                f"default value will be {self.new_value}. To avoid "
                f"this warning, please explicitly set {self.arg_name} value."
            )

        @functools.wraps(func)
        def fixed_func(*args, **kwargs):
            if len(args) < arg_idx + 1 and self.arg_name not in kwargs:
                warnings.warn(self.warning_msg, FutureWarning, stacklevel=2)
            return func(*args, **kwargs)

        return fixed_func


class remove_arg:
    """Decorator that warns FutureWarning when an argument that will be
    removed is passed."""

    def __init__(self, arg_name, *, changed_version, help_msg=None):
        self.arg_name = arg_name
        self.help_msg = help_msg
        self.changed_version = changed_version

    def __call__(self, func):
        parameters = inspect.signature(func).parameters
        arg_idx = list(parameters.keys()).index(self.arg_name)
        warning_msg = (
            f"{self.arg_name} argument is deprecated and will be removed "
            f"in version {self.changed_version}. To avoid this warning, "
            f"please do not use the {self.arg_name} argument. Please "
            f"see {func.__name__} documentation for more details.")
        if self.help_msg is not None:
            warning_msg += f" {self.help_msg}"

        @functools.wraps(func)
        def fixed_func(*args, **kwargs):
            if len(args) > arg_idx or self.arg_name in kwargs:
                warnings.warn(warning_msg, FutureWarning, stacklevel=2)
            return func(*args, **kwargs)

        return fixed_func


class deprecate_kwarg:
    """Decorator that renames deprecated keyword arguments, warning
    FutureWarning for each."""

    def __init__(self, kwarg_mapping, warning_msg=None,
                 removed_version=None):
        self.kwarg_mapping = kwarg_mapping
        if warning_msg is None:
            self.warning_msg = ("'{old_arg}' is a deprecated argument name "
                                "for `{func_name}`. ")
            if removed_version is not None:
                self.warning_msg += (
                    f"It will be removed in version {removed_version}. ")
            self.warning_msg += "Please use '{new_arg}' instead."
        else:
            self.warning_msg = warning_msg

    def __call__(self, func):
        @functools.wraps(func)
        def fixed_func(*args, **kwargs):
            for old_arg, new_arg in self.kwarg_mapping.items():
                if old_arg in kwargs:
                    warnings.warn(
                        self.warning_msg.format(old_arg=old_arg,
                                                func_name=func.__name__,
                                                new_arg=new_arg),
                        FutureWarning, stacklevel=2)
                    kwargs[new_arg] = kwargs.pop(old_arg)
            return func(*args, **kwargs)

        return fixed_func


class deprecated:
    """Decorator that marks a function deprecated: it warns
    ``skimage_deprecation`` (``behavior="warn"``) or raises it
    (``"raise"``)."""

    def __init__(self, alt_func=None, behavior="warn",
                 removed_version=None):
        self.alt_func = alt_func
        self.behavior = behavior
        self.removed_version = removed_version

    def __call__(self, func):
        alt_msg = ""
        if self.alt_func is not None:
            alt_msg = f" Use ``{self.alt_func}`` instead."
        rmv_msg = ""
        if self.removed_version is not None:
            rmv_msg = f" and will be removed in version {self.removed_version}"
        msg = f"Function ``{func.__name__}`` is deprecated{rmv_msg}.{alt_msg}"

        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            if self.behavior == "warn":
                func_code = func.__code__
                warnings.simplefilter("always", skimage_deprecation)
                warnings.warn_explicit(msg, category=skimage_deprecation,
                                       filename=func_code.co_filename,
                                       lineno=func_code.co_firstlineno + 1)
            elif self.behavior == "raise":
                raise skimage_deprecation(msg)
            return func(*args, **kwargs)

        doc = "**Deprecated function**." + alt_msg
        if wrapped.__doc__ is None:
            wrapped.__doc__ = doc
        else:
            wrapped.__doc__ = doc + "\n\n    " + wrapped.__doc__
        return wrapped


def get_bound_method_class(m):
    """The class of a bound method."""
    return m.im_class if sys.version < "3" else m.__self__.__class__


def check_random_state(seed):
    """A ``np.random.RandomState`` for ``seed``: None (or ``np.random``)
    gives numpy's global one, an int a new one, a RandomState itself."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError("%r cannot be used to seed a numpy.random.RandomState "
                     "instance" % seed)
