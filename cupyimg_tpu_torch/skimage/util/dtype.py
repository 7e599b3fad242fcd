"""Image dtype conversions (skimage.util.dtype) on torch tensors.

Floats live in [0, 1] or [-1, 1]; integer rescaling replicates bits to
scale up exactly and floor-divides to scale down, as skimage's
``_convert``.  torch's uint16/uint32/uint64 have few kernels (no
arithmetic, clamp or division on the card), so every conversion computes
in int32/int64/float and casts to the requested type at the end; uint64
is handled as its bits in int64.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = [
    "img_as_float32",
    "img_as_float64",
    "img_as_float",
    "img_as_int",
    "img_as_uint",
    "img_as_ubyte",
    "img_as_bool",
    "dtype_limits",
    "dtype_range",
]

_integer_types = (
    np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
    np.int64, np.uint64,
)
dtype_range = {
    np.bool_: (False, True),
    np.float16: (-1, 1),
    np.float32: (-1, 1),
    np.float64: (-1, 1),
}
dtype_range.update({t: (np.iinfo(t).min, np.iinfo(t).max)
                    for t in _integer_types})
_supported_types = list(dtype_range.keys())


def _np_dtype(x):
    return dtypes.to_numpy(x.dtype) if isinstance(x, torch.Tensor) else (
        np.dtype(x.dtype))


def dtype_limits(image, clip_negative=False):
    """(min, max) intensity limits of the image's dtype."""
    imin, imax = dtype_range[_np_dtype(image).type]
    if clip_negative:
        imin = 0
    return imin, imax


def _dtype_itemsize(itemsize, *dtypes_):
    return next(dt for dt in dtypes_ if np.dtype(dt).itemsize >= itemsize)


def _dtype_bits(kind, bits, itemsize=1):
    s = next(
        i for i in (itemsize, 2, 4, 8)
        if bits < (i * 8) or (bits == (i * 8) and kind == "u")
    )
    return np.dtype(kind + str(s))


def _wide(np_dtype):
    """The signed torch type that integer arithmetic on ``np_dtype``'s
    values runs in (a uint64 value as its bits in int64)."""
    return torch.int64 if np_dtype.itemsize >= 4 else torch.int32


def _shift_down(a, s, as_uint64):
    """``a // 2**s`` for non-negative values (floor division for signed
    ones); ``as_uint64``: ``a`` holds uint64 bits, shifted logically."""
    out = torch.bitwise_right_shift(a, s)
    if as_uint64:
        out = out & ((1 << (64 - s)) - 1)
    return out


def _scale(a, n, m, kind, src, as_uint64=False):
    """Scale positive integers from n to m bits: exact upscale by bit
    replication, floor-divide downscale; ``a`` is in a wide signed type
    (:func:`_wide`) and the result stays in one.  ``src`` names the input
    dtype in the warning of a downcast without scaling."""
    if n == m:
        return a
    if n > m:
        # every value already fits in m bits: plain cast without scaling
        # and a warning (skimage's rule)
        if a.numel():
            if as_uint64 and bool((a < 0).any()):
                amax = 2 ** 64 - 1
            else:
                amax = int(a.max())
        else:
            amax = 0
        if amax < 2 ** m:
            mnew = math.ceil(m / 2) * 2
            # odd m rounds up to a signed name, even m keeps the unsigned
            name = "{}{}".format("int" if mnew > m else "uint", mnew)
            warnings.warn(
                f"Downcasting {src} to {name} without scaling because max "
                f"value {amax} fits in {name}", stacklevel=4)
            return a
        return _shift_down(a, n - m, as_uint64)
    wide = _wide(_dtype_bits(kind, m))
    if m % n == 0:
        # exact upscale to a multiple of n bits (where m is 64 the int64
        # product wraps to the uint64 bits)
        return a.to(wide) * ((2 ** m - 1) // (2 ** n - 1))
    # upscale to a multiple of n bits, then downscale with precision loss
    o = (m // n + 1) * n
    _dtype_bits(kind, o)  # raises where numpy has no such type, as skimage
    b = a.to(torch.int64) * ((2 ** o - 1) // (2 ** n - 1))
    return _shift_down(b, o - m, o == 64).to(wide)


def _finish(x, np_dtype):
    """``x`` (a wide signed integer tensor) cast to ``np_dtype``."""
    target = dtypes.to_torch(np_dtype)
    if target == torch.uint64:
        return x.to(torch.int64).view(torch.uint64)
    return x.to(target)


def _saturate(x, np_dtype):
    """Integral floats ``x`` cast to the integer ``np_dtype``, saturating
    at its limits (exactly: a float bound such as float32(2^31 - 1)
    rounds past the limit; NaN gives 0)."""
    info = np.iinfo(np_dtype)
    hi = x >= float(info.max)
    lo = x <= float(info.min)
    inside = torch.where(hi | lo | torch.isnan(x), 0, x)
    if np_dtype == np.uint64:
        # 2^63 and above do not fit int64: through its bits
        inside = torch.where(inside >= 2.0 ** 63, inside - 2.0 ** 64, inside)
        top = -1  # uint64's maximum in int64's bits
    else:
        top = int(info.max)
    ints = inside.to(torch.int64)
    ints = torch.where(hi, top, torch.where(lo, int(info.min), ints))
    return _finish(ints, np_dtype)


def _convert(image, dtype, force_copy=False, uniform=False):
    """Convert an image to ``dtype`` with skimage's scaling rules."""
    image = util.as_tensor(image)
    dtypeobj_in = dtypes.to_numpy(image.dtype)
    dtypeobj_out = dtypes.to_numpy(dtype) if isinstance(
        dtype, torch.dtype) else np.dtype(dtype)
    dtype_in = dtypeobj_in.type
    dtype_out = dtypeobj_out.type
    kind_in = dtypeobj_in.kind
    kind_out = dtypeobj_out.kind
    itemsize_in = dtypeobj_in.itemsize
    itemsize_out = dtypeobj_out.itemsize

    if dtype_in == dtype_out:
        return image.clone() if force_copy else image

    if not (dtype_in in _supported_types and dtype_out in _supported_types):
        raise ValueError(
            f"Can not convert from {dtypeobj_in} to {dtypeobj_out}.")

    if kind_in in "ui":
        imin_in = np.iinfo(dtype_in).min
        imax_in = np.iinfo(dtype_in).max
    if kind_out in "ui":
        imin_out = np.iinfo(dtype_out).min
        imax_out = np.iinfo(dtype_out).max
    as_uint64 = dtype_in == np.uint64
    wide_in = dtypes.widen_unsigned(image)

    # any -> binary
    if kind_out == "b":
        if kind_in == "f":
            return image > dtype_in(dtype_range[dtype_in][1] / 2)
        if as_uint64:  # above 2^63: the bits read negative, not int64 min
            return (wide_in < 0) & (wide_in != -2 ** 63)
        return wide_in > int(dtype_in(dtype_range[dtype_in][1] / 2))

    # binary -> any
    if kind_in == "b":
        if kind_out == "f":
            return image.to(dtypes.to_torch(dtypeobj_out))
        # uint64's maximum is int64's -1 in bits
        top = -1 if dtype_out == np.uint64 else dtype_range[dtype_out][1]
        return _finish(image.to(_wide(dtypeobj_out)) * int(top),
                       dtypeobj_out)

    # float -> any
    if kind_in == "f":
        if kind_out == "f":
            return image.to(dtypes.to_torch(dtypeobj_out))
        if image.numel():
            lo, hi = torch.aminmax(image)
            lo, hi = torch.stack([lo, hi]).tolist()
            if lo < -1.0 or hi > 1.0:
                raise ValueError(
                    "Images of type float must be between -1 and 1.")
        ct = dtypes.to_torch(_dtype_itemsize(itemsize_out, dtype_in,
                                             np.float32, np.float64))
        x = image.to(ct)

        def c(v):  # a factor rounded to ct first, as numpy's weak scalars
            return torch.tensor(v, dtype=ct, device=x.device)

        if not uniform:
            if kind_out == "u":
                image_out = x * c(imax_out)
            else:
                image_out = x * c((imax_out - imin_out) / 2) - c(0.5)
            image_out = torch.round(image_out)  # half to even, as rint
        elif kind_out == "u":
            image_out = x * c(imax_out + 1)
        else:
            image_out = torch.floor(x * c((imax_out - imin_out + 1.0) / 2.0))
        return _saturate(image_out, dtypeobj_out)

    # signed/unsigned int -> float
    if kind_out == "f":
        ct = dtypes.to_torch(_dtype_itemsize(itemsize_in, dtype_out,
                                             np.float32, np.float64))
        if as_uint64:
            # the two 32-bit halves are exact in float64: one rounding,
            # as numpy's conversion
            hi = torch.bitwise_right_shift(wide_in, 32) & 0xFFFFFFFF
            x = (hi.to(torch.float64) * 2.0 ** 32
                 + (wide_in & 0xFFFFFFFF).to(torch.float64)).to(ct)
        else:
            x = wide_in.to(ct)
        # the factors rounded to ct first, as numpy's weak scalars
        if kind_in == "u":
            x = x * torch.tensor(1.0 / imax_in, dtype=ct, device=x.device)
        else:
            x = (x + torch.tensor(0.5, dtype=ct, device=x.device)) * (
                torch.tensor(2 / (imax_in - imin_in), dtype=ct,
                             device=x.device))
        return x.to(dtypes.to_torch(dtypeobj_out))

    # unsigned int -> signed/unsigned int
    if kind_in == "u":
        if kind_out == "i":
            x = _scale(wide_in, 8 * itemsize_in, 8 * itemsize_out - 1, "u",
                       dtypeobj_in, as_uint64)
            return _finish(x, dtypeobj_out)
        return _finish(_scale(wide_in, 8 * itemsize_in, 8 * itemsize_out,
                              "u", dtypeobj_in, as_uint64), dtypeobj_out)

    # signed int -> unsigned int
    if kind_out == "u":
        x = _scale(wide_in, 8 * itemsize_in - 1, 8 * itemsize_out, "i",
                   dtypeobj_in)
        return _finish(torch.clamp_min(x, 0), dtypeobj_out)

    # signed int -> signed int
    if itemsize_in > itemsize_out:
        return _finish(_scale(wide_in, 8 * itemsize_in - 1,
                              8 * itemsize_out - 1, "i", dtypeobj_in),
                       dtypeobj_out)
    _dtype_bits("i", itemsize_out * 8)  # raises as skimage for int64
    x = wide_in.to(torch.int64) - imin_in
    x = _scale(x, 8 * itemsize_in, 8 * itemsize_out, "i", dtypeobj_in)
    return _finish(x.to(torch.int64) + imin_out, dtypeobj_out)


def img_as_float32(image, force_copy=False):
    """Convert to float32 (skimage.img_as_float32)."""
    return _convert(image, np.float32, force_copy)


def img_as_float64(image, force_copy=False):
    """Convert to float64 (skimage.img_as_float64)."""
    return _convert(image, np.float64, force_copy)


def img_as_float(image, force_copy=False):
    """Convert to floating point; float inputs keep their dtype
    (skimage.img_as_float)."""
    image = util.as_tensor(image)
    if image.is_floating_point():
        return image.clone() if force_copy else image
    return _convert(image, np.float64, force_copy)


def img_as_uint(image, force_copy=False):
    """Convert to uint16 (skimage.img_as_uint)."""
    return _convert(image, np.uint16, force_copy)


def img_as_int(image, force_copy=False):
    """Convert to int16 (skimage.img_as_int)."""
    return _convert(image, np.int16, force_copy)


def img_as_ubyte(image, force_copy=False):
    """Convert to uint8 (skimage.img_as_ubyte)."""
    return _convert(image, np.uint8, force_copy)


def img_as_bool(image, force_copy=False):
    """Convert to bool (skimage.img_as_bool)."""
    return _convert(image, np.bool_, force_copy)


def convert(image, dtype, force_copy=False, uniform=False):
    """Deprecated public alias of the range converter (skimage's
    ``convert``): warns FutureWarning, then :func:`_convert`."""
    warnings.warn(
        "The use of this function is discouraged as its behavior may "
        "change dramatically in scikit-image 1.0. This function will be "
        "removed in scikit-image 1.0.",
        FutureWarning,
        stacklevel=2,
    )
    return _convert(image=image, dtype=dtype, force_copy=force_copy,
                    uniform=uniform)
