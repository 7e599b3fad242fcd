"""Intensity and histogram operations (skimage.exposure) on torch
tensors.

An integer image's histogram has one bin per integer value: one
``bincount`` after widening (torch's uint16/32 lack kernels); a float
image's uses the port's ``numpy.histogram``.  ``_interp`` is numpy's
``interp`` (a ``searchsorted`` and a lerp, numpy's edge rules), used by
``equalize_hist`` and ``match_histograms``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from cupyimg_tpu_torch import numpy as tnp
from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.skimage.util.dtype import dtype_limits, dtype_range

__all__ = [
    "histogram",
    "equalize_hist",
    "rescale_intensity",
    "cumulative_distribution",
    "adjust_gamma",
    "adjust_log",
    "adjust_sigmoid",
    "is_low_contrast",
]

_F64 = torch.float64


def _np_dtype(image):
    return dtypes.to_numpy(image.dtype)


def _extrema(image):
    """``(min, max)`` of an image as host numbers (one sync)."""
    lo, hi = torch.aminmax(dtypes.widen_unsigned(image))
    return lo.item(), hi.item()


def _interp(x, xp, fp):
    """numpy.interp in float64: ``fp[0]`` left of ``xp[0]``, ``fp[-1]`` at
    and right of ``xp[-1]``, else ``slope * (x - xp[j]) + fp[j]`` with
    ``xp[j] <= x < xp[j + 1]`` (``fp[j]`` where ``x`` hits ``xp[j]``)."""
    x = x.to(_F64)
    xp = xp.to(_F64).contiguous()
    fp = fp.to(_F64)
    n = xp.numel()
    if n == 1:
        return torch.full_like(x, fp[0].item())
    j = (torch.searchsorted(xp, x, right=True) - 1).clamp(0, n - 2)
    x0 = xp[j]
    f0 = fp[j]
    slope = (fp[j + 1] - f0) / (xp[j + 1] - x0)
    res = torch.where(x == x0, f0, slope * (x - x0) + f0)
    res = torch.where(x < xp[0], fp[0], res)
    return torch.where(x >= xp[-1], fp[-1], res)


def _offset_array(arr, low_boundary, high_boundary):
    """Offset the array so the lowest value is 0 (for int bincount)."""
    if low_boundary < 0:
        offset = low_boundary
        arr = arr - offset
    else:
        offset = 0
    return arr, offset


def _bincount_histogram(image, source_range):
    """Integer-image histogram with one bin per integer."""
    image_np_min, image_np_max = _extrema(image)
    if source_range == "image":
        image_min = image_np_min
        image_max = image_np_max
    elif source_range == "dtype":
        image_min, image_max = dtype_limits(image, clip_negative=False)
    else:
        raise ValueError("Incorrect value for `source_range` argument")
    # widened before the offset: int8 shifted by +128 would wrap
    image, offset = _offset_array(
        dtypes.widen_unsigned(image).reshape(-1).to(torch.int64),
        image_min, image_max)
    length = int(image_max - image_min + 1)
    hist = torch.bincount(
        torch.clamp(image - (image_min - offset), 0, length - 1),
        minlength=length,
    )
    bin_centers = torch.arange(image_min, image_max + 1, device=hist.device)
    return hist, bin_centers


def histogram(image, nbins=256, source_range="image", normalize=False):
    """Histogram of an image: integer dtypes get one bin per integer value
    (int64 counts), floats ``nbins`` bins over the image's or the dtype's
    range; a channel axis is not treated specially."""
    image = util.as_tensor(image)
    sh = image.shape
    if len(sh) == 3 and sh[-1] < 4:
        warnings.warn(
            "This might be a color image. The histogram will be "
            "computed on the flattened image. You can instead "
            "apply this function to each color channel."
        )
    if _np_dtype(image).kind in "iu":
        hist, bin_centers = _bincount_histogram(image, source_range)
    else:
        flat = image.reshape(-1)
        if source_range == "image":
            hist_range = _extrema(flat)
        elif source_range == "dtype":
            hist_range = dtype_limits(image, clip_negative=False)
        else:
            raise ValueError("Incorrect value for `source_range` argument")
        hist, bin_edges = tnp.histogram(flat, bins=nbins, range=hist_range)
        bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2.0
    if normalize:
        hist = hist.to(_F64) / torch.sum(hist)
    return hist, bin_centers


def cumulative_distribution(image, nbins=256):
    """The normalized cumulative histogram of an image (float64) and its
    bin centres."""
    hist, bin_centers = histogram(image, nbins)
    img_cdf = torch.cumsum(hist, dim=0).to(_F64)
    img_cdf = img_cdf / img_cdf[-1]
    return img_cdf, bin_centers


def equalize_hist(image, nbins=256, mask=None):
    """Histogram equalization (float64 in [0, 1]); with ``mask`` the
    histogram counts only the pixels under it (selected on the
    device)."""
    image = util.as_tensor(image)
    if mask is not None:
        mask = util.as_tensor(mask, device=image.device).to(torch.bool)
        cdf, bin_centers = cumulative_distribution(
            image.reshape(-1)[mask.reshape(-1)], nbins)
    else:
        cdf, bin_centers = cumulative_distribution(image, nbins)
    out = _interp(image.reshape(-1), bin_centers, cdf)
    return out.reshape(image.shape)


DTYPE_RANGE = {np.dtype(k).name: v for k, v in dtype_range.items()}
DTYPE_RANGE.update({"uint10": (0, 2 ** 10 - 1), "uint12": (0, 2 ** 12 - 1),
                    "uint14": (0, 2 ** 14 - 1), "bool": dtype_range[np.bool_],
                    "float": dtype_range[np.float64]})


def intensity_range(image, range_values="image", clip_negative=False):
    """The ``(min, max)`` intensity of 'image' (its extremes), 'dtype',
    a dtype's name (uint10/12/14 included) or type, or an explicit
    pair."""
    if range_values == "dtype":
        range_values = _np_dtype(image).type
    if range_values == "image":
        i_min, i_max = _extrema(image)
    elif isinstance(range_values, str) and range_values in DTYPE_RANGE:
        i_min, i_max = DTYPE_RANGE[range_values]
        if clip_negative:
            i_min = 0
    elif range_values in dtype_range:
        i_min, i_max = dtype_range[range_values]
        if clip_negative:
            i_min = 0
    else:
        i_min, i_max = range_values
    return i_min, i_max


def _output_dtype(dtype_or_range):
    """The output dtype for ``out_range``: a pair of values gives
    float64, a named range uint10/12/14 gives uint16; a bad string
    raises."""
    if isinstance(dtype_or_range, (list, tuple, np.ndarray)):
        return np.float64
    if isinstance(dtype_or_range, type):
        return dtype_or_range
    if dtype_or_range in DTYPE_RANGE:
        try:
            return np.dtype(dtype_or_range).type
        except TypeError:  # uint10 / uint12 / uint14
            return np.uint16
    raise ValueError(
        "Incorrect value for out_range, should be a valid image data type "
        f"or a pair of values, got {dtype_or_range}."
    )


def rescale_intensity(image, in_range="image", out_range="dtype"):
    """Stretch or shrink the intensity range, in float64, cast to the
    output dtype by truncation as skimage's ``np.asarray``."""
    image = util.as_tensor(image)
    if isinstance(out_range, str) and out_range in ("dtype", "image"):
        out_dtype = _output_dtype(_np_dtype(image).type)
    else:
        out_dtype = _output_dtype(out_range)
    imin, imax = (float(v) for v in intensity_range(image, in_range))
    omin, omax = (
        float(v)
        for v in intensity_range(
            image, out_range, clip_negative=(imin >= 0)
        )
    )
    if np.any(np.isnan([imin, imax, omin, omax])):
        warnings.warn(
            "One or more intensity levels are NaN. Rescaling will "
            "broadcast NaN to the full image. Provide intensity levels "
            "yourself to avoid this. E.g. with np.nanmin(image), "
            "np.nanmax(image).",
            stacklevel=2,
        )
    image = dtypes.widen_unsigned(image).to(_F64)
    image = torch.clamp(image, imin, imax)
    if imin != imax:
        image = (image - imin) / (imax - imin)
        out = image * (omax - omin) + omin
    else:
        out = torch.clamp(image, omin, omax)
    return out.to(dtypes.to_torch(np.dtype(out_dtype)))


def _assert_non_negative(image):
    if bool(torch.any(dtypes.widen_unsigned(image) < 0)):
        raise ValueError(
            "Image Correction methods work correctly only on images with "
            "non-negative values. Use skimage.exposure.rescale_intensity."
        )


def _scale(image):
    lo, hi = dtype_limits(image, True)
    return float(hi - lo)


def _as_float(image):
    """Integers in float64 (numpy's true division), floats as they
    are."""
    if image.is_floating_point():
        return image
    return dtypes.widen_unsigned(image).to(_F64)


def adjust_gamma(image, gamma=1, gain=1):
    """Gamma correction ``gain * image ** gamma`` (integers through
    [0, 1])."""
    image = util.as_tensor(image)
    _assert_non_negative(image)
    if gamma < 0:
        raise ValueError("Gamma should be a non-negative real number.")
    dtype = image.dtype
    if not image.is_floating_point():
        scale = _scale(image)
        out = ((_as_float(image) / scale) ** gamma) * scale * gain
        return out.to(dtype)
    return ((image ** gamma) * gain).to(dtype)


def adjust_log(image, gain=1, inv=False):
    """Logarithmic correction ``gain * log2(1 + image)`` (or its inverse
    ``gain * (2 ** image - 1)``), through [0, 1]."""
    image = util.as_tensor(image)
    _assert_non_negative(image)
    scale = _scale(image)
    norm = _as_float(image) / scale
    if inv:
        out = (2 ** norm - 1) * scale * gain
    else:
        out = torch.log2(1 + norm) * scale * gain
    return out.to(image.dtype)


def adjust_sigmoid(image, cutoff=0.5, gain=10, inv=False):
    """Sigmoid correction ``1 / (1 + exp(gain * (cutoff - image)))``,
    through [0, 1]."""
    image = util.as_tensor(image)
    scale = _scale(image)
    norm = _as_float(image) / scale
    sig = 1 / (1 + torch.exp(gain * (cutoff - norm)))
    if inv:
        sig = 1 - sig
    return (sig * scale).to(image.dtype)


def is_low_contrast(
    image, fraction_threshold=0.05, lower_percentile=1, upper_percentile=99,
    method="linear",
):
    """True if the span between the two percentiles is below
    ``fraction_threshold`` of the dtype's range (RGB(A) images through
    grey)."""
    image = util.as_tensor(image)
    if image.ndim == 3 and image.shape[2] in (3, 4):
        from cupyimg_tpu_torch.skimage.color.colorconv import (
            rgb2gray,
            rgba2rgb,
        )

        if image.shape[2] == 4:
            image = rgba2rgb(image)
        image = rgb2gray(image)
    dlimits = dtype_limits(image, clip_negative=False)
    q = np.array([lower_percentile, upper_percentile], np.float64) / 100
    limits = tnp.quantile(dtypes.widen_unsigned(image), q).tolist()
    ratio = (limits[1] - limits[0]) / (dlimits[1] - dlimits[0])
    return bool(ratio < fraction_threshold)
