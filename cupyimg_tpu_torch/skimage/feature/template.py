"""``match_template`` (skimage.feature) on torch tensors: normalized
cross-correlation.  The numerator is ``signal.fftconvolve`` of the padded
image with the flipped template (for CUDA float32 data the FFT kernel's
real-product route); the window sums and sums of squares are differences
of cumulative sums."""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, util
from cupyimg_tpu_torch.scipy.signal import fftconvolve
from cupyimg_tpu_torch.scipy.signal.signaltools import _median_keepdims
from .._shared.utils import NUMPY_PAD_TO_NDIMAGE, check_nD

__all__ = ["match_template"]

_STATS = {
    "maximum": lambda x, axis: torch.amax(x, dim=axis, keepdim=True),
    "minimum": lambda x, axis: torch.amin(x, dim=axis, keepdim=True),
    "mean": lambda x, axis: torch.mean(x, dim=axis, keepdim=True),
    "median": _median_keepdims,
}


def _pad(x, pad_width, mode, constant_values):
    """``numpy.pad(x, pad_width, mode)`` of a floating ``x`` as jnp.pad
    computes it, on ``x``'s device.  The reflections, 'edge' and
    'constant' are ``boundary.pad``'s.  The others go axis by axis over
    the array padded so far: 'maximum', 'minimum', 'mean' and 'median'
    repeat the statistic of the whole axis, 'linear_ramp' ramps from 0 to
    the edge value, 'empty' pads with zeros.  A callable ``mode`` is
    given each 1-D row of the zero-padded array, along each axis in turn,
    as ``mode(row, (before, after), axis, {})``, and returns it (or
    fills it in place, as numpy's convention has it).  Any other name
    raises NotImplementedError, as jnp.pad does."""
    if mode in NUMPY_PAD_TO_NDIMAGE:
        return boundary.pad(x, pad_width, NUMPY_PAD_TO_NDIMAGE[mode],
                            constant_values if mode == "constant" else 0.0)
    if callable(mode):
        x = boundary.pad(x, pad_width, "constant", 0.0)
        for axis, width in enumerate(pad_width):
            rows = x.movedim(axis, -1)
            out = []
            for row in rows.reshape(-1, rows.shape[-1]).clone():
                ret = mode(row, tuple(width), axis, {})
                out.append(row if ret is None else torch.as_tensor(
                    ret, dtype=x.dtype, device=x.device))
            x = torch.stack(out).reshape(rows.shape).movedim(-1, axis)
        return x
    if mode not in _STATS and mode not in ("linear_ramp", "empty"):
        raise NotImplementedError(
            f"Unimplemented padding mode '{mode}' for np.pad.")
    for axis, (lo, hi) in enumerate(pad_width):
        n = x.shape[axis]
        if mode == "empty":
            shape = list(x.shape)
            shape[axis] = lo
            before = x.new_zeros(shape)
            shape[axis] = hi
            after = x.new_zeros(shape)
        elif mode == "linear_ramp":
            shape = [1] * x.ndim
            ramps = []
            for width, edge in ((lo, x.narrow(axis, 0, 1)),
                                (hi, x.narrow(axis, n - 1, 1))):
                shape[axis] = width
                t = torch.arange(width, dtype=x.dtype, device=x.device)
                ramps.append(edge * (t / width).reshape(shape))
            before, after = ramps[0], torch.flip(ramps[1], (axis,))
        else:
            stat = _STATS[mode](x, axis)
            before = stat.repeat_interleave(lo, axis)
            after = stat.repeat_interleave(hi, axis)
        x = torch.cat([before, x, after], axis)
    return x


def _window_sum(image, window_shape):
    """Sums over every window of ``window_shape`` that lies one sample
    inside the array along each axis."""
    for axis, w in enumerate(window_shape):
        s = torch.cumsum(image, dim=axis)
        n = s.shape[axis]
        image = s.narrow(axis, w, n - w - 1) - s.narrow(axis, 0, n - w - 1)
    return image


def match_template(
    image, template, pad_input=False, mode="constant",
    constant_values=0,
):
    """Normalized cross-correlation of ``template`` over ``image`` (2-D or
    3-D), in [-1, 1]; 0 where the window has no variance.  ``mode`` is
    any of numpy.pad's modes (see :func:`_pad`)."""
    image = util.as_tensor(image)
    template = util.as_tensor(template, device=image.device)
    check_nD(image, (2, 3))

    if image.ndim < template.ndim:
        raise ValueError(
            "Dimensionality of template must be less than or "
            "equal to the dimensionality of image."
        )
    if any(si < st for si, st in zip(image.shape, template.shape)):
        raise ValueError("Image must be larger than template.")

    image_shape = tuple(image.shape)

    float_dtype = torch.promote_types(image.dtype, torch.float32)
    image = image.to(float_dtype)
    template = template.to(float_dtype)

    pad_width = [(width, width) for width in template.shape]
    image = _pad(image, pad_width, mode, constant_values)

    image_window_sum = _window_sum(image, template.shape)
    image_window_sum2 = _window_sum(image * image, template.shape)

    template_mean = template.mean()
    template_volume = math.prod(template.shape)
    template_ssd = torch.sum((template - template_mean) ** 2)

    trim = (slice(1, -1),) * image.ndim
    xcorr = fftconvolve(image, torch.flip(template, tuple(range(
        template.ndim))), mode="valid")[trim]

    numerator = xcorr - image_window_sum * template_mean

    denominator = (
        image_window_sum2
        - image_window_sum * image_window_sum / template_volume
    ) * template_ssd
    denominator = torch.sqrt(torch.clamp(denominator, min=0))

    # no division by zero
    valid = denominator > np.finfo(np.float64).eps
    response = torch.where(
        valid, numerator / torch.where(valid, denominator,
                                       torch.ones_like(denominator)),
        torch.zeros_like(numerator))

    slices = []
    for i in range(template.ndim):
        if pad_input:
            d0 = (template.shape[i] - 1) // 2
            d1 = d0 + image_shape[i]
        else:
            d0 = template.shape[i] - 1
            d1 = d0 + image_shape[i] - template.shape[i] + 1
        slices.append(slice(d0, d1))

    return response[tuple(slices)]
