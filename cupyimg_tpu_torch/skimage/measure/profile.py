"""``profile_line`` (skimage.measure) on torch tensors.

The scan line's sample grid is built in closed form and sampled with one
``ndi.map_coordinates`` call per channel: on a CUDA float32 image that is
one launch of the spline gather kernel, and for ``order > 1`` one launch
of the fused separable kernel per prefilter pole before it.
"""

from __future__ import annotations

import math
from warnings import warn

import torch

from cupyimg_tpu_torch import numpy as tnp
from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from .._shared.utils import _validate_interpolation_order

__all__ = ["profile_line"]


def profile_line(
    image,
    src,
    dst,
    linewidth=1,
    order=None,
    mode=None,
    cval=0.0,
    *,
    reduce_func=torch.mean,
):
    """Intensity profile of an image along a scan line from ``src`` to
    ``dst`` (both included), sampled ``linewidth`` pixels wide and
    reduced across the width by ``reduce_func`` (skimage parity).

    ``reduce_func`` is called as ``reduce_func(pixels, axis=1)``; a
    function that takes no ``axis`` runs on each row through
    ``numpy.apply_along_axis``; ``None`` returns the samples
    ``(length, linewidth[, channels])``.  ``torch.mean`` of integer
    samples is taken in float64, as numpy's.
    """
    image = util.as_tensor(image)
    order = _validate_interpolation_order(image.dtype, order)

    if mode is None:
        warn(
            "Default out of bounds interpolation mode 'constant' is "
            "deprecated. In version 0.19 it will be set to 'reflect'. "
            "To avoid this warning, set `mode=` explicitly.",
            FutureWarning,
            stacklevel=2,
        )
        mode = "constant"

    perp_lines = _line_profile_coordinates(src, dst, linewidth=linewidth,
                                           device=image.device)
    if image.ndim == 3:
        pixels = [
            ndi.map_coordinates(
                image[..., i],
                perp_lines,
                prefilter=order > 1,
                order=order,
                mode=mode,
                cval=cval,
            )
            for i in range(image.shape[2])
        ]
        pixels = torch.stack(pixels, dim=-1)
    else:
        pixels = ndi.map_coordinates(
            image,
            perp_lines,
            prefilter=order > 1,
            order=order,
            mode=mode,
            cval=cval,
        )
    # the rows across the line run the other way round in skimage
    pixels = torch.flip(pixels, dims=(1,))

    if reduce_func is None:
        return pixels
    if reduce_func in (torch.mean, torch.nanmean) and not (
            pixels.is_floating_point() or pixels.is_complex()):
        pixels = pixels.to(torch.float64)
    try:
        return reduce_func(pixels, axis=1)
    except TypeError:  # the function takes no axis argument
        return tnp.apply_along_axis(reduce_func, arr=pixels, axis=1)


def _line_profile_coordinates(src, dst, linewidth=1, device=None):
    """The scan line's sample coordinates, float64 ``(2, N, linewidth)``:
    ``N = ceil(|dst - src| + 1)`` points along the line, ``linewidth``
    across it."""
    src_row, src_col = (float(v) for v in src)
    dst_row, dst_col = (float(v) for v in dst)
    d_row = dst_row - src_row
    d_col = dst_col - src_col
    theta = math.atan2(d_row, d_col)

    length = int(math.ceil(math.hypot(d_row, d_col) + 1))
    f64 = dict(dtype=torch.float64, device=device)
    line_col = torch.linspace(src_col, dst_col, length, **f64)
    line_row = torch.linspace(src_row, dst_row, length, **f64)

    # linewidth - 1: from pixel counts to distances between centres
    col_width = (linewidth - 1) * math.sin(-theta) / 2
    row_width = (linewidth - 1) * math.cos(theta) / 2
    frac = (torch.linspace(-1.0, 1.0, linewidth, **f64) if linewidth > 1
            else torch.zeros(1, **f64))
    perp_rows = line_row[:, None] + frac[None, :] * row_width
    perp_cols = line_col[:, None] + frac[None, :] * col_width
    return torch.stack([perp_rows, perp_cols])
