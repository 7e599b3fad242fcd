"""Integral images (skimage.transform.integral) on torch tensors.

torch has no cumulative sum of unsigned types beyond uint8's promotion,
and no uint64 arithmetic on the card, so the integral of an unsigned or
bool image is int64 (skimage and cupyimg_tpu: uint64, the same values
below 2^63); signed integers accumulate in int64 and floats in float64.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = ["integral_image", "integrate"]


def integral_image(image, *, dtype=None):
    """Cumulative sum of the image over every axis.  The default type is
    float64 for floating images and int64 for integer and bool ones
    (int64 and wider floats keep theirs)."""
    image = util.as_tensor(image)
    if dtype is not None:
        dtype = dtypes.to_torch(dtype)
    elif image.is_floating_point():
        dtype = torch.promote_types(image.dtype, torch.float64)
    elif not image.is_complex():
        dtype = torch.int64
    S = dtypes.widen_unsigned(image)
    for i in range(image.ndim):
        S = torch.cumsum(S, dim=i, dtype=dtype)
    return S


def integrate(ii, start, end):
    """Sums over windows by the integral image ``ii``: ``start`` and
    ``end`` are coordinate tuples (or lists of them), inclusive, negative
    values counted from the end.  One (len(start),) tensor in ``ii``'s
    dtype on its device; the index arithmetic is host numpy."""
    ii = util.as_tensor(ii)
    start = np.atleast_2d(np.array(start))
    end = np.atleast_2d(np.array(end))
    rows = start.shape[0]
    total_shape = np.asarray(ii.shape)
    start = start + total_shape * (start < 0)
    end = end + total_shape * (end < 0)

    if np.any((end - start) < 0):
        raise IndexError("end coordinates must be greater or equal to start")
    bad = np.any(end >= total_shape, axis=1) | np.any(start < 0, axis=1)
    if np.any(bad):
        raise IndexError("window coordinates are outside the image")

    S = torch.zeros(rows, dtype=ii.dtype, device=ii.device)
    ndim = ii.ndim
    # inclusion-exclusion over the 2^ndim corners of each window
    for bits in itertools.product((0, 1), repeat=ndim):
        corner = []
        sign = (-1) ** (ndim - sum(bits))
        valid = np.ones(rows, dtype=bool)
        for d, b in enumerate(bits):
            if b:
                corner.append(end[:, d])
            else:
                corner.append(start[:, d] - 1)
                valid &= start[:, d] > 0
        if not valid.any():
            continue
        idx = tuple(torch.as_tensor(np.clip(c, 0, ii.shape[d] - 1),
                                    device=ii.device)
                    for d, c in enumerate(corner))
        vals = ii[idx]
        keep = torch.as_tensor(valid, device=ii.device)
        S = S + sign * torch.where(keep, vals, torch.zeros_like(vals))
    return S
