"""``block_reduce`` (skimage.measure) on torch tensors: pad to a multiple
of the block size, view as blocks, reduce over the block axes."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, dtypes, util
from cupyimg_tpu_torch.skimage.util.shape import view_as_blocks

__all__ = ["block_reduce"]


def block_reduce(image, block_size, func=torch.sum, cval=0, func_kwargs=None):
    """Downsample by applying ``func`` to local blocks (skimage parity).

    ``func`` is called as ``func(blocks, axis=block_axes, **func_kwargs)``
    with the block axes last (``torch.sum``, ``torch.mean``,
    ``torch.amax``, ...).  The image is padded at its end with ``cval``
    (cast to its dtype) up to a multiple of ``block_size``.  uint16/32/64
    data are reduced in the signed type that holds them (torch has few
    kernels for them); a reduction that keeps that type (min, max) is
    cast back.
    """
    image = util.as_tensor(image)
    if np.isscalar(block_size):
        block_size = (int(block_size),) * image.ndim
    if len(block_size) != image.ndim:
        raise ValueError(
            "`block_size` must have the same length as `image.shape`.")
    if func_kwargs is None:
        func_kwargs = {}
    padded_shape = []
    for b, s in zip(block_size, image.shape):
        if b < 1:
            raise ValueError(
                "Down-sampling factors must be >= 1. Use "
                "`skimage.transform.resize` to up-sample an image.")
        padded_shape.append(s + (-s) % b)
    orig_dtype = image.dtype
    image = dtypes.widen_unsigned(image)
    if list(padded_shape) != list(image.shape):
        fill = boundary.fill_value(cval, orig_dtype)
        padded = torch.full(padded_shape, fill, dtype=image.dtype,
                            device=image.device)
        padded[tuple(slice(0, s) for s in image.shape)] = image
        image = padded
    blocked = view_as_blocks(image, tuple(int(b) for b in block_size))
    out = func(blocked, axis=tuple(range(image.ndim, blocked.ndim)),
               **func_kwargs)
    if image.dtype != orig_dtype and out.dtype == image.dtype:
        out = out.to(orig_dtype)
    return out
