"""``view_as_blocks`` and ``view_as_windows`` (skimage.util.shape) on torch
tensors: views, as skimage's ``as_strided`` ones are (``reshape`` and
``permute`` for blocks of a contiguous tensor, ``Tensor.unfold`` per axis
for windows)."""

from __future__ import annotations

import numbers

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

__all__ = ["view_as_blocks", "view_as_windows"]


def view_as_blocks(arr_in, block_shape):
    """Non-overlapping blocks: shape ``(n0, ..., b0, ...)`` with ``n_i =
    shape_i // b_i``; ``block_shape`` a tuple that divides the shape."""
    if not isinstance(block_shape, tuple):
        raise TypeError("block needs to be a tuple")
    block_shape = np.array(block_shape)
    if (block_shape <= 0).any():
        raise ValueError("'block_shape' elements must be strictly positive")
    arr_in = util.as_tensor(arr_in)
    if block_shape.size != arr_in.ndim:
        raise ValueError(
            "'block_shape' must have the same length as 'arr_in.shape'")
    arr_shape = np.array(arr_in.shape)
    if (arr_shape % block_shape).sum() != 0:
        raise ValueError("'block_shape' is not compatible with 'arr_in'")
    n_blocks = arr_shape // block_shape
    # interleaved (n0, b0, n1, b1, ...), then the block axes last
    interleaved = []
    for n, b in zip(n_blocks, block_shape):
        interleaved += [int(n), int(b)]
    out = arr_in.reshape(interleaved)
    order = list(range(0, 2 * arr_in.ndim, 2)) + list(
        range(1, 2 * arr_in.ndim, 2))
    return out.permute(order)


def view_as_windows(arr_in, window_shape, step=1):
    """Rolling windows: shape ``(o0, ..., w0, ...)`` with ``o_i =
    (shape_i - w_i) // step_i + 1``; a view of ``arr_in``.  ``arr_in``
    must be a tensor or numpy array (lists raise TypeError)."""
    if not isinstance(arr_in, (np.ndarray, torch.Tensor)):
        raise TypeError("`arr_in` must be a numpy ndarray or a torch tensor")
    arr_in = util.as_tensor(arr_in)
    ndim = arr_in.ndim
    if isinstance(window_shape, numbers.Number):
        window_shape = (window_shape,) * ndim
    if not (len(window_shape) == ndim):
        raise ValueError("`window_shape` is incompatible with `arr_in.shape`")
    if isinstance(step, numbers.Number):
        if step < 1:
            raise ValueError("`step` must be >= 1")
        step = (step,) * ndim
    if len(step) != ndim:
        raise ValueError("`step` is incompatible with `arr_in.shape`")
    arr_shape = np.array(arr_in.shape)
    window_shape = np.array(window_shape, dtype=arr_shape.dtype)
    if ((arr_shape - window_shape) < 0).any():
        raise ValueError("`window_shape` is too large")
    if ((window_shape - 1) < 0).any():
        raise ValueError("`window_shape` is too small")
    out = arr_in
    # each unfold turns axis d into its window count and appends the
    # window's axis: (o0, ..., o_{n-1}, w0, ..., w_{n-1})
    for d in range(ndim):
        out = out.unfold(d, int(window_shape[d]), int(step[d]))
    return out
