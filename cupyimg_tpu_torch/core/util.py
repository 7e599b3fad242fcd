"""Shared argument-normalization utilities and input conversion."""

from __future__ import annotations

import operator

import numpy as np
import torch

from cupyimg_tpu_torch.core.config import config


class PerformanceWarning(Warning):
    """Warns about paths known to be slow on the device."""


def as_tensor(x, device=None):
    """The port's tensor for ``x``.

    A tensor keeps its device unless ``device`` is given.  Anything else
    (numpy array, list, scalar) goes to ``device`` or ``config.device``
    (``"cuda"`` by default).  Raises if that is a CUDA device and CUDA is
    missing: the library never moves a call to the CPU on its own.
    """
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cupyimg_tpu_torch: CUDA is not available; pass CPU tensors or "
            "set cupyimg_tpu_torch.config.device = 'cpu'"
        )
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


def fix_sequence_arg(arg, ndim: int, name: str, conv=lambda x: x):
    """Broadcast a scalar arg to a length-``ndim`` list."""
    if isinstance(arg, str):
        return [conv(arg)] * ndim
    try:
        arg = iter(arg)
    except TypeError:
        return [conv(arg)] * ndim
    lst = [conv(x) for x in arg]
    if len(lst) != ndim:
        raise RuntimeError(f"{name} must have length equal to input rank")
    return lst


def check_origin(origin, width: int) -> int:
    """Validate a filter origin against the footprint width."""
    origin = int(origin)
    if (width // 2 + origin < 0) or (width // 2 + origin >= width):
        raise ValueError("invalid origin")
    return origin


def check_axis(axis: int, rank: int) -> int:
    """Normalize a (possibly negative) axis index."""
    axis = operator.index(axis)
    if axis < 0:
        axis += rank
    if axis < 0 or axis >= rank:
        raise ValueError("invalid axis")
    return axis


def normalize_axis_index(ax: int, ndim: int) -> int:
    if ax < -ndim or ax >= ndim:
        raise np.exceptions.AxisError(ax, ndim)
    return ax % ndim


def check_cval(mode: str, cval, integer_output: bool):
    if mode == "constant" and integer_output and not np.isfinite(cval):
        raise NotImplementedError(
            "Non-finite cval is not supported for outputs with integer dtype."
        )


def check_axes(axes, ndim: int):
    """Normalize scipy's ``axes`` argument: None -> all axes, scalar ->
    1-tuple; negative axes wrap; duplicates rejected."""
    if axes is None:
        return tuple(range(ndim))
    if np.isscalar(axes):
        axes = (axes,)
    axes = tuple(check_axis(int(a), ndim) for a in axes)
    if len(set(axes)) != len(axes):
        raise ValueError("axes must be unique")
    return axes


def expand_axes_arg(arg, axes, ndim: int, name: str, default, conv):
    """Per-axis argument given over ``axes`` -> full-ndim list with
    ``default`` on excluded axes."""
    vals = fix_sequence_arg(arg, len(axes), name, conv)
    out = [default] * ndim
    for a, v in zip(axes, vals):
        out[a] = v
    return out
