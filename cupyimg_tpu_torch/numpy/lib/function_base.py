"""N-d ``gradient`` with numpy's semantics (numpy.gradient) on torch
tensors: second-order central differences inside, one-sided first- or
second-order differences at the edges (``edge_order``), per-axis scalar
or 1-d spacing, axis tuples and numpy's error classes; slice arithmetic,
a few elementwise passes per axis."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

__all__ = ["gradient"]


def _ndim(d):
    return d.ndim if hasattr(d, "ndim") else np.ndim(d)


def _gradient_along_axis(f, distances, axis, edge_order):
    """One axis of the gradient: the 3-tap interior stencil and the edge
    stencils, rounded to ``f``'s dtype."""
    n = f.shape[axis]

    def sl(start, stop):
        return f.narrow(axis, start, stop - start)

    uniform = distances is None or _ndim(distances) == 0
    if uniform:
        dx = 1.0 if distances is None else distances
        if isinstance(dx, torch.Tensor):
            dx = dx.item()
        interior = (sl(2, n) - sl(0, n - 2)) / (2.0 * dx)
    else:
        shape = [1] * f.ndim
        shape[axis] = n - 1
        # numpy's precision: the differences and coefficients in the
        # spacing's float type (float64 for integers), one rounding to
        # f's dtype at the end
        d = distances.to(f.device)
        if not d.is_floating_point():
            d = d.to(torch.float64)
        dxs = torch.diff(d.to(torch.promote_types(d.dtype, f.dtype))
                         ).reshape(shape)
        dx1 = dxs.narrow(axis, 0, n - 2)
        dx2 = dxs.narrow(axis, 1, n - 2)
        a = -dx2 / (dx1 * (dx1 + dx2))
        b = (dx2 - dx1) / (dx1 * dx2)
        c = dx1 / (dx2 * (dx1 + dx2))
        interior = a * sl(0, n - 2) + b * sl(1, n - 1) + c * sl(2, n)

    if edge_order == 1:
        if uniform:
            first = (sl(1, 2) - sl(0, 1)) / dx
            last = (sl(n - 1, n) - sl(n - 2, n - 1)) / dx
        else:
            first = (sl(1, 2) - sl(0, 1)) / dxs.narrow(axis, 0, 1)
            last = (sl(n - 1, n) - sl(n - 2, n - 1)) / dxs.narrow(
                axis, n - 2, 1)
    else:
        if uniform:
            dx1f = dx2f = dx1l = dx2l = dx
        else:
            dx1f = dxs.narrow(axis, 0, 1)
            dx2f = dxs.narrow(axis, 1, 1)
            dx1l = dxs.narrow(axis, n - 3, 1)
            dx2l = dxs.narrow(axis, n - 2, 1)
        a = -(2.0 * dx1f + dx2f) / (dx1f * (dx1f + dx2f))
        b = (dx1f + dx2f) / (dx1f * dx2f)
        c = -dx1f / (dx2f * (dx1f + dx2f))
        first = a * sl(0, 1) + b * sl(1, 2) + c * sl(2, 3)
        a = dx2l / (dx1l * (dx1l + dx2l))
        b = -(dx2l + dx1l) / (dx1l * dx2l)
        c = (2.0 * dx2l + dx1l) / (dx2l * (dx1l + dx2l))
        last = a * sl(n - 3, n - 2) + b * sl(n - 2, n - 1) + c * sl(n - 1, n)
    return torch.cat([first, interior, last], dim=axis).to(f.dtype)


def gradient(f, *varargs, axis=None, edge_order=1):
    """Gradient of an N-dimensional array (numpy.gradient): a list of one
    tensor per axis, or one tensor when one axis is asked for.  A floating
    input keeps its dtype; integers and bool give float64.  1-d spacings
    work in their own float type (float64 for integers), as numpy's."""
    f = util.as_tensor(f)
    ndim = f.ndim
    if axis is None:
        axes = tuple(range(ndim))
    else:
        if np.ndim(axis) == 0:
            axis = (axis,)
        axes = tuple(util.normalize_axis_index(int(ax), ndim)
                     for ax in axis)
        if len(set(axes)) != len(axes):
            raise ValueError("repeated axis")
    len_axes = len(axes)

    n = len(varargs)
    if n == 0:
        dx = [None] * len_axes
    elif n == 1 and _ndim(varargs[0]) == 0:
        dx = list(varargs) * len_axes
    elif n == len_axes:
        dx = []
        for d in varargs:
            d_nd = _ndim(d)
            if d_nd == 0:
                dx.append(d)
                continue
            if d_nd != 1:
                raise ValueError("distances must be either scalars or 1d")
            dx.append(util.as_tensor(d, device=f.device))
    else:
        raise TypeError("invalid number of arguments")

    if edge_order > 2:
        raise ValueError("'edge_order' greater than 2 not supported")

    if not (f.is_floating_point() or f.is_complex()):
        f = f.to(torch.float64)

    outvals = []
    for i, ax in enumerate(axes):
        if f.shape[ax] < edge_order + 1:
            raise ValueError(
                "Shape of array too small to calculate a numerical "
                "gradient, at least (edge_order + 1) elements are "
                "required.")
        d = dx[i]
        if d is not None and _ndim(d) == 1 and d.shape[0] != f.shape[ax]:
            raise ValueError(
                "when 1d, distances must match the length of the "
                "corresponding dimension")
        outvals.append(_gradient_along_axis(f, d, ax, edge_order))
    if len_axes == 1:
        return outvals[0]
    return outvals
