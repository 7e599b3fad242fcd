"""``RegularGridInterpolator`` and ``interpn`` on torch tensors: linear
and nearest interpolation on rectilinear grids, values with trailing
axes, ``bounds_error`` and ``fill_value`` as scipy's.

The grid's axes live on the host (for the checks) and on the values'
device.  A call looks up each axis with ``searchsorted`` and sums the
2^d corner products on the device; the bounds check is one host sync per
call, for all axes together.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = ["RegularGridInterpolator", "interpn"]


def _host(p):
    return p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else (
        np.asarray(p))


class RegularGridInterpolator:
    """Interpolation on a regular (rectilinear) grid
    (scipy.interpolate.RegularGridInterpolator): ``points`` one strictly
    ascending 1-D array per axis, ``values`` on the grid (integers become
    float64), ``method`` 'linear' or 'nearest'.  Out-of-bounds samples
    raise with ``bounds_error``, else take ``fill_value`` (None
    extrapolates)."""

    def __init__(self, points, values, method="linear", bounds_error=True,
                 fill_value=np.nan):
        if method not in ("linear", "nearest"):
            raise ValueError(f"Method '{method}' is not defined")
        self.method = method
        self.bounds_error = bounds_error
        values = util.as_tensor(values)
        if len(points) > values.ndim:
            raise ValueError(
                f"There are {len(points)} point arrays, but values has "
                f"{values.ndim} dimensions")
        if not (values.is_floating_point() or values.is_complex()):
            values = values.to(torch.float64)
        self.fill_value = fill_value
        if fill_value is not None:
            if not np.can_cast(np.asarray(fill_value).dtype,
                               dtypes.to_numpy(values.dtype),
                               casting="same_kind"):
                raise ValueError(
                    "fill_value must be either 'None' or of a type "
                    "compatible with values")
        host = [_host(p) for p in points]
        for i, p in enumerate(host):
            if not np.all(np.diff(p) > 0.0):
                raise ValueError(
                    f"The points in dimension {i} must be strictly "
                    f"ascending")
            if not p.ndim == 1:
                raise ValueError(
                    f"The points in dimension {i} must be 1-dimensional")
            if not values.shape[i] == len(p):
                raise ValueError(
                    f"There are {len(p)} points and {values.shape[i]} "
                    f"values in dimension {i}")
        self._host_grid = host
        self.grid = tuple(torch.as_tensor(p, device=values.device)
                          for p in host)
        self.values = values

    def __call__(self, xi, method=None):
        method = self.method if method is None else method
        if method not in ("linear", "nearest"):
            raise ValueError(f"Method '{method}' is not defined")
        ndim = len(self.grid)
        xi = util.as_tensor(xi, device=self.values.device)
        if not (xi.is_floating_point()):
            xi = xi.to(torch.float64)
        if xi.ndim == 1 and ndim > 1 and xi.shape[0] == ndim:
            xi = xi[None]
        xi_shape = tuple(xi.shape)
        xi = xi.reshape(-1, xi_shape[-1])
        if xi.shape[-1] != ndim:
            raise ValueError(
                f"The requested sample points xi have dimension "
                f"{xi.shape[1]}, but this RegularGridInterpolator has "
                f"dimension {ndim}")
        if self.bounds_error and xi.shape[0] > 0:
            # every axis' extremes in one sync
            lo, hi = torch.aminmax(xi, dim=0)
            lo, hi = torch.stack([lo, hi]).cpu().numpy()
            for i, g in enumerate(self._host_grid):
                if not (lo[i] >= g[0] and hi[i] <= g[-1]):
                    raise ValueError(
                        f"One of the requested xi is out of bounds in "
                        f"dimension {i}")
        cols = xi.T
        indices, norm_dist, out_of_bounds = self._find_indices(cols)
        if method == "linear":
            result = self._evaluate_linear(indices, norm_dist)
        else:
            result = self._evaluate_nearest(indices, norm_dist)
        if not self.bounds_error and self.fill_value is not None:
            mask = out_of_bounds.reshape((-1,) + (1,) * (result.ndim - 1))
            result = torch.where(
                mask, torch.as_tensor(self.fill_value, dtype=result.dtype,
                                      device=result.device), result)
        return result.reshape(xi_shape[:-1]
                              + tuple(self.values.shape[ndim:]))

    def _find_indices(self, cols):
        indices = []
        norm_distances = []
        out_of_bounds = torch.zeros(cols.shape[1], dtype=torch.bool,
                                    device=cols.device)
        for x, grid in zip(cols, self.grid):
            g = grid.to(torch.promote_types(grid.dtype, x.dtype))
            x = x.contiguous().to(g.dtype)
            i = torch.searchsorted(g, x) - 1
            i = i.clamp(0, g.shape[0] - 2)
            gi = g[i]
            norm_distances.append((x - gi) / (g[i + 1] - gi))
            indices.append(i)
            if not self.bounds_error:
                out_of_bounds = out_of_bounds | (x < g[0]) | (x > g[-1])
        return indices, norm_distances, out_of_bounds

    def _evaluate_linear(self, indices, norm_distances):
        # the weights broadcast over the values' trailing axes
        tail = (slice(None),) + (None,) * (self.values.ndim - len(indices))
        values = None
        for corner in itertools.product((0, 1), repeat=len(indices)):
            weight = None
            for up, yi in zip(corner, norm_distances):
                w = yi if up else 1 - yi
                weight = w if weight is None else weight * w
            at = tuple(i + up for i, up in zip(indices, corner))
            term = self.values[at] * weight[tail]
            values = term if values is None else values + term
        return values

    def _evaluate_nearest(self, indices, norm_distances):
        at = tuple(torch.where(yi <= 0.5, i, i + 1)
                   for i, yi in zip(indices, norm_distances))
        return self.values[at]


def interpn(points, values, xi, method="linear", bounds_error=True,
            fill_value=np.nan):
    """Multidimensional interpolation on regular grids
    (scipy.interpolate.interpn); ``xi`` an (..., ndim) array or a tuple of
    coordinate arrays that broadcast together."""
    if method not in ("linear", "nearest"):
        raise ValueError(f"interpn only understands the methods 'linear' "
                         f"and 'nearest'. You provided {method}.")
    values = util.as_tensor(values)
    if len(points) > values.ndim:
        raise ValueError(
            f"There are {len(points)} point arrays, but values has "
            f"{values.ndim} dimensions")
    if isinstance(xi, tuple) and len(xi) > 1:
        # scipy's _ndim_coords_from_arrays: broadcast and stack on a new
        # trailing axis
        parts = [util.as_tensor(x, device=values.device) for x in xi]
        xi = torch.stack(torch.broadcast_tensors(*parts), dim=-1)
    interp = RegularGridInterpolator(
        points, values, method=method, bounds_error=bounds_error,
        fill_value=fill_value)
    return interp(xi)
