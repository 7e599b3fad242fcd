"""Spline interpolation: taps, weights and the plain gather.

The counterpart of ``cupyimg_tpu/ops/interp.py``: the per-axis tap and
weight rules of scipy's ``map_coordinate`` (orders 0-5, every ndimage
mode), and the plain PyTorch gather built on them,
:func:`gather_general`: per-point coordinates, accumulated over the
(order+1)^ndim tap product.  It is the plain version of the CUDA gather
(``ops/spline_gather.py``), which computes the same taps, weights and
masks per output thread.

Spline weight formulas are SciPy's ni_splines.c math.
"""

from __future__ import annotations

import itertools

import torch

from cupyimg_tpu_torch.core import boundary
from cupyimg_tpu_torch.ops.iir import get_spline_mode

__all__ = [
    "spline_weights",
    "wrap_coord",
    "premap_coord",
    "axis_taps",
    "gather_general",
]


def spline_weights(t, order: int):
    """B-spline weights for fractional offset ``t``, orders 1-5.

    ``t = c - floor(c)`` for odd orders, ``t = c - floor(c + 0.5)`` for
    even orders; returns a list of ``order + 1`` values of ``t``'s type.
    """
    if order == 1:
        return [1.0 - t, t]
    if order == 2:
        w1 = 0.75 - t * t
        y = 0.5 - t
        w0 = 0.5 * y * y
        return [w0, w1, 1.0 - w0 - w1]
    if order == 3:
        y = 1.0 - t
        w1 = (t * t * (t - 2.0) * 3.0 + 4.0) / 6.0
        w2 = (y * y * (y - 2.0) * 3.0 + 4.0) / 6.0
        w0 = y * y * y / 6.0
        return [w0, w1, w2, 1.0 - w0 - w1 - w2]
    if order == 4:
        y = t * t
        w2 = y * (y * 0.25 - 0.625) + 115.0 / 192.0
        y = 1.0 + t
        w1 = y * (y * (y * (5.0 - y) / 6.0 - 1.25) + 5.0 / 24.0) + 55.0 / 96.0
        y = 1.0 - t
        w3 = y * (y * (y * (5.0 - y) / 6.0 - 1.25) + 5.0 / 24.0) + 55.0 / 96.0
        y = 0.5 - t
        y = y * y
        w0 = y * y / 24.0
        return [w0, w1, w2, w3, 1.0 - w0 - w1 - w2 - w3]
    if order == 5:
        y = t * t
        w2 = y * (y * (0.25 - t / 12.0) - 0.5) + 0.55
        y = 1.0 - t
        yy = y * y
        w3 = yy * (yy * (0.25 - (1.0 - t) / 12.0) - 0.5) + 0.55
        y = t + 1.0
        w1 = (
            y * (y * (y * (y * (y / 24.0 - 0.375) + 1.25) - 1.75) + 0.625)
            + 0.425
        )
        y = 2.0 - t
        w4 = (
            y * (y * (y * (y * (y / 24.0 - 0.375) + 1.25) - 1.75) + 0.625)
            + 0.425
        )
        y = 1.0 - t
        yy = y * y
        w0 = (1.0 - t) * yy * yy / 120.0
        return [w0, w1, w2, w3, w4, 1.0 - w0 - w1 - w2 - w3 - w4]
    raise ValueError("order must be in 1..5")


def _div(c, d):
    """``c / d`` rounded as a true division: a CUDA tensor divided by a
    Python number is multiplied by the number's reciprocal instead, which
    can move a coordinate across a floor."""
    return c / torch.tensor(d, dtype=c.dtype, device=c.device)


def wrap_coord(c, n: int):
    """Remap a float coordinate into [0, n-1] with period n-1 ('wrap'
    mode: the first and last samples are identified)."""
    if n == 1:
        return torch.zeros_like(c)
    period = float(n - 1)
    neg = c + period * (torch.trunc(_div(-c, period)) + 1.0)
    pos = c - period * torch.trunc(_div(c, period))
    return torch.where(c < 0, neg, torch.where(c > period, pos, c))


def premap_coord(c, n: int, mode: str):
    """Float boundary premap of the target coordinate, as scipy's
    ``map_coordinate`` C routine does it: the coordinate folds into (or
    near) the domain *before* tap selection, which decides the order-0
    round-half-up direction at reflection ties."""
    if mode in ("constant", "grid-constant"):
        return c
    if mode == "wrap":
        return wrap_coord(c, n)
    if n == 1:
        return torch.zeros_like(c)
    if mode == "nearest":
        return torch.clamp(c, 0, n - 1)
    if mode == "grid-wrap":
        return c - n * torch.floor(_div(c, float(n)))
    if mode == "mirror":
        # fold the negative side up by whole periods, then either
        # translate by one period or negate (NI_EXTEND_MIRROR)
        sz2 = 2.0 * n - 2.0
        cn = torch.where(c < -sz2, sz2 * torch.trunc(_div(-c, sz2)) + c, c)
        cn = torch.where(cn <= 1.0 - n, cn + sz2, -cn)
        cp = c - sz2 * torch.trunc(_div(c, sz2))
        cp = torch.where(cp >= n, sz2 - cp, cp)
        return torch.where(c < 0, cn, torch.where(c > n - 1, cp, c))
    if mode in ("reflect", "grid-mirror"):
        sz2 = 2.0 * n
        # negative side: fold up near the domain, then reflect about -0.5
        cn = torch.where(c < -sz2, sz2 * torch.trunc(_div(-c, sz2)) + c, c)
        cn = torch.where(cn < -n, cn + sz2, -cn - 1.0)
        # positive side: fold down, then reflect about n-0.5
        cp = c - sz2 * torch.trunc(_div(c, sz2))
        cp = torch.where(cp >= n, sz2 - cp - 1.0, cp)
        return torch.where(c < 0, cn, torch.where(c > n - 1, cp, c))
    raise ValueError(f"unrecognized mode: {mode}")


def _map_tap(idx, n: int, mode: str):
    """Map one integer tap index per ``mode``; returns (safe_idx,
    oob | None).  'constant' leaves out-of-domain handling to the outer
    mask, so its taps just clamp; 'grid-constant' marks per-tap oob."""
    if mode == "grid-constant":
        oob = (idx < 0) | (idx >= n)
        return torch.clamp(idx, 0, n - 1), oob
    if mode == "constant":
        return torch.clamp(idx, 0, n - 1), None
    mapped, _ = boundary.map_indices(idx, n, mode)
    return mapped, None


def _first_tap(f, n: int, order: int):
    """The integer first tap from its float value ``f``, clamped first to
    a range where every tap of a far-out coordinate stays out of bounds,
    so the int cast is defined for any coordinate (the weights come from
    the unclamped coordinate)."""
    f = torch.clamp(f, -float(order + 3), float(n + order + 2))
    return f.to(torch.int64)


def axis_taps(c, n: int, order: int, mode: str):
    """Per-axis taps: list of (index, weight or None, oob or None).

    'wrap' remaps the float coordinate first; order >= 2 taps use the
    spline boundary family; 'nearest' clips the raw coordinate for
    order >= 2; 'grid-constant' marks each tap out of the domain.
    """
    d = premap_coord(c, n, mode)
    if order == 0:
        # scipy rounds half up for the nearest-neighbour tap
        cf = _first_tap(torch.floor(d + 0.5), n, 0)
        idx, oob = _map_tap(cf, n, mode)
        return [(idx, None, oob)]

    if order == 1:
        cf = torch.floor(d)
        w1 = d - cf
        w0 = 1.0 - w1
        cfi = _first_tap(cf, n, 1)
        i0, oob0 = _map_tap(cfi, n, mode)
        i1, oob1 = _map_tap(cfi + 1, n, mode)
        return [(i0, w0, oob0), (i1, w1, oob1)]

    # order >= 2: spline footprint
    if mode == "grid-constant":
        tap_mode = "grid-constant"  # per-tap cval
    elif mode == "nearest":
        # taps come from the raw coordinate and each clamps on its own,
        # so out-of-domain points extrapolate with the edge sample's
        # weight mass (ni_interpolation.c); clipped far enough out that
        # every tap still clamps to the same edge
        d = torch.clamp(c, -float(order + 2), float(n + order + 1))
        tap_mode = "nearest"
    else:  # the spline boundary family; 'constant' adds the outer mask
        tap_mode = get_spline_mode(mode)
    f = torch.floor(d) if order % 2 else torch.floor(d + 0.5)
    t = d - f
    start = _first_tap(f, n, order) - order // 2
    weights = spline_weights(t, order)
    out = []
    for k in range(order + 1):
        idx, oob = _map_tap(start + k, n, tap_mode)
        out.append((idx, weights[k], oob))
    return out


def _outer_constant_mask(coords, shape):
    """mode='constant': any coordinate outside [0, n-1] -> cval."""
    mask = None
    for c, n in zip(coords, shape):
        m = (c < 0) | (c > n - 1)
        mask = m if mask is None else mask | m
    return mask


def _apply_cval(vals, oob, cval):
    if oob is None:
        return vals
    return torch.where(oob, torch.tensor(cval, dtype=vals.dtype,
                                         device=vals.device), vals)


def gather_general(x, coords, order, mode: str, cval):
    """Interpolate ``x`` at dense coordinates (``ndim`` tensors of the
    output shape).  ``order`` is one spline order or one per axis (an
    axis of order 0 read at integer coordinates takes one plane).
    Each tap's value is multiplied by its axes' weights in turn, axis 0
    first, in the wider of the data's and the coordinates' precision,
    then cast to the data's dtype and summed over the tap product, axis
    0's taps slowest: scipy's order, which decides rounding ties of
    integer outputs as scipy does.  Returns the float/complex output."""
    orders = [order] * x.ndim if isinstance(order, int) else list(order)
    taps = [axis_taps(coords[j], x.shape[j], orders[j], mode)
            for j in range(x.ndim)]
    out = None
    for combo in itertools.product(*taps):
        vals = x[tuple(t[0] for t in combo)]
        oob = None
        for t in combo:
            if t[2] is not None:
                oob = t[2] if oob is None else oob | t[2]
        term = _apply_cval(vals, oob, cval)
        for t in combo:
            if t[1] is not None:
                term = term * t[1]
        term = term.to(vals.dtype)
        out = term if out is None else out + term
    if mode == "constant":
        mask = _outer_constant_mask(coords, x.shape)
        out = torch.where(mask, torch.tensor(cval, dtype=out.dtype,
                                             device=out.device), out)
    return out
