"""B-spline prefilter: causal/anticausal IIR recurrences and their FIR form.

The counterpart of ``cupyimg_tpu/ops/iir.py``.  Two routes:

- :func:`_apply_axis0`, the plain path (every CPU tensor, float64 and
  complex data, short axes): the recursion runs as a loop along the
  filtered axis with every other axis vectorized, in SciPy's
  ni_splines.c operation order.  The mode-specific boundary
  initializations are truncated geometric sums with static
  coefficients, each one tensordot against the filtered axis.
- :func:`spline_filter_fir`, a CUDA float32 2-D/3-D tensor: each pole's
  causal+anticausal pair is one symmetric exponential FIR, so the whole
  nd prefilter is one launch of the fused separable kernel
  (``ops/fused_separable.py``, B1) per pole, every axis filtered in that
  launch.

Math source: the published pole values and init formulas of SciPy's
ni_splines.c.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.ops import fused_separable

__all__ = [
    "get_poles",
    "get_gain",
    "get_spline_mode",
    "pole_taps",
    "spline_filter_fir",
    "spline_filter1d",
]


def get_poles(order: int):
    """Exact spline filter poles for orders 2-5 (SciPy ni_splines math)."""
    if order == 2:
        return (math.sqrt(8.0) - 3.0,)
    elif order == 3:
        return (math.sqrt(3.0) - 2.0,)
    elif order == 4:
        return (
            math.sqrt(664.0 - math.sqrt(438976.0)) + math.sqrt(304.0) - 19.0,
            math.sqrt(664.0 + math.sqrt(438976.0)) - math.sqrt(304.0) - 19.0,
        )
    elif order == 5:
        return (
            math.sqrt(67.5 - math.sqrt(4436.25)) + math.sqrt(26.25) - 6.5,
            math.sqrt(67.5 + math.sqrt(4436.25)) - math.sqrt(26.25) - 6.5,
        )
    raise ValueError("only order 2-5 supported")


def get_gain(poles) -> float:
    g = 1.0
    for z in poles:
        g *= (1.0 - z) * (1.0 - 1.0 / z)
    return g


def get_spline_mode(mode: str) -> str:
    """Boundary family used by the spline prefilter for an ndimage mode.

    Exact analytic conditions exist for mirror/reflect/grid-wrap;
    'nearest' approximates best with reflect, everything else with
    mirror (the reference's _spline_prefilter_core.py decision table)."""
    if mode in ("mirror", "reflect", "grid-wrap"):
        return mode
    if mode == "grid-mirror":
        return "reflect"
    return "reflect" if mode == "nearest" else "mirror"


def _n_boundary(poles, pole_dtype) -> int:
    """Truncation length for the boundary sums: smallest k with
    |z|^k < tol."""
    largest = max(abs(p) for p in poles)
    tol = 1e-10 if np.dtype(pole_dtype) == np.float32 else 1e-18
    return int(math.ceil(math.log(tol, largest)))


def _causal_init_coeffs(n: int, z: float, mode: str, nb: int) -> np.ndarray:
    """Static coefficient vector w such that y[0] = w . x[0:n]."""
    w = np.zeros(n, dtype=np.float64)
    if mode == "mirror":
        zn1 = z ** (n - 1)
        w[0] += 1.0
        w[n - 1] += zn1
        zi = z
        for i in range(1, min(n - 1, nb)):
            w[i] += zi
            w[n - 1 - i] += zi * zn1
            zi *= z
        w /= 1.0 - zn1 * zn1
    elif mode == "grid-wrap":
        w[0] += 1.0
        zi = z
        m = min(n, nb)
        for i in range(1, m):
            w[n - i] += zi
            zi *= z
        w /= 1.0 - z ** m
    elif mode == "reflect":
        zn = z ** n
        a = np.zeros(n, dtype=np.float64)
        a[0] += 1.0
        a[n - 1] += zn
        zi = z
        for i in range(1, min(n, nb)):
            a[i] += zi
            a[n - 1 - i] += zi * zn
            zi *= z
        w = a * (z / (1.0 - zn * zn))
        w[0] += 1.0
    else:
        raise ValueError(f"invalid spline boundary mode: {mode}")
    return w


def _real_np_dtype(dtype):
    return np.float32 if dtype in (torch.float32, torch.complex64) \
        else np.float64


def _dot0(w: np.ndarray, y):
    """``w . y`` over axis 0 on ``y``'s device, summed in float64
    (complex128) and rounded once to ``y``'s dtype.  Multiply-adds, not
    ``torch.tensordot``: a float32 product there may take TF32 on the
    card."""
    wide = torch.complex128 if y.is_complex() else torch.float64
    wt = torch.as_tensor(np.asarray(w, np.float64), device=y.device)
    wt = wt.reshape((-1,) + (1,) * (y.ndim - 1))
    return (wt * y.to(wide)).sum(dim=0).to(y.dtype)


def _apply_axis0(x, order: int, spline_mode: str, nb: int):
    """Causal + anticausal filtering along axis 0 for all poles."""
    n = x.shape[0]
    poles = get_poles(order)
    real = _real_np_dtype(x.dtype)
    y = x * float(real(get_gain(poles)))
    for z in poles:
        zc = float(real(z))
        # causal pass: y[i] = x[i] + z * y[i-1]
        out = torch.empty_like(y)
        carry = _dot0(_causal_init_coeffs(n, z, spline_mode, nb)
                      .astype(real), y)
        out[0] = carry
        for i in range(1, n):
            carry = y[i] + zc * carry
            out[i] = carry
        y = out
        # anticausal init on the causal-filtered sequence
        if spline_mode == "mirror":
            ylast = (zc * y[n - 2] + y[n - 1]) * float(real(z / (z * z - 1.0)))
        elif spline_mode == "reflect":
            ylast = y[n - 1] * float(real(z / (z - 1.0)))
        else:  # grid-wrap
            m = min(n - 1, nb)
            w = np.zeros(n, dtype=np.float64)
            w[n - 1] = 1.0
            zi = z
            for i in range(m):
                w[i] += zi
                zi *= z
            w *= z / (zi - 1.0)  # zi == z**(m+1)
            ylast = _dot0(w.astype(real), y)
        # anticausal pass: y[i] = z * (y[i+1] - y[i]), i = n-2..0
        out = torch.empty_like(y)
        out[n - 1] = ylast
        carry = ylast
        for i in range(n - 2, -1, -1):
            carry = zc * (carry - y[i])
            out[i] = carry
        y = out
    return y


def _symmetric_pole_taps(z: float, nb: int) -> np.ndarray:
    """Combined causal+anticausal impulse response of one pole,
    ``((1-z)/(1+z)) z^|k|`` for ``|k| <= nb`` (its share of the gain
    included; DC gain 1)."""
    k = np.arange(-nb, nb + 1, dtype=np.float64)
    return ((1.0 - z) / (1.0 + z)) * (z ** np.abs(k))


def pole_taps(order: int):
    """The symmetric FIR of each pole of ``order``, truncated where
    |z|^nb < 1e-10 (the float32 boundary-sum tolerance of the recursion):
    37 taps for order 3, 57 for order 5's slower pole."""
    taps = []
    for z in get_poles(order):
        nb = int(math.ceil(math.log(1e-10) / math.log(abs(z))))
        taps.append(tuple(float(v) for v in _symmetric_pole_taps(z, nb)))
    return taps


def spline_filter_fir(x, order: int, axes, mode: str):
    """The spline prefilter as truncated symmetric FIRs on kernel B1.

    Applies to a CUDA float32 2-D/3-D tensor whose filtered axes are at
    least half as long as each pole's FIR (the JAX package's gates);
    returns None otherwise, and the caller takes the recursion.  One
    launch of ``fused_separable_correlate`` per pole, every axis of
    ``axes`` filtered in it; agrees with the recursion to float32
    roundoff.
    """
    if not (x.is_cuda and x.dtype == torch.float32 and x.ndim in (2, 3)):
        return None
    spline_mode = get_spline_mode(mode)
    axes = tuple(axes)
    plans = []
    for taps in pole_taps(order):
        if any(len(taps) > 2 * x.shape[ax] for ax in axes):
            return None  # boundary extension longer than the axis
        weights = [taps if ax in axes else None for ax in range(x.ndim)]
        if not fused_separable.supports(x, weights):
            return None
        plans.append(weights)
    for weights in plans:
        x = fused_separable.fused_separable_correlate(
            x, weights, (0,) * x.ndim, (spline_mode,) * x.ndim, 0.0
        )
    return x


def spline_filter1d(x, order: int, axis: int, mode: str):
    """Spline prefilter along one axis by the recursion; ``x`` is a float
    or complex tensor of the working dtype.  ``mode`` is the ndimage mode
    (mapped to the exact boundary family here)."""
    if order in (0, 1) or x.ndim == 0 or x.shape[axis] == 1:
        return x
    spline_mode = get_spline_mode(mode)
    nb = _n_boundary(get_poles(order), _real_np_dtype(x.dtype))
    y = torch.movedim(x, axis, 0)
    y = _apply_axis0(y, order, spline_mode, nb)
    return torch.movedim(y, 0, axis).contiguous()
