"""NumPy gap-fillers on torch tensors: ``convolve``, ``correlate``,
``gradient``, ``histogram``, ``histogram2d``, ``histogramdd``,
``ravel_multi_index``, ``apply_along_axis``, ``ndim`` and ``quantile``,
with numpy's semantics (values, dtypes, error classes).

1-d ``convolve``/``correlate`` run the ndimage engine's full correlation
(``correlate1d(..., crop=False, dtype_mode="numpy")``): the product is in
numpy's promoted dtype, and integers wrap as numpy's do.  ``quantile``
sorts once (``torch.quantile`` refuses more than 2^24 elements).
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes as _dtypes
from cupyimg_tpu_torch.core import util as _util
from cupyimg_tpu_torch.scipy.ndimage import filters as _filters

__all__ = [
    "convolve",
    "correlate",
    "gradient",
    "histogram",
    "histogram2d",
    "histogramdd",
    "ravel_multi_index",
    "apply_along_axis",
    "ndim",
    "quantile",
]


def ndim(a):
    """Number of dimensions (works on any array-like)."""
    if hasattr(a, "ndim"):
        return a.ndim
    return np.ndim(a)


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    """Flat indices of a tuple of index arrays (numpy.ravel_multi_index):
    int64, on the device of the first index array.  ``mode`` is 'raise'
    (one host check for the whole tuple), 'wrap' or 'clip', one per axis
    or one for all; ``order`` 'C' or 'F'."""
    dims = tuple(int(d) for d in dims)
    if len(multi_index) != len(dims):
        raise ValueError(f"parameter multi_index must be a sequence of "
                         f"length {len(dims)}")
    first = next((m for m in multi_index if isinstance(m, torch.Tensor)),
                 None)
    device = None if first is None else first.device
    idx = torch.broadcast_tensors(*[
        _util.as_tensor(m, device=device).to(torch.int64)
        for m in multi_index])
    modes = [mode] * len(dims) if isinstance(mode, str) else list(mode)
    if len(modes) != len(dims):
        raise ValueError("mode must have one entry per dimension")
    out_of_range = None
    fixed = []
    for i, m, d in zip(idx, modes, dims):
        if m == "wrap":
            i = torch.remainder(i, d)
        elif m == "clip":
            i = i.clamp(0, d - 1)
        elif m == "raise":
            bad = ((i < 0) | (i >= d)).any()
            out_of_range = bad if out_of_range is None else out_of_range | bad
        else:
            raise ValueError(f"clipmode must be one of 'clip', 'raise', or "
                             f"'wrap' (got {m!r})")
        fixed.append(i)
    if out_of_range is not None and bool(out_of_range):
        raise ValueError("invalid entry in coordinates array")
    if order not in ("C", "F"):
        raise ValueError("only 'C' or 'F' order is permitted")
    axes = range(len(dims)) if order == "C" else reversed(range(len(dims)))
    flat = None
    for k in axes:
        flat = fixed[k] if flat is None else flat * dims[k] + fixed[k]
    return flat


def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    """``func1d`` on every 1-D slice along ``axis`` (numpy's
    apply_along_axis): a host loop over the slices; the results, all of
    one shape, take the place of ``axis``."""
    arr = _util.as_tensor(arr)
    nd = arr.ndim
    axis = _util.normalize_axis_index(axis, nd)
    moved = torch.movedim(arr, axis, -1)
    outer = tuple(moved.shape[:-1])
    rows = moved.reshape(-1, arr.shape[axis])
    if rows.shape[0] == 0:
        raise ValueError("Cannot apply_along_axis when any iteration "
                         "dimensions are 0")
    res = [_util.as_tensor(func1d(r, *args, **kwargs), device=arr.device)
           for r in rows.unbind(0)]
    out = torch.stack(res).reshape(outer + tuple(res[0].shape))
    r = res[0].ndim
    return torch.movedim(out, tuple(range(nd - 1, nd - 1 + r)),
                         tuple(range(axis, axis + r)))


_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _quantile_plan(n, qn, method):
    """numpy's neighbour indices and weights for ``n`` sorted values at
    the quantiles ``qn`` (a host array), reckoned on the host as numpy
    does: ``(lower, upper, gamma)``, or ``(index, None, None)`` for the
    methods that take one order statistic."""
    vi = np.asarray((n - 1) * qn)
    if method == "lower" or (method == "linear" and vi.dtype.kind in "iu"):
        return np.floor(vi).astype(np.intp), None, None
    if method == "higher":
        return np.ceil(vi).astype(np.intp), None, None
    if method == "nearest":
        return np.around(vi).astype(np.intp), None, None
    if method == "midpoint":
        vi = np.asarray(0.5 * (np.floor(vi) + np.ceil(vi)))
    prev = np.asarray(np.floor(vi))
    nxt = np.asarray(prev + 1)
    prev[vi >= n - 1] = -1
    nxt[vi >= n - 1] = -1
    prev[vi < 0] = 0
    nxt[vi < 0] = 0
    gamma = np.asarray(vi - prev)
    if method == "midpoint":
        gamma = np.where(vi % 1 == 0, 0.0, 0.5)
    return (prev.astype(np.intp), nxt.astype(np.intp),
            np.asarray(gamma, dtype=vi.dtype))


def quantile(a, q, axis=None, out=None, overwrite_input=False,
             method="linear", keepdims=False):
    """The ``q``-th quantiles of ``a`` (numpy.quantile): one
    ``torch.sort`` along the reduced axes, then numpy's ``method`` (the
    five that ``jnp.quantile`` accepts), its indices and weights reckoned
    on the host from ``q`` and its dtypes: 'lower', 'higher' and 'nearest'
    keep ``a``'s dtype, 'linear' and 'midpoint' interpolate in the
    promotion of ``a`` with ``q`` (a Python ``q`` takes a float ``a``'s
    dtype).  A slice holding NaN gives NaN.  ``out`` is not supported."""
    del overwrite_input
    if out is not None:
        raise NotImplementedError("cupyimg_tpu_torch is functional: `out` "
                                  "is not supported")
    if method not in _METHODS:
        raise ValueError("method can only be 'linear', 'lower', 'higher', "
                         "'midpoint', or 'nearest'")
    a = _util.as_tensor(a)
    if a.is_complex():
        raise TypeError("a must be an array of real numbers")
    a_np = _dtypes.to_numpy(a.dtype)
    if isinstance(q, torch.Tensor):
        qn = q.detach().cpu().numpy()
    elif isinstance(q, (int, float)) and a_np.kind == "f":
        qn = np.asarray(q, dtype=a_np)
    else:
        qn = np.asarray(q)
    if qn.ndim > 1:
        raise ValueError("q must be a scalar or 1d")
    if not (np.all(qn >= 0) and np.all(qn <= 1)):
        raise ValueError("Quantiles must be in the range [0, 1]")
    nd = a.ndim
    if axis is None:
        axes = tuple(range(nd))
    else:
        axes = (axis,) if np.ndim(axis) == 0 else tuple(axis)
        axes = tuple(_util.normalize_axis_index(int(x), nd) for x in axes)
        if len(set(axes)) != len(axes):
            raise ValueError("repeated axis")
    rest = [d for d in range(nd) if d not in axes]
    # the reduced axes flattened onto the first axis
    data = a.permute(list(axes) + rest).reshape(
        [-1] + [a.shape[d] for d in rest])
    n = data.shape[0]
    if n == 0:
        raise IndexError("cannot do a non-empty take from an empty axes.")
    s = torch.sort(data, dim=0).values
    lo, hi, gamma = _quantile_plan(n, qn.reshape(-1), method)
    dev = a.device
    below = s[torch.as_tensor(lo, device=dev)]
    if hi is None:
        res = below
    else:
        above = s[torch.as_tensor(hi, device=dev)]
        t = torch.as_tensor(gamma, device=dev).reshape(
            (-1,) + (1,) * (s.ndim - 1))
        work = _dtypes.to_torch(np.result_type(a_np, gamma.dtype))
        diff = (above - below).to(work)
        # numpy's _lerp: from the lower end below t = 0.5, from the upper
        # end at and above it
        res = torch.where(t >= 0.5, above.to(work) - diff * (1 - t),
                          below.to(work) + diff * t)
    if s.is_floating_point():  # NaN sorts last: a slice with one is NaN
        res = torch.where(torch.isnan(s[-1:]), s[-1:].to(res.dtype), res)
    res = res.reshape(tuple(qn.shape) + tuple(a.shape[d] for d in rest))
    if keepdims:
        res = res.reshape(tuple(qn.shape) + tuple(
            1 if d in axes else a.shape[d] for d in range(nd)))
    return res


def _np_conv_corr(a, v, mode, convolution):
    a = _util.as_tensor(a)
    v = _util.as_tensor(v, device=a.device)
    if a.ndim != 1 or v.ndim != 1:
        raise ValueError("object too deep for desired array")
    if a.shape[0] == 0 or v.shape[0] == 0:
        raise ValueError("v cannot be empty")
    if mode not in ("full", "same", "valid"):
        raise ValueError(
            f"mode must be one of 'full', 'same', 'valid'; got {mode}")
    inverted = False
    if v.shape[0] > a.shape[0]:
        a, v = v, a
        inverted = True
    n, k = a.shape[0], v.shape[0]
    fn = _filters.convolve1d if convolution else _filters.correlate1d
    full = fn(a, v, mode="constant", cval=0.0, crop=False,
              dtype_mode="numpy")
    length = n + k - 1
    if mode == "full":
        out = full
    elif mode == "same":
        start = (length - n) // 2
        out = full[start:start + n]
    else:
        start = (length - (n - k + 1)) // 2
        out = full[start:start + n - k + 1]
    if inverted and not convolution:
        # numpy applies the mode window before un-swapping: flip and
        # conjugate last
        out = torch.flip(out, (0,))
        if out.is_complex():
            out = out.conj().resolve_conj()
    return out


def convolve(a, v, mode="full"):
    """1-d convolution with numpy's semantics (numpy.convolve): the
    longer operand is the signal; the result is in numpy's promoted
    dtype."""
    return _np_conv_corr(a, v, mode, True)


def correlate(a, v, mode="valid"):
    """1-d correlation with numpy's semantics (numpy.correlate; ``v`` is
    conjugated)."""
    return _np_conv_corr(a, v, mode, False)


# first-party numpy-parity histograms and gradient (lib/); imported last
# so that lib/__init__'s back-references resolve
from cupyimg_tpu_torch.numpy.lib.histograms import (  # noqa: E402
    histogram,
    histogram2d,
    histogramdd,
)
from cupyimg_tpu_torch.numpy.lib.function_base import gradient  # noqa: E402
