"""Stencil engines on torch tensors.

A stencil is *boundary-extend + weighted shifted-slice accumulation*.
Weights are concrete numpy arrays, so zero taps are skipped while the
accumulation is built.  This is the path every tensor that the fused
kernels do not take runs on (CPU tensors, integer and float64 data,
complex data); each pass costs one read and one write of the volume.
:func:`correlate_nd` sends a float32 CUDA correlation to the dense kernel
(``ops/fused_dense.py``); :func:`reduce_window` and
:func:`gather_windows` serve the min/max and rank filters.

All engines take *normalized* arguments (per-axis origins, validated
mode); argument munging lives in the scipy.ndimage API layer.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, dtypes


def footprint_pad_width(shape, origins):
    """Per-axis (lo, hi) boundary extension for a filter footprint.

    scipy convention: the window for output element ``i`` covers input
    elements ``i + k - size//2 - origin`` for ``k in range(size)``, hence
    ``lo = size//2 + origin`` and ``hi = size - 1 - lo``.
    """
    pad = []
    for size, origin in zip(shape, origins):
        lo = size // 2 + origin
        pad.append((lo, size - 1 - lo))
    return pad


def _scalar(w):
    """A numpy tap as a Python number of its kind: complex, bool and
    integer taps keep their kind, so that a product with an integer
    accumulator stays integer (and wraps as numpy's)."""
    kind = np.asarray(w).dtype.kind
    if kind == "c":
        return complex(w)
    if kind == "b":
        return bool(w)
    return int(w) if kind in "iu" else float(w)


def correlate_shift_add(x, weights, mode, cval, origins, acc_dtype):
    """Dense nd correlation via boundary-extend + shifted-slice accumulation.

    ``out[i] = sum_k weights[k] * x[i + k - size//2 - origin]``, with the
    zero taps of the numpy array ``weights`` skipped.  ``acc_dtype`` is a
    numpy dtype; the result has its torch counterpart.
    """
    acc = dtypes.to_torch(acc_dtype)
    pad_width = footprint_pad_width(weights.shape, origins)
    xp = boundary.pad(x, pad_width, mode, cval).to(acc)
    out = None
    for idx in np.argwhere(weights != 0):
        idx = tuple(int(i) for i in idx)
        sl = tuple(slice(o, o + n) for o, n in zip(idx, x.shape))
        term = _scalar(weights[idx]) * xp[sl]
        out = term if out is None else out + term
    if out is None:  # all-zero weights
        out = xp.new_zeros(x.shape)
    return out


def correlate1d_axis(x, weights1d, axis: int, mode, cval, origin, acc_dtype):
    """1-d correlation along one axis of an nd tensor.

    Symmetric / antisymmetric odd kernels fold pairs scipy-style
    (``w[mid+k]*(x[i+k] ± x[i-k])``, NI_Correlate1D's special case):
    same flop order as scipy, so last-ulp rounding, which integer
    truncation amplifies to ±1, matches exactly.
    """
    size = weights1d.shape[0]
    if (
        origin == 0
        and size > 1
        and size % 2 == 1
        and dtypes.kind(acc_dtype) in "fc"
    ):
        mid = size // 2
        w = weights1d
        sym = bool(np.array_equal(w[:mid], w[:mid:-1]))
        asym = bool(np.array_equal(w[:mid], -w[:mid:-1]))
        if sym or asym:
            pad_width = [(0, 0)] * x.ndim
            pad_width[axis] = (mid, mid)
            xp = boundary.pad(x, pad_width, mode, cval).to(
                dtypes.to_torch(acc_dtype)
            )
            n = x.shape[axis]

            def seg(k):  # slice at tap offset k (0..size-1)
                return xp.narrow(axis, k, n)

            out = _scalar(w[mid]) * seg(mid) if w[mid] != 0 else None
            for k in range(1, mid + 1):
                if w[mid + k] == 0:
                    continue
                pair = seg(mid + k) + seg(mid - k) if sym else (
                    seg(mid + k) - seg(mid - k))
                term = _scalar(w[mid + k]) * pair
                out = term if out is None else out + term
            if out is None:
                out = xp.new_zeros(x.shape)
            return out
    shape = [1] * x.ndim
    shape[axis] = size
    origins = [0] * x.ndim
    origins[axis] = origin
    return correlate_shift_add(
        x, weights1d.reshape(shape), mode, cval, origins, acc_dtype
    )


def correlate_nd(x, weights, mode, cval, origins, acc_dtype):
    """Dense nd correlation: the dense kernel for a CUDA tensor whose
    accumulation dtype is float32 and whose weights its gate admits
    (``fused_dense.supports_dense``), else :func:`correlate_shift_add`.

    ``acc_dtype`` is float32 under ``dtype_mode="float"``, and under
    ``"numpy"`` for float16 and float32 operands: under the default
    ``"ndimage"`` even float32 data accumulates in float64.
    """
    from cupyimg_tpu_torch.ops import fused_dense

    weights = np.asarray(weights)
    if dtypes.policy_dtype(acc_dtype) == np.float32:
        xw = x.to(torch.float32)
        if fused_dense.supports_dense(xw, weights):
            return fused_dense.fused_dense_correlate(
                xw.contiguous(), weights, origins, mode, cval
            )
    return correlate_shift_add(x, weights, mode, cval, origins, acc_dtype)


def reduce_window(x, offsets, mode, cval, reducer, init=None):
    """Running reduction over footprint taps without materializing windows.

    ``offsets`` is ``(taps, pad_width)`` from :func:`footprint_offsets`;
    ``reducer`` combines the accumulator with each shifted slice (e.g.
    ``torch.minimum``).  Drives the min/max filters that the fused
    separable kernel does not take.
    """
    taps, pad_width = offsets
    xp = boundary.pad(x, pad_width, mode, cval)
    out = init
    for off in taps:
        piece = xp[tuple(slice(o, o + n) for o, n in zip(off, x.shape))]
        out = piece if out is None else reducer(out, piece)
    return out


def footprint_offsets(footprint, origins):
    """Static (offsets, pad_width) for a boolean footprint (numpy array)."""
    footprint = np.asarray(footprint)
    pad_width = footprint_pad_width(footprint.shape, origins)
    taps = [tuple(int(i) for i in idx) for idx in np.argwhere(footprint)]
    return taps, pad_width


def gather_windows(x, footprint, origins, mode, cval):
    """Footprint windows stacked as a (K, *x.shape) tensor: K times the
    volume in memory, for the rank filters of more than 64 taps."""
    taps, pad_width = footprint_offsets(footprint, origins)
    xp = boundary.pad(x, pad_width, mode, cval)
    return torch.stack([
        xp[tuple(slice(o, o + n) for o, n in zip(off, x.shape))]
        for off in taps
    ])
