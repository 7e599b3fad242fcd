"""Boundary-mode semantics as index-space functions on torch tensors.

Mode semantics (scipy.ndimage convention, for integer sample index ``i`` in
an axis of length ``n``)::

    'reflect'       (d c b a | a b c d | d c b a)   period 2n   (== grid-mirror)
    'constant'      (k k k k | a b c d | k k k k)   cval outside
    'nearest'       (a a a a | a b c d | d d d d)   clamp
    'mirror'        (d c b   | a b c d | c b a)     period 2n-2
    'wrap'          (a b c d | a b c d | a b c d)   period n    (== grid-wrap)
    'grid-constant' same as constant for integer indices

The same math runs inside the CUDA kernel (``csrc/fused_separable.cu``,
``map_index``), where each axis of a halo'd tile is mapped on its own.
"""

from __future__ import annotations

import numpy as np
import torch

#: All modes accepted by ndimage-layer functions.
BOUNDARY_MODES = frozenset(
    {
        "reflect",
        "constant",
        "nearest",
        "mirror",
        "wrap",
        "grid-mirror",
        "grid-wrap",
        "grid-constant",
    }
)

# modes whose out-of-range samples take the constant value
_CONSTANT_MODES = frozenset({"constant", "grid-constant"})


def check_mode(mode: str) -> str:
    """Validate a boundary mode string."""
    if mode not in BOUNDARY_MODES:
        raise RuntimeError(f"boundary mode not supported (actual: {mode})")
    return mode


def ndimage_mode_to_pad_mode(mode: str) -> str:
    """ndimage mode -> numpy.pad-style mode name."""
    return {
        "reflect": "symmetric",
        "grid-mirror": "symmetric",
        "mirror": "reflect",
        "nearest": "edge",
        "wrap": "wrap",
        "grid-wrap": "wrap",
        "constant": "constant",
        "grid-constant": "constant",
    }[mode]


def _map(idx, n, mode, xp):
    """Shared body of :func:`map_indices` and :func:`map_indices_np`
    (``xp`` is ``torch`` or ``numpy``; ``%`` is non-negative for a
    positive divisor in both)."""
    if mode in ("reflect", "grid-mirror"):
        if n == 1:
            return xp.zeros_like(idx), None
        period = 2 * n
        im = idx % period
        return xp.where(im < n, im, period - 1 - im), None
    if mode == "mirror":
        if n == 1:
            return xp.zeros_like(idx), None
        period = 2 * n - 2
        im = idx % period
        return xp.where(im < n, im, period - im), None
    if mode == "nearest":
        return xp.clip(idx, 0, n - 1), None
    if mode in ("wrap", "grid-wrap"):
        return idx % n, None
    if mode in _CONSTANT_MODES:
        oob = (idx < 0) | (idx >= n)
        return xp.clip(idx, 0, n - 1), oob
    raise RuntimeError(f"boundary mode not supported (actual: {mode})")


def map_indices(idx, n: int, mode: str):
    """Map integer indices onto ``[0, n)`` for a boundary mode.

    Parameters
    ----------
    idx : integer torch tensor (any shape, may be far out of range)
    n : axis length
    mode : one of BOUNDARY_MODES

    Returns
    -------
    (mapped, oob) : mapped indices (safe for gather) and, for constant
    modes, a boolean mask of positions whose value must be replaced by
    cval (``None`` for non-constant modes).
    """
    return _map(torch.as_tensor(idx), n, mode, torch)


def map_indices_np(idx, n: int, mode: str):
    """NumPy twin of :func:`map_indices`; ``oob`` is always a boolean
    array."""
    idx = np.asarray(idx)
    mapped, oob = _map(idx, n, mode, np)
    if oob is None:
        oob = np.zeros(idx.shape, bool)
    return mapped, oob


def fill_value(cval, dtype):
    """``cval`` as a number of the torch ``dtype``, converted as
    cupyimg_tpu converts it: an integer dtype truncates toward zero and
    saturates at its range (NaN gives 0; an integer ``cval`` stays
    exact); other dtypes cast."""
    if dtype.is_floating_point or dtype.is_complex or dtype == torch.bool:
        return torch.tensor(cval, dtype=dtype).item()
    if isinstance(cval, (int, np.integer)):
        cval = int(cval)
    else:
        cval = float(cval)
        if np.isnan(cval):
            return 0
        cval = np.trunc(cval)
    info = torch.iinfo(dtype)
    return int(min(max(cval, info.min), info.max))


def pad(x, pad_width, mode: str, cval=0.0):
    """N-d boundary extension of ``x`` by a per-axis index gather.

    Every ndimage mode, any pad width (wider than the axis too).

    Parameters
    ----------
    x : torch tensor
    pad_width : sequence of (lo, hi) ints, one per axis
    mode : boundary mode, or a sequence of modes, one per axis
    cval : fill value for constant modes
    """
    modes = [mode] * x.ndim if isinstance(mode, str) else list(mode)
    for m in modes:
        check_mode(m)
    y = x
    for axis, ((lo, hi), m) in enumerate(zip(pad_width, modes)):
        lo, hi = int(lo), int(hi)
        if lo == 0 and hi == 0:
            continue
        n = y.shape[axis]
        # the index table is built on the host: no device sync for oob.any()
        mapped, oob = map_indices_np(np.arange(-lo, n + hi), n, m)
        y = torch.index_select(
            y, axis, torch.as_tensor(mapped, device=y.device)
        )
        if oob.any():
            shape = [1] * y.ndim
            shape[axis] = oob.shape[0]
            fill = torch.tensor(fill_value(cval, y.dtype), dtype=y.dtype,
                                device=y.device)
            mask = torch.as_tensor(oob, device=y.device).reshape(shape)
            y = torch.where(mask, fill, y)
    return y
