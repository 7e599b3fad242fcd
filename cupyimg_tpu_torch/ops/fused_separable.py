"""Fused separable correlation and box min/max: the CUDA kernel, its
planner and its plain PyTorch versions.

The counterpart of the separable half of ``cupyimg_tpu/ops/pallas_stencil.py``
(``fused_separable_correlate`` and ``fused_separable_minmax`` ->
``_fused_separable``).  Per-axis 1-D correlations, or per-axis running
minima/maxima, of a 2-D/3-D float32 array run in ONE pass over device
memory (``csrc/fused_separable.cu``, one kernel templated on the op): the
input is boundary-extended once, inside the kernel's loads, each axis with
its own mode, and a constant mode on any axis gives the shared ``cval``.

For a CUDA tensor :func:`fused_separable_correlate` and
:func:`fused_separable_minmax` launch the kernel or raise; only a CPU
tensor takes the plain versions (``*_ref``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary

__all__ = [
    "fused_separable_correlate",
    "fused_separable_correlate_ref",
    "fused_separable_minmax",
    "fused_separable_minmax_ref",
    "plan",
    "supports",
]

MAX_TAPS = 64
#: input tiles in flight per block (kStages in the kernel)
STAGES = 4
#: output tile width along the last axis (kT2 in the kernel)
T2 = 64
#: shared memory one block can use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
# blocks the planner aims for: a few waves over the H100's 132 SMs
_TARGET_BLOCKS = 1024

_MODE_CODES = {
    "reflect": 0, "grid-mirror": 0,
    "mirror": 1,
    "nearest": 2,
    "wrap": 3, "grid-wrap": 3,
    "constant": 4, "grid-constant": 4,
}
# the kernel's per-axis op (kCorr, kMin, kMax)
_OP_CODES = {"corr": 0, "min": 1, "max": 2}


def supports(x, weights):
    """Whether the fused kernel applies: a CUDA float32 tensor, 2-D or
    3-D, at most 64 taps per axis."""
    return (
        isinstance(x, torch.Tensor)
        and x.is_cuda
        and x.dtype == torch.float32
        and x.ndim in (2, 3)
        and all(w is None or len(w) <= MAX_TAPS for w in weights)
    )


def _window(ntaps, origin):
    """(lo, hi) window extent of one axis, scipy convention."""
    lo = ntaps // 2 + origin
    hi = ntaps - 1 - lo
    if lo < 0 or hi < 0:
        raise ValueError("fused path requires in-window origins")
    return lo, hi


# ---------------------------------------------------------------------------
# tile planner
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    """Launch geometry of the kernel for a (n0, n1, n2) volume.

    Block (bx, by) writes output planes ``[by*z, min(by*z + z, n0))`` of
    axis 0 over the tile ``[o1, o1 + t1) x [o2, o2 + t2)`` of axes 1 and
    2, clipped to the volume, with ``o1 = (bx // tiles2) * t1`` and
    ``o2 = (bx % tiles2) * t2``: the same arithmetic as the kernel.
    """

    shape: tuple
    ntaps: tuple
    t1: int
    t2: int
    z: int
    grid: tuple
    smem_bytes: int

    @property
    def tiles2(self):
        return math.ceil(self.shape[2] / self.t2)

    def block_region(self, bx, by):
        """Output slices (axes 0, 1, 2) written by block (bx, by)."""
        n0, n1, n2 = self.shape
        o1 = (bx // self.tiles2) * self.t1
        o2 = (bx % self.tiles2) * self.t2
        z0 = by * self.z
        return (
            slice(z0, min(z0 + self.z, n0)),
            slice(o1, min(o1 + self.t1, n1)),
            slice(o2, min(o2 + self.t2, n2)),
        )


def smem_bytes(ntaps, t1, t2=T2):
    """Shared memory of one block, in bytes (4-byte words): the taps, the
    row and column index maps, STAGES halo'd input tiles, the tile after
    the axis-2 pass and the ring of K0 filtered planes."""
    k0, k1, k2 = ntaps
    h1, h2 = t1 + k1 - 1, t2 + k2 - 1
    return 4 * (3 * MAX_TAPS + h1 + h2 + STAGES * h1 * h2 + h1 * t2
                + k0 * t1 * t2)


def plan(shape, ntaps):
    """Tiles, grid and shared-memory bytes for a (n0, n1, n2) volume with
    ``ntaps`` taps per axis (1 for an axis that is not filtered)."""
    n0, n1, n2 = (int(s) for s in shape)
    ntaps = tuple(int(k) for k in ntaps)
    t2 = T2
    t1 = 8 if n1 <= 8 else 16
    while smem_bytes(ntaps, t1, t2) > SMEM_LIMIT:
        if t1 == 1:
            raise ValueError(f"no tile fits the taps {ntaps}")
        t1 //= 2
    tiles = math.ceil(n1 / t1) * math.ceil(n2 / t2)
    chunks = max(1, min(n0, math.ceil(_TARGET_BLOCKS / tiles)))
    z = math.ceil(n0 / chunks)
    return Plan(
        shape=(n0, n1, n2), ntaps=ntaps, t1=t1, t2=t2, z=z,
        grid=(tiles, math.ceil(n0 / z)),
        smem_bytes=smem_bytes(ntaps, t1, t2),
    )


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _tap_kind(taps):
    """0 general, 1 all taps equal, 2 symmetric (kernel constants)."""
    n = len(taps)
    if all(v == taps[0] for v in taps):
        return 1
    if n > 2 and all(taps[k] == taps[n - 1 - k] for k in range(n // 2)):
        return 2
    return 0


def _launch(x, weights, origins, modes, cval, op="corr"):
    """One launch of the kernel.  ``weights[ax]`` is the taps of axis
    ``ax`` for ``op="corr"``, or a window of ``len(weights[ax])`` samples
    for ``"min"``/``"max"`` (whose values are not read); None skips the
    axis."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim not in (2, 3):
        raise ValueError(
            "fused_separable kernel takes a 2-D or 3-D float32 CUDA tensor, "
            f"got {x.ndim}-D {x.dtype} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError("fused_separable kernel takes a contiguous tensor")
    if len(weights) != x.ndim or len(origins) != x.ndim or (
            len(modes) != x.ndim):
        raise ValueError("one weights/origin/mode entry per axis expected")
    pad3 = 3 - x.ndim
    shape3 = (1,) * pad3 + tuple(x.shape)
    taps = np.zeros((3, MAX_TAPS), np.float32)
    info = np.zeros((3, 4), np.int32)  # ntaps, lo, mode, kind
    info[:, 0] = 1
    taps[:, 0] = 1.0
    info[:, 3] = 1
    for ax, (w, origin, mode) in enumerate(zip(weights, origins, modes)):
        boundary.check_mode(mode)
        if w is None:
            continue
        w = [float(v) for v in w]
        if not 1 <= len(w) <= MAX_TAPS:
            raise ValueError(f"fused_separable kernel takes 1..{MAX_TAPS} taps")
        lo, _ = _window(len(w), int(origin))
        a = ax + pad3
        taps[a, : len(w)] = w
        kind = _tap_kind(w) if op == "corr" else 0
        info[a] = (len(w), lo, _MODE_CODES[mode], kind)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    p = plan(shape3, info[:, 0])
    dims = np.asarray(shape3, np.int32)
    geom = np.asarray(
        (p.t1, p.z, p.grid[0], p.grid[1], p.smem_bytes), np.int32
    )
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_separable_f32(
            x.data_ptr(), y.data_ptr(), dims.ctypes.data, taps.ctypes.data,
            info.ctypes.data, float(cval), geom.ctypes.data, _OP_CODES[op],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_separable kernel launch failed: CUDA error {err}")
    return y


def _library():
    from cupyimg_tpu_torch.ops import _build

    lib = _build.load("fused_separable")
    fn = lib.fused_separable_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib


def fused_separable_correlate(x, weights, origins, modes, cval=0.0):
    """Apply per-axis 1-D correlations in one fused pass.

    Parameters
    ----------
    x : (S0, S1[, S2]) float32 tensor
    weights : sequence of (sequence of float) or None, one per axis
        Filter taps (None = skip axis), at most 64 per axis.
    origins : sequence of int, per axis
    modes : sequence of str, ndimage boundary mode per axis
    cval : float, shared by every constant-mode axis

    A CUDA tensor launches ``csrc/fused_separable.cu`` (and counts one in
    ``fused_separable_correlate.launches``); a CPU tensor runs
    :func:`fused_separable_correlate_ref`.
    """
    if x.device.type == "cpu":
        return fused_separable_correlate_ref(x, weights, origins, modes, cval)
    y = _launch(x, weights, origins, modes, cval)
    fused_separable_correlate.launches += 1
    return y


fused_separable_correlate.launches = 0


def fused_separable_correlate_ref(x, weights, origins, modes, cval=0.0):
    """Plain PyTorch version of the kernel: one combined per-axis
    extension by index gather, then per-axis shifted-slice accumulation
    in the input's dtype (axis 2 first, as the kernel does)."""
    pads = [
        (0, 0) if w is None else _window(len(w), int(o))
        for w, o in zip(weights, origins)
    ]
    y = boundary.pad(x, pads, list(modes), cval)
    for ax in reversed(range(x.ndim)):
        w = weights[ax]
        if w is None:
            continue
        n = x.shape[ax]
        acc = None
        for k, wk in enumerate(w):
            term = float(wk) * y.narrow(ax, k, n)
            acc = term if acc is None else acc + term
        y = acc
    return x.clone() if y is x else y


def _minmax_windows(sizes):
    """Per-axis windows for :func:`_launch`: None for a size of 1 or
    None (axis skipped), else ``size`` placeholder taps."""
    return [None if sz is None or int(sz) <= 1 else (1.0,) * int(sz)
            for sz in sizes]


def fused_separable_minmax(x, sizes, origins, modes, cval=0.0, is_min=True):
    """Box minimum (``is_min``) or maximum in one fused pass.

    Parameters
    ----------
    x : (S0, S1[, S2]) float32 tensor
    sizes : sequence of int, window size per axis (1 or None = skip), at
        most 64
    origins : sequence of int, per axis (window ``lo = size//2 + origin``)
    modes : sequence of str, ndimage boundary mode per axis
    cval : float, shared by every constant-mode axis

    The raw input is extended once; for a minimum or maximum that equals
    extending each pass's output again, under every mode and cval.  A
    CUDA tensor launches ``csrc/fused_separable.cu`` with the min or max
    op (and counts one in ``fused_separable_minmax.launches``); a CPU
    tensor runs :func:`fused_separable_minmax_ref`.  NaN propagates, as
    in ``torch.minimum``.
    """
    if x.device.type == "cpu":
        return fused_separable_minmax_ref(x, sizes, origins, modes, cval,
                                          is_min)
    y = _launch(x, _minmax_windows(sizes), origins, modes, cval,
                "min" if is_min else "max")
    fused_separable_minmax.launches += 1
    return y


fused_separable_minmax.launches = 0


def fused_separable_minmax_ref(x, sizes, origins, modes, cval=0.0,
                               is_min=True):
    """Plain PyTorch version of the min/max kernel: one combined per-axis
    extension by index gather, then a running ``torch.minimum`` or
    ``torch.maximum`` over ``narrow`` slices of each axis."""
    windows = _minmax_windows(sizes)
    pads = [
        (0, 0) if w is None else _window(len(w), int(o))
        for w, o in zip(windows, origins)
    ]
    y = boundary.pad(x, pads, list(modes), cval)
    op = torch.minimum if is_min else torch.maximum
    for ax in reversed(range(x.ndim)):
        if windows[ax] is None:
            continue
        n = x.shape[ax]
        acc = y.narrow(ax, 0, n)
        for k in range(1, len(windows[ax])):
            acc = op(acc, y.narrow(ax, k, n))
        y = acc
    return x.clone() if y is x else y
