"""Fused separable correlation and box min/max: the CUDA kernel, its
planner and its plain PyTorch versions.

The counterpart of the separable half of ``cupyimg_tpu/ops/pallas_stencil.py``
(``fused_separable_correlate`` and ``fused_separable_minmax`` ->
``_fused_separable``).  Per-axis 1-D correlations, or per-axis running
minima/maxima, of a 2-D/3-D float32 array run in ONE pass over device
memory (``csrc/fused_separable.cu``, one kernel templated on the op): the
input is boundary-extended once, inside the kernel's loads, each axis with
its own mode, and a constant mode on any axis gives the shared ``cval``.

Two further modes serve grey morphology over flat box windows, each in
one launch: two-stage (:func:`fused_separable_open_close`, min then max
or max then min over one combined extension) and pair
(:func:`fused_separable_morph_pair`, max - min or max + min - 2x from one
extension).  Whether a tile of the two-stage mode fits shared memory is
the planner's answer (:func:`supports_open_close`), given before any
launch.

For a CUDA tensor every wrapper launches the kernel or raises; only a
CPU tensor takes the plain versions (``*_ref``).
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
    "fused_separable_open_close",
    "fused_separable_open_close_ref",
    "fused_separable_morph_pair",
    "fused_separable_morph_pair_ref",
    "plan",
    "supports",
    "supports_open_close",
    "supports_pair",
]

MAX_TAPS = 64
#: input tiles in flight per block (kStages in the kernel)
STAGES = 4
#: input tiles in flight per block of the two-stage and pair modes
#: (kMorphStages in the kernel)
MORPH_STAGES = 2
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
# the morphology kernels' kinds (kOpening, kClosing, kGrad, kLaplace)
_MORPH_KINDS = {"opening": 0, "closing": 1, "grad": 2, "laplace": 3}


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


def smem_bytes(ntaps, t1, t2=T2, mode="separable"):
    """Shared memory of one block, in bytes (4-byte words).

    ``mode="separable"``: the taps, the row and column index maps, STAGES
    halo'd input tiles, the tile after the axis-2 pass and the ring of K0
    filtered planes.  ``"open_close"``: the index maps, MORPH_STAGES
    input tiles halo'd by both stages' windows, stage 1's tile after
    axis 2, its ring of K0 planes and its output plane (each halo'd by
    stage 2's window), stage 2's tile after axis 2 and its ring of K0
    planes.  ``"pair"``: the index maps, MORPH_STAGES halo'd input tiles,
    and the tile after axis 2 and the ring of K0 planes, each twice (min
    and max)."""
    k0, k1, k2 = ntaps
    if mode == "open_close":
        w1, w2 = t1 + k1 - 1, t2 + k2 - 1
        h1, h2 = w1 + k1 - 1, w2 + k2 - 1
        return 4 * (h1 + h2 + MORPH_STAGES * h1 * h2 + h1 * w2
                    + (k0 + 1) * w1 * w2 + w1 * t2 + k0 * t1 * t2)
    h1, h2 = t1 + k1 - 1, t2 + k2 - 1
    if mode == "pair":
        return 4 * (h1 + h2 + MORPH_STAGES * h1 * h2 + 2 * h1 * t2
                    + 2 * k0 * t1 * t2)
    if mode != "separable":
        raise ValueError(f"unknown kernel mode {mode!r}")
    return 4 * (3 * MAX_TAPS + h1 + h2 + STAGES * h1 * h2 + h1 * t2
                + k0 * t1 * t2)


def plan(shape, ntaps, mode="separable"):
    """Tiles, grid and shared-memory bytes for a (n0, n1, n2) volume with
    ``ntaps`` taps (or window samples) per axis (1 for an axis that is not
    filtered), for one of the kernel's modes (:func:`smem_bytes`).
    Raises ValueError when not even a one-row tile fits."""
    n0, n1, n2 = (int(s) for s in shape)
    ntaps = tuple(int(k) for k in ntaps)
    t2 = T2
    t1 = 8 if n1 <= 8 else 16
    while smem_bytes(ntaps, t1, t2, mode) > SMEM_LIMIT:
        if t1 == 1:
            raise ValueError(f"no tile fits the taps {ntaps} ({mode})")
        t1 //= 2
    tiles = math.ceil(n1 / t1) * math.ceil(n2 / t2)
    chunks = max(1, min(n0, math.ceil(_TARGET_BLOCKS / tiles)))
    z = math.ceil(n0 / chunks)
    if mode == "open_close":
        # stage 1 runs over 2 (K0 - 1) planes more than a block writes:
        # at least 8 (K0 - 1) planes a block keep that within a quarter
        z = min(n0, max(z, 8 * (ntaps[0] - 1)))
    return Plan(
        shape=(n0, n1, n2), ntaps=ntaps, t1=t1, t2=t2, z=z,
        grid=(tiles, math.ceil(n0 / z)),
        smem_bytes=smem_bytes(ntaps, t1, t2, mode),
    )


def _fits(ntaps, mode):
    """Whether a one-row tile of ``mode`` fits shared memory (the
    planner's last resort)."""
    return smem_bytes(ntaps, 1, T2, mode) <= SMEM_LIMIT


def _supports_morph(x, sizes, mode):
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and x.ndim in (2, 3) and len(sizes) == x.ndim):
        return False
    ntaps = [1 if sz is None else max(int(sz), 1) for sz in sizes]
    # a 2-D array runs as (1, n0, n1)
    return max(ntaps) <= MAX_TAPS and _fits(
        (1,) * (3 - x.ndim) + tuple(ntaps), mode)


def supports_open_close(x, sizes):
    """Whether one two-stage pass computes an opening or closing of
    ``x`` over a box of ``sizes``: a 2-D or 3-D float32 tensor (a CUDA
    one launches the kernel, a CPU one runs the plain version), at most
    64 samples per axis, and a tile that the planner fits in 227 KB.
    Where this is False the caller takes two min/max passes."""
    return _supports_morph(x, sizes, "open_close")


def supports_pair(x, sizes):
    """Whether one pair pass computes a morphological gradient or laplace
    of ``x`` over a box of ``sizes`` (as :func:`supports_open_close`; every
    window of at most 64 samples per axis fits)."""
    return _supports_morph(x, sizes, "pair")


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


def _check_input(x, *per_axis):
    """Raise unless ``x`` is a contiguous 2-D or 3-D float32 CUDA tensor
    with one entry per axis in each of ``per_axis``."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim not in (2, 3):
        raise ValueError(
            "fused_separable kernel takes a 2-D or 3-D float32 CUDA tensor, "
            f"got {x.ndim}-D {x.dtype} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError("fused_separable kernel takes a contiguous tensor")
    if any(len(a) != x.ndim for a in per_axis):
        raise ValueError("one weights/size/origin/mode entry per axis expected")


def _geometry(shape3, ntaps, mode):
    """The kernel's dims and plan arguments (t1, z, grid, shared bytes)."""
    p = plan(shape3, ntaps, mode)
    dims = np.asarray(shape3, np.int32)
    geom = np.asarray(
        (p.t1, p.z, p.grid[0], p.grid[1], p.smem_bytes), np.int32
    )
    return dims, geom


def _launch(x, weights, origins, modes, cval, op="corr"):
    """One launch of the kernel.  ``weights[ax]`` is the taps of axis
    ``ax`` for ``op="corr"``, or a window of ``len(weights[ax])`` samples
    for ``"min"``/``"max"`` (whose values are not read); None skips the
    axis."""
    _check_input(x, weights, origins, modes)
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
    dims, geom = _geometry(shape3, info[:, 0], "separable")
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
    fn = lib.fused_separable_morph_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [
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


def _box_pads(sizes, origins):
    """Per-axis (lo, hi) extension of a box of ``sizes`` (1 or None: no
    extension)."""
    return [
        (0, 0) if sz is None or int(sz) <= 1 else _window(int(sz), int(o))
        for sz, o in zip(sizes, origins)
    ]


def _box_fold(y, sizes, is_min):
    """A running ``torch.minimum`` or ``torch.maximum`` over ``narrow``
    slices of each axis with a window (axis 2 first, as the kernel does):
    each such axis shrinks by ``size - 1``."""
    op = torch.minimum if is_min else torch.maximum
    for ax in reversed(range(y.ndim)):
        sz = sizes[ax]
        if sz is None or int(sz) <= 1:
            continue
        n = y.shape[ax] - int(sz) + 1
        acc = y.narrow(ax, 0, n)
        for k in range(1, int(sz)):
            acc = op(acc, y.narrow(ax, k, n))
        y = acc
    return y


def fused_separable_minmax_ref(x, sizes, origins, modes, cval=0.0,
                               is_min=True):
    """Plain PyTorch version of the min/max kernel: one combined per-axis
    extension by index gather, then a running ``torch.minimum`` or
    ``torch.maximum`` over ``narrow`` slices of each axis."""
    y = boundary.pad(x, _box_pads(sizes, origins), list(modes), cval)
    y = _box_fold(y, sizes, is_min)
    return x.clone() if y is x else y


def _launch_morph(x, sizes, origins1, origins2, modes, cval, kind):
    """One launch of a morphology kernel (``kind`` in _MORPH_KINDS):
    ``origins1`` are the windows' origins of stage 1 (or of both folds of
    a pair), ``origins2`` those of stage 2."""
    _check_input(x, sizes, origins1, origins2, modes)
    pad3 = 3 - x.ndim
    shape3 = (1,) * pad3 + tuple(x.shape)
    info = np.zeros((3, 4), np.int32)  # window, lead 1, lead 2, mode
    info[:, 0] = 1
    for ax, (sz, o1, o2, mode) in enumerate(zip(sizes, origins1, origins2,
                                                 modes)):
        boundary.check_mode(mode)
        if sz is None or int(sz) <= 1:
            continue
        if int(sz) > MAX_TAPS:
            raise ValueError(f"fused_separable kernel takes 1..{MAX_TAPS} "
                             "samples per axis")
        info[ax + pad3] = (int(sz), _window(int(sz), int(o1))[0],
                           _window(int(sz), int(o2))[0], _MODE_CODES[mode])
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    dims, geom = _geometry(
        shape3, info[:, 0],
        "open_close" if kind in ("opening", "closing") else "pair")
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_separable_morph_f32(
            x.data_ptr(), y.data_ptr(), dims.ctypes.data, info.ctypes.data,
            float(cval), geom.ctypes.data, _MORPH_KINDS[kind], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_separable {kind} kernel launch failed: CUDA error {err}")
    return y


def fused_separable_open_close(x, sizes, origins1, origins2, modes,
                               cval=0.0, opening=True):
    """Grey opening (``opening``: min, then max) or closing (max, then
    min) over a flat box in ONE fused pass: both stages share one halo'd
    tile load instead of two whole-volume round trips.

    Parameters
    ----------
    x : (S0, S1[, S2]) float32 tensor
    sizes : sequence of int, the box per axis (1 or None = skip), at most
        64, the same in both stages
    origins1, origins2 : sequence of int, per axis, the windows' origins
        of stage 1 and stage 2 (the caller applies grey_dilation's origin
        negation to the max stage)
    modes : sequence of str, ndimage boundary mode per axis
    cval : float, shared by every constant-mode axis

    Computes the contract of :func:`fused_separable_open_close_ref`
    (extend once, by both windows).  That equals scipy's two calls where
    extension commutes with the stage-1 fold: odd windows with origin 0
    under reflect, mirror and grid-mirror, any window under wrap and
    grid-wrap; the morphology module gates on it.  A CUDA tensor launches
    ``csrc/fused_separable.cu``'s two-stage kernel (and counts one in
    ``fused_separable_open_close.launches``); a CPU tensor runs the plain
    version.  The planner must fit a tile (:func:`supports_open_close`).
    """
    if x.device.type == "cpu":
        return fused_separable_open_close_ref(x, sizes, origins1, origins2,
                                              modes, cval, opening)
    y = _launch_morph(x, sizes, origins1, origins2, modes, cval,
                      "opening" if opening else "closing")
    fused_separable_open_close.launches += 1
    return y


fused_separable_open_close.launches = 0


def fused_separable_open_close_ref(x, sizes, origins1, origins2, modes,
                                   cval=0.0, opening=True):
    """Plain PyTorch version of the two-stage kernel: extend the raw
    input once by both stages' windows added together, fold stage 1 over
    that extended domain (down to ``x``'s shape widened by stage 2's
    window), then fold stage 2 back to ``x.shape``."""
    pads = [(a + c, b + d) for (a, b), (c, d) in
            zip(_box_pads(sizes, origins1), _box_pads(sizes, origins2))]
    y = boundary.pad(x, pads, list(modes), cval)
    y = _box_fold(_box_fold(y, sizes, opening), sizes, not opening)
    return x.clone() if y is x else y


def fused_separable_morph_pair(x, sizes, origins, modes, cval=0.0,
                               combine="grad"):
    """Morphological gradient (``combine="grad"``: max - min) or laplace
    (``"laplace"``: max + min - 2x) over a flat box in ONE fused pass: the
    min and max folds read the same halo'd tile.

    Parameters as :func:`fused_separable_minmax`; both folds use
    ``origins``.  Both read one extension of ``x``, so this equals
    scipy's separate calls under every mode; the morphology module gates
    on equal min and max windows (odd sizes, origin 0).  A CUDA tensor
    launches ``csrc/fused_separable.cu``'s pair kernel (and counts one in
    ``fused_separable_morph_pair.launches``); a CPU tensor runs
    :func:`fused_separable_morph_pair_ref`.  NaN propagates.
    """
    if combine not in ("grad", "laplace"):
        raise ValueError(f"unknown pair combine {combine!r}")
    if x.device.type == "cpu":
        return fused_separable_morph_pair_ref(x, sizes, origins, modes, cval,
                                              combine)
    y = _launch_morph(x, sizes, origins, origins, modes, cval, combine)
    fused_separable_morph_pair.launches += 1
    return y


fused_separable_morph_pair.launches = 0


def fused_separable_morph_pair_ref(x, sizes, origins, modes, cval=0.0,
                                   combine="grad"):
    """Plain PyTorch version of the pair kernel: extend once, take the
    min and max folds of that one extension, then ``mx - mn`` or
    ``(mx + mn) - 2.0 * x``, each operation rounded on its own."""
    if combine not in ("grad", "laplace"):
        raise ValueError(f"unknown pair combine {combine!r}")
    y = boundary.pad(x, _box_pads(sizes, origins), list(modes), cval)
    mn = _box_fold(y, sizes, True)
    mx = _box_fold(y, sizes, False)
    if combine == "grad":
        return mx - mn
    return mx + mn - 2.0 * x
