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
extension).  Each has a rows path for a 2-D array and a planes path for
a 3-D one (:func:`plan`); whether a tile of the two-stage mode fits
shared memory is the planner's answer (:func:`supports_open_close`),
given before any launch.

For a CUDA tensor every wrapper launches the kernel or raises; only a
CPU tensor takes the plain versions (``*_ref``).
"""

from __future__ import annotations

import ctypes
import functools
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
#: input tiles in flight per block (kStages in the kernel; at most this
#: many on the morphology modes' planes path)
STAGES = 4
#: output tile width along the last axis (kT2 in the kernel)
T2 = 64
#: the rows path (a 2-D array): output columns a block (kRowW) and input
#: rows a step (kRowStep)
ROW_W = 128
ROW_STEP = 16
#: shared memory one block can use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
#: axis-0 windows the planes path keeps in registers, not in a shared
#: ring (the kernel's KZ instances)
REGISTER_WINDOWS = (3, 5)
# blocks the planes path aims for: about one resident wave of four blocks
# on each of the H100's 132 SMs (half the planes' axis-0 halo of 1024)
_TARGET_BLOCKS = 512
# the rows path's blocks: one resident wave of four blocks on each SM
_ROW_BLOCKS = 4 * 132
#: the morphology modes' planes path: rows of a thread's axis-1 run
#: (kMorphL), and the two-stage stage-1 runs a thread holds with a
#: register window (kMorphItems) of 256 threads
MORPH_L = 4
MORPH_ITEMS = 2
#: axis-0 windows the morphology modes' planes path keeps in registers
MORPH_WINDOWS = (1, 3, 5)
#: input planes in flight on that path, the most that fit first (the
#: kernel's wait depths)
MORPH_STAGES = (4, 2, 1)
# one resident wave of the morphology kernels' blocks, by mode and path
# (kMorphBlocksPerSM, kMorphRowBlocksPerSM): planes 2 (two-stage) and 3
# (pair) an SM, rows 4 and 3
_MORPH_BLOCKS = {"open_close": 2 * 132, "pair": 3 * 132}
_MORPH_ROW_BLOCKS = {"open_close": 4 * 132, "pair": 3 * 132}

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
    ``mode`` is the kernel's path or mode (:func:`smem_bytes`); on the
    rows paths a block marches down its ``t1`` rows of a strip ``t2``
    wide.  ``stages`` (input planes in flight) and ``window`` (the
    axis-0 window in registers, 0 for a shared ring) are the morphology
    planes path's; the morphology modes' tiles and strips start ``shift``
    columns left of column 0 (minus the input's lead along axis 2, modulo
    4; the planes path only where that adds no tile), so that each input
    tile starts on a 16-byte boundary.
    """

    shape: tuple
    ntaps: tuple
    t1: int
    t2: int
    z: int
    grid: tuple
    smem_bytes: int
    mode: str = "separable"
    stages: int = STAGES
    window: int = 0
    shift: int = 0

    @property
    def tiles2(self):
        return math.ceil((self.shape[2] + self.shift) / self.t2)

    def block_region(self, bx, by):
        """Output slices (axes 0, 1, 2) written by block (bx, by)."""
        n0, n1, n2 = self.shape
        o1 = (bx // self.tiles2) * self.t1
        o2 = (bx % self.tiles2) * self.t2 - self.shift
        z0 = by * self.z
        return (
            slice(z0, min(z0 + self.z, n0)),
            slice(o1, min(o1 + self.t1, n1)),
            slice(max(o2, 0), max(min(o2 + self.t2, n2), 0)),
        )


def _row_chunks(k2, t2):
    """16-byte chunks of a halo'd tile row of ``t2 + k2 - 1`` samples
    from any alignment (``nch`` in the planes kernel)."""
    return (t2 + k2 - 1 + 6) // 4


def _row_units(k2):
    """8-sample units of a rows-path stage row (``nu`` in the kernel):
    3 + ROW_W + k2 - 1 samples from any alignment, rounded up to 2 modulo
    4 so that the two rows a warp reads fall on disjoint banks."""
    need = (ROW_W + k2 + 2 + 7) // 8
    return (need + 1) // 4 * 4 + 2


def row_ring(k1):
    """Rows of the rows path's ring: the vertical window's K1 - 1 rows
    of halo plus a step, rounded up to a step (``ring_rows`` in the
    kernel)."""
    return ROW_STEP * (math.ceil((k1 - 1) / ROW_STEP) + 1)


def _morph_units(k2):
    """8-sample units of a row of the two-stage rows path's stage-1 buffer
    (``nu1`` in the kernel): 128 + k2 - 1 samples, rounded up to 2 modulo
    4."""
    return (((k2 + 134) >> 3) + 1) // 4 * 4 + 2


def smem_bytes(ntaps, t1, t2=T2, mode="separable", stages=STAGES,
               window=0):
    """Shared memory of one block, in bytes (4-byte words).

    ``mode="separable"`` (the planes path): the taps, the row and column
    index maps, STAGES halo'd input tiles (rows of 16-byte chunks), the
    tile after the axis-2 pass and the ring of K0 filtered planes (none
    for K0 in REGISTER_WINDOWS).  ``"rows"`` (a 2-D array): the taps of
    two axes, one stage buffer of ROW_STEP input rows and the ring of
    :func:`row_ring` filtered rows of ``t2``; ``t1``, the block's rows,
    costs nothing.

    The morphology modes' planes paths: ``"open_close"``: the index maps,
    ``stages`` input tiles halo'd by both stages' windows (rows of
    16-byte chunks), stage 1's tile after axis 2 (MORPH_L rows more, which
    the last runs may read) and its plane after axis 1 and 0 (halo'd by
    stage 2's window), both in rows of whole runs of MORPH_L, stage 2's
    tile after axis 2 (MORPH_L rows more)
    and, with no register ``window``, the rings of K0 planes of both
    stages.  ``"pair"``: the index maps, ``stages`` halo'd input tiles,
    the tile after axis 2 as (min, max) pairs and, with no register
    ``window``, the ring of K0 planes of pairs.  Their rows paths
    (``t2`` columns a strip, 128 computed a row): ``"open_close_rows"``:
    one stage buffer, stage 1's ring, its 16 rows for stage 2, stage 2's
    ring; ``"pair_rows"``: two stage buffers and a ring of pairs."""
    k0, k1, k2 = ntaps
    if mode in ("open_close_rows", "pair_rows"):
        lag = math.ceil((k1 - 1) / ROW_STEP)
        stage = ROW_STEP * 8 * _row_units(k2)
        if mode == "pair_rows":
            return 4 * (2 * stage + 2 * ROW_STEP * (lag + 2) * ROW_W)
        return 4 * (stage + ROW_STEP * 8 * _morph_units(k2)
                    + 2 * ROW_STEP * (lag + 1) * ROW_W)
    if mode in ("open_close", "pair"):
        if mode == "open_close":
            w1, w2 = t1 + k1 - 1, t2 + k2 - 1
        else:
            w1, w2 = t1, t2
        h1, h2 = w1 + k1 - 1, w2 + k2 - 1
        maps = (h1 + h2 + 3) // 4 * 4
        tiles = stages * h1 * 4 * ((h2 + 6) // 4)
        if mode == "pair":
            ring = 0 if window else 2 * k0 * t1 * t2
            return 4 * (maps + tiles + 2 * (h1 + MORPH_L) * t2 + ring)
        w2p = MORPH_L * math.ceil(w2 / MORPH_L)  # rows of whole runs
        ring = 0 if window else k0 * (w1 * w2 + t1 * t2)
        return 4 * (maps + tiles + (h1 + MORPH_L) * w2p + w1 * w2p
                    + (w1 + MORPH_L) * t2 + ring)
    h1, h2 = t1 + k1 - 1, t2 + k2 - 1
    if mode == "rows":
        return 4 * (2 * MAX_TAPS + ROW_STEP * 8 * _row_units(k2)
                    + row_ring(k1) * t2)
    if mode != "separable":
        raise ValueError(f"unknown kernel mode {mode!r}")
    maps = (h1 + h2 + 3) // 4 * 4
    ring = 0 if k0 in REGISTER_WINDOWS else k0 * t1 * t2
    return 4 * (3 * MAX_TAPS + maps + STAGES * h1 * 4 * _row_chunks(k2, t2)
                + h1 * t2 + ring)


def morph_items(ntaps, t1):
    """Stage-1 axis-1 runs of the two-stage planes path for a ``t1``-row
    tile: MORPH_L rows of stage 1's plane (t1 + K1 - 1 rows) by its
    T2 + K2 - 1 columns."""
    _, k1, k2 = ntaps
    return math.ceil((t1 + k1 - 1) / MORPH_L) * (T2 + k2 - 1)


def _morph_plan(shape, ntaps, mode, shift):
    """The morphology modes' plan: a rows path for one plane with axis 0
    unfiltered, else the planes path, trying the register window first
    (for K0 in MORPH_WINDOWS, while the two-stage kernel's stage-1 runs
    fit MORPH_ITEMS a thread), then the rings, with the tallest tile and
    the most stages in flight that fit."""
    n0, n1, n2 = shape
    k0, k1, k2 = ntaps
    if n0 == 1 and k0 == 1:
        rmode = mode + "_rows"
        # stage 1's ROW_W columns hold stage 2's halo; strips of a
        # multiple of 4 columns
        ow = (ROW_W - (k2 - 1)) // 4 * 4 if mode == "open_close" else ROW_W
        strips = math.ceil((n2 + shift) / ow)
        # runs of rows that keep the blocks within one resident wave
        per_strip = max(1, _MORPH_ROW_BLOCKS[mode] // strips)
        rows = ROW_STEP * math.ceil(n1 / (per_strip * ROW_STEP))
        return Plan(
            shape=shape, ntaps=ntaps, t1=rows, t2=ow, z=1,
            grid=(strips * math.ceil(n1 / rows), 1),
            smem_bytes=smem_bytes(ntaps, rows, ow, rmode), mode=rmode,
            shift=shift,
        )
    # the planes path shifts its tiles only where that adds no tile
    if math.ceil((n2 + shift) / T2) > math.ceil(n2 / T2):
        shift = 0
    windows = (k0, 0) if k0 in MORPH_WINDOWS else (0,)
    for window in windows:
        for t1 in (8, 4, 2, 1) if n1 <= 8 else (16, 8, 4, 2, 1):
            if (window and mode == "open_close"
                    and morph_items(ntaps, t1) > MORPH_ITEMS * 256):
                continue
            for stages in MORPH_STAGES:
                nbytes = smem_bytes(ntaps, t1, T2, mode, stages, window)
                if nbytes <= SMEM_LIMIT:
                    break
            else:
                continue
            tiles = math.ceil(n1 / t1) * math.ceil((n2 + shift) / T2)
            chunks = max(1, min(n0, _MORPH_BLOCKS[mode] // tiles))
            z = math.ceil(n0 / chunks)
            if mode == "open_close":
                # stage 1 runs over 2 (K0 - 1) planes more than a block
                # writes: at least 8 (K0 - 1) planes a block keep that
                # within a quarter
                z = min(n0, max(z, 8 * (k0 - 1)))
            return Plan(
                shape=shape, ntaps=ntaps, t1=t1, t2=T2, z=z,
                grid=(tiles, math.ceil(n0 / z)), smem_bytes=nbytes,
                mode=mode, stages=stages, window=window, shift=shift,
            )
    raise ValueError(f"no tile fits the taps {ntaps} ({mode})")


def plan(shape, ntaps, mode="separable", shift=0):
    """Tiles, grid and shared-memory bytes for a (n0, n1, n2) volume with
    ``ntaps`` taps (or window samples) per axis (1 for an axis that is not
    filtered), for one of the kernel's modes (:func:`smem_bytes`).  A
    ``"separable"`` call on one plane with axis 0 unfiltered (a 2-D
    array) takes the rows path: strips of ROW_W columns, and runs of rows
    (a multiple of ROW_STEP) that give about one resident wave of blocks.
    ``"open_close"`` and ``"pair"`` plan the morphology kernels
    (:func:`_morph_plan`), whose tiles start ``shift`` columns left of
    column 0 (where the plan's ``shift`` keeps it).  Raises ValueError
    when not even a one-row tile fits."""
    n0, n1, n2 = (int(s) for s in shape)
    ntaps = tuple(int(k) for k in ntaps)
    if mode in ("open_close", "pair"):
        return _morph_plan((n0, n1, n2), ntaps, mode, int(shift))
    if mode == "separable" and n0 == 1 and ntaps[0] == 1:
        strips = math.ceil(n2 / ROW_W)
        rows = ROW_STEP * max(1, min(math.ceil(n1 / ROW_STEP), math.ceil(
            n1 * strips / _ROW_BLOCKS / ROW_STEP)))
        return Plan(
            shape=(n0, n1, n2), ntaps=ntaps, t1=rows, t2=ROW_W, z=1,
            grid=(strips * math.ceil(n1 / rows), 1),
            smem_bytes=smem_bytes(ntaps, rows, ROW_W, "rows"), mode="rows",
        )
    t2 = T2
    t1 = 8 if n1 <= 8 else 16
    while smem_bytes(ntaps, t1, t2, mode) > SMEM_LIMIT:
        if t1 == 1:
            raise ValueError(f"no tile fits the taps {ntaps} ({mode})")
        t1 //= 2
    tiles = math.ceil(n1 / t1) * math.ceil(n2 / t2)
    chunks = max(1, min(n0, math.ceil(_TARGET_BLOCKS / tiles)))
    z = math.ceil(n0 / chunks)
    return Plan(
        shape=(n0, n1, n2), ntaps=ntaps, t1=t1, t2=t2, z=z,
        grid=(tiles, math.ceil(n0 / z)),
        smem_bytes=smem_bytes(ntaps, t1, t2, mode),
    )


def _fits(ntaps, mode):
    """Whether the planner fits a planes-path tile of morphology ``mode``
    for these windows (its last resort: a one-row tile, one plane in
    flight, rings in shared memory).  A 2-D array's rows path fits every
    window of at most 64 samples."""
    return smem_bytes(ntaps, 1, T2, mode, stages=1) <= SMEM_LIMIT


def _supports_morph(x, sizes, mode):
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and x.ndim in (2, 3) and len(sizes) == x.ndim):
        return False
    ntaps = [1 if sz is None else max(int(sz), 1) for sz in sizes]
    if max(ntaps) > MAX_TAPS:
        return False
    # a 2-D array runs as (1, n0, n1), on its rows path
    return x.ndim == 2 or _fits(tuple(ntaps), mode)


def supports_open_close(x, sizes):
    """Whether one two-stage pass computes an opening or closing of
    ``x`` over a box of ``sizes``: a 2-D or 3-D float32 tensor (a CUDA
    one launches the kernel, a CPU one runs the plain version), at most
    64 samples per axis, and for a 3-D one a tile that the planner fits
    in 227 KB (every 2-D window fits its rows path).  Where this is
    False the caller takes two min/max passes."""
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


@functools.lru_cache(maxsize=256)
def _geometry(shape3, ntaps, mode, shift=0):
    """The kernel's dims and plan arguments (t1, z, grid, shared bytes,
    path: 1 for a rows path, a slot for the 16-byte flag, then the
    morphology planes path's stages and register window, t2 and the
    morphology modes' shift), planned once per shape, taps, mode and
    shift."""
    p = plan(shape3, ntaps, mode, shift)
    dims = np.asarray(shape3, np.int32)
    geom = np.asarray((p.t1, p.z, p.grid[0], p.grid[1], p.smem_bytes,
                       int(p.mode.endswith("rows")), 0, p.stages, p.window,
                       p.t2, p.shift), np.int32)
    dims.setflags(write=False)  # shared by every call of the cache
    geom.setflags(write=False)
    return dims, geom


def _plan_args(x, shape3, ntaps, mode, shift=0):
    """``_geometry`` with its 16-byte flag set: whether rows may be read in
    16-byte chunks (an aligned array whose rows are a multiple of 16
    bytes)."""
    dims, geom = _geometry(tuple(shape3), tuple(int(k) for k in ntaps), mode,
                           shift)
    geom = geom.copy()
    geom[6] = int(x.data_ptr() % 16 == 0 and shape3[2] % 4 == 0)
    return dims, geom


@functools.lru_cache(maxsize=256)
def _axis_args(pad3, weights, origins, modes, op):
    """The kernel's taps (3 x 64) and per-axis (ntaps, lo, mode, kind) for
    hashable ``weights`` (tuples or None): packed once per filter."""
    taps = np.zeros((3, MAX_TAPS), np.float32)
    info = np.zeros((3, 4), np.int32)  # ntaps, lo, mode, kind
    info[:, 0] = 1
    taps[:, 0] = 1.0
    info[:, 3] = 1
    for ax, (w, origin, mode) in enumerate(zip(weights, origins, modes)):
        boundary.check_mode(mode)
        if w is None:
            continue
        if not 1 <= len(w) <= MAX_TAPS:
            raise ValueError(f"fused_separable kernel takes 1..{MAX_TAPS} taps")
        lo, _ = _window(len(w), int(origin))
        a = ax + pad3
        taps[a, : len(w)] = w
        kind = _tap_kind(w) if op == "corr" else 0
        info[a] = (len(w), lo, _MODE_CODES[mode], kind)
    taps.setflags(write=False)  # shared by every call of the cache
    info.setflags(write=False)
    return taps, info


def _launch(x, weights, origins, modes, cval, op="corr"):
    """One launch of the kernel.  ``weights[ax]`` is the taps of axis
    ``ax`` for ``op="corr"``, or a window of ``len(weights[ax])`` samples
    for ``"min"``/``"max"`` (whose values are not read); None skips the
    axis."""
    _check_input(x, weights, origins, modes)
    pad3 = 3 - x.ndim
    shape3 = (1,) * pad3 + tuple(x.shape)
    taps, info = _axis_args(
        pad3, tuple(None if w is None else tuple(float(v) for v in w)
                    for w in weights),
        tuple(int(o) for o in origins), tuple(modes), op)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    dims, geom = _plan_args(x, shape3, info[:, 0], "separable")
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


@functools.cache
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


def _morph_info(x, sizes, origins1, origins2, modes):
    """Per-axis (window, lead of stage 1, lead of stage 2, mode) of the
    morphology kernels for ``x`` (as (n0, n1, n2)): ``origins1`` are the
    windows' origins of stage 1 (or of both folds of a pair), ``origins2``
    those of stage 2."""
    pad3 = 3 - x.ndim
    info = np.zeros((3, 4), np.int32)
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
    return info


def _morph_args(x, sizes, origins1, origins2, modes, kind):
    """The morphology kernel's dims, per-axis info (:func:`_morph_info`)
    and plan arguments for a non-empty ``x``."""
    info = _morph_info(x, sizes, origins1, origins2, modes)
    shape3 = (1,) * (3 - x.ndim) + tuple(x.shape)
    two = kind in ("opening", "closing")
    # the input's lead along axis 2 (both stages' for the two-stage kernel)
    lead2 = int(info[2, 1]) + (int(info[2, 2]) if two else 0)
    dims, geom = _plan_args(x, shape3, info[:, 0],
                            "open_close" if two else "pair", -lead2 % 4)
    return dims, info, geom


def _launch_morph(x, sizes, origins1, origins2, modes, cval, kind):
    """One launch of a morphology kernel (``kind`` in _MORPH_KINDS)."""
    _check_input(x, sizes, origins1, origins2, modes)
    y = torch.empty_like(x)
    if x.numel() == 0:
        _morph_info(x, sizes, origins1, origins2, modes)
        return y
    dims, info, geom = _morph_args(x, sizes, origins1, origins2, modes, kind)
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
