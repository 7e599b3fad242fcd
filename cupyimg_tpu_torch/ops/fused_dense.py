"""Dense (non-separable) correlation: the CUDA kernel, its tap-group
planner and its plain PyTorch version.

The counterpart of ``cupyimg_tpu/ops/pallas_stencil.py``'s dense half
(``supports_dense``, ``fused_dense_correlate`` -> ``_fused_dense``): a
2-D/3-D float32 correlation over the nonzero taps of a concrete weights
array, in one pass over device memory (``csrc/fused_dense.cu``), with one
ndimage mode applied inside the kernel's loads.  A footprint that
:func:`blocked_plan` accepts runs on the register-blocked kernel (one of
its compile-time instances, ``BLOCKED_INSTANCES``); any other on the
generic kernel, planned by :func:`group_taps`.

For a CUDA tensor :func:`fused_dense_correlate` launches the kernel or
raises; only a CPU tensor takes :func:`fused_dense_correlate_ref`.

:func:`group_taps` also plans the rank kernel (``ops/fused_rank.py``):
both load one halo'd strip of input per group of taps.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, dtypes
from cupyimg_tpu_torch.ops import stencil
from cupyimg_tpu_torch.ops.fused_separable import (
    _MODE_CODES,
    SMEM_LIMIT,
    _window,
)

__all__ = [
    "blocked_plan",
    "fused_dense_correlate",
    "fused_dense_correlate_ref",
    "group_taps",
    "supports_dense",
]

MAX_DENSE_TAPS = 1400
#: output tile of one block (kT1 x kT2 in the kernel)
T1, T2 = 32, 64
#: the largest strip a group may load, in 4-byte words (48 KB)
STRIP_WORDS = 12 * 1024
#: ints per group in the kernel's plan buffer
_GROUP_INTS = 8
#: blocks along axis 0 at most (CUDA's grid.y limit); a block loops over
#: the planes beyond it
_MAX_GRID_Y = 65535
#: the blocked kernel's compile-time instances: (K0 planes, S rows of a
#: chunk) -> rows a thread (R: the output tile is 8R x T2)
BLOCKED_INSTANCES = {
    **{(1, s): 8 for s in (1, 3, 5, 7, 9, 16)},
    **{(k0, s): 4 for k0 in (2, 3, 4, 5) for s in (3, 5)},
}
# one resident wave of the blocked kernel's 3-D blocks: three an SM
_BLOCKED_BLOCKS = 3 * 132


def supports_dense(x, weights):
    """Whether the dense kernel applies: a CUDA float32 tensor, 2-D or
    3-D, concrete real/int/bool weights of the same rank with 1..1400
    nonzero taps and at most twice the array on each axis."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda
            and x.dtype == torch.float32 and x.ndim in (2, 3)):
        return False
    if not isinstance(weights, np.ndarray) or weights.dtype.kind not in "fiub":
        return False
    if weights.ndim != x.ndim:
        return False
    nnz = int(np.count_nonzero(weights))
    if nnz == 0 or nnz > MAX_DENSE_TAPS:
        return False
    return all(ws <= 2 * s for ws, s in zip(weights.shape, x.shape))


# ---------------------------------------------------------------------------
# tap-group planner
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Group:
    """Taps ``taps`` (indices into the tap list) whose offsets lie in the
    strip of plane offset ``d0``, rows ``[d1, d1 + h1 - t1]`` and columns
    ``[d2, d2 + h2 - t2]`` of the footprint; the kernel loads that strip,
    ``h1 x h2`` samples, for a ``t1 x t2`` output tile."""

    d0: int
    d1: int
    d2: int
    h1: int
    h2: int
    taps: tuple


def group_taps(offsets, t1, t2, budget=STRIP_WORDS):
    """Cut the taps ``offsets`` (a list of (d0, d1, d2) footprint indices)
    into groups whose halo'd strip fits ``budget`` words.

    Taps of one plane offset d0 share a strip when it fits; else runs of
    rows d1 do; a row whose column span alone does not fit is cut into
    column ranges.  Every group's strip fits, whatever the footprint's
    extent, since a single tap needs only a ``t1 x t2`` strip.
    """
    if t1 * t2 > budget:
        raise ValueError("the output tile alone exceeds the strip budget")
    planes = {}
    for i, (d0, d1, d2) in enumerate(offsets):
        planes.setdefault(d0, {}).setdefault(d1, []).append((d2, i))
    groups = []

    def words(rows, cols):
        return (t1 + rows - 1) * (t2 + cols - 1)

    def close(d0, rows):
        d1a = rows[0][0]
        taps = [t for _, row in rows for t in row]
        d2a = min(d2 for d2, _ in taps)
        d2b = max(d2 for d2, _ in taps)
        groups.append(Group(
            d0, d1a, d2a, t1 + rows[-1][0] - d1a, t2 + d2b - d2a,
            tuple(i for _, i in sorted(taps, key=lambda t: t[1])),
        ))

    for d0 in sorted(planes):
        rows = sorted(planes[d0].items())
        run = []
        for d1, row in rows:
            row = sorted(row)
            cand = run + [(d1, row)]
            cols = [d2 for _, r in cand for d2, _ in r]
            if words(d1 - cand[0][0] + 1, max(cols) - min(cols) + 1) <= budget:
                run = cand
                continue
            if run:
                close(d0, run)
            if words(1, row[-1][0] - row[0][0] + 1) <= budget:
                run = [(d1, row)]
                continue
            # one row too wide: cut it into column ranges that fit
            span = budget // t1 - t2 + 1
            chunk = []
            for d2, i in row:
                if chunk and d2 - chunk[0][0] + 1 > span:
                    close(d0, [(d1, chunk)])
                    chunk = []
                chunk.append((d2, i))
            run = [(d1, chunk)]
        close(d0, run)
    return groups


def plan_buffer(groups, offsets, values):
    """The kernel's plan as one int32 array: ``len(groups)`` rows of
    (d0, d1, d2, h1, h2, tap_begin, tap_end, 0), then each tap's strip
    offset in group order, then ``values`` (a 4-byte numpy array, one
    entry per tap, as raw words in the same order)."""
    head = np.zeros((len(groups), _GROUP_INTS), np.int32)
    order = []
    offs = []
    for g, grp in enumerate(groups):
        head[g, :7] = (grp.d0, grp.d1, grp.d2, grp.h1, grp.h2, len(order),
                       len(order) + len(grp.taps))
        for i in grp.taps:
            _, d1, d2 = offsets[i]
            offs.append((d1 - grp.d1) * grp.h2 + (d2 - grp.d2))
            order.append(i)
    values = np.ascontiguousarray(values)
    if values.dtype.itemsize != 4 or len(values) != len(offsets):
        raise ValueError("one 4-byte value per tap expected")
    vals = values.view(np.int32)[order]
    return np.concatenate([head.ravel(), np.asarray(offs, np.int32), vals])


def smem_bytes(groups):
    """Shared bytes of the dense kernel: every tap's (offset, weight)
    pair and its largest strip."""
    ntaps = sum(len(g.taps) for g in groups)
    return 8 * ntaps + 4 * max(g.h1 * g.h2 for g in groups)


def grid(shape3, t1, t2):
    """(grid_x, grid_y) over a (n0, n1, n2) array for a t1 x t2 tile."""
    n0, n1, n2 = shape3
    return (math.ceil(n1 / t1) * math.ceil(n2 / t2), min(n0, _MAX_GRID_Y))


@dataclass(frozen=True)
class BlockedPlan:
    """The blocked kernel's plan for one weights array: instance (k0, s)
    with ``rows`` rows a thread; the footprint's nonzero bounding box
    (``start``, ``box``: its extent per axis); ``cols``, the (chunk,
    column) pairs of the box with a nonzero tap, chunk c holding rows
    [c s, c s + s), the ``ndense`` pairs with no zero weight first; their
    weights, (len(cols), k0, s), zero past the box; the shared bytes of a
    block and the stages (input planes in flight, 1 for k0 == 1)."""

    k0: int
    s: int
    rows: int
    start: tuple
    box: tuple
    cols: tuple
    weights: np.ndarray
    smem_bytes: int
    stages: int
    ndense: int

    @property
    def t1(self):
        return 8 * self.rows


def blocked_smem_bytes(ncols, k0, s, rows, box, stages):
    """Shared bytes of the blocked kernel: the (chunk, column) pairs,
    their k0 x s weights, the tile's index maps and ``stages`` tiles of
    (8 rows + chunks s - 1) rows of 16-byte chunks (``H1``, ``H2P`` in
    the kernel)."""
    _, w1, w2 = box
    h1 = 8 * rows + math.ceil(w1 / s) * s - 1
    h2 = T2 + w2 - 1
    head = (2 * ncols + ncols * k0 * s + h1 + h2 + 3) // 4 * 4
    return 4 * (head + stages * h1 * 4 * ((h2 + 6) // 4))


def blocked_plan(w):
    """The blocked kernel's plan for float32 weights ``w`` (2-D or 3-D),
    or None where it does not apply: the nonzero taps' bounding box has
    no instance's K0 planes, the tile does not fit shared memory, or the
    taps are too sparse for register blocking to pay (each (chunk,
    column) pair loads rows + s - 1 samples for ``rows`` outputs, which
    must not exceed one load per nonzero tap).  The chunk size s is the
    instance's that loads the fewest samples, the smaller on a tie."""
    w3 = np.asarray(w, np.float32).reshape((1,) * (3 - w.ndim) + w.shape)
    nz = np.argwhere(w3 != 0)
    if len(nz) == 0:
        return None
    start = nz.min(0)
    stop = nz.max(0) + 1
    box = w3[tuple(slice(a, b) for a, b in zip(start, stop))]
    k0, w1, w2 = box.shape
    cands = sorted(
        (math.ceil(w1 / s) * (r + s - 1), s, r)
        for (kk, s), r in BLOCKED_INSTANCES.items() if kk == k0)
    if not cands:
        return None
    _, s, rows = cands[0]
    chunks = math.ceil(w1 / s)
    padded = np.zeros((k0, chunks * s, w2), np.float32)
    padded[:, :w1] = box
    cols = [(c, d2) for c in range(chunks) for d2 in range(w2)
            if padded[:, c * s:(c + 1) * s, d2].any()]
    # the pairs with no zero weight first: the kernel skips their test
    cols.sort(key=lambda cd: not padded[:, cd[0] * s:(cd[0] + 1) * s,
                                        cd[1]].all())
    ndense = sum(1 for c, d2 in cols
                 if padded[:, c * s:(c + 1) * s, d2].all())
    if len(cols) * (rows + s - 1) > rows * len(nz):
        return None
    weights = np.stack([padded[:, c * s:(c + 1) * s, d2] for c, d2 in cols])
    for stages in ((1,) if k0 == 1 else (4, 3, 2)):
        nbytes = blocked_smem_bytes(len(cols), k0, s, rows, box.shape,
                                    stages)
        if nbytes <= SMEM_LIMIT:
            weights.setflags(write=False)
            return BlockedPlan(k0, s, rows, tuple(int(v) for v in start),
                               box.shape, tuple(cols), weights, nbytes,
                               stages, ndense)
    return None


def blocked_buffer(bp):
    """The blocked kernel's plan buffer: the (chunk, column) pairs as
    int32, then their weights as raw float32 words."""
    pairs = np.asarray(bp.cols, np.int32).reshape(-1)
    return np.concatenate([pairs, bp.weights.reshape(-1).view(np.int32)])


def blocked_grid(shape3, bp):
    """(grid_x, grid_y, z) of the blocked kernel over a (n0, n1, n2)
    array: tiles of 8 rows x T2; one plane a block step for k0 == 1 (a
    block loops over planes past CUDA's grid.y limit), else runs of z
    output planes that keep the blocks within one resident wave."""
    n0, n1, n2 = shape3
    tiles = math.ceil(n1 / bp.t1) * math.ceil(n2 / T2)
    if bp.k0 == 1:
        return tiles, min(n0, _MAX_GRID_Y), 1
    chunks = max(1, min(n0, _BLOCKED_BLOCKS // tiles))
    z = math.ceil(n0 / chunks)
    return tiles, math.ceil(n0 / z), z


def footprint_offsets3(mask):
    """Nonzero footprint indices of a 2-D or 3-D array as (d0, d1, d2)
    triples, in ``np.argwhere`` order (a 2-D index gets d0 = 0)."""
    idx = np.argwhere(mask)
    if mask.ndim == 2:
        idx = np.concatenate([np.zeros((len(idx), 1), idx.dtype), idx], 1)
    return [tuple(int(v) for v in i) for i in idx]


def window_lo(wshape, origins):
    """Per-axis window lead ``size // 2 + origin``, checked in range."""
    return [_window(size, int(o))[0] for size, o in zip(wshape, origins)]


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _launch(x, weights, origins, mode, cval):
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim not in (2, 3):
        raise ValueError(
            "fused_dense kernel takes a 2-D or 3-D float32 CUDA tensor, "
            f"got {x.ndim}-D {x.dtype} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError("fused_dense kernel takes a contiguous tensor")
    if weights.ndim != x.ndim or len(origins) != x.ndim:
        raise ValueError("weights and origins must match the array's rank")
    boundary.check_mode(mode)
    w32 = np.ascontiguousarray(weights, np.float32)
    if not 1 <= np.count_nonzero(w32) <= MAX_DENSE_TAPS:
        raise ValueError(f"fused_dense kernel takes 1..{MAX_DENSE_TAPS} taps")
    los = window_lo(weights.shape, origins)
    pad3 = 3 - x.ndim
    shape3 = (1,) * pad3 + tuple(x.shape)
    los = [0] * pad3 + los
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _library()
    bp, buf = _blocked_device_plan(w32.tobytes(), w32.shape, x.device)
    dims = np.asarray(shape3, np.int32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if bp is not None:
            gx, gy, z = blocked_grid(shape3, bp)
            lo = np.asarray([a - b for a, b in zip(los, bp.start)], np.int32)
            box = np.asarray(bp.box[1:], np.int32)
            vec = int(x.data_ptr() % 16 == 0 and shape3[2] % 4 == 0)
            geom = np.asarray((gx, gy, bp.smem_bytes, z, bp.stages, vec,
                               bp.k0, bp.s, bp.ndense), np.int32)
            err = lib.fused_dense_blocked_f32(
                x.data_ptr(), y.data_ptr(), dims.ctypes.data, lo.ctypes.data,
                box.ctypes.data, _MODE_CODES[mode], float(cval),
                buf.data_ptr(), len(bp.cols), geom.ctypes.data, stream,
            )
        else:
            plan, ngroups, ntaps, smem = _device_plan(
                w32.tobytes(), w32.shape, x.device)
            geom = np.asarray((*grid(shape3, T1, T2), smem), np.int32)
            lo = np.asarray(los, np.int32)
            err = lib.fused_dense_f32(
                x.data_ptr(), y.data_ptr(), dims.ctypes.data, lo.ctypes.data,
                _MODE_CODES[mode], float(cval), plan.data_ptr(), ngroups,
                ntaps, geom.ctypes.data, stream,
            )
    if err != 0:
        raise RuntimeError(f"fused_dense kernel launch failed: CUDA error {err}")
    return y


@functools.lru_cache(maxsize=32)
def _blocked_device_plan(w_bytes, wshape, device):
    """(:func:`blocked_plan`, its buffer on ``device``) for float32
    weights given as raw bytes, or (None, None): built once per weights
    array and device."""
    bp = blocked_plan(np.frombuffer(w_bytes, np.float32).reshape(wshape))
    if bp is None:
        return None, None
    return bp, torch.from_numpy(blocked_buffer(bp)).to(device)


@functools.lru_cache(maxsize=32)
def _device_plan(w_bytes, wshape, device):
    """(plan buffer on ``device``, group count, tap count, shared bytes)
    for float32 weights given as raw bytes: built once per weights array
    and device, so a repeated call spends no host time planning or
    copying."""
    w = np.frombuffer(w_bytes, np.float32).reshape(wshape)
    offsets = footprint_offsets3(w != 0)
    groups = group_taps(offsets, T1, T2)
    buf = plan_buffer(groups, offsets, w[w != 0])
    return (torch.from_numpy(buf).to(device), len(groups), len(offsets),
            smem_bytes(groups))


def _library():
    from cupyimg_tpu_torch.ops import _build

    lib = _build.load("fused_dense")
    fn = lib.fused_dense_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.fused_dense_blocked_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def fused_dense_correlate(x, weights, origins, mode, cval=0.0):
    """Dense nd correlation over the nonzero taps of ``weights``.

    Parameters
    ----------
    x : (S0, S1[, S2]) float32 tensor
    weights : numpy array of the same rank, real, int or bool
    origins : sequence of int, per axis
    mode : str, one ndimage boundary mode for every axis
    cval : float

    A CUDA tensor launches ``csrc/fused_dense.cu`` (and counts one in
    ``fused_dense_correlate.launches``); a CPU tensor runs
    :func:`fused_dense_correlate_ref`.
    """
    weights = np.asarray(weights)
    if x.device.type == "cpu":
        return fused_dense_correlate_ref(x, weights, origins, mode, cval)
    y = _launch(x, weights, origins, mode, cval)
    fused_dense_correlate.launches += 1
    return y


fused_dense_correlate.launches = 0


def fused_dense_correlate_ref(x, weights, origins, mode, cval=0.0):
    """Plain PyTorch version of the kernel: one gather pad, then a
    shifted-slice sum over the nonzero taps in the input's dtype."""
    window_lo(np.shape(weights), origins)
    return stencil.correlate_shift_add(
        x, np.asarray(weights, np.float64), mode, cval, list(origins),
        dtypes.to_numpy(x.dtype),
    )
