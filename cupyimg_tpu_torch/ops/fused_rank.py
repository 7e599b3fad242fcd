"""Rank filter over a footprint of at most 64 taps: the CUDA kernel and
its plain PyTorch version.

The counterpart of ``cupyimg_tpu/ops/pallas_stencil.py``'s rank half
(``supports_rank``, ``fused_rank_filter`` -> ``_fused_rank``): the k-th
order statistic of a 2-D/3-D int32 or float32 array over a boolean
footprint, in one pass over device memory (``csrc/fused_rank.cu``), with
one ndimage mode applied inside the kernel's loads.

Two kinds of instance serve a call.  The footprints and ranks of
:data:`INSTANCES` (every interior rank of the 3x3, 5x5 and 3x3x3 boxes,
the 7x7 median, every rank of the 3x3 cross) have compile-time networks
(``csrc/rank_networks.cuh``, written by :func:`write_header` from
``ops/sorting_networks.py``) with the wires in registers; a full
rectangle among them shares its presort along axis 0, as the JAX
kernel's rectangle route shares it: a thread owns :data:`R` outputs of
one column, sorts each lane window once, merges each plane's rows once,
and runs only the merge of the sorted runs per output.  Any other
footprint of 3..64 taps runs on the generic instance, which stages the
CE list of :func:`~cupyimg_tpu_torch.ops.sorting_networks.flat_rank_network`
at run time.  Every route (both instances and :func:`fused_rank_filter_ref`)
runs the same compare-exchanges on the same values, so they agree
bitwise, NaN included.

For a CUDA tensor :func:`fused_rank_filter` launches the kernel or
raises; only a CPU tensor takes :func:`fused_rank_filter_ref`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary
from cupyimg_tpu_torch.ops import fused_dense, sorting_networks, stencil
from cupyimg_tpu_torch.ops.fused_separable import _MODE_CODES
from cupyimg_tpu_torch.ops.sorting_networks import (
    flat_rank_network, rank_select, rank_select_presorted, sort_runs_values,
    sort_values)

__all__ = [
    "INSTANCES",
    "Instance",
    "fused_rank_filter",
    "fused_rank_filter_ref",
    "instance",
    "supports_rank",
    "write_header",
]

MAX_RANK_TAPS = 64
#: output tile of one block of the generic instance (kT1 x kT2 in the
#: kernel): one output a thread
T1, T2 = 8, 32
#: outputs of one thread of a compile-time instance along axis 0, at
#: least (kR; a rectangle rounds it up to whole rounds of F0,
#: :func:`instance_rows`)
R = 8
#: threads of a block of a compile-time instance (kIThreads)
INSTANCE_THREADS = 128
#: parts the compile-time instances are built in (``ops/_build.py``)
PARTS = 4
HEADER = Path(__file__).resolve().parent.parent / "csrc" / "rank_networks.cuh"


def _shape3(shape):
    """A footprint's shape as the instances see it: 2-D (a, b) as
    (a, 1, b), so that axis 0 is the axis a thread marches along."""
    shape = tuple(int(v) for v in shape)
    return (shape[0], 1, shape[1]) if len(shape) == 2 else shape


def _mask(footprint):
    """The footprint's taps as a C-order bit mask (bit i: tap at flat
    index i)."""
    return int(sum(1 << int(i) for i in np.flatnonzero(footprint.ravel())))


def _instances():
    full = {s: (1 << int(np.prod(s))) - 1 for s in
            ((3, 1, 3), (5, 1, 5), (3, 3, 3), (7, 1, 7))}
    cross = _mask(np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool))
    out = [((3, 1, 3), full[3, 1, 3], r) for r in range(1, 8)]
    out += [((5, 1, 5), full[5, 1, 5], r) for r in range(1, 24)]
    out += [((3, 3, 3), full[3, 3, 3], r) for r in range(1, 26)]
    out += [((7, 1, 7), full[7, 1, 7], 24)]
    out += [((3, 1, 3), cross, r) for r in range(5)]
    return tuple(out)


#: the compile-time instances, by id: ``(footprint shape as (F0, F1, F2),
#: C-order tap mask, rank)``.  Ranks 0 and K-1 of a box route to the
#: min/max filter before they get here.
INSTANCES = _instances()
#: the data types each instance is built for: float32 for all, int32 for
#: the 3x3 footprints (the main path's int32 call is the cross); an int32
#: 5x5, 7x7 or 3x3x3 box runs on the generic instance, which keeps the
#: build within its time
INSTANCE_TYPES = tuple(
    (torch.float32, torch.int32) if inst[0] == (3, 1, 3) else (torch.float32,)
    for inst in INSTANCES)


def _cost(i):
    """Compare-exchanges in the unrolled bodies of instance ``i``, in
    all its types (the build's load, used to spread the instances over
    the parts)."""
    (f0, f1, f2), mask, rank = INSTANCES[i]
    k = bin(mask).count("1")
    if k != f0 * f1 * f2:
        body = R * len(sorting_networks.pruned_network(k, rank))
    else:
        lane, (merge, _), (final, _) = sorting_networks.rect_stages(
            (f0, f1, f2), rank)
        # the unrolled code: F0 - 1 planes before the rounds, one round
        # of F0
        body = (2 * f0 - 1) * (f1 * len(lane) + len(merge)) + f0 * len(final)
    return len(INSTANCE_TYPES[i]) * body


def _parts():
    """Each instance's part: the costliest first, each to the part with
    the least load so far."""
    load = [0] * PARTS
    part = [0] * len(INSTANCES)
    for i in sorted(range(len(INSTANCES)), key=lambda i: -_cost(i)):
        p = load.index(min(load))
        part[i] = p
        load[p] += _cost(i)
    return tuple(part)


INSTANCE_PARTS = _parts()
_INSTANCE_IDS = {inst: i for i, inst in enumerate(INSTANCES)}


def header_text():
    """The text of ``csrc/rank_networks.cuh`` for :data:`INSTANCES`."""
    types = [sum(1 << t for t, dt in enumerate((torch.float32, torch.int32))
                 if dt in ts) for ts in INSTANCE_TYPES]
    return sorting_networks.cuda_networks(INSTANCES, INSTANCE_PARTS, types)


def write_header(path=HEADER):
    """Write ``csrc/rank_networks.cuh`` (run ``python -m
    cupyimg_tpu_torch.ops.fused_rank`` after changing :data:`INSTANCES`)."""
    Path(path).write_text(header_text())


class Instance(NamedTuple):
    """The instance that serves a call: ``id`` in :data:`INSTANCES` and
    the ``part`` it is built in, or ``id`` None for the generic one."""

    id: int | None
    part: int


def instance(footprint, rank, dtype=torch.float32):
    """The instance for a boolean footprint (2-D or 3-D), a rank and the
    data's type."""
    footprint = np.asarray(footprint, bool)
    key = (_shape3(footprint.shape), _mask(footprint), int(rank))
    i = _INSTANCE_IDS.get(key) if footprint.ndim in (2, 3) else None
    if i is None or dtype not in INSTANCE_TYPES[i]:
        return Instance(None, 0)
    return Instance(i, INSTANCE_PARTS[i])


def instance_rows(fshape3, rect):
    """Outputs of one thread along axis 0: R, rounded up to whole rounds
    of F0 for a full rectangle (``R`` in the kernel)."""
    return fshape3[0] * math.ceil(R / fshape3[0]) if rect else R


def instance_geometry(shape3, fshape3, rect):
    """(grid_x, grid_y, block_x, block_y, shared bytes) of a compile-time
    instance over a (n0, n1, n2) array, the array's 2-D form being
    (n0, 1, n1): blocks of 128 threads, 128 x 1 in 2-D and 32 x 4 in
    3-D, each thread :func:`instance_rows` outputs along axis 0; the
    halo'd tile holds the block's rows + F0 - 1 planes of (by + F1 - 1)
    rows, each row 16-byte chunks covering bx + F2 - 1 samples from any
    alignment."""
    n0, n1, n2 = shape3
    f0, f1, f2 = fshape3
    r = instance_rows(fshape3, rect)
    by = 1 if n1 == 1 else 4
    bx = INSTANCE_THREADS // by
    row = 4 * math.ceil((bx + f2 - 1 + 3) / 4)
    smem = 4 * (r + f0 - 1) * (by + f1 - 1) * row
    return (math.ceil(n2 / bx) * math.ceil(n1 / by), math.ceil(n0 / r), bx,
            by, smem)


def supports_rank(x, filter_size):
    """Whether the rank kernel applies: a CUDA int32 or float32 tensor,
    2-D or 3-D, and a footprint of 3..64 taps."""
    return (
        isinstance(x, torch.Tensor)
        and x.is_cuda
        and x.dtype in (torch.int32, torch.float32)
        and x.ndim in (2, 3)
        and 3 <= filter_size <= MAX_RANK_TAPS
    )


def _launch(x, footprint, origins, rank, mode, cval):
    if not x.is_cuda or x.dtype not in (torch.int32, torch.float32) or (
            x.ndim not in (2, 3)):
        raise ValueError(
            "fused_rank kernel takes a 2-D or 3-D int32 or float32 CUDA "
            f"tensor, got {x.ndim}-D {x.dtype} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError("fused_rank kernel takes a contiguous tensor")
    if footprint.ndim != x.ndim or len(origins) != x.ndim:
        raise ValueError("footprint and origins must match the array's rank")
    boundary.check_mode(mode)
    k = int(footprint.sum())
    if not 1 <= k <= MAX_RANK_TAPS or not 0 <= rank < k:
        raise ValueError(
            f"fused_rank kernel takes 1..{MAX_RANK_TAPS} taps and a rank "
            f"in range, got {k} taps and rank {rank}"
        )
    los = fused_dense.window_lo(footprint.shape, origins)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fill = boundary.fill_value(cval, x.dtype)
    is_int = x.dtype == torch.int32
    inst = instance(footprint, rank, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if inst.id is not None:
            # the 2-D form (n0, 1, n1): axis 0 is the one a thread marches
            shape3 = _shape3(x.shape)
            lo = np.asarray(_shape3(los), np.int32)
            if x.ndim == 2:
                lo[1] = 0
            geom = np.asarray(instance_geometry(
                shape3, _shape3(footprint.shape), bool(footprint.all())),
                np.int32)
            vec = int(x.data_ptr() % 16 == 0 and shape3[2] % 4 == 0)
            dims = np.asarray(shape3, np.int32)
            err = _library(inst.part).fused_rank_instance(
                inst.id, int(is_int), x.data_ptr(), y.data_ptr(),
                dims.ctypes.data, lo.ctypes.data,
                _MODE_CODES[mode], float(fill) if not is_int else 0.0,
                int(fill) if is_int else 0, vec, geom.ctypes.data, stream)
        else:
            # a 2-D array runs as (1, n0, n1)
            pad3 = 3 - x.ndim
            shape3 = (1,) * pad3 + tuple(x.shape)
            plan, ngroups, nces, out, smem = _device_plan(
                footprint.tobytes(), footprint.shape, rank, x.device)
            geom = np.asarray((*fused_dense.grid(shape3, T1, T2), smem),
                              np.int32)
            counts = np.asarray((ngroups, k, nces, out), np.int32)
            dims = np.asarray(shape3, np.int32)
            lo = np.asarray([0] * pad3 + los, np.int32)
            lib = _library(0)
            fn, cv = ((lib.fused_rank_i32, ctypes.c_int(fill)) if is_int else
                      (lib.fused_rank_f32, ctypes.c_float(fill)))
            err = fn(
                x.data_ptr(), y.data_ptr(), dims.ctypes.data, lo.ctypes.data,
                _MODE_CODES[mode], cv, plan.data_ptr(), counts.ctypes.data,
                geom.ctypes.data, stream,
            )
    if err != 0:
        raise RuntimeError(f"fused_rank kernel launch failed: CUDA error {err}")
    return y


@functools.lru_cache(maxsize=32)
def _device_plan(fp_bytes, fpshape, rank, device):
    """(plan buffer on ``device``, group count, CE count, output wire,
    shared bytes) of the generic instance for a boolean footprint given
    as raw bytes and a rank: built once per footprint, rank and
    device."""
    fp = np.frombuffer(fp_bytes, bool).reshape(fpshape)
    offsets = fused_dense.footprint_offsets3(fp)
    k = len(offsets)
    groups = fused_dense.group_taps(offsets, T1, T2)
    ces, out = flat_rank_network(_shape3(fpshape), _mask(fp), rank)
    ces = np.asarray(ces, np.int32).reshape(-1)
    buf = np.concatenate([
        fused_dense.plan_buffer(groups, offsets, np.arange(k, dtype=np.int32)),
        ces,
    ])
    # shared words: the CE list padded to 4 words (ce_words in the
    # kernel), k wires of every thread, the largest strip
    ce_words = (len(ces) // 2 + 3) // 4 * 4
    smem = 4 * (ce_words + k * T1 * T2 + max(g.h1 * g.h2 for g in groups))
    return (torch.from_numpy(buf).to(device), len(groups), len(ces) // 2, out,
            smem)


@functools.cache
def _library(part):
    """The built library of one part: every part holds its instances'
    entry ``fused_rank_instance``, part 0 also the generic instance's
    ``fused_rank_f32`` / ``fused_rank_i32``."""
    from cupyimg_tpu_torch.ops import _build

    lib = _build.load("fused_rank", part)
    if part == 0:
        for fn, cv in ((lib.fused_rank_f32, ctypes.c_float),
                       (lib.fused_rank_i32, ctypes.c_int)):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int, cv, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
    fn = lib.fused_rank_instance
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_rank_filter(x, footprint, origins, rank, mode, cval=0.0):
    """The ``rank``-th smallest value over a boolean footprint.

    Parameters
    ----------
    x : (S0, S1[, S2]) int32 or float32 tensor
    footprint : boolean numpy array of the same rank, at most 64 taps
    origins : sequence of int, per axis
    rank : int in [0, taps)
    mode : str, one ndimage boundary mode for every axis
    cval : float, converted to the array's dtype

    A CUDA tensor launches ``csrc/fused_rank.cu`` (and counts one in
    ``fused_rank_filter.launches``); a CPU tensor runs
    :func:`fused_rank_filter_ref`.
    """
    footprint = np.ascontiguousarray(footprint, bool)
    if x.device.type == "cpu":
        return fused_rank_filter_ref(x, footprint, origins, rank, mode, cval)
    y = _launch(x, footprint, origins, int(rank), mode, cval)
    fused_rank_filter.launches += 1
    return y


fused_rank_filter.launches = 0


def fused_rank_filter_ref(x, footprint, origins, rank, mode, cval=0.0):
    """Plain PyTorch version of the kernel: one gather pad, then the
    kernel's network over shifted slices.  A full rectangle runs its
    shared presort, as ``cupyimg_tpu``'s rectangle route does: the lane
    windows sorted once over the padded array, in 3-D each plane's rows
    merged once, then the pruned merge of the sorted runs; any other
    footprint the pruned Batcher network over its taps in ``np.argwhere``
    order (the kernel's wires)."""
    footprint = np.asarray(footprint, bool)
    fused_dense.window_lo(footprint.shape, origins)
    taps, pad_width = stencil.footprint_offsets(footprint, origins)
    xp = boundary.pad(x, pad_width, mode, cval)
    rank = int(rank)
    if footprint.ndim not in (2, 3) or not footprint.all():
        vals = [xp[tuple(slice(o, o + n) for o, n in zip(off, x.shape))]
                for off in taps]
        return rank_select(vals, rank).clone()
    w = footprint.shape[-1]
    lane = sort_values([xp[..., k:k + x.shape[-1]] for k in range(w)])
    if footprint.ndim == 3:
        w1, n1 = footprint.shape[1], x.shape[1]
        lane = sort_runs_values([[v[:, k:k + n1] for v in lane]
                                 for k in range(w1)])
    n0 = x.shape[0]
    runs = [[v[k:k + n0] for v in lane] for k in range(footprint.shape[0])]
    return rank_select_presorted(runs, rank).clone()


if __name__ == "__main__":
    write_header()
