"""Rank filter over a footprint of at most 64 taps: the CUDA kernel and
its plain PyTorch version.

The counterpart of ``cupyimg_tpu/ops/pallas_stencil.py``'s rank half
(``supports_rank``, ``fused_rank_filter`` -> ``_fused_rank``): the k-th
order statistic of a 2-D/3-D int32 or float32 array over a boolean
footprint, in one pass over device memory (``csrc/fused_rank.cu``), with
one ndimage mode applied inside the kernel's loads.  The kernel runs the
same pruned Batcher network (``ops/sorting_networks.py``) as the plain
version, so the two agree bitwise, NaN included.

For a CUDA tensor :func:`fused_rank_filter` launches the kernel or
raises; only a CPU tensor takes :func:`fused_rank_filter_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary
from cupyimg_tpu_torch.ops import fused_dense, stencil
from cupyimg_tpu_torch.ops.fused_separable import _MODE_CODES
from cupyimg_tpu_torch.ops.sorting_networks import pruned_network, rank_select

__all__ = [
    "fused_rank_filter",
    "fused_rank_filter_ref",
    "supports_rank",
]

MAX_RANK_TAPS = 64
#: output tile of one block (kT1 x kT2 in the kernel): one output a thread
T1, T2 = 8, 32


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
    pad3 = 3 - x.ndim
    shape3 = (1,) * pad3 + tuple(x.shape)
    los = [0] * pad3 + los
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    plan, ngroups, nces, smem = _device_plan(
        footprint.tobytes(), footprint.shape, rank, x.device)
    geom = np.asarray((*fused_dense.grid(shape3, T1, T2), smem), np.int32)
    counts = np.asarray((ngroups, k, nces, rank), np.int32)
    dims = np.asarray(shape3, np.int32)
    lo = np.asarray(los, np.int32)
    lib = _library()
    fill = boundary.fill_value(cval, x.dtype)
    fn, cv = ((lib.fused_rank_f32, ctypes.c_float(fill))
              if x.dtype == torch.float32 else
              (lib.fused_rank_i32, ctypes.c_int(fill)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
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
    """(plan buffer on ``device``, group count, CE count, shared bytes)
    for a boolean footprint given as raw bytes and a rank: built once per
    footprint, rank and device."""
    offsets = fused_dense.footprint_offsets3(
        np.frombuffer(fp_bytes, bool).reshape(fpshape))
    k = len(offsets)
    groups = fused_dense.group_taps(offsets, T1, T2)
    ces = np.asarray(pruned_network(k, rank), np.int32).reshape(-1)
    buf = np.concatenate([
        fused_dense.plan_buffer(groups, offsets, np.arange(k, dtype=np.int32)),
        ces,
    ])
    # shared words: the CE list padded to 4 words (ce_words in the
    # kernel), k wires of every thread, the largest strip
    ce_words = (len(ces) // 2 + 3) // 4 * 4
    smem = 4 * (ce_words + k * T1 * T2 + max(g.h1 * g.h2 for g in groups))
    return torch.from_numpy(buf).to(device), len(groups), len(ces) // 2, smem


def _library():
    from cupyimg_tpu_torch.ops import _build

    lib = _build.load("fused_rank")
    for fn, cv in ((lib.fused_rank_f32, ctypes.c_float),
                   (lib.fused_rank_i32, ctypes.c_int)):
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, cv, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
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
    pruned Batcher network over the shifted slices (taps in
    ``np.argwhere`` order, as the kernel's wires)."""
    footprint = np.asarray(footprint, bool)
    fused_dense.window_lo(footprint.shape, origins)
    taps, pad_width = stencil.footprint_offsets(footprint, origins)
    xp = boundary.pad(x, pad_width, mode, cval)
    vals = [xp[tuple(slice(o, o + n) for o, n in zip(off, x.shape))]
            for off in taps]
    return rank_select(vals, int(rank)).clone()
