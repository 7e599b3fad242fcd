"""Coordinate thinning (skimage._shared.coord.ensure_spacing) on torch
tensors.

A point survives unless an earlier surviving point (in row order) lies
within ``spacing``.  The pairwise "close" matrix is computed on the
device a block of rows at a time and each block comes to the host once,
where the greedy pass runs: each kept point strikes the later points
close to it.  A block holds at most ``_BLOCK_ELEMENTS`` pairs, so that
n^2 need not fit anywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

__all__ = ["ensure_spacing"]

#: pairs of the close matrix per block (one host transfer each)
_BLOCK_ELEMENTS = 2 ** 26


def _close(block, coords, spacing, p_norm, strict):
    diff = block[:, None, :] - coords[None, :, :]
    if np.isinf(p_norm):
        dist = torch.amax(torch.abs(diff), dim=-1)
    else:
        dist = torch.sum(torch.abs(diff) ** p_norm, dim=-1) ** (1.0 / p_norm)
    # strict: points exactly `spacing` apart both survive; not strict
    # (corner_peaks' raw ball query): they conflict
    return dist < spacing if strict else dist <= spacing


def ensure_spacing(coord, spacing=1, p_norm=np.inf, *, max_out=None,
                   strict=True):
    """The rows of ``coord`` (priority = row order) that are pairwise at
    least ``spacing`` apart in the ``p_norm`` (Minkowski p) distance;
    at most ``max_out`` of them.  A tensor on ``coord``'s device."""
    coords = util.as_tensor(coord)
    if coords.ndim == 1:
        coords = coords[:, None]
    n = coords.shape[0]
    if n == 0:
        return coords
    work = coords if coords.is_floating_point() else coords.to(torch.float64)
    keep = np.ones(n, dtype=bool)
    rows = max(1, _BLOCK_ELEMENTS // n)
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        close = _close(work[i0:i1], work, spacing, p_norm,
                       strict).cpu().numpy()
        for i in range(i0, i1):
            if keep[i]:
                keep[i + 1:] &= ~close[i - i0, i + 1:]
    idx = np.flatnonzero(keep)
    if max_out is not None:
        idx = idx[:max_out]
    return coords[torch.as_tensor(idx, device=coords.device)]
