"""Morphological reconstruction (skimage.morphology.reconstruction).

Computed on the device as geodesic dilation (erosion) iterated to its
fixpoint::

    rec <- min(rec (+) selem, mask)      (dilation method)
    rec <- max(rec (-) selem, mask)      (erosion method)

Each sweep combines the footprint's shifted copies in place; values move
one footprint radius a sweep.  Convergence is checked once every
``_CHECK`` sweeps (a check waits for the device; sweeps past the fixpoint
change nothing).  The sweeps run are added to ``reconstruction.sweeps``.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = ["reconstruction"]

_CHECK = 4


def _pairs(offsets, shape):
    """(destination, source) slices of each offset: ``out[i] <-
    x[i - offset]`` where ``i - offset`` lies inside ``shape``."""
    out = []
    for off in offsets:
        dst, src = [], []
        for o, n in zip(off, shape):
            dst.append(slice(max(0, o), n + min(0, o)))
            src.append(slice(max(0, -o), n - max(0, o)))
        out.append((tuple(dst), tuple(src)))
    return out


def _reconstruct_loop(seed, mask, offsets, method):
    combine = torch.maximum if method == "dilation" else torch.minimum
    clamp = torch.minimum if method == "dilation" else torch.maximum
    pairs = _pairs(offsets, seed.shape)

    def sweep(r):
        acc = r.clone()
        for dst, src in pairs:
            acc[dst] = combine(acc[dst], r[src])
        return clamp(acc, mask)

    rec = seed
    sweeps = 0
    while True:
        prev = rec
        for _ in range(_CHECK):
            rec = sweep(rec)
        sweeps += _CHECK
        if torch.equal(rec, prev):
            break
    reconstruction.sweeps += sweeps
    return rec


def reconstruction(seed, mask, method="dilation", selem=None, offset=None):
    """Morphological reconstruction of ``seed`` under ``mask``
    (skimage.morphology.reconstruction: the same arguments and checks),
    computed as geodesic dilation or erosion to the fixpoint."""
    seed = util.as_tensor(seed)
    mask = util.as_tensor(mask, device=seed.device)
    if tuple(seed.shape) != tuple(mask.shape):
        raise ValueError("seed and mask must have the same shape")
    if method == "dilation" and bool((seed > mask).any()):
        raise ValueError(
            "Intensity of seed image must be less than that "
            "of the mask image for reconstruction by dilation."
        )
    if method == "erosion" and bool((seed < mask).any()):
        raise ValueError(
            "Intensity of seed image must be greater than that "
            "of the mask image for reconstruction by erosion."
        )
    if method not in ("dilation", "erosion"):
        raise ValueError(
            "Reconstruction method can be one of 'erosion' "
            "or 'dilation'. Got '%s'." % method
        )
    if selem is None:
        selem = np.ones((3,) * seed.ndim, dtype=bool)
    else:
        if isinstance(selem, torch.Tensor):
            selem = selem.cpu().numpy()
        selem = np.asarray(selem).astype(bool)
    if offset is None:
        if not all(d % 2 == 1 for d in selem.shape):
            raise ValueError("Footprint dimensions must all be odd")
        offset = np.array([d // 2 for d in selem.shape])
    else:
        offset = np.asarray(offset)
        if offset.ndim != selem.ndim:
            raise ValueError("Offset and selem ndims must be equal.")
        if not all(0 <= o < d for o, d in zip(offset, selem.shape)):
            raise ValueError("Offset must be included inside selem")
    # neighbour offsets (the centre is the accumulator's own start)
    coords = np.argwhere(selem) - offset[None, :]
    offsets = [tuple(int(c) for c in row) for row in coords if row.any()]
    dtype = dtypes.to_torch(np.promote_types(dtypes.to_numpy(seed.dtype),
                                             dtypes.to_numpy(mask.dtype)))
    return _reconstruct_loop(seed.to(dtype), mask.to(dtype), offsets, method)


reconstruction.sweeps = 0
