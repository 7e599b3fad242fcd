"""Distance transforms on torch tensors (scipy parity, as ``cupyimg_tpu``
computes them).

The exact squared Euclidean distance transform is separable into per-axis
*min-plus convolutions* ``g(i) = min_j (f(j) + s^2 (i-j)^2)`` (Felzenszwalb
& Huttenlocher 2012), evaluated directly as a blocked reduction over j
in float32: O(n) per output, but parallel over rows and outputs.  The
(rows, n, B) cost tensor of one block of j is materialised, so rows are
taken in chunks whose cost tensor stays within ``_CHUNK_BYTES``.
Feature indices (``return_indices``) ride along as the argmin of the
same reduction; a tie goes to the lowest j.

``distance_transform_cdt`` (taxicab, chessboard) iterates a unit-ball
dilation of the background to its fixpoint; ``distance_transform_bf``
dispatches to the two.  All plain torch, on any device.

Differences from scipy (as ``cupyimg_tpu``): the EDT is float32 where
scipy's is float64; ``distance_transform_cdt(return_indices=True)``
returns the Euclidean argmin; an input without background gives scipy's
"virtual feature" at (-1, 0, ..., 0); ``distances=``/``indices=`` output
arrays and custom chamfer metrics raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

__all__ = [
    "distance_transform_edt",
    "distance_transform_cdt",
    "distance_transform_bf",
]

_BLOCK = 256
# bytes of one chunk's (rows, n, B) float32 cost tensor
_CHUNK_BYTES = 256 << 20


def _minplus_rows(f, scale2, track):
    """``out[r, i] = min_j f[r, j] + scale2 * (i - j)^2`` for a (R, n)
    float32 tensor, with the argmin j (int64) when ``track``."""
    R, n = f.shape
    dev = f.device
    i = torch.arange(n, dtype=torch.float32, device=dev)
    best_v = torch.full((R, n), float("inf"), dtype=torch.float32,
                        device=dev)
    best_j = torch.zeros((R, n), dtype=torch.int64, device=dev) if track \
        else None
    for j0 in range(0, n, _BLOCK):
        jb = torch.arange(j0, min(j0 + _BLOCK, n), device=dev)
        d = i[:, None] - jb.to(torch.float32)          # (n, B)
        cost = f[:, None, j0:j0 + jb.numel()] + scale2 * (d * d)  # (R, n, B)
        if track:
            v, a = cost.min(dim=-1)  # the first index of a tie
            upd = v < best_v         # strict: earlier blocks keep ties
            best_v = torch.where(upd, v, best_v)
            best_j = torch.where(upd, jb[a], best_j)
        else:
            best_v = torch.minimum(best_v, cost.amin(dim=-1))
    return best_v, best_j


def _minplus_axis(f, pos, axis, scale2, track):
    """One min-plus pass along ``axis``; carries the per-axis feature
    coordinates in ``pos`` through the argmin when ``track``."""
    n = f.shape[axis]
    fm = f.movedim(axis, -1)
    lead = fm.shape[:-1]
    fm = fm.reshape(-1, n)
    rows = max(1, _CHUNK_BYTES // (4 * n * min(n, _BLOCK)))
    vals, idx = [], []
    for r0 in range(0, fm.shape[0], rows):
        v, j = _minplus_rows(fm[r0:r0 + rows], scale2, track)
        vals.append(v)
        idx.append(j)
    out = torch.cat(vals).reshape(*lead, n).movedim(-1, axis)
    if not track:
        return out, pos
    bestj = torch.cat(idx)
    new_pos = []
    for p in pos:
        pm = p.movedim(axis, -1).reshape(-1, n)
        g = torch.take_along_dim(pm, bestj, dim=-1)
        new_pos.append(g.reshape(*lead, n).movedim(-1, axis))
    return out, new_pos


def _sampling(sampling, ndim):
    if sampling is None:
        return (1.0,) * ndim
    if np.isscalar(sampling):
        return (float(sampling),) * ndim
    return tuple(float(s) for s in np.asarray(sampling))


def _edt_core(x, sampling, track):
    """Squared distances by per-axis min-plus passes, then the root;
    the feature coordinates (int32) when ``track``."""
    ndim = x.ndim
    f = torch.where(x, torch.tensor(1e20, dtype=torch.float32,
                                    device=x.device),
                    torch.tensor(0.0, dtype=torch.float32, device=x.device))
    pos = None
    if track:
        pos = [
            torch.arange(x.shape[ax], dtype=torch.int32, device=x.device)
            .reshape([-1 if i == ax else 1 for i in range(ndim)])
            .expand(x.shape)
            for ax in range(ndim)
        ]
    for ax in range(ndim):
        # new_pos[ax] is the coordinate stored at the argmin: correct as is
        f, pos = _minplus_axis(f, pos, ax, float(np.float32(sampling[ax] ** 2)),
                               track)
    return torch.sqrt(f), pos


def distance_transform_edt(
    input, sampling=None, return_distances=True, return_indices=False,
    distances=None, indices=None,
):
    """Exact Euclidean distance transform (scipy parity; float32
    distances, int32 indices)."""
    if distances is not None or indices is not None:
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: output arrays are returned, "
            "not written in place"
        )
    if not (return_distances or return_indices):
        raise RuntimeError("at least one output must be requested")
    x = util.as_tensor(input) != 0
    ndim = x.ndim
    samp = _sampling(sampling, ndim)
    if x.numel() == 0:  # scipy: empty distances, (ndim, *shape) indices
        results = []
        if return_distances:
            results.append(torch.zeros(x.shape, dtype=torch.float32,
                                       device=x.device))
        if return_indices:
            results.append(torch.zeros((ndim,) + tuple(x.shape),
                                       dtype=torch.int32, device=x.device))
        return results[0] if len(results) == 1 else tuple(results)
    dist, pos = _edt_core(x, samp, bool(return_indices))
    # scipy's answer for an input without background: the nearest
    # "feature" is the virtual index (-1, 0, ..., 0)
    has_bg = (~x).any()
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for ax in range(ndim):
        g = torch.arange(x.shape[ax], dtype=torch.float32, device=x.device)
        if ax == 0:
            g = g + 1.0
        shp = [1] * ndim
        shp[ax] = x.shape[ax]
        acc = acc + (g.reshape(shp) * float(np.float32(samp[ax]))) ** 2
    virtual = torch.sqrt(acc).expand(x.shape)
    dist = torch.where(has_bg, dist, virtual)
    results = []
    if return_distances:
        results.append(dist)
    if return_indices:
        idx = torch.stack(pos, dim=0)
        vidx = torch.zeros_like(idx)
        vidx[0] = -1
        results.append(torch.where(has_bg, idx, vidx))
    return results[0] if len(results) == 1 else tuple(results)


_CDT_METRICS = {
    "taxicab": 1,
    "cityblock": 1,
    "manhattan": 1,
    "chessboard": np.inf,
}


def _cdt_core(x, metric):
    """Chamfer distance by iterated unit-ball dilation of the
    background to its fixpoint (one convergence check per step), exact
    for the taxicab and chessboard metrics."""
    ndim = x.ndim
    big = np.iinfo(np.int32).max // 2
    d = torch.where(x, big, 0).to(torch.int32)
    if metric == "chessboard":
        offsets = [tuple(int(o) - 1 for o in off)
                   for off in np.ndindex(*([3] * ndim))
                   if any(o != 1 for o in off)]
    else:
        offsets = []
        for ax in range(ndim):
            for s in (-1, 1):
                off = [0] * ndim
                off[ax] = s
                offsets.append(tuple(off))
    padded = torch.full([n + 2 for n in d.shape], big, dtype=torch.int32,
                        device=d.device)
    inner = tuple(slice(1, n + 1) for n in d.shape)
    while True:
        padded[inner] = d
        best = d
        for off in offsets:
            sl = tuple(slice(1 - o, 1 - o + n) for o, n in zip(off, d.shape))
            best = torch.minimum(best, padded[sl] + 1)
        if torch.equal(best, d):
            return d
        d = best


def distance_transform_cdt(
    input, metric="chessboard", return_distances=True, return_indices=False,
    distances=None, indices=None,
):
    """Chamfer distance transform, taxicab or chessboard (scipy parity;
    the indices are the Euclidean argmin, as in ``cupyimg_tpu``)."""
    if distances is not None or indices is not None:
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: output arrays are returned, "
            "not written in place"
        )
    if isinstance(metric, str):
        m = metric.lower()
        if m not in _CDT_METRICS:
            raise ValueError("invalid metric provided")
    else:
        raise NotImplementedError(
            "custom structuring-element metrics are not supported"
        )
    x = util.as_tensor(input) != 0
    results = []
    if return_distances:
        out = _cdt_core(x, "chessboard" if m == "chessboard" else "taxicab")
        # scipy returns -1 everywhere when there is no background
        results.append(torch.where((~x).any(), out, -1))
    if return_indices:
        _, pos = _edt_core(x, (1.0,) * x.ndim, True)
        results.append(torch.stack(pos, dim=0))
    if not results:
        raise RuntimeError("at least one output must be requested")
    return results[0] if len(results) == 1 else tuple(results)


def distance_transform_bf(
    input, metric="euclidean", sampling=None, return_distances=True,
    return_indices=False, distances=None, indices=None,
):
    """Brute-force distance transform (scipy parity): the exact engines
    above give the same answers."""
    m = metric.lower() if isinstance(metric, str) else metric
    if m in ("euclidean", 1):
        return distance_transform_edt(input, sampling, return_distances,
                                      return_indices, distances, indices)
    if m in ("taxicab", "cityblock", "manhattan", 2):
        name = "taxicab"
    elif m in ("chessboard", 3):
        name = "chessboard"
    else:
        raise RuntimeError("distance metric not supported")
    return distance_transform_cdt(input, name, return_distances,
                                  return_indices, distances, indices)
