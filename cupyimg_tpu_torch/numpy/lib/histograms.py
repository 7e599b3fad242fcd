"""The histogram family with numpy's semantics on torch tensors.

The bin edges are numpy's own: the data's minimum and maximum come to
the host in one sync (none when ``range`` or explicit edges are given)
and ``np.histogram_bin_edges`` computes the edges there, with numpy's
dtype, rounding and errors.  Binning runs on the device:
``searchsorted(edges, x, side="right") - 1``, the last bin edge-inclusive,
samples outside the edges dropped; counts by ``bincount`` (int64), weights
by ``index_add_``.  Integer and bool weights sum in int64, complex weights
in complex128 and real ones in float64, each cast at the end to numpy's
result dtype (``torch.histogram`` has no CUDA kernel, ``torch.histc``
takes no weights and ``bincount`` sums in float64 only).

Where this departs from numpy, it follows ``cupyimg_tpu``: string bin
rules raise NotImplementedError, float weights give at least float32,
and ``histogramdd``/``histogram2d`` counts are int64 (numpy: float64).
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = ["histogram", "histogram2d", "histogramdd"]


_SIGN = -(2 ** 63)


def _widen(x):
    """``x`` in a signed type holding its values; uint64 stays uint64,
    which :func:`_order_keys` and :func:`_bin_index` handle."""
    return x if x.dtype == torch.uint64 else dtypes.widen_unsigned(x)


def _order_keys(x):
    """int64 keys in the order of ``x``'s values: uint64 with its sign bit
    flipped (its bits as int64 would put 2^63 and above below 0)."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ _SIGN
    return x


def _ravel_and_check_weights(a, weights):
    a = util.as_tensor(a)
    if a.is_complex():
        raise NotImplementedError("complex number is not supported")
    if a.dtype == torch.bool:
        a = a.to(torch.uint8)
    a = _widen(a)
    if weights is not None:
        weights = util.as_tensor(weights, device=a.device)
        if weights.shape != a.shape:
            raise ValueError("weights should have the same shape as a.")
        weights = weights.reshape(-1)
    return a.reshape(-1), weights


def _host_bins(bins):
    """``bins`` as a host object: a count, or a numpy array of edges."""
    if isinstance(bins, str):
        raise NotImplementedError(
            "only integer and array bins are implemented")
    if isinstance(bins, torch.Tensor):
        return bins.detach().cpu().numpy()
    arr = np.asarray(bins)
    if arr.ndim == 0:
        try:
            return operator.index(bins)
        except TypeError:
            raise TypeError(
                "`bins` must be an integer, a string, or an array")
    return arr


def _edges(columns, bins, ranges):
    """numpy's bin edges of each 1-D column: a list of host arrays.  The
    columns that need their data's range send their minima and maxima to
    the host together, one sync."""
    need = [i for i, (b, r) in enumerate(zip(bins, ranges))
            if np.ndim(b) == 0 and r is None and columns[i].numel() > 0]
    lims = {}
    if need:
        mm = torch.stack([torch.stack(torch.aminmax(_order_keys(columns[i])))
                          for i in need]).cpu().numpy()
        lims = {i: (np.bitwise_xor(m, np.int64(_SIGN)).view(np.uint64)
                    if columns[i].dtype == torch.uint64 else m)
                for i, m in zip(need, mm)}
    out = []
    for i, (col, b, r) in enumerate(zip(columns, bins, ranges)):
        np_dt = dtypes.to_numpy(col.dtype)
        if np.ndim(b) == 1:
            e = np.asarray(b)
            if e.size > 1 and np.any(e[:-1] > e[1:]):
                raise ValueError(
                    "`bins` must increase monotonically, when an array")
            out.append(e)
            continue
        if np.ndim(b) != 0:
            raise ValueError("`bins` must be 1d, when an array")
        # numpy's edges from a stand-in holding the data's extremes
        stand_in = (lims[i].astype(np_dt) if i in lims
                    else np.zeros(0, np_dt))
        out.append(np.histogram_bin_edges(stand_in, b, r))
    return out


def _bin_index(x, edges_t, n_bins):
    """Bin of each sample and whether it lies inside the edges, compared
    in numpy's promoted type: uint64 against uint64 exactly (as order
    keys), uint64 against any other type in float64."""
    if x.dtype == torch.uint64 and edges_t.dtype == torch.uint64:
        xe, e = _order_keys(x).contiguous(), _order_keys(edges_t)
    else:
        x, e = (t.to(torch.float64) if t.dtype == torch.uint64
                else dtypes.widen_unsigned(t) for t in (x, edges_t))
        common = torch.promote_types(x.dtype, e.dtype)
        xe, e = x.to(common).contiguous(), e.to(common)
    idx = torch.searchsorted(e, xe, right=True) - 1
    idx = torch.where(xe == e[-1], n_bins - 1, idx)
    valid = (xe >= e[0]) & (xe <= e[-1])
    return idx.clamp(0, max(n_bins - 1, 0)), valid


def _weights_dtypes(weights):
    """(accumulation, result) torch dtypes of the counts."""
    if weights is None:
        return torch.int64, torch.int64
    w = dtypes.to_numpy(weights.dtype)
    if w.kind == "c":
        return torch.complex128, dtypes.to_torch(
            np.result_type(w, np.complex64))
    if w.kind in "bui":
        return torch.int64, torch.int64
    return torch.float64, dtypes.to_torch(np.result_type(w, np.float32))


def _count(flat_idx, valid, total, weights):
    """Counts (or summed weights) of ``total`` bins; invalid samples land
    in a spare bin past the end, which is dropped."""
    key = torch.where(valid, flat_idx, total)
    acc, res = _weights_dtypes(weights)
    if weights is None:
        return torch.bincount(key, minlength=total + 1)[:total]
    out = torch.zeros(total + 1, dtype=acc, device=key.device)
    w = weights.to(acc)
    if acc == torch.complex128:
        # real and imaginary parts as two float64 columns
        torch.view_as_real(out).index_add_(0, key, torch.view_as_real(w))
    else:
        out.index_add_(0, key, w)
    return out[:total].to(res)


def histogram(x, bins=10, range=None, weights=None, density=False):
    """Histogram of a dataset (numpy.histogram): ``(hist, bin_edges)``,
    both tensors on the data's device; ``bins`` a count or edges."""
    x, weights = _ravel_and_check_weights(x, weights)
    bins = _host_bins(bins)
    (edges,) = _edges([x], [bins], [range])
    n_bins = edges.shape[0] - 1
    edges_t = torch.as_tensor(edges, device=x.device)
    idx, valid = _bin_index(x, edges_t, n_bins)
    y = _count(idx, valid, n_bins, weights)
    if density:
        db = torch.as_tensor(np.diff(edges).astype(np.float64),
                             device=x.device)
        return y / db / y.sum(), edges_t
    return y, edges_t


def histogramdd(sample, bins=10, range=None, weights=None, density=False):
    """Multidimensional histogram (numpy.histogramdd): ``(hist, edges)``
    with one edge tensor per dimension; ``sample`` an (N, D) array or a
    sequence of D arrays."""
    if isinstance(sample, (torch.Tensor, np.ndarray)):
        sample = util.as_tensor(sample)
        if sample.ndim == 1:
            sample = sample[:, None]
    else:
        parts = [s for s in sample]
        first = next((s for s in parts if isinstance(s, torch.Tensor)),
                     None)
        dev = None if first is None else first.device
        sample = torch.stack([util.as_tensor(s, device=dev).reshape(-1)
                              for s in parts], dim=-1)
    N, D = sample.shape
    if sample.dtype == torch.bool:
        sample = sample.to(torch.uint8)
    sample = _widen(sample)

    try:
        M = len(bins)
        if M != D:
            raise ValueError("The dimension of bins must be equal to the "
                             "dimension of the sample x.")
    except TypeError:
        bins = [bins] * D
    bins = [_host_bins(b) for b in bins]
    if range is None:
        range = [None] * D
    elif len(range) != D:
        raise ValueError("range argument must have one entry per dimension")
    if weights is not None:
        weights = util.as_tensor(weights, device=sample.device).reshape(-1)
        if weights.shape[0] != N:
            raise ValueError("weights should have the same length as "
                             "sample.")

    columns = [sample[:, i] for i in np.arange(D)]
    edges = _edges(columns, bins, range)
    n_bins = [e.shape[0] - 1 for e in edges]
    edges_t = [torch.as_tensor(e, device=sample.device) for e in edges]
    flat = torch.zeros(N, dtype=torch.int64, device=sample.device)
    valid = torch.ones(N, dtype=torch.bool, device=sample.device)
    for col, e, nb in zip(columns, edges_t, n_bins):
        idx, ok = _bin_index(col, e, nb)
        flat = flat * nb + idx
        valid = valid & ok
    total = int(np.prod(n_bins)) if n_bins else 1
    hist = _count(flat, valid, total, weights).reshape(tuple(n_bins))
    if density:
        hist = hist.to(torch.float64)
        s = hist.sum()
        for i in np.arange(D):
            shape = [1] * D
            shape[i] = n_bins[i]
            db = np.diff(edges[i]).astype(np.float64).reshape(shape)
            hist = hist / torch.as_tensor(db, device=hist.device)
        hist = hist / s
    return hist, edges_t


def histogram2d(x, y, bins=10, range=None, weights=None, density=False):
    """2-d histogram (numpy.histogram2d): ``(hist, xedges, yedges)``."""
    try:
        n = len(bins)
    except TypeError:
        n = 1
    if n != 1 and n != 2:
        bins = [bins, bins]
    hist, edges = histogramdd([x, y], bins, range, weights=weights,
                              density=density)
    return hist, edges[0], edges[1]
