"""scipy.ndimage measurements on torch tensors: ``label`` and the labeled
reductions.

``label`` is a deterministic fixpoint on the device: min-label
propagation over the structure's neighbour offsets, hooking (a pixel that
sees a smaller label lowers its parent's label to it, one scatter-min)
and pointer doubling (``lab <- min(lab, lab[lab[lab]])``), iterated until
nothing changes.  Labels stay integers throughout (a float minimum is not exact
above 2^24 elements).  The converged label of a pixel is the smallest
flat index of its component, so a cumulative sum over the component
roots numbers the components 1..N in raster order of their first pixel:
scipy's numbering, exactly.

The labeled reductions are scatter operations (``index_add_``,
``scatter_reduce``, ``bincount``) on the device, in float64.  Like scipy,
they learn the number of labels with one host sync; ``find_objects``,
``value_indices``, the ``*_position`` functions, ``center_of_mass`` and
``labeled_comprehension`` return host objects, as scipy's do.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy.ndimage.morphology import (
    generate_binary_structure,
)

__all__ = [
    "label",
    "sum",
    "sum_labels",
    "mean",
    "variance",
    "standard_deviation",
    "minimum",
    "maximum",
    "median",
    "minimum_position",
    "maximum_position",
    "extrema",
    "center_of_mass",
    "histogram",
    "labeled_comprehension",
    "find_objects",
    "value_indices",
]

# propagation sweeps between two convergence checks (each check waits for
# the device; sweeps past the fixpoint change nothing)
_LABEL_CHECK = 4


def _structure_offsets(structure, ndim):
    """Nonzero offsets of ``structure | flip(structure)`` relative to the
    centre (centre excluded): connectivity is symmetric, so a structure
    that is not centrosymmetric labels as its symmetrized self (scipy
    raises AssertionError for it)."""
    if structure is None:
        structure = generate_binary_structure(ndim, 1)
    if isinstance(structure, torch.Tensor):
        structure = structure.cpu().numpy()
    structure = np.asarray(structure)
    if structure.ndim != ndim:
        raise RuntimeError("structure and input must have equal rank")
    for s in structure.shape:
        if s != 3:
            raise ValueError("structure dimensions must be equal to 3")
    structure = structure != 0
    offs = []
    for idx in np.argwhere(structure | np.flip(structure)):
        off = tuple(int(i) - 1 for i in idx)
        if any(off):
            offs.append(off)
    return offs


def _slices(off, shape):
    """(destination, source) slices so that ``dst[i] <- src[i + off]``
    over every ``i`` with ``i + off`` inside ``shape``."""
    dst, src = [], []
    for o, n in zip(off, shape):
        dst.append(slice(max(0, -o), n - max(0, o)))
        src.append(slice(max(0, o), n + min(0, o)))
    return tuple(dst), tuple(src)


def _box_min(lab):
    """The minimum over every 3^n box, as one running minimum per axis
    (a box is separable); cells past the edges take no part."""
    out = lab
    for axis in range(lab.ndim):
        n = out.shape[axis]
        if n == 1:
            continue
        m = out.clone()
        lo, hi = out.narrow(axis, 0, n - 1), out.narrow(axis, 1, n - 1)
        m.narrow(axis, 0, n - 1).copy_(torch.minimum(m.narrow(axis, 0, n - 1),
                                                     hi))
        m.narrow(axis, 1, n - 1).copy_(torch.minimum(m.narrow(axis, 1, n - 1),
                                                     lo))
        out = m
    return out


def label(input, structure=None, output=None, *, greyscale_mode=False):
    """Label connected components (scipy.ndimage.label).

    Returns ``(labels, num_features)``: int32 labels (or ``output``'s
    dtype) and the count as a 0-d int32 tensor on the input's device.
    ``greyscale_mode=True`` connects neighbours only where their values
    are equal (skimage.measure.label's rule).  The propagation sweeps run
    are added to ``label.sweeps``.
    """
    x = util.as_tensor(input)
    if x.ndim < 1:
        # scipy labels a scalar as a single (0-d) component
        lab1, num = label(x.reshape(1), structure=None, output=output,
                          greyscale_mode=greyscale_mode)
        return lab1.reshape(()), num
    offsets = _structure_offsets(structure, x.ndim)
    out_dtype = torch.int32 if output is None else dtypes.to_torch(
        np.dtype(output))
    labels, num = _label_core(x, offsets, bool(greyscale_mode))
    return labels.to(out_dtype), num


label.sweeps = 0


def _label_core(x, offsets, greyscale_mode):
    shape = tuple(x.shape)
    n = x.numel()
    idt = torch.int32 if n < 2 ** 31 - 1 else torch.int64
    dev = x.device
    fg = x != 0
    sent = torch.tensor(n, dtype=idt, device=dev)
    flat_idx = torch.arange(n, dtype=idt, device=dev).reshape(shape)
    lab0 = torch.where(fg, flat_idx, sent)

    if not greyscale_mode and len(offsets) == 3 ** x.ndim - 1:
        # the full box: background stays n (the min identity), so a box
        # minimum is exactly min-label propagation
        def propagate(lab):
            return torch.where(fg, _box_min(lab), sent)

    elif not greyscale_mode:
        # any 3^n structure: shifted background contributes n, nothing
        pairs = [_slices(off, shape) for off in offsets]

        def propagate(lab):
            new = lab.clone()
            for dst, src in pairs:
                new[dst] = torch.minimum(new[dst], lab[src])
            return torch.where(fg, new, sent)

    else:
        # greyscale mode: neighbours connect only where values are equal
        pairs = []
        for off in offsets:
            dst, src = _slices(off, shape)
            pairs.append((dst, src, fg[dst] & fg[src] & (x[dst] == x[src])))

        def propagate(lab):
            new = lab.clone()
            for dst, src, valid in pairs:
                new[dst] = torch.minimum(
                    new[dst], torch.where(valid, lab[src], sent))
            return new

    def compress(flat):
        # pointer doubling: follow the parent link twice
        hop = torch.where(flat == sent, sent, flat[flat.clamp_max(n - 1)])
        hop2 = torch.where(hop == sent, sent, flat[hop.clamp_max(n - 1)])
        return torch.minimum(flat, hop2)

    # one private slot past the end for each pixel: where a pixel has
    # nothing to hook, its scatter lands there, uncontended
    spare = torch.arange(n, 2 * n, device=dev)

    def sweep(lab):
        m = propagate(lab).reshape(-1)
        flat = lab.reshape(-1)
        # hooking: a pixel that sees a smaller label in its neighbourhood
        # lowers its parent's label to it, so that whole subtrees merge in
        # one sweep, not one pixel a sweep
        buf = torch.cat([flat, m])
        buf.scatter_reduce_(0, torch.where(m < flat, flat.long(), spare), m,
                            "amin")
        return compress(torch.minimum(buf[:n], m)).reshape(shape)

    lab = sweep(lab0)
    sweeps = 1
    if not torch.equal(lab, lab0):
        while True:
            prev = lab
            for _ in range(_LABEL_CHECK):
                lab = sweep(lab)
            sweeps += _LABEL_CHECK
            if torch.equal(lab, prev):
                break
    label.sweeps += sweeps

    # number the roots 1..N in raster order of their first pixel (a root
    # is the smallest flat index of its component: scipy's numbering)
    flat = lab.reshape(-1)
    is_root = (flat == flat_idx.reshape(-1)) & fg.reshape(-1)
    rank = torch.cumsum(is_root.to(idt), 0, dtype=idt)
    new = torch.where(flat == sent, torch.zeros((), dtype=idt, device=dev),
                      rank[flat.clamp_max(n - 1)])
    num = (rank[n - 1] if n > 0 else torch.zeros((), dtype=idt, device=dev)
           ).to(torch.int32)
    return new.reshape(shape), num


# ---------------------------------------------------------------------------
# labeled reductions
# ---------------------------------------------------------------------------


def _is_scalar(index):
    return np.isscalar(index) or getattr(index, "ndim", None) == 0


def _norm_labels_index(input, labels, index):
    """Normalize (labels, index): ``(x, labels, index, scalar)`` with
    ``index`` a host int64 array (or None)."""
    x = util.as_tensor(input)
    if labels is None:
        return x, None, None, False
    labels = util.as_tensor(labels, device=x.device)
    if labels.shape != x.shape:
        # scipy broadcasts labels against input
        labels = labels.broadcast_to(x.shape)
    if index is None:
        return x, labels, None, False
    if isinstance(index, torch.Tensor):
        index = index.cpu().numpy()
    scalar = _is_scalar(index)
    index = np.asarray([int(index)] if scalar else index, dtype=np.int64)
    low = int(index.min()) if index.size else 0
    if low < 0:
        # a negative label that the index asks for reduces over its own
        # pixels, as scipy's: shift labels and index so that the lowest
        # label asked for is 0 (labels below it stay negative and drop out)
        labels = labels.to(torch.int64) - low
        index = index - low
    return x, labels, index, scalar


def _reject_complex(x):
    """scipy's stats reductions cast to float64 with 'safe' casting, so
    complex input raises TypeError."""
    if x.is_complex():
        raise TypeError(
            "Cannot cast array data from {} to float64 according to the "
            "rule 'safe'".format(dtypes.to_numpy(x.dtype))
        )


def _num_segments(labels):
    """The number of segments, ``max(labels) + 1``: one host sync."""
    return int(labels.max()) + 1 if labels.numel() else 1


def _segments(labels, num_seg):
    """Flat int64 segment ids; a negative label goes to the spare segment
    ``num_seg`` (one past the end), which every reduction drops (an index
    that asks for negative labels has shifted them to 0 and up first,
    ``_norm_labels_index``)."""
    seg = labels.reshape(-1).to(torch.int64)
    return torch.where(seg < 0, num_seg, seg)


def _f64(x):
    """``x`` in numpy's promotion with float64 (complex: complex128)."""
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def _unlabeled_float(x):
    """The dtype of a whole-array mean, variance or median, as
    ``cupyimg_tpu`` computes them: a floating input keeps its dtype, 64-bit
    integers give float64, narrower integers and bool float32 (scipy:
    float64 for every integer)."""
    if x.is_floating_point() or x.is_complex():
        return x
    wide = x.dtype in (torch.int64, torch.uint64)
    return x.to(torch.float64 if wide else torch.float32)


def _segment_sum(values, seg, num_seg):
    out = values.new_zeros(num_seg + 1)
    return out.index_add_(0, seg, values.reshape(-1))[:num_seg]


def _counts(seg, num_seg):
    return torch.bincount(seg, minlength=num_seg + 1)[:num_seg]


def _take(per_label, index, num_seg):
    """``per_label`` at the requested labels (clamped into range; callers
    mask the absent ones)."""
    idx = torch.as_tensor(np.clip(index, 0, num_seg - 1),
                          device=per_label.device)
    return per_label[idx]


def _present(index, num_seg, counts):
    """Which requested labels occur: a host bool array (only the counts at
    ``index`` come to the host).  Absent labels follow scipy's empty-set
    rules: 0 for sum, NaN for the mean family, ValueError for a scalar
    min/max/position, 0 in a list."""
    within = (index >= 0) & (index < num_seg)
    return within & (_take(counts, index, num_seg).cpu().numpy() > 0)


def _masked(values, present, fill):
    if present.all():
        return values
    mask = torch.as_tensor(present, device=values.device)
    return torch.where(mask, values, torch.as_tensor(fill, dtype=values.dtype,
                                                     device=values.device))


def sum(input, labels=None, index=None):
    """Sum of values per label (scipy.ndimage.sum)."""
    x, labels, index, scalar = _norm_labels_index(input, labels, index)
    _reject_complex(x)
    if labels is None:
        return torch.sum(x)
    num_seg = _num_segments(labels)
    sums = _segment_sum(_f64(x), _segments(labels, num_seg), num_seg)
    if index is None:
        return sums[1:].sum()
    within = (index >= 0) & (index < num_seg)
    out = _masked(_take(sums, index, num_seg), within, 0.0)
    return out[0] if scalar else out


sum_labels = sum


def _count_and_sum(x, labels, num_seg):
    seg = _segments(labels, num_seg)
    return seg, _counts(seg, num_seg), _segment_sum(_f64(x), seg, num_seg)


def mean(input, labels=None, index=None):
    """Mean of values per label (scipy.ndimage.mean)."""
    x, labels, index, scalar = _norm_labels_index(input, labels, index)
    _reject_complex(x)
    if labels is None:
        return torch.mean(_unlabeled_float(x))
    num_seg = _num_segments(labels)
    _, counts, sums = _count_and_sum(x, labels, num_seg)
    if index is None:
        return sums[1:].sum() / counts[1:].sum()  # 0/0 -> nan, as scipy
    means = sums / counts.clamp_min(1)
    out = _masked(_take(means, index, num_seg),
                  _present(index, num_seg, counts), np.nan)
    return out[0] if scalar else out


def variance(input, labels=None, index=None):
    """Variance of values per label (scipy.ndimage.variance): the mean
    first, then the mean squared deviation from it."""
    x, labels, index, scalar = _norm_labels_index(input, labels, index)
    _reject_complex(x)
    if labels is None:
        return torch.var(_unlabeled_float(x), correction=0)
    num_seg = _num_segments(labels)
    seg, counts, sums = _count_and_sum(x, labels, num_seg)
    xf = _f64(x).reshape(-1)
    if index is None:
        inside = labels.reshape(-1) > 0
        cnt = counts[1:].sum()
        dev = torch.where(inside, xf - sums[1:].sum() / cnt, 0.0)
        return (dev * dev).sum() / cnt  # 0/0 -> nan, as scipy
    means = torch.cat([sums / counts.clamp_min(1), sums.new_zeros(1)])
    dev = xf - means[seg]
    vars_ = _segment_sum(dev * dev, seg, num_seg) / counts.clamp_min(1)
    out = _masked(_take(vars_, index, num_seg),
                  _present(index, num_seg, counts), np.nan)
    return out[0] if scalar else out


def standard_deviation(input, labels=None, index=None):
    """Standard deviation per label (scipy.ndimage.standard_deviation)."""
    return torch.sqrt(variance(input, labels, index))


def _identity(dtype, is_min):
    """The identity of a minimum (``is_min``) or maximum in ``dtype``."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _segment_extreme(x, seg, num_seg, is_min):
    """Per-segment minimum or maximum (NaN propagates; an empty segment
    holds the reduction's identity)."""
    vals = x.reshape(-1)
    if vals.dtype == torch.bool:
        vals = vals.to(torch.uint8)
    out = vals.new_full((num_seg + 1,), _identity(vals.dtype, is_min))
    out = out.scatter_reduce(0, seg, vals, "amin" if is_min else "amax",
                             include_self=True)[:num_seg]
    return out.to(x.dtype)


def _empty_reduction_error(is_min):
    # scipy lets numpy raise this when a requested label has no pixels
    return ValueError(
        "zero-size array to reduction operation "
        f"{'minimum' if is_min else 'maximum'} which has no identity"
    )


def _min_or_max(input, labels, index, is_min):
    x, labels, index, scalar = _norm_labels_index(input, labels, index)
    if labels is None:
        return torch.amin(x) if is_min else torch.amax(x)
    num_seg = _num_segments(labels)
    seg = _segments(labels, num_seg)
    if index is None:
        if num_seg == 1:  # no positive label at all
            raise _empty_reduction_error(is_min)
        vals = x.reshape(-1)[labels.reshape(-1) > 0]
        return torch.amin(vals) if is_min else torch.amax(vals)
    present = _present(index, num_seg, _counts(seg, num_seg))
    # scipy raises only for a scalar absent index (the minimum of an empty
    # set); the list form reads 0 for absent labels
    if scalar and not present.all():
        raise _empty_reduction_error(is_min)
    per = _segment_extreme(x, seg, num_seg, is_min)
    out = _masked(_take(per, index, num_seg), present, 0)
    return out[0] if scalar else out


def minimum(input, labels=None, index=None):
    """Minimum per label (scipy.ndimage.minimum)."""
    return _min_or_max(input, labels, index, True)


def maximum(input, labels=None, index=None):
    """Maximum per label (scipy.ndimage.maximum)."""
    return _min_or_max(input, labels, index, False)


def _unravel(flats, shape):
    """Host tuples of the positions of the flat indices ``flats``."""
    flats = np.asarray(flats, dtype=np.int64)
    return list(zip(*(a.tolist() for a in np.unravel_index(flats, shape))))


def _position_of(input, labels, index, is_min):
    x, labels, index, scalar = _norm_labels_index(input, labels, index)
    shape = tuple(x.shape)
    n = x.numel()
    xf = x.reshape(-1)
    if labels is None:
        if index is None:
            flat = torch.argmin(xf) if is_min else torch.argmax(xf)
            return _unravel([int(flat)], shape)[0]
        labels = torch.ones(shape, dtype=torch.int32, device=x.device)
    if index is None:
        if int(labels.max()) <= 0:
            raise _empty_reduction_error(is_min)
        # every positive label is one region when index is None: the
        # position of the extremum over labels > 0
        valid = labels.reshape(-1) > 0
        vals = xf[valid]
        g = torch.amin(vals) if is_min else torch.amax(vals)
        pos = torch.arange(n, device=x.device)
        first = int(torch.where(valid & (xf == g), pos, n).min())
        return _unravel([first], shape)[0]
    num_seg = _num_segments(labels)
    seg = _segments(labels, num_seg)
    present = _present(index, num_seg, _counts(seg, num_seg))
    # a scalar absent index raises, as scipy; the list form gives 0
    if scalar and not present.all():
        raise _empty_reduction_error(is_min)
    per = torch.cat([_segment_extreme(x, seg, num_seg, is_min),
                     x.new_zeros(1)])
    hit = xf == per[seg]
    # scipy's tie rule with an explicit index: a minimum's FIRST raveled
    # position, a maximum's LAST
    pos = torch.arange(n, device=x.device)
    if is_min:
        pos = torch.where(hit, pos, n)
        init = n
    else:
        pos = torch.where(hit, pos, -1)
        init = -1
    best = pos.new_full((num_seg + 1,), init).scatter_reduce(
        0, seg, pos, "amin" if is_min else "amax", include_self=True)
    flats = np.where(present,
                     _take(best[:num_seg], index, num_seg).cpu().numpy(), 0)
    out = _unravel(flats, shape)
    return out[0] if scalar else out


def minimum_position(input, labels=None, index=None):
    """Position of the per-label minimum (scipy.ndimage.minimum_position;
    host tuples)."""
    return _position_of(input, labels, index, True)


def maximum_position(input, labels=None, index=None):
    """Position of the per-label maximum (scipy.ndimage.maximum_position;
    host tuples)."""
    return _position_of(input, labels, index, False)


def extrema(input, labels=None, index=None):
    """(min, max, min_position, max_position) per label
    (scipy.ndimage.extrema: a scalar absent index raises; absent labels in
    a list give 0 and position 0, as minimum()/maximum() do)."""
    return (
        minimum(input, labels, index),
        maximum(input, labels, index),
        minimum_position(input, labels, index),
        maximum_position(input, labels, index),
    )


def _median_of_sorted(s):
    """numpy's median of the sorted 1-D ``s`` (NaN when empty)."""
    k = s.shape[0]
    if k == 0:
        return torch.tensor(float("nan"), dtype=s.dtype, device=s.device)
    return (s[(k - 1) // 2] + s[k // 2]) / 2


def median(input, labels=None, index=None):
    """Median per label (scipy.ndimage.median): one lexicographic sort by
    (label, value), made of two stable sorts, then the mean of the middle
    two of each label's run, in a floating input's own dtype as scipy
    computes it (``cupyimg_tpu``: float64), integers in float64."""
    x, labels, index, scalar = _norm_labels_index(input, labels, index)
    if labels is None:
        s = torch.sort(_unlabeled_float(x).reshape(-1)).values
        if bool(torch.isnan(s[-1:]).any()):  # np.median propagates NaN
            return torch.tensor(float("nan"), dtype=s.dtype,
                                device=s.device)
        return _median_of_sorted(s)
    num_seg = _num_segments(labels)
    seg = _segments(labels, num_seg)
    xf = (x if x.is_floating_point() else _f64(x)).reshape(-1)
    if index is None:
        # the positive labels' values, NaN left out (np.nanmedian)
        vals = xf[(labels.reshape(-1) > 0) & ~torch.isnan(xf)]
        return _median_of_sorted(torch.sort(vals).values)
    by_value = torch.sort(xf, stable=True).indices
    order = by_value[torch.sort(seg[by_value], stable=True).indices]
    val_sorted = xf[order]
    counts = _counts(seg, num_seg)
    starts = torch.cumsum(counts, 0) - counts
    last = max(x.numel() - 1, 0)
    lo = val_sorted[(starts + ((counts - 1) // 2).clamp_min(0)).clamp_max(
        last)]
    hi = val_sorted[(starts + counts // 2).clamp_max(last)]
    out = _masked(_take((lo + hi) / 2, index, num_seg),
                  _present(index, num_seg, counts), np.nan)
    return out[0] if scalar else out


def _coordinates(shape, device):
    """One float64 coordinate tensor per axis, broadcasting over
    ``shape``."""
    out = []
    for ax, s in enumerate(shape):
        view = [1] * len(shape)
        view[ax] = s
        out.append(torch.arange(s, dtype=torch.float64,
                                device=device).reshape(view))
    return out


def center_of_mass(input, labels=None, index=None):
    """Center of mass per label (scipy.ndimage.center_of_mass; host
    tuples of floats)."""
    x, labels, index, scalar = _norm_labels_index(input, labels, index)
    xf = _f64(x)
    grids = _coordinates(x.shape, x.device)
    if labels is None:
        total = xf.sum()
        return tuple(float((xf * g).sum() / total) for g in grids)
    if index is None:
        inside = labels > 0
        w = torch.where(inside, xf, 0.0)
        tot = w.sum()
        return tuple(float((w * g).sum() / tot) for g in grids)
    num_seg = _num_segments(labels)
    seg = _segments(labels, num_seg)
    wsum = _segment_sum(xf, seg, num_seg)
    present = _present(index, num_seg, _counts(seg, num_seg))
    cols = []
    for g in grids:
        c = _segment_sum(xf * g, seg, num_seg) / wsum
        cols.append(np.where(present, _take(c, index, num_seg).cpu().numpy(),
                             np.nan))
    out = list(zip(*(c.tolist() for c in cols)))
    return out[0] if scalar else out


def histogram(input, min, max, bins, labels=None, index=None):
    """Histogram of values, optionally per label (scipy.ndimage.histogram;
    int64 counts)."""
    x, labels, index, scalar = _norm_labels_index(input, labels, index)
    bins = int(bins)
    edges = torch.as_tensor(np.linspace(float(min), float(max), bins + 1),
                            device=x.device)
    xf = x.reshape(-1).to(torch.float64)
    b = torch.searchsorted(edges, xf, right=True) - 1
    b = torch.where(xf == edges[-1], bins - 1, b)
    in_range = (b >= 0) & (b < bins)
    if labels is None:
        key = torch.where(in_range, b, bins)
        return torch.bincount(key, minlength=bins + 1)[:bins]
    num_seg = _num_segments(labels)
    seg = _segments(labels, num_seg)
    spare = num_seg * bins
    key = torch.where(in_range & (seg < num_seg), seg * bins + b, spare)
    counts = torch.bincount(key, minlength=spare + 1)[:spare].reshape(
        num_seg, bins)
    if index is None:
        return counts[1:].sum(0)
    sel = _take(counts, index, num_seg)
    if scalar:
        return sel[0]
    return list(sel.unbind(0))


def labeled_comprehension(
    input, labels, index, func, out_dtype, default, pass_positions=False
):
    """Apply ``func`` to the values (and optionally the flat positions) of
    each labeled region (scipy.ndimage.labeled_comprehension): a host loop
    over the regions, on numpy copies of the input and the labels."""
    x = util.as_tensor(input)
    if labels is None:
        if pass_positions:
            return func(x.reshape(-1), torch.arange(x.numel(),
                                                    device=x.device))
        return func(x.reshape(-1))
    labels_np = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
                 else np.asarray(labels))
    x_np = x.cpu().numpy()
    labels_np = np.broadcast_to(labels_np, x_np.shape)
    if index is None:
        mask = labels_np > 0
        vals = x_np[mask]
        if pass_positions:
            return func(vals, np.flatnonzero(mask))
        return func(vals)
    if isinstance(index, torch.Tensor):
        index = index.cpu().numpy()
    scalar = _is_scalar(index)
    idx_list = [int(index)] if scalar else [int(i) for i in np.asarray(index)]
    out = np.empty(len(idx_list), dtype=out_dtype)
    flat_labels = labels_np.ravel()
    flat_x = x_np.ravel()
    for k, i in enumerate(idx_list):
        mask = flat_labels == i
        if not mask.any():
            out[k] = default
        elif pass_positions:
            out[k] = func(flat_x[mask], np.flatnonzero(mask))
        else:
            out[k] = func(flat_x[mask])
    return out[0] if scalar else out


def _bbox_reduce(labels, num_seg):
    """Per-label (lowest, highest) coordinate on each axis: two
    scatter-min/max reductions per axis on the device, (num_seg, ndim)
    each; an absent label keeps int64's maximum as its lowest."""
    seg = labels.reshape(-1).to(torch.int64)
    seg = torch.where((seg < 0) | (seg >= num_seg), 0, seg)
    big = torch.iinfo(torch.int64)
    los, his = [], []
    for ax in range(labels.ndim):
        view = [1] * labels.ndim
        view[ax] = labels.shape[ax]
        coord = torch.arange(labels.shape[ax], device=labels.device)
        coord = coord.reshape(view).broadcast_to(labels.shape).reshape(-1)
        los.append(coord.new_full((num_seg,), big.max).scatter_reduce(
            0, seg, coord, "amin"))
        his.append(coord.new_full((num_seg,), big.min).scatter_reduce(
            0, seg, coord, "amax"))
    return torch.stack(los, 1), torch.stack(his, 1)


def find_objects(input, max_label=0):
    """The bounding slices of labeled objects (scipy.ndimage.find_objects):
    a list over labels ``1..max_label`` of slice tuples (``None`` for an
    absent label).  The boxes are reduced on the device; only the
    (max_label, 2 * ndim) table comes to the host.  Unsigned labels are
    read in the signed type that holds them (torch has no max of
    uint16/32)."""
    x = dtypes.widen_unsigned(util.as_tensor(input))
    if x.ndim == 0:
        # scipy: a nonzero scalar is one object with an empty slice tuple
        v = int(x)
        n = max_label if max_label > 0 else v
        return [() if lbl == v else None for lbl in range(1, n + 1)]
    if max_label <= 0:
        max_label = int(x.max()) if x.numel() else 0
    if max_label <= 0:
        return []
    lo, hi = _bbox_reduce(x, max_label + 1)
    absent = torch.iinfo(torch.int64).max
    return [None if first[0] == absent else
            tuple(slice(a, b + 1) for a, b in zip(first, last))
            for first, last in zip(lo[1:].tolist(), hi[1:].tolist())]


def value_indices(arr, *, ignore_value=None):
    """A dict mapping each distinct value of an integer array to its index
    arrays (scipy.ndimage.value_indices).  One stable device sort groups
    the positions; the dict of numpy index tuples is host data, as
    scipy's."""
    a = util.as_tensor(arr)
    if a.is_floating_point() or a.is_complex() or a.dtype == torch.bool:
        raise ValueError("Parameter 'arr' must be an integer array")
    svals, order = torch.sort(a.reshape(-1), stable=True)
    svals, order = svals.cpu().numpy(), order.cpu().numpy()
    uniq, starts = np.unique(svals, return_index=True)
    bounds = list(starts) + [svals.size]
    out = {}
    for i, v in enumerate(uniq):
        if ignore_value is not None and v == ignore_value:
            continue
        idx = np.sort(order[bounds[i]:bounds[i + 1]])
        out[v] = np.unravel_index(idx, tuple(a.shape))
    return out
