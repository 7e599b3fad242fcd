"""Rank selection via pruned sorting networks.

The compare-exchange (CE) structure of Batcher's odd-even mergesort,
*pruned backward* from the single requested rank wire, which removes the
CEs that cannot influence that output (for a median of 9 about 20 of 25
remain; for rank 0 or K-1 the network is a min/max tree).  The network
constructors are pure Python; the wire ops are ``torch.minimum`` and
``torch.maximum`` over whole shifted tensors, so no window tensor is
built and no generic sort runs.  NaN propagates through every CE, as in
``torch.minimum``.

The same CE lists drive the rank kernel (``csrc/fused_rank.cu``), which
runs :func:`pruned_network` per output point, so the kernel and
:func:`rank_select` agree bitwise.  The presorted-run networks
(:func:`presorted_rank_network`, :func:`merge_runs_full_network`) count
the fewest CEs known for a rectangular footprint.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "batcher_network",
    "merge_runs_full_network",
    "presorted_rank_network",
    "pruned_network",
    "rank_select",
]


@functools.lru_cache(maxsize=None)
def batcher_network(n: int):
    """Batcher odd-even mergesort compare-exchange list for n wires."""
    pairs = []

    def oddeven_merge(lo, hi, r):
        step = r * 2
        if step < hi - lo:
            oddeven_merge(lo, hi, step)
            oddeven_merge(lo + r, hi, step)
            for i in range(lo + r, hi - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def oddeven_sort(lo, hi):
        if hi - lo >= 1:
            mid = lo + ((hi - lo) // 2)
            oddeven_sort(lo, mid)
            oddeven_sort(mid + 1, hi)
            oddeven_merge(lo, hi, 1)

    # Pad to a power of two and drop the CEs with a virtual wire (index
    # >= n): virtual wires hold +inf at the high indices, and a CE puts
    # the minimum on its low index, so dropping them is exact.
    m = 1
    while m < n:
        m *= 2
    oddeven_sort(0, m - 1)
    return tuple((a, b) for a, b in pairs if a < n and b < n)


@functools.lru_cache(maxsize=None)
def pruned_network(n: int, rank: int):
    """CE list reduced to those that can influence output wire ``rank``.

    Backward slice: walk the network in reverse keeping a live-wire set
    initialized to {rank}; a CE is kept iff it touches a live wire, and
    both of its wires become live.
    """
    pairs = batcher_network(n)
    live = {rank}
    kept = []
    for (a, b) in reversed(pairs):
        if a in live or b in live:
            kept.append((a, b))
            live.add(a)
            live.add(b)
    return tuple(reversed(kept))


def rank_select(values, rank: int):
    """Select the rank-th smallest across a list of same-shape arrays.

    Applies the pruned Batcher network with torch.minimum/maximum over
    whole tensors.
    """
    n = len(values)
    wires = list(values)
    for (a, b) in pruned_network(n, rank):
        lo = torch.minimum(wires[a], wires[b])
        hi = torch.maximum(wires[a], wires[b])
        wires[a] = lo
        wires[b] = hi
    return wires[rank]


def _ce_pair(u, v, ces):
    """Compare-exchange with static +inf sentinels (``None``): a CE
    against +inf resolves at build time (the real wire is the min), so
    sentinel padding costs zero runtime compare-exchanges."""
    if v is None:
        return u, v
    if u is None:
        return v, None
    ces.append((u, v))
    return u, v


def _oe_merge_p2(a, b, ces):
    """Batcher odd-even merge of two equal power-of-two wire lists
    (entries are wire ids or ``None`` = +inf), appending CEs."""
    m = len(a)
    assert m == len(b)
    if m == 1:
        return list(_ce_pair(a[0], b[0], ces))
    e = _oe_merge_p2(a[0::2], b[0::2], ces)
    o = _oe_merge_p2(a[1::2], b[1::2], ces)
    res = [None] * (2 * m)
    res[0] = e[0]
    for i in range(m - 1):
        x, y = _ce_pair(o[i], e[i + 1], ces)
        res[2 * i + 1] = x
        res[2 * i + 2] = y
    res[2 * m - 1] = o[m - 1]
    return res


def _oe_merge(a, b, ces):
    """Merge two sorted wire lists of arbitrary length: pad both to a
    common power of two with +inf sentinels, run the classic odd-even
    merge (sentinel CEs vanish statically), keep the padded order."""
    def p2(n):
        v = 1
        while v < n:
            v *= 2
        return v

    m = p2(max(len(a), len(b), 1))
    ap = list(a) + [None] * (m - len(a))
    bp = list(b) + [None] * (m - len(b))
    return _oe_merge_p2(ap, bp, ces)


@functools.lru_cache(maxsize=None)
def presorted_rank_network(run_len: int, n_runs: int, rank: int):
    """(ces, out_wire) selecting the rank-th smallest of
    ``n_runs * run_len`` wires arranged as ``n_runs`` runs each already
    sorted ascending (wire id = run * run_len + position).

    Used by the shared-window-presort rank kernels: sorting the lane
    window once is shared across every sublane tap, so only this merge
    stage runs per output.  The pruned network is validated by the 0/1
    principle restricted to run-sorted inputs (exhaustive when feasible,
    dense random sampling otherwise).
    """
    import numpy as np

    runs = [
        list(range(r * run_len, (r + 1) * run_len))
        for r in range(n_runs)
    ]
    ces = []
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(_oe_merge(runs[i], runs[i + 1], ces))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    out_wire = runs[0][rank]

    live = {out_wire}
    kept = []
    for (x, y) in reversed(ces):
        if x in live or y in live:
            kept.append((x, y))
            live.add(x)
            live.add(y)
    kept = tuple(reversed(kept))

    # ---- 0/1-principle validation over run-sorted inputs ----
    n = run_len * n_runs
    combos = (run_len + 1) ** n_runs
    if combos <= 300_000:
        counts = np.indices((run_len + 1,) * n_runs).reshape(
            n_runs, -1
        )
    else:
        rng = np.random.RandomState(0)
        counts = rng.randint(0, run_len + 1, (n_runs, 300_000))
    ncase = counts.shape[1]
    wires = np.zeros((n, ncase), np.int8)
    for r in range(n_runs):
        for p in range(run_len):
            # sorted ascending: zeros first, ones in the top `count`
            wires[r * run_len + p] = (p >= run_len - counts[r])
    ones = counts.sum(axis=0)
    want = (rank >= n - ones).astype(np.int8)
    for (x, y) in kept:
        lo = np.minimum(wires[x], wires[y])
        hi = np.maximum(wires[x], wires[y])
        wires[x] = lo
        wires[y] = hi
    if not np.array_equal(wires[out_wire], want):
        raise AssertionError(
            f"presorted rank network invalid: {run_len}x{n_runs} "
            f"rank {rank}"
        )
    return kept, out_wire


def sort_values(values):
    """Fully sort a list of same-shape arrays with Batcher's network;
    returns the list in ascending order."""
    wires = list(values)
    for (a, b) in batcher_network(len(wires)):
        lo = torch.minimum(wires[a], wires[b])
        hi = torch.maximum(wires[a], wires[b])
        wires[a] = lo
        wires[b] = hi
    return wires


def rank_select_presorted(run_values, rank: int):
    """Select the rank-th smallest where ``run_values`` is a list of
    runs (lists of same-shape arrays), each run sorted ascending."""
    run_len = len(run_values[0])
    assert all(len(r) == run_len for r in run_values)
    ces, out_wire = presorted_rank_network(
        run_len, len(run_values), rank
    )
    wires = [v for run in run_values for v in run]
    for (a, b) in ces:
        lo = torch.minimum(wires[a], wires[b])
        hi = torch.maximum(wires[a], wires[b])
        wires[a] = lo
        wires[b] = hi
    return wires[out_wire]


@functools.lru_cache(maxsize=None)
def merge_runs_full_network(run_len: int, n_runs: int):
    """(ces, order) fully sorting ``n_runs`` pre-sorted runs of
    ``run_len`` (wire id = run * run_len + position); 0/1-validated.

    Used as the SHARED middle stage of two-level rank kernels (e.g. a
    3-D window sorts its lane axis once, merges each sublane row's
    runs once, and only the final cross-row merge runs per output)."""
    import numpy as np

    runs = [
        list(range(r * run_len, (r + 1) * run_len))
        for r in range(n_runs)
    ]
    ces = []
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(_oe_merge(runs[i], runs[i + 1], ces))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    order = [w for w in runs[0] if w is not None]
    ces = tuple(ces)

    n = run_len * n_runs
    combos = (run_len + 1) ** n_runs
    if combos <= 300_000:
        counts = np.indices((run_len + 1,) * n_runs).reshape(
            n_runs, -1
        )
    else:
        rng = np.random.RandomState(0)
        counts = rng.randint(0, run_len + 1, (n_runs, 300_000))
    ncase = counts.shape[1]
    wires = np.zeros((n, ncase), np.int8)
    for r in range(n_runs):
        for p in range(run_len):
            wires[r * run_len + p] = (p >= run_len - counts[r])
    for (x, y) in ces:
        lo = np.minimum(wires[x], wires[y])
        hi = np.maximum(wires[x], wires[y])
        wires[x] = lo
        wires[y] = hi
    ones = counts.sum(axis=0)
    for pos in range(n):
        want = (pos >= n - ones).astype(np.int8)
        if not np.array_equal(wires[order[pos]], want):
            raise AssertionError(
                f"full merge network invalid: {run_len}x{n_runs}"
            )
    return ces, tuple(order)


def sort_runs_values(run_values):
    """Fully sort a list of pre-sorted runs of same-shape arrays;
    returns the ascending list of all values."""
    run_len = len(run_values[0])
    ces, order = merge_runs_full_network(run_len, len(run_values))
    wires = [v for run in run_values for v in run]
    for (a, b) in ces:
        lo = torch.minimum(wires[a], wires[b])
        hi = torch.maximum(wires[a], wires[b])
        wires[a] = lo
        wires[b] = hi
    return [wires[w] for w in order]
