"""Rank selection via pruned sorting networks.

The compare-exchange (CE) structure of Batcher's odd-even mergesort,
*pruned backward* from the single requested rank wire, which removes the
CEs that cannot influence that output (for a median of 9 about 20 of 25
remain; for rank 0 or K-1 the network is a min/max tree).  The network
constructors are pure Python; the wire ops are ``torch.minimum`` and
``torch.maximum`` over whole shifted tensors, so no window tensor is
built and no generic sort runs.  NaN propagates through every CE, as in
``torch.minimum``.

The same CE lists drive the rank kernel (``csrc/fused_rank.cu``):
its generic instance runs :func:`flat_rank_network` per output point
from a list staged at run time, and its compile-time instances run the
networks that :func:`cuda_networks` writes out as C++
(``csrc/rank_networks.cuh``), so the kernel and the plain version agree
bitwise.  The presorted-run networks (:func:`presorted_rank_network`,
:func:`merge_runs_full_network`) count the fewest CEs known for a
rectangular footprint: the lane window sorted once and shared, then only
the merge of the sorted runs per output.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "batcher_network",
    "cuda_networks",
    "flat_rank_network",
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


def rect_stages(fshape3, rank):
    """The three stages of a full rectangle's shared presort, for a
    footprint of shape ``(F0, F1, F2)`` (a 2-D one as ``(F0, 1, F2)``):
    ``(lane sort, row merge and its order, presorted rank network and its
    output wire)``, as ``cupyimg_tpu``'s rectangle route runs them: each
    lane window of F2 sorted, the F1 sorted lanes of a plane merged into
    one run of F1 * F2, and the F0 runs merged down to ``rank``."""
    f0, f1, f2 = (int(v) for v in fshape3)
    merge, order = merge_runs_full_network(f2, f1)
    ces, out = presorted_rank_network(f1 * f2, f0, int(rank))
    return batcher_network(f2), (merge, order), (ces, out)


@functools.lru_cache(maxsize=None)
def flat_rank_network(fshape3, mask, rank):
    """(ces, out_wire) over the K taps of a footprint, wire k holding tap
    k in ``np.argwhere`` order: the footprint is ``fshape3`` (a 2-D one as
    ``(F0, 1, F2)``) with the taps set in the C-order bit ``mask``.  A full
    rectangle gets its shared presort laid out flat, every stage on the
    wires of one output (the same compare-exchanges on the same values as
    :func:`rect_stages` run shared, so the same result bit for bit);
    any other footprint the rank-pruned Batcher network."""
    f0, f1, f2 = (int(v) for v in fshape3)
    k = bin(mask).count("1")
    if k != f0 * f1 * f2:
        return pruned_network(k, int(rank)), int(rank)
    lane, (merge, order), (final, out) = rect_stages(fshape3, rank)
    run = f1 * f2
    ces = []
    for base in range(0, k, f2):  # every lane window
        ces += [(base + a, base + b) for a, b in lane]
    for base in range(0, k, run):  # every plane's rows
        ces += [(base + a, base + b) for a, b in merge]

    def wire(i):  # position q of sorted run r
        r, q = divmod(i, run)
        return r * run + order[q]

    ces += [(wire(a), wire(b)) for a, b in final]
    return tuple(ces), wire(out)


def _cuda_ces(ces):
    return "".join(f"    rn_ce(v[{a}], v[{b}]);\n" for a, b in ces)


def cuda_networks(instances, parts, types):
    """The C++ header ``csrc/rank_networks.cuh`` for the rank kernel's
    compile-time instances: every network an instance runs as a template
    specialisation of straight-line compare-exchanges (``rn_ce`` on
    constant wire indices, so after unrolling every wire is a register),
    and the instance table as one X-macro per part.

    ``instances``: ``(fshape3, mask, rank)`` per instance id (see
    :func:`flat_rank_network`); ``parts``: the part each id is compiled
    in; ``types``: the data types each id is built for (bit 0 float32,
    bit 1 int32)."""
    sorts, merges, presorted, pruned = set(), set(), set(), set()
    for fshape3, mask, rank in instances:
        f0, f1, f2 = fshape3
        k = bin(mask).count("1")
        if k == f0 * f1 * f2:
            sorts.add(f2)
            merges.add((f2, f1))
            presorted.add((f1 * f2, f0, rank))
        else:
            pruned.add((k, rank))
    out = [
        "// Compare-exchange networks of the rank kernel's compile-time\n"
        "// instances (csrc/fused_rank.cu).  Generated from\n"
        "// ops/sorting_networks.py by ops/fused_rank.py:write_header; do not\n"
        "// edit (tests/test_torch_fused_rank.py compares it with a fresh\n"
        "// copy).\n",
        "#pragma once\n\n#include \"boundary.cuh\"\n\n",
        "// wire a gets the smaller value, wire b the larger; NaN reaches both\n",
        "template <class T>\n__device__ __forceinline__ void rn_ce(T& a, T& b) "
        "{\n  const T lo = min_nan(a, b);\n  b = max_nan(a, b);\n  a = lo;\n}\n\n",
        "// RnSort<N>::run(v): v[0..N) ascending (Batcher)\n",
        "template <int N>\nstruct RnSort;\n",
        "// RnMerge<RUN, NRUNS>::run(v, o): o[0..RUN*NRUNS) ascending, from\n"
        "// NRUNS runs each ascending (v[r * RUN + q])\n",
        "template <int RUN, int NRUNS>\nstruct RnMerge;\n",
        "// RnPresorted<RUN, NRUNS, RANK>::run(v): the RANK-th smallest of\n"
        "// NRUNS ascending runs (v[r * RUN + q]); v is overwritten\n",
        "template <int RUN, int NRUNS, int RANK>\nstruct RnPresorted;\n",
        "// RnPruned<N, RANK>::run(v): the RANK-th smallest of v[0..N)\n",
        "template <int N, int RANK>\nstruct RnPruned;\n",
    ]
    head = "  template <class T>\n  __device__ static __forceinline__ "
    for n in sorted(sorts):
        out.append(f"\ntemplate <>\nstruct RnSort<{n}> {{\n{head}void run(T* v) "
                   f"{{\n{_cuda_ces(batcher_network(n))}  }}\n}};\n")
    for run, nruns in sorted(merges):
        ces, order = merge_runs_full_network(run, nruns)
        body = _cuda_ces(ces) + "".join(
            f"    o[{q}] = v[{w}];\n" for q, w in enumerate(order))
        out.append(f"\ntemplate <>\nstruct RnMerge<{run}, {nruns}> {{\n"
                   f"{head}void run(T* v, T* o) {{\n{body}  }}\n}};\n")
    for run, nruns, rank in sorted(presorted):
        ces, w = presorted_rank_network(run, nruns, rank)
        out.append(f"\ntemplate <>\nstruct RnPresorted<{run}, {nruns}, {rank}> "
                   f"{{\n{head}T run(T* v) {{\n{_cuda_ces(ces)}"
                   f"    return v[{w}];\n  }}\n}};\n")
    for n, rank in sorted(pruned):
        out.append(f"\ntemplate <>\nstruct RnPruned<{n}, {rank}> {{\n"
                   f"{head}T run(T* v) {{\n{_cuda_ces(pruned_network(n, rank))}"
                   f"    return v[{rank}];\n  }}\n}};\n")
    nparts = max(parts) + 1
    out.append("\n// The instances: X(id, F0, F1, F2, mask, rank, types), one list a\n"
               "// part; types: bit 0 float32, bit 1 int32\n"
               f"#define RN_NPARTS {nparts}\n")
    for part in range(nparts):
        out.append(f"#define RN_INSTANCES_{part}(X)")
        for i, ((f0, f1, f2), mask, rank) in enumerate(instances):
            if parts[i] == part:
                out.append(f" \\\n  X({i}, {f0}, {f1}, {f2}, {mask:#x}ull, {rank}, "
                           f"{types[i]})")
        out.append("\n")
    return "".join(out)
