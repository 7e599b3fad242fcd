"""The dense kernel's module in the torch port (``ops/fused_dense.py``).

- Its plain version against cupyimg_tpu's Pallas kernel run by the Pallas
  interpreter on the CPU (``interpret=True``), on the same numpy inputs,
  float32: rtol 1e-6 plus atol 1e-6 * sum|w| * max|x| (the two sum the
  taps in another order, so outputs near 0 need the absolute term).
- The tap-group planner: every tap in exactly one group, inside its
  group's strip, every strip within the shared-memory budget, for the
  most extended footprints the gate admits; the grid covers the output
  exactly.
- A numpy model of the kernel, driven by the very plan buffer the kernel
  gets (strip loads, flat tap offsets, weights as raw words), against the
  plain version.
- The blocked kernel's planner: its instance choice, every nonzero tap
  in exactly one (chunk, column) pair with its weight, shared bytes
  within 227 KB, the grid covering the output exactly; and a numpy model
  of its register-blocked accumulation over its plan buffer (windows of
  rows + S - 1 samples, zero taps skipped, so an inf under a zero tap
  gives no NaN) against the plain version.
- On a CUDA device only: the kernel against its plain version.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cupyimg_tpu.ops.pallas_stencil import fused_dense_correlate as jax_dense
from cupyimg_tpu_torch.core import boundary
from cupyimg_tpu_torch.ops import fused_dense as fd


def _sparse(shape, nnz, seed):
    """Random weights of ``shape`` with ``nnz`` nonzero taps."""
    rng = np.random.RandomState(seed)
    w = np.zeros(int(np.prod(shape)))
    w[rng.choice(w.size, nnz, replace=False)] = rng.uniform(-1, 1, nnz)
    return w.reshape(shape)


CASES = {
    # name: (shape, weights, origins, mode, cval)
    "2d-7x7-reflect": ((24, 40), np.random.RandomState(1).randn(7, 7),
                       (0, 0), "reflect", 0.0),
    "2d-3x13-constant-lane-toeplitz": (
        (20, 36), np.random.RandomState(2).randn(3, 13), (1, -6),
        "constant", 1.5),
    "3d-3x5x4-wrap-origins": ((10, 12, 20),
                              np.random.RandomState(3).randn(3, 5, 4),
                              (-1, 2, 1), "grid-wrap", 0.0),
    "2d-sparse-9x9-mirror": ((24, 40), _sparse((9, 9), 12, 4), (4, -4),
                             "mirror", 0.0),
}


def _tol(x, w):
    return 1e-6 * np.abs(w).sum() * max(1.0, np.abs(x).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_interpret(name):
    shape, w, origins, mode, cval = CASES[name]
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    exp = np.asarray(jax_dense(jnp.asarray(x), w, origins, mode, cval,
                               interpret=True))
    before = fd.fused_dense_correlate.launches
    got = fd.fused_dense_correlate(torch.from_numpy(x), w, origins, mode, cval)
    assert fd.fused_dense_correlate.launches == before  # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-6, atol=_tol(x, w))


def _offsets3(w):
    return fd.footprint_offsets3(w != 0)


def _scattered(extent, nnz, seed):
    """(d0, d1, d2) offsets of ``nnz`` distinct taps of a 2-D footprint
    of ``extent``, without building the (huge) weights array."""
    rng = np.random.RandomState(seed)
    flat = set()
    while len(flat) < nnz:
        flat.add(int(rng.randint(extent[0] * extent[1])))
    return sorted((0, f // extent[1], f % extent[1]) for f in flat)


EXTREMES = {
    # footprints the gate admits, at their most extended
    "dense-37x37": lambda: _offsets3(np.ones((37, 37))),
    "dense-11x11x11": lambda: _offsets3(np.ones((11, 11, 11))),
    "sparse-60x60x60-1400": lambda: _offsets3(_sparse((60, 60, 60), 1400, 5)),
    "row-1x8000": lambda: _scattered((1, 8000), 700, 6),
    "sparse-8000x8000": lambda: _scattered((8000, 8000), 1400, 7),
    "one-tap": lambda: _offsets3(np.ones((1, 1))),
}


@pytest.mark.parametrize("name", sorted(EXTREMES))
def test_planner_groups_fit_and_partition_the_taps(name):
    offsets = EXTREMES[name]()
    groups = fd.group_taps(offsets, fd.T1, fd.T2)
    seen = sorted(i for g in groups for i in g.taps)
    assert seen == list(range(len(offsets)))  # each tap in one group
    for g in groups:
        assert g.h1 * g.h2 <= fd.STRIP_WORDS
        for i in g.taps:
            d0, d1, d2 = offsets[i]
            assert d0 == g.d0
            assert 0 <= d1 - g.d1 <= g.h1 - fd.T1
            assert 0 <= d2 - g.d2 <= g.h2 - fd.T2
    # the strip and every tap's (offset, weight) fit one block's 227 KB
    assert fd.smem_bytes(groups) <= 4 * fd.STRIP_WORDS + 8 * len(offsets)
    assert fd.smem_bytes(groups) <= 227 * 1024
    if name.startswith("dense"):
        # a footprint whose halo fits loads one strip per plane offset
        assert len(groups) == len({o[0] for o in offsets})


@pytest.mark.parametrize("shape3", [(1, 4096, 4096), (256, 256, 256),
                                    (3, 17, 65), (70000, 1, 5)])
def test_grid_covers_the_output_exactly(shape3):
    n0, n1, n2 = shape3
    gx, gy = fd.grid(shape3, fd.T1, fd.T2)
    assert gx == math.ceil(n1 / fd.T1) * math.ceil(n2 / fd.T2)
    assert gy == min(n0, 65535)
    # block x owns rows [o1, o1 + T1) and columns [o2, o2 + T2), as the
    # kernel derives them; block y owns the planes y, y + gy, ...
    tiles2 = math.ceil(n2 / fd.T2)
    rows = sorted((b // tiles2) * fd.T1 for b in range(gx))
    cols = sorted({(b % tiles2) * fd.T2 for b in range(gx)})
    assert rows[-1] < n1 <= rows[-1] + fd.T1
    assert cols == list(range(0, n2, fd.T2))
    assert sum(len(range(y, n0, gy)) for y in range(gy)) == n0


def _model_kernel(x, w, origins, mode, cval):
    """numpy model of csrc/fused_dense.cu over its plan buffer."""
    offsets = _offsets3(w)
    groups = fd.group_taps(offsets, fd.T1, fd.T2)
    vals = np.asarray(w[w != 0], np.float32)
    buf = fd.plan_buffer(groups, offsets, vals)
    ng, nt = len(groups), len(offsets)
    head = buf[: 8 * ng].reshape(ng, 8)
    tap_off = buf[8 * ng: 8 * ng + nt]
    tap_w = buf[8 * ng + nt:].view(np.float32)
    x3 = x.reshape((1,) * (3 - x.ndim) + x.shape)
    n0, n1, n2 = x3.shape
    lo = [0] * (3 - x.ndim) + fd.window_lo(w.shape, origins)
    y = np.zeros_like(x3)
    for z in range(n0):
        for o1 in range(0, n1, fd.T1):
            for o2 in range(0, n2, fd.T2):
                acc = np.zeros((fd.T1, fd.T2), np.float32)
                for d0, d1, d2, h1, h2, tb, te, _ in head:
                    idx = [np.asarray([z + d0 - lo[0]]),
                           o1 + d1 - lo[1] + np.arange(h1),
                           o2 + d2 - lo[2] + np.arange(h2)]
                    maps = [boundary.map_indices_np(i, n, mode)
                            for i, n in zip(idx, (n0, n1, n2))]
                    strip = x3[np.ix_(*(m for m, _ in maps))][0]
                    oob = (maps[0][1][:, None, None] | maps[1][1][None, :, None]
                           | maps[2][1][None, None, :])[0]
                    flat = np.where(oob, np.float32(cval), strip).ravel()
                    r = np.arange(fd.T1)[:, None] * h2 + np.arange(fd.T2)
                    for t in range(tb, te):
                        acc += tap_w[t] * flat[r + tap_off[t]]
                tile = y[z, o1:o1 + fd.T1, o2:o2 + fd.T2]
                tile[...] = acc[: tile.shape[0], : tile.shape[1]]
    return y.reshape(x.shape)


@pytest.mark.parametrize("shape, w, origins, mode", [
    ((20, 70), np.random.RandomState(8).randn(5, 9), (1, -3), "constant"),
    ((3, 18, 66), np.random.RandomState(9).randn(3, 2, 4), (0, 0, -1),
     "reflect"),
    ((6, 40), _sparse((1, 61), 9, 10), (0, 0), "wrap"),
])
def test_model_of_the_kernel_matches_plain_version(shape, w, origins, mode):
    x = np.random.RandomState(11).rand(*shape).astype(np.float32)
    got = _model_kernel(x, w, origins, mode, 0.5)
    ref = fd.fused_dense_correlate_ref(torch.from_numpy(x), w, origins,
                                       mode, 0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(w).sum())


def test_model_splits_a_row_too_wide_for_one_strip():
    """A 1 x 13000 row with three taps: the strip budget cuts it."""
    w = np.zeros((1, 13000))
    w[0, [0, 6500, 12999]] = (0.5, -1.0, 2.0)
    groups = fd.group_taps(_offsets3(w), fd.T1, fd.T2)
    assert len(groups) == 3
    x = np.random.RandomState(12).rand(4, 7000).astype(np.float32)
    ref = fd.fused_dense_correlate_ref(torch.from_numpy(x), w, (0, 0),
                                       "wrap").numpy()
    np.testing.assert_allclose(_model_kernel(x, w, (0, 0), "wrap", 0.0), ref,
                               rtol=0, atol=1e-5 * 3.5)


BLOCKED = {
    # name: (weights, (k0, s, rows) or None for the generic kernel)
    "2d-9x9": (np.ones((9, 9)), (1, 9, 8)),
    "2d-7x7": (np.ones((7, 7)), (1, 7, 8)),
    "2d-1x31": (np.ones((1, 31)), (1, 1, 8)),
    "2d-31x31-two-chunks": (np.ones((31, 31)), (1, 16, 8)),
    "2d-37x37-three-chunks": (np.ones((37, 37)), (1, 16, 8)),
    "2d-11x11": (np.ones((11, 11)), (1, 16, 8)),
    "3d-3x3x3": (np.ones((3, 3, 3)), (3, 3, 4)),
    "3d-5x5x5": (np.ones((5, 5, 5)), (5, 5, 4)),
    "3d-2x4x3": (np.ones((2, 4, 3)), (2, 5, 4)),
    "3d-4x7x7-two-chunks": (np.ones((4, 7, 7)), (4, 5, 4)),
    "3d-1x3x3": (np.ones((1, 3, 3)), (1, 3, 8)),
    # no instance for 6 planes or more, too sparse, or a tile too wide
    "3d-6x3x3": (np.ones((6, 3, 3)), None),
    "3d-11x11x11": (np.ones((11, 11, 11)), None),
    "2d-sparse-25x40": (_sparse((25, 40), 60, 4), None),
    "2d-sparse-9x9-12": (_sparse((9, 9), 12, 4), None),
    "2d-row-1x1400": (np.ones((1, 1400)), None),
}


@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_blocked_plan_instances_and_fit(name):
    w, want = BLOCKED[name]
    w = np.asarray(w, np.float32)
    # zero borders move the bounding box, not the instance
    wz = np.pad(w, [(1, 2)] * w.ndim)
    for ww in (w, wz):
        bp = fd.blocked_plan(ww)
        if want is None:
            assert bp is None
            continue
        assert (bp.k0, bp.s, bp.rows) == want
        assert (bp.k0, bp.s) in fd.BLOCKED_INSTANCES
        assert bp.smem_bytes == fd.blocked_smem_bytes(
            len(bp.cols), bp.k0, bp.s, bp.rows, bp.box, bp.stages)
        assert bp.smem_bytes <= fd.SMEM_LIMIT
        assert bp.stages == (1 if bp.k0 == 1 else 4)
        # every nonzero tap in exactly one (chunk, column) pair, with
        # its weight; nothing else nonzero
        w3 = ww.reshape((1,) * (3 - ww.ndim) + ww.shape)
        rebuilt = np.zeros((bp.k0, bp.s * (bp.box[1] // bp.s + 1),
                            bp.box[2]), np.float32)
        for (c, d2), wc in zip(bp.cols, bp.weights):
            assert not rebuilt[:, c * bp.s:(c + 1) * bp.s, d2].any()
            rebuilt[:, c * bp.s:(c + 1) * bp.s, d2] = wc
        # the pairs with no zero weight first: the kernel skips their test
        full = [bool(wc.all()) for wc in bp.weights]
        assert full == [True] * bp.ndense + [False] * (len(full) - bp.ndense)
        a = bp.start
        np.testing.assert_array_equal(
            rebuilt[:, : bp.box[1]],
            w3[a[0]:a[0] + bp.box[0], a[1]:a[1] + bp.box[1],
               a[2]:a[2] + bp.box[2]])
        assert not rebuilt[:, bp.box[1]:].any()


@pytest.mark.parametrize("shape3, k0", [((1, 4096, 4096), 1),
                                        ((256, 256, 256), 3),
                                        ((70000, 3, 70), 1), ((9, 33, 65), 5)])
def test_blocked_grid_covers_the_output_exactly(shape3, k0):
    bp = fd.blocked_plan(np.ones((k0, 3, 3), np.float32))
    n0, n1, n2 = shape3
    gx, gy, z = fd.blocked_grid(shape3, bp)
    tiles2 = math.ceil(n2 / fd.T2)
    # tile t: rows (t // tiles2) t1 on, columns (t % tiles2) T2 on
    tiles = math.ceil(n1 / bp.t1) * tiles2
    rows = sorted({(t // tiles2) * bp.t1 for t in range(tiles)})
    cols = sorted({(t % tiles2) * fd.T2 for t in range(tiles)})
    assert rows == list(range(0, n1, bp.t1))
    assert cols == list(range(0, n2, fd.T2))
    assert gx == tiles  # block (bx, by): tile bx
    if k0 == 1:  # planes by, by + gy, ... (CUDA's grid.y limit)
        assert z == 1 and gy == min(n0, 65535)
        assert sum(len(range(y, n0, gy)) for y in range(gy)) == n0
    else:  # planes [by z, by z + z); one resident wave
        assert (gy - 1) * z < n0 <= gy * z
        assert gx * gy <= fd._BLOCKED_BLOCKS


def _model_blocked(x, w, origins, mode, cval):
    """numpy model of csrc/fused_dense.cu's blocked kernel over its plan
    buffer: per output tile and input plane, for each (chunk, column)
    pair the rows + S - 1 samples a thread's outputs need, then R fused
    multiply-adds per nonzero tap (a zero weight is skipped), into the
    K0 output planes the input plane feeds."""
    bp = fd.blocked_plan(np.asarray(w, np.float32))
    buf = fd.blocked_buffer(bp)
    ncols, k0, s, r = len(bp.cols), bp.k0, bp.s, bp.rows
    pairs = buf[: 2 * ncols].reshape(ncols, 2)
    wts = buf[2 * ncols:].view(np.float32).reshape(ncols, k0, s)
    x3 = x.reshape((1,) * (3 - x.ndim) + x.shape)
    n0, n1, n2 = x3.shape
    lo = [0] * (3 - x.ndim) + fd.window_lo(w.shape, origins)
    lo = [a - b for a, b in zip(lo, bp.start)]
    h1 = bp.t1 + math.ceil(bp.box[1] / s) * s - 1
    h2 = fd.T2 + bp.box[2] - 1
    y = np.zeros_like(x3)
    for o1 in range(0, n1, bp.t1):
        for o2 in range(0, n2, fd.T2):
            acc = np.zeros((n0 + k0, bp.t1, fd.T2), np.float32)
            for e in range(n0 + k0 - 1):  # input plane e - lo0
                idx = [np.asarray([e - lo[0]]), o1 - lo[1] + np.arange(h1),
                       o2 - lo[2] + np.arange(h2)]
                maps = [boundary.map_indices_np(i, n, mode)
                        for i, n in zip(idx, (n0, n1, n2))]
                tile = x3[np.ix_(*(m for m, _ in maps))][0]
                oob = (maps[0][1][:, None, None] | maps[1][1][None, :, None]
                       | maps[2][1][None, None, :])[0]
                tile = np.where(oob, np.float32(cval), tile)
                for (c, d2), wc in zip(pairs, wts):
                    for t0 in range(0, bp.t1, r):  # a thread's R rows
                        win = tile[t0 + c * s: t0 + c * s + r + s - 1,
                                   d2: d2 + fd.T2]
                        for d0 in range(k0):
                            zo = e - d0
                            if not 0 <= zo < n0:
                                continue
                            for d1 in range(s):
                                if wc[d0, d1] == 0:
                                    continue
                                acc[zo, t0:t0 + r] = (
                                    wc[d0, d1] * win[d1:d1 + r]
                                    + acc[zo, t0:t0 + r])
            tile_y = y[:, o1:o1 + bp.t1, o2:o2 + fd.T2]
            tile_y[...] = acc[:n0, : tile_y.shape[1], : tile_y.shape[2]]
    return y.reshape(x.shape)


@pytest.mark.parametrize("shape, w, origins, mode", [
    ((20, 70), np.random.RandomState(8).randn(5, 9), (1, -3), "constant"),
    ((20, 70), np.random.RandomState(13).randn(19, 3), (0, 1), "mirror"),
    ((4, 18, 66), np.random.RandomState(9).randn(3, 2, 4), (0, 0, -1),
     "reflect"),
])
def test_model_of_the_blocked_kernel_matches_plain_version(shape, w,
                                                           origins, mode):
    x = np.random.RandomState(11).rand(*shape).astype(np.float32)
    got = _model_blocked(x, w, origins, mode, 0.5)
    ref = fd.fused_dense_correlate_ref(torch.from_numpy(x), w, origins,
                                       mode, 0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(w).sum())


def test_model_of_the_blocked_kernel_skips_zero_taps_over_inf():
    """An inf under a zero weight stays out of the sum: no 0 * inf NaN,
    the same infinities as the plain version."""
    w = np.array([[0.0, 1.0, -2.0], [0.5, 0.0, 0.0], [1.0, 0.25, 0.0]])
    x = np.random.RandomState(14).rand(20, 70).astype(np.float32)
    x[[3, 9, 15], [10, 40, 69]] = np.inf
    x[11, 20] = -np.inf
    with np.errstate(invalid="ignore"):  # inf - inf where both meet
        got = _model_blocked(x, w, (0, 0), "reflect", 0.0)
    ref = fd.fused_dense_correlate_ref(torch.from_numpy(x), w, (0, 0),
                                       "reflect").numpy()
    assert not np.isnan(ref).all() and np.isinf(ref).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got[~np.isfinite(ref)],
                                  ref[~np.isfinite(ref)])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-5 * 4.75)


def test_supports_dense_gate():
    w = np.ones((3, 3))
    assert not fd.supports_dense(torch.rand(8, 8), w)  # CPU tensor
    cuda_like = torch.empty(0)  # no CUDA here: exercise the weight checks
    assert not fd.supports_dense(cuda_like, w)
    assert not fd.supports_dense(torch.rand(8, 8), w.astype(complex))


def test_out_of_window_origin_raises():
    with pytest.raises(ValueError):
        fd.fused_dense_correlate(torch.rand(8, 8), np.ones((3, 3)), (2, 0),
                                 "reflect")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_kernels_skip_zero_taps_over_inf(cuda):
    x = np.random.RandomState(15).rand(40, 70).astype(np.float32)
    x[[3, 9, 15], [10, 40, 69]] = np.inf
    xc = torch.from_numpy(x).cuda()
    for w in (np.array([[0.0, 1.0, -2.0], [0.5, 0.0, 0.0], [1.0, 0.25, 0.0]]),
              _sparse((9, 9), 12, 16)):  # blocked, then generic
        got = fd.fused_dense_correlate(xc, w, (0, 0), "reflect").cpu()
        ref = fd.fused_dense_correlate_ref(xc, w, (0, 0), "reflect").cpu()
        assert torch.equal(got.isnan(), ref.isnan())
        assert torch.equal(got.isinf(), ref.isinf())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    shape, w, origins, mode, cval = CASES[name]
    x = torch.from_numpy(
        np.random.RandomState(0).rand(*shape).astype(np.float32)).cuda()
    before = fd.fused_dense_correlate.launches
    got = fd.fused_dense_correlate(x, w, origins, mode, cval)
    assert fd.fused_dense_correlate.launches == before + 1
    ref = fd.fused_dense_correlate_ref(x, w, origins, mode, cval)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5 * np.abs(w).sum())
