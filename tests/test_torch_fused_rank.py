"""The rank kernel's module in the torch port (``ops/fused_rank.py``) and
the sorting networks it runs (``ops/sorting_networks.py``).

- Its plain version against cupyimg_tpu's Pallas kernel run by the Pallas
  interpreter on the CPU (``interpret=True``), on the same numpy inputs:
  exact (an order statistic of the same values).
- The network constructors equal cupyimg_tpu's, and each pruned network
  selects its rank (0/1 principle, exhaustive for small K).
- The planner on the most extended footprints the gate admits.
- A numpy model of the kernel, driven by its plan buffer (strip loads,
  flat tap offsets, wires, the CE list), against the plain version:
  exact, NaN included.
- On a CUDA device only: the kernel against its plain version.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cupyimg_tpu.ops import sorting_networks as jsn
from cupyimg_tpu.ops.pallas_stencil import fused_rank_filter as jax_rank
from cupyimg_tpu_torch.core import boundary
from cupyimg_tpu_torch.ops import fused_dense as fd
from cupyimg_tpu_torch.ops import fused_rank as fr
from cupyimg_tpu_torch.ops import sorting_networks as tsn

CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)

CASES = {
    # name: (shape, dtype, footprint, origins, rank, mode, cval)
    "2d-5x5-median": ((20, 37), np.float32, np.ones((5, 5), bool), (0, 0),
                      12, "reflect", 0.0),
    "3d-3x3x3-median": ((8, 9, 21), np.float32, np.ones((3, 3, 3), bool),
                        (0, 0, 0), 13, "mirror", 0.0),
    "2d-cross-int32-constant": ((18, 29), np.int32, CROSS, (0, 1), 2,
                                "constant", 3.0),
    "2d-4x2-even-origins": ((16, 33), np.float32, np.ones((4, 2), bool),
                            (-2, -1), 1, "grid-wrap", 0.0),
}


def _input(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        return rng.randint(-50, 50, shape).astype(np.int32)
    return rng.randn(*shape).astype(dtype)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_interpret(name):
    shape, dtype, fp, origins, rank, mode, cval = CASES[name]
    x = _input(shape, dtype)
    exp = np.asarray(jax_rank(jnp.asarray(x), fp, origins, rank, mode, cval,
                              interpret=True))
    before = fr.fused_rank_filter.launches
    got = fr.fused_rank_filter(torch.from_numpy(x), fp, origins, rank, mode,
                               cval)
    assert fr.fused_rank_filter.launches == before  # CPU: no launch
    np.testing.assert_array_equal(got.numpy(), exp)


def test_network_constructors_match_the_reference():
    for n in range(1, 65):
        assert tsn.batcher_network(n) == jsn.batcher_network(n)
    for n, r in [(9, 4), (25, 12), (27, 13), (64, 1), (64, 62), (5, 2)]:
        assert tsn.pruned_network(n, r) == jsn.pruned_network(n, r)
    assert tsn.presorted_rank_network(5, 5, 12) == \
        jsn.presorted_rank_network(5, 5, 12)
    assert tsn.merge_runs_full_network(3, 3) == \
        jsn.merge_runs_full_network(3, 3)
    # the least CE counts a pixel of the rectangles' shared presort
    assert len(tsn.batcher_network(5)) + len(
        tsn.presorted_rank_network(5, 5, 12)[0]) == 91
    assert len(tsn.batcher_network(3)) + len(
        tsn.merge_runs_full_network(3, 3)[0]) + len(
        tsn.presorted_rank_network(9, 3, 13)[0]) == 76


@pytest.mark.parametrize("n", [3, 5, 8, 9, 12])
def test_pruned_networks_select_their_rank(n):
    """0/1 principle: on every 0/1 input, wire ``rank`` ends up 1 exactly
    when more than n - 1 - rank inputs are 1."""
    cases = np.array(list(itertools.product((0, 1), repeat=n)), np.int8).T
    for rank in range(n):
        wires = [torch.from_numpy(c.copy()) for c in cases]
        got = tsn.rank_select(wires, rank).numpy()
        want = (cases.sum(0) > n - 1 - rank).astype(np.int8)
        np.testing.assert_array_equal(got, want)


def test_rank_select_propagates_nan():
    vals = [torch.tensor([1.0, np.nan, 3.0]), torch.tensor([2.0, 0.0, 1.0]),
            torch.tensor([0.0, 5.0, 2.0])]
    out = tsn.rank_select(vals, 1)
    assert out[0] == 1.0 and torch.isnan(out[1]) and out[2] == 2.0


EXTREMES = {
    "1x4000-64-ones": (1, 4000),
    "40x40x40-64-ones": (40, 40, 40),
}


def _ones_at(extent, k, seed):
    fp = np.zeros(int(np.prod(extent)), bool)
    fp[np.random.RandomState(seed).choice(fp.size, k, replace=False)] = True
    return fp.reshape(extent)


@pytest.mark.parametrize("name", sorted(EXTREMES))
def test_planner_fits_the_most_extended_footprints(name):
    fp = _ones_at(EXTREMES[name], 64, 1)
    offsets = fd.footprint_offsets3(fp)
    groups = fd.group_taps(offsets, fr.T1, fr.T2)
    assert sorted(i for g in groups for i in g.taps) == list(range(64))
    for g in groups:
        assert g.h1 * g.h2 <= fd.STRIP_WORDS
        for i in g.taps:
            d0, d1, d2 = offsets[i]
            assert d0 == g.d0 and 0 <= d1 - g.d1 <= g.h1 - fr.T1
            assert 0 <= d2 - g.d2 <= g.h2 - fr.T2


def _model_kernel(x, fp, origins, rank, mode, cval):
    """numpy model of csrc/fused_rank.cu over its plan buffer."""
    offsets = fd.footprint_offsets3(fp)
    k = len(offsets)
    groups = fd.group_taps(offsets, fr.T1, fr.T2)
    buf = fd.plan_buffer(groups, offsets, np.arange(k, dtype=np.int32))
    ces = tsn.pruned_network(k, rank)
    ng = len(groups)
    head = buf[: 8 * ng].reshape(ng, 8)
    tap_off = buf[8 * ng: 8 * ng + k]
    tap_wire = buf[8 * ng + k:]
    x3 = x.reshape((1,) * (3 - x.ndim) + x.shape)
    n0, n1, n2 = x3.shape
    lo = [0] * (3 - x.ndim) + fd.window_lo(fp.shape, origins)
    cv = boundary.fill_value(cval, torch.from_numpy(x).dtype)
    y = np.zeros_like(x3)
    for z in range(n0):
        for o1 in range(0, n1, fr.T1):
            for o2 in range(0, n2, fr.T2):
                v = [None] * k
                for d0, d1, d2, h1, h2, tb, te, _ in head:
                    idx = [np.asarray([z + d0 - lo[0]]),
                           o1 + d1 - lo[1] + np.arange(h1),
                           o2 + d2 - lo[2] + np.arange(h2)]
                    maps = [boundary.map_indices_np(i, n, mode)
                            for i, n in zip(idx, (n0, n1, n2))]
                    strip = x3[np.ix_(*(m for m, _ in maps))][0]
                    oob = (maps[0][1][:, None, None]
                           | maps[1][1][None, :, None]
                           | maps[2][1][None, None, :])[0]
                    flat = np.where(oob, cv, strip).astype(x.dtype).ravel()
                    r = np.arange(fr.T1)[:, None] * h2 + np.arange(fr.T2)
                    for t in range(tb, te):
                        v[tap_wire[t]] = torch.from_numpy(
                            flat[r + tap_off[t]])
                for a, b in ces:
                    v[a], v[b] = (torch.minimum(v[a], v[b]),
                                  torch.maximum(v[a], v[b]))
                tile = y[z, o1:o1 + fr.T1, o2:o2 + fr.T2]
                tile[...] = v[rank].numpy()[: tile.shape[0], : tile.shape[1]]
    return y.reshape(x.shape)


@pytest.mark.parametrize("shape, dtype, fp, origins, rank, mode", [
    ((12, 40), np.float32, np.ones((3, 4), bool), (0, -1), 6, "nearest"),
    ((3, 10, 35), np.int32, _ones_at((3, 2, 3), 9, 2), (1, 0, 0), 4,
     "constant"),
    ((5, 70), np.float32, _ones_at((1, 150), 7, 3), (0, 0), 3, "reflect"),
])
def test_model_of_the_kernel_matches_plain_version(shape, dtype, fp, origins,
                                                   rank, mode):
    x = _input(shape, dtype, 4)
    if dtype == np.float32:
        x[1, 3] = np.nan
    got = _model_kernel(x, fp, origins, rank, mode, 2.5)
    ref = fr.fused_rank_filter_ref(torch.from_numpy(x), fp, origins, rank,
                                   mode, 2.5).numpy()
    np.testing.assert_array_equal(got, ref)


def test_supports_rank_gate():
    assert not fr.supports_rank(torch.rand(8, 8), 9)  # CPU tensor
    assert not fr.supports_rank(np.zeros((8, 8), np.float32), 9)


def test_out_of_window_origin_raises():
    with pytest.raises(ValueError):
        fr.fused_rank_filter(torch.rand(8, 8), np.ones((3, 3), bool), (2, 0),
                             4, "reflect")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    shape, dtype, fp, origins, rank, mode, cval = CASES[name]
    x = torch.from_numpy(_input(shape, dtype)).cuda()
    before = fr.fused_rank_filter.launches
    got = fr.fused_rank_filter(x, fp, origins, rank, mode, cval)
    assert fr.fused_rank_filter.launches == before + 1
    ref = fr.fused_rank_filter_ref(x, fp, origins, rank, mode, cval)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
