"""The fused separable kernel's module in the torch port.

- Its plain version against cupyimg_tpu's Pallas kernel run by the Pallas
  interpreter on the CPU (``interpret=True``), on the same numpy inputs:
  atol 2e-6 (float32, taps that sum to 1, inputs in [0, 1)), 1e-5 for
  the 64-tap case; the min/max op exactly.
- Its plain version against a float64 numpy statement of the function
  (extend the raw input once, then correlate each axis), where the
  Pallas lane-matmul plan departs from it (constant mode, nonzero cval,
  taps that do not sum to 1: a case the library's cval gate never sends
  to a fused kernel).
- The tile planner's coverage and shared-memory bound, on both paths
  (planes; rows for a 2-D array).
- That the port never imports JAX or the JAX package.
- On a CUDA device only: the kernel against its plain version.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cupyimg_tpu.ops.pallas_stencil import (
    fused_separable_correlate as jax_fused,
    fused_separable_minmax as jax_minmax,
)
from cupyimg_tpu_torch.ops import fused_separable as fs

REPO = pathlib.Path(__file__).resolve().parents[1]
U5 = (0.2,) * 5


def _gauss(radius, sigma):
    g = np.exp(-0.5 * np.arange(-radius, radius + 1) ** 2 / sigma ** 2)
    return tuple(g / g.sum())


_T64 = np.random.RandomState(7).uniform(0.1, 1.0, 64)
T64 = tuple(_T64 / _T64.sum())  # asymmetric, sums to 1

CASES = {
    # name: (shape, weights, origins, modes, cval, atol)
    "3d-modes-origins": (
        (24, 20, 40), (U5, (0.1, 0.5, 0.3, 0.1), U5), (1, -1, -2),
        ("reflect", "mirror", "wrap"), 0.0, 2e-6,
    ),
    "3d-lanemm-padless": (
        (32, 24, 128), (U5, U5, U5), (0, 0, 0), ("reflect",) * 3, 0.0, 2e-6,
    ),
    "2d": (
        (40, 52), (_gauss(3, 1.2), _gauss(3, 1.2)), (0, 0),
        ("nearest", "grid-constant"), 0.0, 2e-6,
    ),
    "2d-25tap-lane-toeplitz": (
        (40, 52), (_gauss(12, 3.0), _gauss(12, 3.0)), (0, 0),
        ("reflect", "mirror"), 0.0, 2e-6,
    ),
    "3d-64tap-constant-short-axis": (
        (16, 24, 40), (T64, T64, T64), (0, 0, 0), ("constant",) * 3, 0.5, 1e-5,
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_interpret(name):
    shape, weights, origins, modes, cval, atol = CASES[name]
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    exp = np.asarray(
        jax_fused(jnp.asarray(x), weights, origins, modes, cval,
                  interpret=True)
    )
    before = fs.fused_separable_correlate.launches
    got = fs.fused_separable_correlate(
        torch.from_numpy(x), weights, origins, modes, cval
    )
    assert fs.fused_separable_correlate.launches == before  # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=atol)


MINMAX_CASES = {
    # name: (shape, sizes, origins, modes, cval, is_min)
    "3d-min-modes-origins-skip": (
        (12, 10, 20), (3, 1, 4), (1, 0, -2),
        ("constant", "wrap", "mirror"), 0.5, True),
    "2d-max-short-axis": ((6, 30), (9, 2), (0, 0),
                          ("reflect", "grid-constant"), -0.25, False),
}


@pytest.mark.parametrize("name", sorted(MINMAX_CASES))
def test_minmax_plain_version_matches_pallas_interpret(name):
    shape, sizes, origins, modes, cval, is_min = MINMAX_CASES[name]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    exp = np.asarray(jax_minmax(jnp.asarray(x), sizes, origins, modes, cval,
                                is_min, interpret=True))
    before = fs.fused_separable_minmax.launches
    got = fs.fused_separable_minmax(torch.from_numpy(x), sizes, origins,
                                    modes, cval, is_min)
    assert fs.fused_separable_minmax.launches == before  # CPU: no launch
    np.testing.assert_array_equal(got.numpy(), exp)


def test_minmax_plain_version_extends_once_and_keeps_nan():
    """Extending the raw input once equals scipy's per-pass re-extension
    for a box extremum, under every mode; a NaN spreads over its box."""
    import scipy.ndimage as sndi

    x = np.random.RandomState(2).rand(7, 9, 11)
    for mode in ("reflect", "mirror", "nearest", "wrap", "constant"):
        got = fs.fused_separable_minmax_ref(
            torch.from_numpy(x), (3, 4, 2), (0, 1, 0), (mode,) * 3, 0.75,
            False)
        exp = sndi.maximum_filter(x, (3, 4, 2), mode=mode, cval=0.75,
                                  origin=(0, 1, 0))
        np.testing.assert_array_equal(got.numpy(), exp)
    x[3, 4, 5] = np.nan
    got = fs.fused_separable_minmax_ref(torch.from_numpy(x), (3, 3, 3),
                                        (0, 0, 0), ("reflect",) * 3)
    assert torch.isnan(got).sum() == 27 and torch.isnan(got[2:5, 3:6, 4:7]).all()


def _extend_once_reference(x, weights, origins, modes, cval):
    """float64 numpy: pad each axis by its own mode (np.pad), then a
    'valid' correlation along each filtered axis."""
    np_mode = {"reflect": "symmetric", "mirror": "reflect", "wrap": "wrap",
               "nearest": "edge", "constant": "constant"}
    y = x.astype(np.float64)
    for ax, (w, o, m) in enumerate(zip(weights, origins, modes)):
        if w is None:
            continue
        lo = len(w) // 2 + o
        pw = [(0, 0)] * x.ndim
        pw[ax] = (lo, len(w) - 1 - lo)
        kw = {"constant_values": cval} if m == "constant" else {}
        y = np.pad(y, pw, mode=np_mode[m], **kw)
    for ax, w in enumerate(weights):
        if w is None:
            continue
        n = x.shape[ax]
        y = sum(wk * np.take(y, np.arange(k, k + n), axis=ax)
                for k, wk in enumerate(w))
    return y


@pytest.mark.parametrize(
    "weights, origins, modes",
    [
        ((_T64 - 0.5,) * 3, (0, 0, 0), ("constant",) * 3),
        ((None, (0.3, -0.7, 1.2, 0.4), U5), (0, 1, -2),
         ("wrap", "constant", "nearest")),
        ((U5, U5, (2.0, -1.0, 0.5)), (2, 0, 1),
         ("mirror", "reflect", "constant")),
    ],
)
def test_plain_version_extends_the_raw_input_once(weights, origins, modes):
    x = np.random.RandomState(4).rand(6, 9, 11)
    exp = _extend_once_reference(x, weights, origins, modes, 0.5)
    got = fs.fused_separable_correlate_ref(
        torch.from_numpy(x), weights, origins, modes, 0.5
    )
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-12, atol=1e-12)


def test_skipped_axes_return_a_copy():
    x = torch.rand(5, 6)
    y = fs.fused_separable_correlate(x, (None, None), (0, 0),
                                     ("reflect",) * 2)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_supports_needs_a_cuda_float32_tensor():
    w = (U5, U5, U5)
    assert not fs.supports(torch.rand(8, 8, 8), w)  # CPU
    assert not fs.supports(np.zeros((8, 8, 8), np.float32), w)


def test_launch_rejects_a_cpu_tensor():
    with pytest.raises(ValueError):
        fs._launch(torch.rand(8, 8), (U5, U5), (0, 0), ("reflect",) * 2, 0.0)


def test_out_of_window_origin_raises():
    with pytest.raises(ValueError):
        fs.fused_separable_correlate(
            torch.rand(8, 8), (U5, None), (3, 0), ("reflect",) * 2
        )


@pytest.mark.parametrize(
    "shape, ntaps",
    [
        ((7, 9, 11), (5, 5, 5)),
        ((1, 30, 70), (1, 25, 25)),
        ((40, 17, 33), (64, 1, 3)),
        ((3, 100, 129), (1, 1, 64)),
        ((1, 1, 1), (1, 1, 1)),
    ],
)
def test_planner_tiles_cover_output_exactly(shape, ntaps):
    p = fs.plan(shape, ntaps)
    hits = np.zeros(shape, np.int32)
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            region = p.block_region(bx, by)
            assert all(s.start < s.stop for s in region)  # no idle block
            hits[region] += 1
    assert (hits == 1).all()
    assert p.smem_bytes == fs.smem_bytes(ntaps, p.t1, p.t2, p.mode) <= (
        fs.SMEM_LIMIT)
    # one plane with axis 0 unfiltered is a 2-D array: the rows path
    assert p.mode == ("rows" if shape[0] == 1 and ntaps[0] == 1
                      else "separable")


@pytest.mark.parametrize(
    "ntaps",
    [(64, 64, 64), (1, 64, 64), (64, 1, 1), (5, 5, 5), (25, 25, 25)],
)
def test_planner_fits_256_cubed(ntaps):
    shape = (256, 256, 256)
    p = fs.plan(shape, ntaps)
    assert p.smem_bytes <= fs.SMEM_LIMIT
    assert p.grid[0] == math.ceil(256 / p.t1) * math.ceil(256 / p.t2)
    assert (p.grid[1] - 1) * p.z < 256 <= p.grid[1] * p.z
    assert p.grid[0] * p.grid[1] >= 132  # every SM of an H100 gets a block


def test_rows_path_plan_fits_every_tap_count():
    """The rows path (a 2-D array): every pair of tap counts 1..64 fits
    64 KB, so three blocks of 256 threads share an SM; the ring holds the
    vertical halo and a step, the stage rows the horizontal halo from any
    alignment; the steps a block runs cover its rows and their halo."""
    for k1 in range(1, fs.MAX_TAPS + 1):
        ring = fs.row_ring(k1)
        assert ring % fs.ROW_STEP == 0 and ring >= k1 - 1 + fs.ROW_STEP
        assert ring < k1 - 1 + 2 * fs.ROW_STEP
        for k2 in range(1, fs.MAX_TAPS + 1):
            b = fs.smem_bytes((1, k1, k2), 8, fs.ROW_W, "rows")
            assert 3 * b <= fs.SMEM_LIMIT and b <= 64 * 1024
            units = fs._row_units(k2)
            # 16 threads of 8 outputs read up to sample 3 + 127 + k2 - 1
            assert 8 * units >= 3 + fs.ROW_W + k2 - 1 and units % 4 == 2
            assert fs.ROW_STEP * units <= 2 * 256  # two units a thread
    for shape, k in (((4096, 4096), 37), ((4096, 4096), 57),
                     ((2048, 2048), 25), ((4096, 4096), 9)):
        p = fs.plan((1, *shape), (1, k, k))
        assert p.mode == "rows" and p.t1 % fs.ROW_STEP == 0
        # about one resident wave: four blocks on each of 132 SMs
        assert 132 * 3 <= p.grid[0] <= 132 * 5 and p.grid[1] == 1
        lag = (k - 1 + fs.ROW_STEP - 1) // fs.ROW_STEP
        steps = p.t1 // fs.ROW_STEP + lag
        assert fs.ROW_STEP * steps >= p.t1 + k - 1
        # the vertical halo's share: (t1 + k - 1) / t1 rows filtered
        assert (p.t1 + k - 1) / p.t1 < 1.5


def test_port_never_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|cupyimg_tpu)(\.|\s|$)", re.M
    )
    files = sorted((REPO / "cupyimg_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {f.name for f in files}
    assert {"fused_separable.py", "fused_dense.py", "fused_rank.py",
            "sorting_networks.py", "stencil.py", "filters.py"} <= names
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    shape, weights, origins, modes, cval, atol = CASES[name]
    x = torch.from_numpy(
        np.random.RandomState(0).rand(*shape).astype(np.float32)
    ).cuda()
    before = fs.fused_separable_correlate.launches
    got = fs.fused_separable_correlate(x, weights, origins, modes, cval)
    assert fs.fused_separable_correlate.launches == before + 1
    ref = fs.fused_separable_correlate_ref(x, weights, origins, modes, cval)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MINMAX_CASES))
def test_minmax_kernel_matches_plain_version(cuda, name):
    shape, sizes, origins, modes, cval, is_min = MINMAX_CASES[name]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    x[2, 3] = np.nan
    xc = torch.from_numpy(x).cuda()
    before = fs.fused_separable_minmax.launches
    got = fs.fused_separable_minmax(xc, sizes, origins, modes, cval, is_min)
    assert fs.fused_separable_minmax.launches == before + 1
    ref = fs.fused_separable_minmax_ref(xc, sizes, origins, modes, cval,
                                        is_min)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
