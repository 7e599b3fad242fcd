"""The spline gather's module and the spline prefilter in the torch port.

- The plain gather (``ops/interp.gather_general``, the plain version of
  ``csrc/spline_gather.cu``) against cupyimg_tpu's ``ops/interp.
  gather_general`` on the same numpy inputs: every order 0-5 and every
  mode, at coordinates that include exact integers, half-integers, the
  domain edges (-0.5, n-1, n-0.5) and points far outside.  Order 0
  exactly, other orders within 1e-12 (float64) or 1e-6 (float32
  coordinates and data) of max|x|.
- The affine entry's plain version: its coordinate field against numpy's
  ``matrix @ o + offset``, and an order-0 identity axis against a
  per-plane 2-D gather.
- The recursion (``ops/iir._apply_axis0``) against cupyimg_tpu's
  ``ops/iir.spline_filter1d``, and the FIR form (pole taps through the
  fused separable kernel's plain version) against the recursion, 1e-5
  in float32.
- The wrapper's contract with ``csrc/spline_gather.cu`` (entry points,
  mode codes, argument counts), read from the source: there is no CUDA
  compiler on a CPU host.
- On a CUDA device only: the kernel against its plain version, and that
  the public calls launch it and not the plain version.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cupyimg_tpu.ops import iir as jiir
from cupyimg_tpu.ops import interp as jinterp
from cupyimg_tpu_torch.ops import _build, fused_separable, iir, interp
from cupyimg_tpu_torch.ops import spline_gather as sg

REPO = pathlib.Path(__file__).resolve().parents[1]
MODES = ("constant", "nearest", "mirror", "reflect", "wrap", "grid-wrap",
         "grid-mirror", "grid-constant")
SHAPE = (9, 7)


def _coords(shape, out_shape, seed):
    """Random coordinates with knife edges mixed in: integers,
    half-integers, -0.5, n-1, n-0.5 and far-out points on every axis."""
    rng = np.random.RandomState(seed)
    size = int(np.prod(out_shape))
    out = []
    for n in shape:
        special = np.concatenate([
            np.arange(-3, n + 3, dtype=np.float64),
            np.arange(-3, n + 3) + 0.5,
            [-0.5, n - 1, n - 0.5, -1e6, 1e6, -3.7e9, 5.1e9, -7.5, n + 6.5],
        ])
        c = rng.uniform(-2 * n, 3 * n, size)
        c[rng.choice(size, len(special), replace=False)] = special
        out.append(c.reshape(out_shape))
    return np.stack(out)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", range(6))
def test_gather_general_matches_jax(order, mode):
    rng = np.random.RandomState(order)
    x = rng.rand(*SHAPE) - 0.3
    c = _coords(SHAPE, (14, 10), 1)
    exp = np.asarray(jinterp.gather_general(
        jnp.asarray(x), [jnp.asarray(v) for v in c], order, mode, 0.5))
    got = interp.gather_general(
        torch.from_numpy(x), list(torch.from_numpy(c)), order, mode, 0.5
    ).numpy()
    if order == 0:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-12)


@pytest.mark.parametrize("order, mode", [(1, "reflect"), (4, "wrap")])
def test_gather_general_float32_matches_jax(order, mode):
    """float32 coordinates: the weights are formed in float32 on both
    sides."""
    x = np.random.RandomState(7).rand(*SHAPE).astype(np.float32)
    c = np.random.RandomState(8).uniform(-4, 12, (2, 6, 5)).astype(
        np.float32)
    exp = np.asarray(jinterp.gather_general(
        jnp.asarray(x), [jnp.asarray(v) for v in c], order, mode, -1.5))
    got = interp.gather_general(
        torch.from_numpy(x), list(torch.from_numpy(c)), order, mode, -1.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-6)


def test_affine_coords_are_matrix_at_index_plus_offset():
    m = np.array([[0.9, 0.3, 0.0], [-0.2, 1.1, 0.4], [0.0, 0.0, 1.0]])
    off = np.array([1.37, -2.21, 0.0])
    pre = [0.5, 0.0, 0.25]
    got = sg.affine_coords(m, off, (4, 5, 3), torch.float64, "cpu", pre)
    idx = np.indices((4, 5, 3)).reshape(3, -1) + np.asarray(pre)[:, None]
    exp = (m @ idx + off[:, None]).reshape(3, 4, 5, 3)
    np.testing.assert_allclose(torch.stack(got).numpy(), exp, rtol=0,
                               atol=1e-14)


def test_order_zero_identity_axis_reads_one_plane():
    """A volume rotate's route: order 0 and an identity row on axis 0
    resample each plane with the same 2-D affine."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(3, *SHAPE))
    m2 = np.array([[0.8, 0.5], [-0.5, 0.8]])
    m3 = np.eye(3)
    m3[1:, 1:] = m2
    off = np.array([0.0, 1.3, -0.6])
    got = sg.spline_affine(x, m3, off, (3, 8, 6), [0, 3, 3], "reflect", 0.0)
    for p in range(3):
        exp = sg.spline_affine(x[p].contiguous(), m2, off[1:], (8, 6), 3,
                               "reflect", 0.0)
        torch.testing.assert_close(got[p], exp, rtol=0, atol=0)


@pytest.mark.parametrize("order, mode", [
    (2, "mirror"), (3, "reflect"), (4, "grid-wrap"), (5, "reflect"),
])
def test_recursion_matches_jax(order, mode):
    x = np.random.RandomState(order).rand(23, 6)
    exp = np.asarray(jiir.spline_filter1d(jnp.asarray(x), order, 0, mode))
    got = iir.spline_filter1d(torch.from_numpy(x), order, 0, mode)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["mirror", "reflect", "grid-wrap",
                                  "nearest"])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_fir_matches_recursion(order, mode):
    """Each pole's symmetric FIR on the fused separable kernel's plain
    version (what the kernel runs on the card) against the recursion."""
    x = torch.from_numpy(
        np.random.RandomState(order).rand(40, 70).astype(np.float32))
    spline_mode = iir.get_spline_mode(mode)
    got = x
    for taps in iir.pole_taps(order):
        got = fused_separable.fused_separable_correlate(
            got, (taps, taps), (0, 0), (spline_mode,) * 2, 0.0)
    exp = x
    for axis in (0, 1):
        exp = iir.spline_filter1d(exp, order, axis, mode)
    torch.testing.assert_close(got, exp, rtol=0, atol=1e-5)


def test_fir_gate():
    """Only a CUDA float32 2-D/3-D tensor takes the FIR; the taps fit
    the fused kernel (37 for order 3, 57 for order 5)."""
    assert [len(t) for t in iir.pole_taps(3)] == [37]
    assert max(len(t) for t in iir.pole_taps(5)) == 57
    assert iir.spline_filter_fir(torch.rand(40, 40), 3, (0, 1),
                                 "mirror") is None


def test_kernel_source_contract(monkeypatch):
    src = (REPO / "cupyimg_tpu_torch/csrc/spline_gather.cu").read_text()
    codes = dict(re.findall(r"constexpr int kI(\w+) = (\d+);", src))
    names = {"Reflect": "reflect", "GridMirror": "grid-mirror",
             "Mirror": "mirror", "Nearest": "nearest", "Wrap": "wrap",
             "GridWrap": "grid-wrap", "Constant": "constant",
             "GridConstant": "grid-constant"}
    assert {names[k]: int(v) for k, v in codes.items()} == sg._MODE_CODES

    entries = ("spline_affine", "spline_map", "spline_affine_fast",
               "spline_map_fast")

    class Lib:  # stands in for the built library: no nvcc here
        pass

    for entry in entries:
        setattr(Lib, entry, type("Fn", (), {})())
    monkeypatch.setattr(_build, "load", lambda name, part=None: Lib)
    lib = sg._library(0)
    for entry in entries:
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
        assert len(m.group(1).split(",")) == len(
            getattr(lib, entry).argtypes)
    assert "spline_gather" in _build.SOURCES
    assert "-fmad=false" in _build.EXTRA_FLAGS["spline_gather"]


def _source_patterns(src, macro):
    """The order patterns listed in the kernel's ``#define macro(X)``."""
    body = re.search(r"#define " + macro + r"\(X\)(.*?)(?<!\\)\n", src,
                     re.S).group(1)
    pats = [tuple(int(v) for v in m.split(","))
            for m in re.findall(r"\bX\(([\d, ]+)\)", body)]
    for sub in re.findall(r"(SG_\w+_PATTERNS)\(X\)", body):
        pats += _source_patterns(src, sub)
    return pats


def test_instance_patterns_match_the_kernel_source():
    """The host's pattern table is the list of instances the kernel
    compiles, without repeats, and the part code is the kernel's."""
    src = (REPO / "cupyimg_tpu_torch/csrc/spline_gather.cu").read_text()
    for macro, table in (("SG_AFFINE_PATTERNS", sg.AFFINE_PATTERNS),
                         ("SG_MAP_PATTERNS", sg.MAP_PATTERNS)):
        pats = _source_patterns(src, macro)
        assert len(pats) == len(set(pats)) == len(table)
        assert set(pats) == set(table)
    assert "(SG_PART >> 2) & 1;  // 0 float32, 1 float64" in src
    assert "kPartC = (SG_PART >> 1) & 1;" in src
    assert "kPartNC = (SG_PART & 1) + 1;" in src
    assert _build.PARTS["spline_gather"] == ("SG_PART", 8)
    assert sg.pattern_key((0, 3, 3)) == 3033 and sg.pattern_key((5,)) == 15


def _public_call_combinations(monkeypatch):
    """Every (entry, orders, dtype, coordinate dtype) that the public
    interpolation calls hand the kernel: each call runs on the CPU with
    the gather replaced by a recorder (no interpolation is computed)."""
    import cupyimg_tpu_torch.scipy.ndimage as tndi
    from cupyimg_tpu_torch.core.config import config

    seen = []

    def affine(x, matrix, offset, output_shape, order, mode, cval=0.0,
               coord_dtype=torch.float64, pre=None):
        orders = sg._orders(order, x.ndim)
        seen.append(("affine", tuple(orders), x.dtype, coord_dtype, mode,
                     len(output_shape)))
        return torch.zeros(tuple(output_shape), dtype=x.dtype)

    def map_(x, coords, order, mode, cval=0.0):
        seen.append(("map", tuple(sg._orders(order, x.ndim)), x.dtype,
                     coords.dtype, mode, x.ndim))
        return torch.zeros(tuple(coords.shape[1:]), dtype=x.dtype)

    monkeypatch.setattr(sg, "spline_affine", affine)
    monkeypatch.setattr(sg, "spline_map", map_)
    modes = MODES + ("opencv",)
    i = 0
    for ndim in (1, 2, 3):
        shape = (5, 6, 4)[:ndim]
        for dtype in (torch.uint8, torch.float32, torch.float64,
                      torch.complex64, torch.complex128):
            x = torch.ones(shape, dtype=dtype)
            for order in range(6):
                for allow32, precision in ((True, "auto"), (True, "f32"),
                                           (False, "auto")):
                    monkeypatch.setattr(config, "coord_precision", precision)
                    mode = modes[i % len(modes)]
                    i += 1
                    kw = dict(order=order, mode=mode, prefilter=False,
                              allow_float32=allow32)
                    tndi.affine_transform(x, np.eye(ndim) * 0.9, **kw)
                    tndi.shift(x, 0.5, **kw)
                    tndi.zoom(x, 1.5, **kw)
                    tndi.zoom(x, 1.5, grid_mode=True, **kw)
                    for cdt in (torch.float32, torch.float64):
                        c = torch.zeros((ndim, 3, 2), dtype=cdt)
                        tndi.map_coordinates(x, c, **kw)
                    planes = {1: [], 2: [(0, 1)], 3: [(0, 1), (0, 2), (1, 2)]}
                    for axes in planes[ndim]:
                        tndi.rotate(x, 30, axes=axes, **kw)
    return seen


@pytest.mark.filterwarnings("ignore:It is recommended")
def test_instance_table_covers_every_public_call(monkeypatch):
    """Every combination the public calls produce (ndim 1-3, per-axis
    orders, every mode, data and coordinate dtypes, real or complex) is
    served by exactly one fast instance, and no two combinations that
    differ in dtype, coordinate dtype, components or orders share one;
    every instance of the table serves some call."""
    seen = _public_call_combinations(monkeypatch)
    served = {}
    modes = set()
    for entry, orders, dtype, cdtype, mode, out_ndim in seen:
        inst = sg.instance(entry, orders, dtype, cdtype, 100, 100, out_ndim)
        assert inst.key is not None, (entry, orders, dtype, cdtype)
        combo = (entry, orders, dtype, cdtype)
        assert served.setdefault(combo, inst) == inst
        modes.add(mode)
    assert len(set(served.values())) == len(served)
    assert modes >= set(MODES)
    table = {(e, p, k) for e, pats in (("affine", sg.AFFINE_PATTERNS),
                                       ("map", sg.MAP_PATTERNS))
             for p in range(8) for k in map(sg.pattern_key, pats)}
    assert {(i.entry, i.part, i.key) for i in served.values()} == table


def test_generic_instance_takes_the_rest():
    """Mixed orders, a 2-D rotate-like pattern and 2^31 elements go to the
    generic instance (part 0)."""
    f32, f64 = torch.float32, torch.float64
    for args in (("affine", (1, 3), f32, f64, 10, 10),
                 ("affine", (0, 3), f32, f64, 10, 10),
                 ("map", (0, 1, 1), f32, f32, 10, 10),
                 ("affine", (1, 1), f32, f64, 2 ** 31, 10),
                 ("map", (1, 1), f32, f32, 10, 2 ** 30)):
        assert sg.instance(*args) == sg.Instance(args[0], 0, None)
    assert sg.instance("affine", (1, 1), f32, f64, 10, 10, 3).key is None


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="float32/float64/complex"):
        sg.spline_map(torch.zeros(4, 4, dtype=torch.int32),
                      torch.zeros(2, 3), 1, "reflect")
    with pytest.raises(ValueError, match="order"):
        sg.spline_affine(torch.zeros(4, 4), np.eye(2), np.zeros(2), (4, 4),
                         6, "reflect")
    before = sg.launches
    sg.spline_affine(torch.zeros(4, 4), np.eye(2), np.zeros(2), (4, 4), 1,
                     "reflect")
    assert sg.launches == before  # CPU: the plain version, no launch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_version(cuda, mode, dtype):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(6, *SHAPE)).to(dtype)
    if dtype.is_complex:
        x = x + 1j * torch.from_numpy(rng.rand(6, *SHAPE)).to(dtype)
    x = x.cuda()
    c = torch.from_numpy(_coords(x.shape, (7, 5, 4), 6)).cuda()
    scale = float(x.abs().max())
    tol = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-12
    for order in range(6):
        got = sg.spline_map(x, c, order, mode, 0.5)
        ref = sg.spline_map_ref(x, c, order, mode, 0.5)
        torch.cuda.synchronize()
        if order == 0:
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=0, atol=tol * scale)
        m = np.array([[1.0, 0, 0], [0, 0.8, 0.6], [0, -0.6, 0.8]])
        off = np.array([0.0, 1.5, -2.25])
        got = sg.spline_affine(x, m, off, (6, 8, 9), [0, order, order],
                               mode, 0.5)
        ref = sg.spline_affine_ref(x, m, off, (6, 8, 9), [0, order, order],
                                   mode, 0.5)
        torch.testing.assert_close(got, ref, rtol=0, atol=tol * scale)


@pytest.mark.cuda
def test_cuda_calls_launch_the_kernel_not_the_plain_version(cuda,
                                                            monkeypatch):
    import cupyimg_tpu_torch.scipy.ndimage as tndi

    def plain(*args, **kwargs):
        raise AssertionError("the plain gather ran on the card")

    monkeypatch.setattr(interp, "gather_general", plain)
    x = torch.rand(40, 50, device="cuda")
    before = sg.launches
    b1 = fused_separable.fused_separable_correlate.launches
    tndi.map_coordinates(x, torch.rand(2, 30, 20, device="cuda") * 40,
                         order=3, mode="reflect")
    assert sg.launches == before + 1
    assert fused_separable.fused_separable_correlate.launches == b1 + 1
    for call in (lambda: tndi.shift(x, (1.5, -0.3), order=1),
                 lambda: tndi.zoom(x, 1.5, order=0),
                 lambda: tndi.rotate(x, 30, order=1),
                 lambda: tndi.affine_transform(x, [[1, 0.2], [0, 1]],
                                               order=1)):
        before = sg.launches
        call()
        assert sg.launches == before + 1
