"""B1's two-stage and pair modes in the torch port
(``ops/fused_separable.py``: ``fused_separable_open_close``,
``fused_separable_morph_pair``, their plain versions, planner and gates).

- The plain versions against cupyimg_tpu's Pallas kernel run by the
  Pallas interpreter on the CPU (``interpret=True``), exactly: five named
  cases.
- Under the morphology gate, against scipy's two calls, exactly; outside
  it (nearest, constant), against a float64 numpy statement of the
  extend-once contract, exactly.
- The gates, the planner's fit for both modes, its paths and register
  windows, and the two-call route the planner decides for windows that
  do not fit; every window the shared-ring layout fitted still fits.
- A numpy model of the kernels' window fold (van Herk / Gil-Werman runs,
  ``run_fold`` in the kernel) against direct windows, NaN included.
- On a CUDA device only: a gated call launches its kernel once and
  never the plain version.
"""

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax.numpy as jnp
from numpy.lib.stride_tricks import sliding_window_view

from cupyimg_tpu.ops.pallas_stencil import (
    fused_separable_morph_pair as jax_pair,
    fused_separable_open_close as jax_open_close,
)
from cupyimg_tpu_torch.ops import fused_separable as fs
from cupyimg_tpu_torch.scipy.ndimage import morphology as morph

X2 = np.random.RandomState(0).rand(40, 52).astype(np.float32)
X3 = np.random.RandomState(1).rand(12, 14, 20).astype(np.float32)
NP_MODE = {"reflect": "symmetric", "grid-mirror": "symmetric",
           "mirror": "reflect", "nearest": "edge", "wrap": "wrap",
           "grid-wrap": "wrap", "constant": "constant",
           "grid-constant": "constant"}


def _dil(sizes, origins):
    """grey_dilation's origins: negated, shifted by one for even sizes."""
    return tuple(-o - 1 if s % 2 == 0 else -o for s, o in zip(sizes, origins))


def _o12(sizes, origins, opening):
    o_dil = _dil(sizes, origins)
    return (tuple(origins), o_dil) if opening else (o_dil, tuple(origins))


# -- against the Pallas interpreter -----------------------------------------

JAX_OPEN_CLOSE = {
    # name: (x, sizes, erosion origins, modes, opening)
    "2d-reflect": (X2, (5, 3), (0, 0), ("reflect",) * 2, True),
    "3d-mixed-sizes": (X3, (3, 1, 5), (0, 0, 0), ("reflect",) * 3, False),
    "2d-wrap-even-origins": (X2, (4, 6), (1, -2), ("wrap", "grid-wrap"),
                             True),
}


@pytest.mark.parametrize("name", sorted(JAX_OPEN_CLOSE))
def test_open_close_plain_matches_pallas_interpret(name):
    x, sizes, origins, modes, opening = JAX_OPEN_CLOSE[name]
    o1, o2 = _o12(sizes, origins, opening)
    exp = np.asarray(jax_open_close(jnp.asarray(x), sizes, o1, o2, modes,
                                    opening=opening, interpret=True))
    before = fs.fused_separable_open_close.launches
    got = fs.fused_separable_open_close(torch.from_numpy(x), sizes, o1, o2,
                                        modes, 0.0, opening)
    assert fs.fused_separable_open_close.launches == before  # CPU: no launch
    np.testing.assert_array_equal(got.numpy(), exp)


JAX_PAIR = {
    # name: (x, sizes, modes, cval, combine)
    "3d-grad": (X3, (3, 5, 3), ("reflect", "nearest", "wrap"), 0.0, "grad"),
    "2d-laplace-constant": (X2, (5, 3), ("constant",) * 2, 0.75, "laplace"),
}


@pytest.mark.parametrize("name", sorted(JAX_PAIR))
def test_pair_plain_matches_pallas_interpret(name):
    x, sizes, modes, cval, combine = JAX_PAIR[name]
    origins = (0,) * x.ndim
    exp = np.asarray(jax_pair(jnp.asarray(x), sizes, origins, modes, cval,
                              combine=combine, interpret=True))
    before = fs.fused_separable_morph_pair.launches
    got = fs.fused_separable_morph_pair(torch.from_numpy(x), sizes, origins,
                                        modes, cval, combine)
    assert fs.fused_separable_morph_pair.launches == before  # CPU: no launch
    np.testing.assert_array_equal(got.numpy(), exp)


# -- against scipy under the gate, float64 numpy outside it -----------------


def _fold(y, sizes, is_min):
    """float64 numpy: a 'valid' box min/max along each axis with a
    window."""
    red = np.min if is_min else np.max
    for ax, sz in enumerate(sizes):
        if sz > 1:
            y = red(sliding_window_view(y, sz, axis=ax), axis=-1)
    return y


def _extend_once(x, pads, modes, cval):
    y = x.astype(np.float64)
    for ax, (pw, m) in enumerate(zip(pads, modes)):
        width = [(0, 0)] * x.ndim
        width[ax] = pw
        kw = {"constant_values": cval} if NP_MODE[m] == "constant" else {}
        y = np.pad(y, width, mode=NP_MODE[m], **kw)
    return y


def _pads(sizes, origins):
    return [(0, 0) if s <= 1 else (s // 2 + o, s - 1 - s // 2 - o)
            for s, o in zip(sizes, origins)]


def _open_close_contract(x, sizes, o1, o2, modes, cval, opening):
    pads = [(a + c, b + d) for (a, b), (c, d) in
            zip(_pads(sizes, o1), _pads(sizes, o2))]
    y = _extend_once(x, pads, modes, cval)
    return _fold(_fold(y, sizes, opening), sizes, not opening)


GATED = [
    # (x, sizes, erosion origins, modes)
    (X2, (5, 3), (0, 0), ("reflect",) * 2),
    (X2, (3, 7), (0, 0), ("mirror",) * 2),
    (X2, (9, 1), (0, 0), ("grid-mirror", "constant")),
    (X2, (4, 6), (1, -2), ("wrap", "grid-wrap")),
    (X2, (2, 5), (-1, 0), ("grid-wrap", "reflect")),
    (X3, (3, 1, 5), (0, 0, 0), ("reflect",) * 3),
    (X3, (5, 3, 3), (0, 0, 0), ("mirror", "wrap", "grid-mirror")),
    (X3, (2, 3, 4), (0, 1, -1), ("wrap",) * 3),
]


@pytest.mark.parametrize("opening", [True, False])
@pytest.mark.parametrize("case", range(len(GATED)))
def test_open_close_plain_equals_scipy_two_calls_under_the_gate(case,
                                                                opening):
    x, sizes, origins, modes = GATED[case]
    o1, o2 = _o12(sizes, origins, opening)
    got = fs.fused_separable_open_close_ref(torch.from_numpy(x), sizes, o1,
                                            o2, modes, 0.0, opening)
    smodes = [{"grid-mirror": "reflect"}.get(m, m) for m in modes]
    first, second = ((sndi.minimum_filter, sndi.maximum_filter) if opening
                     else (sndi.maximum_filter, sndi.minimum_filter))
    exp = second(first(x, sizes, mode=smodes, origin=o1), sizes,
                 mode=smodes, origin=o2)
    np.testing.assert_array_equal(got.numpy(), exp)
    # and the public call, which takes this route, is scipy's
    fn = sndi.grey_opening if opening else sndi.grey_closing
    pub = (morph.grey_opening if opening else morph.grey_closing)(
        torch.from_numpy(x), size=sizes, mode=modes, origin=origins)
    np.testing.assert_array_equal(
        pub.numpy(), fn(x, size=sizes, mode=smodes, origin=origins))


OUTSIDE = [
    (X2, (5, 3), (0, 0), ("nearest",) * 2, 0.0),
    (X2, (3, 5), (0, 0), ("constant", "nearest"), 0.5),
    (X2, (4, 3), (1, 0), ("reflect", "constant"), -1.0),
    (X3, (3, 5, 3), (0, 0, 0), ("constant",) * 3, 2.0),
]


@pytest.mark.parametrize("opening", [True, False])
@pytest.mark.parametrize("case", range(len(OUTSIDE)))
def test_open_close_plain_extends_once_outside_the_gate(case, opening):
    x, sizes, origins, modes, cval = OUTSIDE[case]
    o1, o2 = _o12(sizes, origins, opening)
    got = fs.fused_separable_open_close_ref(torch.from_numpy(x), sizes, o1,
                                            o2, modes, cval, opening)
    exp = _open_close_contract(x, sizes, o1, o2, modes, cval, opening)
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.float32))


@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_extend_once_is_not_scipy_outside_the_gate(mode):
    """scipy's two calls extend the erosion's output again: under nearest
    and constant that is another function, hence the gate."""
    got = fs.fused_separable_open_close_ref(
        torch.from_numpy(X2), (5, 3), (0, 0), (0, 0), (mode,) * 2, 0.5)
    exp = sndi.grey_opening(X2, size=(5, 3), mode=mode, cval=0.5)
    assert not np.array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(
        morph.grey_opening(torch.from_numpy(X2), size=(5, 3), mode=mode,
                           cval=0.5).numpy(), exp)


@pytest.mark.parametrize("combine", ["grad", "laplace"])
@pytest.mark.parametrize("mode", ["reflect", "mirror", "nearest", "wrap",
                                  "constant", "grid-mirror", "grid-wrap",
                                  "grid-constant"])
def test_pair_plain_extends_once_under_every_mode(mode, combine):
    for x, sizes in ((X2, (5, 3)), (X3, (3, 1, 5))):
        xt = torch.from_numpy(x)
        got = fs.fused_separable_morph_pair_ref(
            xt, sizes, (0,) * x.ndim, (mode,) * x.ndim, 0.5, combine)
        y = _extend_once(x, _pads(sizes, (0,) * x.ndim), (mode,) * x.ndim,
                         0.5).astype(np.float32)
        mn, mx = _fold(y, sizes, True), _fold(y, sizes, False)
        exp = mx - mn if combine == "grad" else (mx + mn) - 2 * x
        np.testing.assert_array_equal(got.numpy(), exp)
        d = sndi.grey_dilation(x, sizes, mode=mode, cval=0.5)
        e = sndi.grey_erosion(x, sizes, mode=mode, cval=0.5)
        np.testing.assert_array_equal(
            got.numpy(), d - e if combine == "grad" else (d + e) - 2 * x)


def test_plain_versions_keep_nan():
    x = X2.copy()
    x[10, 20] = np.nan
    xt = torch.from_numpy(x)
    oc = fs.fused_separable_open_close_ref(xt, (3, 3), (0, 0), (0, 0),
                                           ("reflect",) * 2)
    assert torch.isnan(oc[8:13, 18:23]).all() and int(oc.isnan().sum()) == 25
    for combine in ("grad", "laplace"):
        p = fs.fused_separable_morph_pair_ref(xt, (3, 3), (0, 0),
                                              ("reflect",) * 2, 0.0, combine)
        assert torch.isnan(p[9:12, 19:22]).all() and int(p.isnan().sum()) == 9


def test_pair_rejects_unknown_combine():
    with pytest.raises(ValueError):
        fs.fused_separable_morph_pair(torch.from_numpy(X2), (3, 3), (0, 0),
                                      ("reflect",) * 2, 0.0, "sum")


# -- the kernels' window fold -------------------------------------------------


def _seg_fold(get, k, run, op):
    """numpy statement of the kernel's seg_fold: ``run`` windows of ``k``
    >= ``run`` samples, window j over get(j .. j + k - 1): the core
    (samples run - 1 .. k - 1) once, a suffix fold of 0 .. run - 2 and a
    prefix fold of k .. k + run - 2."""
    core = get(run - 1)
    for m in range(run, k):
        core = op(core, get(m))
    suf = [None] * (run - 1)
    suf[run - 2] = get(run - 2)
    for j in range(run - 3, -1, -1):
        suf[j] = op(get(j), suf[j + 1])
    out = [op(suf[0], core)]
    pre = get(k)
    for j in range(1, run - 1):
        out.append(op(op(suf[j], core), pre))
        pre = op(pre, get(k + j))
    out.append(op(core, pre))
    return out


def _run_fold(get, k, run, op):
    """numpy statement of the kernel's run_fold."""
    if k >= run:
        return _seg_fold(get, k, run, op)
    if run > 4 and k >= 4:
        return [v for h in range(run // 4)
                for v in _seg_fold(lambda m, h=h: get(4 * h + m), k, 4, op)]
    out = []
    for j in range(run):
        a = get(j)
        for m in range(1, k):
            a = op(a, get(j + m))
        out.append(a)
    return out


@pytest.mark.parametrize("run", [4, 8])
@pytest.mark.parametrize("is_min", [True, False])
def test_model_of_the_window_fold_matches_direct_windows(run, is_min):
    """Every window of 1..20 samples, runs of 4 (the planes path's axis
    1) and 8 (the rows path), a line with NaN and signed zeros: the van
    Herk / Gil-Werman order gives the direct fold's values exactly, NaN
    where a window holds one (the NaN-keeping minimum and maximum are
    associative)."""
    rng = np.random.RandomState(3)
    line = rng.randn(120).astype(np.float32)
    line[rng.rand(120) < 0.05] = np.nan
    line[[7, 31]] = 0.0
    line[[8, 30]] = -0.0
    xt = torch.from_numpy(line)
    op = torch.minimum if is_min else torch.maximum
    for k in range(1, 21):
        n = len(line) - k + 1
        ref = fs._box_fold(xt[None, None], (1, 1, k), is_min)[0, 0]
        got = []
        for j0 in range(0, n - run + 1, run):
            got += _run_fold(lambda m: xt[j0 + m], k, run, op)
        got = torch.stack(got)
        assert torch.equal(got.isnan(), ref[: len(got)].isnan()), k
        assert torch.equal(got.nan_to_num(7.0), ref[: len(got)].nan_to_num(7.0))


# -- the gates ----------------------------------------------------------------


def test_open_close_gate_declines_where_extend_once_differs():
    x = torch.from_numpy(X2)
    args = (None, None, "reflect", 0.0, 0, None, True)
    assert morph._try_fused_open_close(x, 5, *args) is not None
    for mode in ("nearest", "constant", "grid-constant"):
        assert morph._try_fused_open_close(
            x, 5, None, None, mode, 0.0, 0, None, True) is None
    # even size, or a nonzero origin, under reflect
    assert morph._try_fused_open_close(x, 4, *args) is None
    assert morph._try_fused_open_close(
        x, 5, None, None, "reflect", 0.0, 1, None, True) is None
    # any window under wrap; a non-flat or non-float call never
    assert morph._try_fused_open_close(
        x, 4, None, None, "wrap", 0.0, 1, None, False) is not None
    assert morph._try_fused_open_close(
        x, None, None, np.ones((3, 3)), "reflect", 0.0, 0, None, True) is None
    assert morph._try_fused_open_close(
        x, None, [[0, 1, 0], [1, 1, 1], [0, 1, 0]], None, "reflect", 0.0, 0,
        None, True) is None
    assert morph._try_fused_open_close(
        x.double(), 5, *args) is None  # the kernel is float32
    assert morph._try_fused_open_close(
        (x * 100).to(torch.int32), 5, *args) is None


def test_pair_gate_declines_unequal_windows():
    x = torch.from_numpy(X2)
    for mode in ("nearest", "constant", "wrap"):
        assert morph._try_fused_morph_pair(
            x, 5, None, None, mode, 0.5, 0, None, "grad") is not None
    assert morph._try_fused_morph_pair(
        x, 4, None, None, "reflect", 0.0, 0, None, "grad") is None
    assert morph._try_fused_morph_pair(
        x, 5, None, None, "reflect", 0.0, 1, None, "laplace") is None


@pytest.mark.parametrize("gate, extra", [
    (morph._try_fused_open_close, True),
    (morph._try_fused_morph_pair, "grad"),
])
def test_gates_check_the_origin_of_size_1_axes(gate, extra):
    """cupyimg_tpu's gates skip this check; its two-call route (and the
    port's, everywhere) raises.  SciPy's separable min/max skips size-1
    axes and raises nothing (ROADMAP C)."""
    x = torch.from_numpy(X2)
    with pytest.raises(ValueError, match="invalid origin"):
        gate(x, (1, 5), None, None, "reflect", 0.0, (3, 0), None, extra)
    with pytest.raises(ValueError, match="invalid origin"):
        morph.grey_erosion(x, size=(1, 5), origin=(3, 0))
    assert sndi.grey_opening(X2, size=(1, 5), origin=(3, 0)).shape == X2.shape


# -- the planner --------------------------------------------------------------

PLANS = [
    ((64, 40, 70), (5, 5, 5)),
    ((30, 40, 70), (3, 3, 3)),
    ((1, 300, 517), (1, 7, 7)),
    ((1, 300, 517), (1, 9, 9)),
    ((1, 200, 300), (1, 50, 50)),
    ((30, 40, 70), (21, 21, 21)),
    ((7, 9, 11), (5, 1, 3)),
    ((1, 5, 700), (1, 9, 9)),
    ((16, 24, 40), (64, 1, 64)),
]


@pytest.mark.parametrize("mode", ["open_close", "pair"])
@pytest.mark.parametrize("shape, ntaps", PLANS + [
    # the main path's shapes (chip_smoke.py)
    ((256, 256, 256), (5, 5, 5)),
    ((256, 256, 256), (3, 3, 3)),
    ((1, 4096, 4096), (1, 7, 7)),
    ((1, 4096, 4096), (1, 9, 9)),
])
def test_planner_fits_both_modes(shape, ntaps, mode):
    if shape[0] > 1 and not fs._fits(ntaps, mode):
        with pytest.raises(ValueError):
            fs.plan(shape, ntaps, mode)
        return
    p = fs.plan(shape, ntaps, mode)
    assert p.smem_bytes == fs.smem_bytes(ntaps, p.t1, p.t2, p.mode,
                                         p.stages, p.window)
    assert p.smem_bytes <= fs.SMEM_LIMIT
    # one plane with axis 0 unfiltered marches down rows; else planes,
    # the axis-0 window in registers where it is 1, 3 or 5
    if shape[0] == 1 and ntaps[0] == 1:
        assert p.mode == mode + "_rows" and p.z == 1
        assert p.t1 % fs.ROW_STEP == 0
        assert p.t2 == ((fs.ROW_W - (ntaps[2] - 1)) // 4 * 4
                        if mode == "open_close" else fs.ROW_W)
    else:
        assert p.mode == mode and p.t2 == fs.T2 and p.t1 <= 16
        assert p.window in (0, ntaps[0])
        if p.window and mode == "open_close":
            assert fs.morph_items(ntaps, p.t1) <= fs.MORPH_ITEMS * 256


@pytest.mark.parametrize("shape, ntaps, mode, want", [
    # (mode, t1, t2, z, grid, stages, register window): the main path's
    # six calls, and the rings and fewer stages the widest windows take
    ((256, 256, 256), (5, 5, 5), "open_close",
     ("open_close", 16, 64, 64, (64, 4), 4, 5)),
    ((256, 256, 256), (3, 3, 3), "pair", ("pair", 16, 64, 43, (64, 6), 4, 3)),
    ((1, 4096, 4096), (1, 7, 7), "open_close",
     ("open_close_rows", 288, 120, 1, (525, 1), 4, 0)),
    ((1, 4096, 4096), (1, 9, 9), "open_close",
     ("open_close_rows", 288, 120, 1, (525, 1), 4, 0)),
    ((1, 4096, 4096), (1, 5, 5), "open_close",
     ("open_close_rows", 288, 124, 1, (510, 1), 4, 0)),
    ((1, 4096, 4096), (1, 5, 5), "pair",
     ("pair_rows", 352, 128, 1, (384, 1), 4, 0)),
    ((30, 40, 70), (7, 7, 7), "open_close",
     ("open_close", 16, 64, 30, (6, 1), 4, 0)),
    ((30, 40, 70), (21, 21, 21), "open_close",
     ("open_close", 2, 64, 30, (40, 1), 2, 0)),
    ((12, 30, 70), (5, 21, 21), "open_close",
     ("open_close", 4, 64, 12, (16, 1), 4, 5)),
    ((16, 24, 40), (64, 64, 64), "pair",
     ("pair", 4, 64, 1, (6, 16), 1, 0)),
])
def test_planner_paths_and_register_windows(shape, ntaps, mode, want):
    p = fs.plan(shape, ntaps, mode)
    assert (p.mode, p.t1, p.t2, p.z, p.grid, p.stages, p.window) == want


@pytest.mark.parametrize("mode", ["open_close", "pair"])
@pytest.mark.parametrize("shape, ntaps", PLANS)
def test_planner_tiles_cover_output_exactly(shape, ntaps, mode):
    if shape[0] > 1 and not fs._fits(ntaps, mode):
        return
    # the tiles and strips start 0..3 columns left of column 0
    for shift in (0, 1, 2, 3):
        p = fs.plan(shape, ntaps, mode, shift)
        hits = np.zeros(shape, np.int32)
        for bx in range(p.grid[0]):
            for by in range(p.grid[1]):
                hits[p.block_region(bx, by)] += 1
        assert (hits == 1).all()


def _ring_layout_fits(ntaps, mode):
    """The windows the shared-ring layout of the morphology kernels fits
    at its last resort (a one-row tile, two planes in flight, 4-byte
    loads, rings of K0 planes for every window): the layout the planner
    replaced, whose gate the new one must not narrow."""
    k0, k1, k2 = ntaps
    t1, t2 = 1, fs.T2
    if mode == "open_close":
        w1, w2 = t1 + k1 - 1, t2 + k2 - 1
        h1, h2 = w1 + k1 - 1, w2 + k2 - 1
        words = (h1 + h2 + 2 * h1 * h2 + h1 * w2 + (k0 + 1) * w1 * w2
                 + w1 * t2 + k0 * t1 * t2)
    else:
        h1, h2 = t1 + k1 - 1, t2 + k2 - 1
        words = h1 + h2 + 2 * h1 * h2 + 2 * h1 * t2 + 2 * k0 * t1 * t2
    return 4 * words <= fs.SMEM_LIMIT


def test_supports_rejects_exactly_what_does_not_fit():
    x2 = torch.zeros(8, 8)
    x3 = torch.zeros(4, 8, 8)
    widest = {}
    for x in (x2, x3):
        for k in range(1, 65):
            sizes = (k,) * x.ndim
            ntaps = (1,) * (3 - x.ndim) + sizes
            # a 2-D array's rows path fits every window
            fits = x.ndim == 2 or fs._fits(ntaps, "open_close")
            assert fs.supports_open_close(x, sizes) == fits
            if fits:
                widest[x.ndim] = k
                fs.plan((1,) * (3 - x.ndim) + tuple(x.shape), ntaps,
                        "open_close")
            else:
                with pytest.raises(ValueError):
                    fs.plan((1,) * (3 - x.ndim) + tuple(x.shape), ntaps,
                            "open_close")
            # every pair window of at most 64 fits
            assert fs.supports_pair(x, sizes)
    # the widest square/cube windows the two-stage planner fuses (the
    # shared-ring layout: 50 and 21)
    assert widest == {2: 64, 3: 22}
    assert not fs.supports_open_close(x2, (65, 1))
    assert not fs.supports_pair(x2, (65, 1))
    assert not fs.supports_open_close(x2.double(), (3, 3))
    assert not fs.supports_pair(torch.zeros(2, 3, 4, 5), (3, 3, 3, 3))


@pytest.mark.parametrize("mode", ["open_close", "pair"])
def test_planner_declines_no_window_the_ring_layout_fitted(mode):
    """The gates say no to nothing the shared-ring layout said yes to:
    every 3-D window of at most 64 per axis it fitted still fits (2-D
    windows all fit the rows path)."""
    lost = [(k0, k1, k2) for k0 in range(1, 65) for k1 in range(1, 65)
            for k2 in range(1, 65)
            if _ring_layout_fits((k0, k1, k2), mode)
            and not fs._fits((k0, k1, k2), mode)]
    assert lost == []


def test_planner_declined_window_takes_the_two_call_route(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the planner declined this window")

    monkeypatch.setattr(fs, "fused_separable_open_close", refuse)
    # a 3-D cube wider than the planner fits (a 2-D window of at most 64
    # always fits the rows path)
    x = np.random.RandomState(5).rand(6, 40, 50).astype(np.float32)
    assert not fs.supports_open_close(torch.from_numpy(x), (31, 31, 31))
    got = morph.grey_opening(torch.from_numpy(x), size=(31, 31, 31))
    np.testing.assert_array_equal(got.numpy(),
                                  sndi.grey_opening(x, size=(31, 31, 31)))
    with pytest.raises(AssertionError):
        morph.grey_opening(torch.from_numpy(x), size=(21, 21, 21))
    with pytest.raises(AssertionError):
        morph.grey_opening(torch.from_numpy(x[0]), size=(63, 63))


def test_launch_rejects_a_cpu_tensor():
    with pytest.raises(ValueError):
        fs._launch_morph(torch.from_numpy(X2), (3, 3), (0, 0), (0, 0),
                         ("reflect",) * 2, 0.0, "opening")


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_gated_cuda_calls_launch_their_kernel_once(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    for name in ("fused_separable_open_close_ref",
                 "fused_separable_morph_pair_ref",
                 "fused_separable_minmax_ref"):
        monkeypatch.setattr(fs, name, refuse)
    x = torch.from_numpy(X3).cuda()
    x2 = torch.from_numpy(X2).cuda()  # the rows path
    for call, counter in (
        (lambda: morph.grey_opening(x, size=5), fs.fused_separable_open_close),
        (lambda: morph.grey_closing(x, size=(3, 4, 2), mode="wrap"),
         fs.fused_separable_open_close),
        (lambda: morph.morphological_gradient(x, size=3),
         fs.fused_separable_morph_pair),
        (lambda: morph.morphological_laplace(x, size=3, mode="constant"),
         fs.fused_separable_morph_pair),
        (lambda: morph.grey_opening(x2, size=9), fs.fused_separable_open_close),
        (lambda: morph.morphological_gradient(x2, size=5),
         fs.fused_separable_morph_pair),
    ):
        before = (fs.fused_separable_open_close.launches,
                  fs.fused_separable_morph_pair.launches,
                  fs.fused_separable_minmax.launches)
        call()
        torch.cuda.synchronize()
        after = (fs.fused_separable_open_close.launches,
                 fs.fused_separable_morph_pair.launches,
                 fs.fused_separable_minmax.launches)
        want = [0, 0, 0]
        want[0 if counter is fs.fused_separable_open_close else 1] = 1
        assert [a - b for a, b in zip(after, before)] == want
