"""B1 on float16 and bfloat16 CUDA tensors: the separable correlation,
min/max and the grey-morphology kernels read and write the half type and
compute in float32.  Every test carries the ``cuda`` marker and skips
without a card; this file imports no JAX.

- Each kernel against its plain version on the same half tensor: every
  kind (corr, min, max, opening, closing, gradient, laplace) x both half
  types x the rows path (2-D) and the planes path (3-D) x reflect,
  constant with a nonzero cval, nearest and wrap, on rows that can and
  cannot be read in 16-byte chunks.  min/max/opening/closing/gradient
  exactly, NaN included; corr and laplace within 1 ulp of the half type
  at max|plain| (the two may sum in another order).
- The same against the plain versions over the branches of the half
  types' redesigned kernels (``BRANCHES``): rows of 16-byte units and of
  an odd number of samples, shifted tiles, 1 to 64 taps along the
  contiguous axis, every axis-0 register window and a ring.
- Each half call of ``chip_smoke.py``'s half path, at a small size, is
  one B1 (or B1-morph) launch, never the plain version, and agrees with
  scipy in float64 on the same half values: opening, closing and min/max
  exactly; the correlations and the gradient (rounded to the half type
  once) within 1 ulp at max|ref| plus 2^-24 x sum|taps| x max|x| an axis
  (float32 sums).
"""

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

from cupyimg_tpu_torch.ops import fused_separable as fs
from cupyimg_tpu_torch.scipy import ndimage as ndi

HALF = {"float16": torch.float16, "bfloat16": torch.bfloat16}
# the mantissa step at 1.0 of each half type
EPS = {torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}
# mode -> (cval, per-axis taps or window sizes): the taps cover the
# kernel's equal, symmetric and general kinds, the windows its register
# windows (1, 3, 5) and rings
MODES = {
    "reflect": (0.0, 5),
    "constant": (0.3, 9),
    "nearest": (0.0, 4),
    "wrap": (0.0, 3),
}
SHAPES = {  # path -> (16-byte rows, rows of an odd number of chunks)
    "rows": ((40, 264), (37, 300)),
    "planes": ((9, 20, 136), (7, 19, 70)),
}
KINDS = ("corr", "min", "max", "opening", "closing", "grad", "laplace")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def ulp(dtype, magnitude):
    """One ulp of the half type at ``magnitude``."""
    return EPS[dtype] * 2.0 ** np.floor(np.log2(max(magnitude, 1e-30)))


def _taps(n):
    if n == 5:
        return (0.2,) * 5
    if n == 9:
        g = np.exp(-0.5 * np.arange(-4, 5) ** 2 / 2.0 ** 2)
        return tuple(g / g.sum())
    if n == 4:
        return (0.1, -0.6, 0.3, 1.2)
    return (0.25, 0.5, 0.25)


def _input(shape, dtype, nans, seed=0):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    if nans:
        x.flat[:: max(1, x.size // 7)] = np.nan
    return torch.from_numpy(x).to(dtype)


def run_kind(kind, x, n, mode, cval):
    """(kernel, plain) results of one kind on ``x`` (CUDA) with windows or
    taps of ``n`` on every axis but a 3-D array's axis 0 under wrap (a
    register window of 1 there)."""
    nd = x.ndim
    sizes = [n] * nd
    if nd == 3 and mode == "wrap":
        sizes[0] = 1
    modes = (mode,) * nd
    zeros = (0,) * nd
    origins = tuple(1 if sz == 4 else 0 for sz in sizes)
    xc = x.cpu()
    if kind == "corr":
        w = [None if sz == 1 else _taps(sz) for sz in sizes]
        args = (w, origins, modes, cval)
        return (fs.fused_separable_correlate(x, *args),
                fs.fused_separable_correlate_ref(xc, *args))
    if kind in ("min", "max"):
        args = (sizes, origins, modes, cval, kind == "min")
        return (fs.fused_separable_minmax(x, *args),
                fs.fused_separable_minmax_ref(xc, *args))
    if kind in ("opening", "closing"):
        args = (sizes, origins, zeros, modes, cval, kind == "opening")
        return (fs.fused_separable_open_close(x, *args),
                fs.fused_separable_open_close_ref(xc, *args))
    args = (sizes, origins, modes, cval, kind)
    return (fs.fused_separable_morph_pair(x, *args),
            fs.fused_separable_morph_pair_ref(xc, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("path", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_version(cuda, kind, dtype, path, mode,
                                      aligned):
    dtype = HALF[dtype]
    cval, n = MODES[mode]
    shape = SHAPES[path][0 if aligned else 1]
    exact = kind not in ("corr", "laplace")
    x = _input(shape, dtype, nans=exact)
    got, ref = run_kind(kind, x.cuda(), n, mode, cval)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    got, ref = got.cpu().double().numpy(), ref.double().numpy()
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=ulp(dtype, np.abs(ref).max()))


# The branches of the half types' redesigned kernels: (shape, per-axis
# taps or windows, mode, cval).  Rows of n2 % 8 == 0 (16-byte units) and
# 3 (every sample through the index map), tiles shifted off a 16-byte
# boundary (sh != 0), K2 of 1, 5, 17 and 64 with an even window among
# them, axis-0 windows of 1, 3 and 5 (registers) and 7 (a ring), partial
# edge tiles; 3-D on the planes paths, 2-D on the rows paths.
BRANCHES = {
    "ring 7, sh 6, n2 % 8 = 0": ((7, 18, 72), (7, 3, 5), "reflect", 0.0),
    "window 3, K2 17, n2 % 8 = 3": ((6, 18, 67), (3, 5, 17), "constant",
                                     0.3),
    "window 5, K2 64, n2 % 8 = 3": ((8, 21, 131), (5, 2, 64), "nearest",
                                     0.0),
    "window 1, K2 1": ((5, 19, 64), (1, 5, 1), "wrap", 0.0),
    "rows K2 5, sh 6": ((40, 264), (17, 5), "mirror", 0.0),
    "rows K2 64, n2 % 8 = 3": ((37, 291), (3, 64), "reflect", 0.0),
    "rows K2 1": ((33, 200), (9, 1), "constant", 0.3),
}


def _branch_taps(n, rng):
    """Taps of each of the kernel's kinds by length: equal (5), symmetric
    (3, 17), general (1, 2, 7, 64)."""
    if n == 5:
        return (0.2,) * 5
    if n == 3:
        return (0.25, 0.5, 0.25)
    if n == 17:
        g = np.exp(-0.5 * (np.arange(-8, 9) / 3.0) ** 2)
        return tuple(g / g.sum())
    return tuple(rng.uniform(-1, 1, n) / n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BRANCHES))
@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("kind", KINDS)
def test_redesigned_branches_match_plain_version(cuda, kind, dtype, case):
    dtype = HALF[dtype]
    shape, sizes, mode, cval = BRANCHES[case]
    nd = len(shape)
    exact = kind not in ("corr", "laplace")
    x = _input(shape, dtype, nans=exact, seed=5)
    xc, xd = x, x.cuda()
    modes, zeros = (mode,) * nd, (0,) * nd
    if kind == "corr":
        rng = np.random.RandomState(sum(sizes))
        args = ([_branch_taps(n, rng) for n in sizes], zeros, modes, cval)
        got = fs.fused_separable_correlate(xd, *args)
        ref = fs.fused_separable_correlate_ref(xc, *args)
    elif kind in ("min", "max"):
        args = (sizes, zeros, modes, cval, kind == "min")
        got = fs.fused_separable_minmax(xd, *args)
        ref = fs.fused_separable_minmax_ref(xc, *args)
    elif kind in ("opening", "closing"):
        args = (sizes, zeros, zeros, modes, cval, kind == "opening")
        got = fs.fused_separable_open_close(xd, *args)
        ref = fs.fused_separable_open_close_ref(xc, *args)
    else:
        args = (sizes, zeros, modes, cval, kind)
        got = fs.fused_separable_morph_pair(xd, *args)
        ref = fs.fused_separable_morph_pair_ref(xc, *args)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    got, ref = got.cpu().double().numpy(), ref.double().numpy()
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=ulp(dtype, np.abs(ref).max()))


def half_calls():
    """The half path's calls at a small size: (name, call, input shape,
    B1 entry it launches, filtered axes' taps for the tolerance; None:
    exact)."""
    u5, u9 = [0.2] * 5, [1 / 9] * 9
    g = np.exp(-0.5 * (np.arange(-8, 9) / 2.0) ** 2)  # sigma 2, radius 8
    g /= g.sum()
    return {
        "uniform_filter 3-D": (lambda m, x: m.uniform_filter(x, 5),
                               (24, 20, 72), "corr", [u5] * 3),
        "gaussian_filter 3-D": (lambda m, x: m.gaussian_filter(x, 2),
                                (24, 20, 72), "corr", [g] * 3),
        "minimum_filter 3-D": (lambda m, x: m.minimum_filter(x, 5),
                               (24, 20, 72), "minmax", None),
        "grey_opening 3-D": (lambda m, x: m.grey_opening(x, size=5),
                             (24, 20, 72), "open_close", None),
        # max - min of half values, rounded once: not exact in the type
        "morphological_gradient 3-D": (
            lambda m, x: m.morphological_gradient(x, size=3),
            (24, 20, 72), "pair", []),
        "uniform_filter 2-D": (lambda m, x: m.uniform_filter(x, 9),
                               (96, 136), "corr", [u9] * 2),
        "sobel 2-D": (lambda m, x: m.sobel(x), (96, 136), "corr",
                      [[1, 2, 1], [-1, 0, 1]]),
        "grey_closing 2-D": (lambda m, x: m.grey_closing(x, size=5),
                             (96, 136), "open_close", None),
    }


ENTRIES = {"corr": fs.fused_separable_correlate,
           "minmax": fs.fused_separable_minmax,
           "open_close": fs.fused_separable_open_close,
           "pair": fs.fused_separable_morph_pair}
PLAIN = ("fused_separable_correlate_ref", "fused_separable_minmax_ref",
         "fused_separable_open_close_ref", "fused_separable_morph_pair_ref")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("name", sorted(half_calls()))
def test_half_call_is_one_b1_launch(cuda, monkeypatch, name, dtype):
    dtype = HALF[dtype]
    fn, shape, entry, taps = half_calls()[name]

    def refuse(*args, **kwargs):
        raise AssertionError("a half CUDA tensor reached a plain version")

    for plain in PLAIN:
        monkeypatch.setattr(fs, plain, refuse)
    x = _input(shape, dtype, nans=False, seed=3)
    before = {k: f.launches for k, f in ENTRIES.items()}
    got = fn(ndi, x.cuda())
    torch.cuda.synchronize()
    delta = {k: f.launches - before[k] for k, f in ENTRIES.items()}
    assert delta == {k: int(k == entry) for k in ENTRIES}
    assert got.dtype == dtype and got.is_cuda
    x64 = x.double().numpy()
    ref = fn(sndi, x64)
    got = got.cpu().double().numpy()
    if taps is None:
        np.testing.assert_array_equal(got, ref)
    else:
        amax = float(np.abs(x64).max())
        tol = ulp(dtype, np.abs(ref).max()) + sum(
            2.0 ** -24 * float(np.abs(t).sum()) * amax for t in taps)
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
