"""float16 and bfloat16 in the torch port, on the CPU.

- The public calls that take bfloat16 in cupyimg_tpu (the ndimage
  filters, morphology and interpolation, ``scipy.signal``'s direct
  convolutions, skimage's ``median`` and ``mean_squared_error``,
  ``numpy.histogram``) and their float16 twins, against cupyimg_tpu on
  the same numpy values (JAX on the CPU with x64, as tests/conftest.py
  sets it; one jit program a dtype): the same dtype, values within 1 ulp
  of the half type at max|ref|.
- The three dtypes the port keeps where cupyimg_tpu without x64 gives
  float32 (the Fourier filters, ``spline_filter``, skimage's edge
  filters): float64, SciPy's dtype and cupyimg_tpu's under x64.
- B1's plain versions on half tensors against a float64 numpy statement
  of the same function on the same half values (extend once, fold each
  axis): corr, gradient and laplace within half an ulp of the half type
  at max|ref| plus 2^-24 x sum|taps| x max|x| for each filtered axis
  (float32 taps and sums); min/max/opening/closing exactly, NaN included.
- B1's plain versions against cupyimg_tpu's Pallas kernel in interpret
  mode on the same half arrays (one jit program a dtype).  The JAX
  kernel rounds in the half type at every operation, so corr, gradient
  and laplace are held within (2 x filtered axes + 2) ulps of max|ref|;
  min/max/opening/closing exactly.  Measured worst case on the
  12 x 16 x 40 case (three filtered axes): corr 2 ulps (bfloat16) and
  1.125 (float16) of max|ref|, laplace 0.5, the rest 0; against float64,
  corr 0.497 / 0.499 ulp, gradient and laplace 0.5.
- The gates admit the half types on CUDA tensors only (a CPU half tensor
  keeps the per-axis path, cupyimg_tpu's CPU path), the planner sizes
  the planes paths' input tiles by element size, and the kernel's cval
  is the value the half type holds.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.numpy as jnpx
import cupyimg_tpu.scipy.ndimage as jndi
import cupyimg_tpu.scipy.signal as jsig
import cupyimg_tpu.skimage.filters as jskf
import cupyimg_tpu.skimage.metrics as jskm
from cupyimg_tpu.ops import pallas_stencil as jps
import cupyimg_tpu_torch.numpy as tnpx
import cupyimg_tpu_torch.scipy.ndimage as tndi
import cupyimg_tpu_torch.scipy.signal as tsig
import cupyimg_tpu_torch.skimage.filters as tskf
import cupyimg_tpu_torch.skimage.metrics as tskm
from cupyimg_tpu_torch.core import dtypes
from cupyimg_tpu_torch.ops import fused_separable as fs

TYPES = {"float16": (torch.float16, jnp.float16),
         "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the mantissa step at 1.0
EPS = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}

_RS = np.random.RandomState(0)
X = _RS.rand(32, 24).astype(np.float32)
W2 = _RS.rand(3, 3)
K5 = _RS.rand(5, 5)
COORDS = _RS.rand(2, 6, 7) * 20
KB = _RS.rand(3, 3).astype(np.float32)  # cast to the half type: bf16 x bf16


def ulp(name, magnitude):
    return EPS[name] * 2.0 ** np.floor(np.log2(max(magnitude, 1e-30)))


# -- the public calls against cupyimg_tpu ------------------------------------

def _calls(nd, sig, skf, skm, npx, kb):
    """name -> call of the module set ``(nd, sig, skf, skm, npx)`` on an
    image; ``kb`` is a 3 x 3 kernel in the image's type."""
    return {
        "uniform_filter": lambda a: nd.uniform_filter(a, 5),
        "uniform_filter1d": lambda a: nd.uniform_filter1d(a, 4, axis=0),
        "gaussian_filter": lambda a: nd.gaussian_filter(a, 1.5),
        "correlate1d": lambda a: nd.correlate1d(a, [0.2, -1.0, 0.5, 3.0],
                                                axis=1),
        "correlate": lambda a: nd.correlate(a, W2),
        "sobel": lambda a: nd.sobel(a),
        "prewitt": lambda a: nd.prewitt(a, axis=0),
        "laplace": lambda a: nd.laplace(a),
        "gaussian_laplace": lambda a: nd.gaussian_laplace(a, 1.2),
        "gaussian_gradient_magnitude":
            lambda a: nd.gaussian_gradient_magnitude(a, 1.2),
        "minimum_filter": lambda a: nd.minimum_filter(a, 3),
        "maximum_filter": lambda a: nd.maximum_filter(a, (3, 5)),
        "median_filter": lambda a: nd.median_filter(a, 3),
        "grey_opening": lambda a: nd.grey_opening(a, size=3),
        "grey_closing": lambda a: nd.grey_closing(a, size=(3, 5)),
        "white_tophat": lambda a: nd.white_tophat(a, size=3),
        "morphological_gradient":
            lambda a: nd.morphological_gradient(a, size=3),
        "morphological_laplace":
            lambda a: nd.morphological_laplace(a, size=3),
        "shift": lambda a: nd.shift(a, (1.3, -0.7)),
        "zoom": lambda a: nd.zoom(a, 1.5),
        "rotate": lambda a: nd.rotate(a, 30),
        "map_coordinates": lambda a: nd.map_coordinates(a, COORDS),
        "spline_filter": lambda a: nd.spline_filter(a),
        "fourier_gaussian": lambda a: nd.fourier_gaussian(a, 2.0),
        "signal.convolve": lambda a: sig.convolve(a, K5),
        "signal.convolve2d": lambda a: sig.convolve2d(a, K5),
        "signal.correlate half kernel": lambda a: sig.correlate(a, kb),
        "correlate numpy mode half kernel":
            lambda a: nd.correlate(a, kb, dtype_mode="numpy"),
        "numpy.convolve half kernel": lambda a: npx.convolve(a[0], kb[0]),
        "signal.convolve2d half kernel":
            lambda a: sig.convolve2d(a, kb, boundary="symm"),
        "skimage.filters.median": lambda a: skf.median(a),
        "skimage.filters.sobel": lambda a: skf.sobel(a),
        "skimage.metrics.mean_squared_error":
            lambda a: skm.mean_squared_error(a, a * 0.5),
        "numpy.histogram": lambda a: npx.histogram(a, bins=10),
        "numpy.histogram 300 bins": lambda a: npx.histogram(a, bins=300),
        "numpy.histogram range": lambda a: npx.histogram(
            a, bins=7, range=(0.1, 0.9)),
        "numpy.histogram density": lambda a: npx.histogram(
            a, bins=5, density=True),
    }


NAMES = sorted(_calls(*[None] * 6))
# where the port keeps float64 and cupyimg_tpu without x64 gives float32
# (ROADMAP C): pinned here for both half types
FLOAT64 = ("fourier_gaussian", "spline_filter", "skimage.filters.sobel")


def _numpy_parts(r):
    """A result (an array, or a histogram's (counts, edges)) as a list of
    (dtype name, float64 numpy array)."""
    if isinstance(r, (tuple, list)):
        return [p for q in r for p in _numpy_parts(q)]
    if isinstance(r, torch.Tensor):
        return [(str(r.dtype).replace("torch.", ""),
                 r.to(torch.complex128 if r.is_complex()
                      else torch.float64).numpy())]
    r = jnp.asarray(r)
    wide = jnp.complex128 if jnp.iscomplexobj(r) else jnp.float64
    return [(str(r.dtype), np.asarray(r.astype(wide)))]


@functools.cache
def _jax_results(name):
    """cupyimg_tpu's results of every call on the ``name``-typed image,
    as one jit program; the float16 histograms eager (inside a jit
    program XLA computes their edges' float16 arithmetic in float32 and
    rounds once, where the eager call rounds each operation; bfloat16
    edges come out the same either way)."""
    jdt = TYPES[name][1]
    calls = _calls(jndi, jsig, jskf, jskm, jnpx, jnp.asarray(KB, jdt))
    x = jnp.asarray(X, jdt)
    eager = {k for k in calls
             if k.startswith("numpy.histogram") and name == "float16"}
    out = _compiled(lambda a: {k: f(a) for k, f in calls.items()
                               if k not in eager}, x)(x)
    out.update({k: calls[k](x) for k in eager})
    return {k: _numpy_parts(v) for k, v in out.items()}


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with the CPU backend's code
    generation unoptimised: the same HLO, compiled in a fraction of the
    time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("call", NAMES)
def test_public_call_matches_cupyimg_tpu(call, dtype):
    tdt = TYPES[dtype][0]
    fn = _calls(tndi, tsig, tskf, tskm, tnpx,
                torch.from_numpy(KB).to(tdt))[call]
    got = _numpy_parts(fn(torch.from_numpy(X).to(tdt)))
    exp = _jax_results(dtype)[call]
    assert [g[0] for g in got] == [e[0] for e in exp]
    for (_, g), (_, e) in zip(got, exp):
        assert g.shape == e.shape
        np.testing.assert_allclose(g, e, rtol=0,
                                   atol=ulp(dtype, np.abs(e).max()))
    if call in FLOAT64:
        assert got[0][0] == "float64"


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("call", [
    "fourier_uniform", "fourier_ellipsoid", "fourier_shift", "scharr",
    "prewitt", "roberts", "farid", "sobel_h", "laplace"])
def test_float64_family_of_half_input(call, dtype):
    """The rest of the Fourier filters and skimage's edge filters keep
    float64 (complex128 for ``fourier_shift``) on a half image, as their
    float16 members of the comparison above: each equals the call on the
    image widened to float64 first."""
    x = torch.from_numpy(X).to(TYPES[dtype][0])
    fn = (getattr(tndi, call, None) if call.startswith("fourier")
          else getattr(tskf, call))
    args = (3,) if call.startswith("fourier") else ()
    got, ref = fn(x, *args), fn(x.double(), *args)
    assert got.dtype == (torch.complex128 if call == "fourier_shift"
                         else torch.float64)
    assert torch.equal(got, ref)


# -- B1's plain versions against float64 numpy -------------------------------

_NP_PAD = {"reflect": "symmetric", "mirror": "reflect", "nearest": "edge",
           "wrap": "wrap", "constant": "constant"}
SHAPE3 = (12, 16, 40)
MODES3 = ("reflect", "nearest", "constant")
CVAL = 0.3
TAPS3 = ((0.2,) * 5, (0.1, -0.6, 0.3, 1.2), (0.25, 0.5, 0.25))
ORIG3 = (0, 1, 0)
SIZES3 = (5, 4, 3)


def _half_input(name, nans):
    x = np.random.RandomState(5).standard_normal(SHAPE3).astype(np.float32)
    if nans:
        x.flat[::97] = np.nan
    return torch.from_numpy(x).to(TYPES[name][0])


def _pads(sizes, origins):
    return [(sz // 2 + o, sz - 1 - (sz // 2 + o))
            for sz, o in zip(sizes, origins)]


def _np_extend(x, pads, cval):
    """x (float64) extended once by each axis's (lo, hi), numpy.pad's
    modes standing for ndimage's."""
    for ax, (pw, mode) in enumerate(zip(pads, MODES3)):
        width = [(0, 0)] * x.ndim
        width[ax] = pw
        kw = {"constant_values": cval} if mode == "constant" else {}
        x = np.pad(x, width, _NP_PAD[mode], **kw)
    return x


def _np_fold(y, sizes, op):
    """op (np.minimum, np.maximum) over each axis's window, axis 2 first."""
    for ax in reversed(range(y.ndim)):
        n = y.shape[ax] - sizes[ax] + 1
        acc = np.take(y, range(n), axis=ax)
        for k in range(1, sizes[ax]):
            acc = op(acc, np.take(y, range(k, k + n), axis=ax))
        y = acc
    return y


def _np_reference(kind, x, cval):
    """The float64 statement of B1's ``kind`` on x (float64)."""
    if kind == "corr":
        y = _np_extend(x, _pads([len(t) for t in TAPS3], ORIG3), cval)
        for ax in reversed(range(3)):
            n = x.shape[ax]
            y = sum(w * np.take(y, range(k, k + n), axis=ax)
                    for k, w in enumerate(TAPS3[ax]))
        return y
    if kind in ("min", "max"):
        op = np.minimum if kind == "min" else np.maximum
        return _np_fold(_np_extend(x, _pads(SIZES3, ORIG3), cval), SIZES3,
                        op)
    if kind in ("opening", "closing"):
        first, second = ((np.minimum, np.maximum) if kind == "opening"
                         else (np.maximum, np.minimum))
        one = _pads(SIZES3, (0, 0, 0))  # each stage's window, origin 0
        y = _np_extend(x, [(2 * a, 2 * b) for a, b in one], cval)
        return _np_fold(_np_fold(y, SIZES3, first), SIZES3, second)
    y = _np_extend(x, _pads(SIZES3, ORIG3), cval)
    mn, mx = _np_fold(y, SIZES3, np.minimum), _np_fold(y, SIZES3, np.maximum)
    return mx - mn if kind == "grad" else mx + mn - 2.0 * x


def _plain(kind, x, cval, interpret_jax=False):
    """B1's plain version of ``kind`` (the port's), or cupyimg_tpu's
    Pallas kernel in interpret mode on the same values."""
    if interpret_jax:
        return {
            "corr": lambda a: jps.fused_separable_correlate(
                a, TAPS3, ORIG3, MODES3, cval, interpret=True),
            "min": lambda a: jps.fused_separable_minmax(
                a, SIZES3, ORIG3, MODES3, cval, True, interpret=True),
            "max": lambda a: jps.fused_separable_minmax(
                a, SIZES3, ORIG3, MODES3, cval, False, interpret=True),
            "opening": lambda a: jps.fused_separable_open_close(
                a, SIZES3, (0,) * 3, (0,) * 3, MODES3, cval, True,
                interpret=True),
            "closing": lambda a: jps.fused_separable_open_close(
                a, SIZES3, (0,) * 3, (0,) * 3, MODES3, cval, False,
                interpret=True),
            "grad": lambda a: jps.fused_separable_morph_pair(
                a, SIZES3, ORIG3, MODES3, cval, "grad", interpret=True),
            "laplace": lambda a: jps.fused_separable_morph_pair(
                a, SIZES3, ORIG3, MODES3, cval, "laplace", interpret=True),
        }[kind](x)
    if kind == "corr":
        return fs.fused_separable_correlate(x, TAPS3, ORIG3, MODES3, cval)
    if kind in ("min", "max"):
        return fs.fused_separable_minmax(x, SIZES3, ORIG3, MODES3, cval,
                                         kind == "min")
    if kind in ("opening", "closing"):
        return fs.fused_separable_open_close(
            x, SIZES3, (0,) * 3, (0,) * 3, MODES3, cval, kind == "opening")
    return fs.fused_separable_morph_pair(x, SIZES3, ORIG3, MODES3, cval,
                                         kind)


KINDS = ("corr", "min", "max", "opening", "closing", "grad", "laplace")
EXACT = ("min", "max", "opening", "closing")


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_matches_float64(kind, dtype):
    x = _half_input(dtype, nans=kind in EXACT)
    got = _plain(kind, x, CVAL)
    assert got.dtype == x.dtype and got.shape == x.shape
    cval = float(torch.tensor(CVAL).to(x.dtype))  # the value the type holds
    ref = _np_reference(kind, x.double().numpy(), cval)
    got = got.double().numpy()
    if kind in EXACT:
        np.testing.assert_array_equal(got, ref)
        return
    amax = float(np.abs(x.double().numpy()).max())
    sums = ([float(np.abs(t).sum()) for t in TAPS3] if kind == "corr"
            else [])  # the pair's folds are exact; one rounding
    tol = 0.5 * ulp(dtype, np.abs(ref).max()) + sum(
        2.0 ** -24 * s * amax for s in sums)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


# -- B1's plain versions against cupyimg_tpu's Pallas kernel -----------------

@functools.cache
def _pallas_results(name):
    """cupyimg_tpu's kernel of every kind in interpret mode on the
    ``name``-typed input (with NaN for the exact kinds), one jit
    program."""
    jdt = TYPES[name][1]
    xs = {n: jnp.asarray(_half_input(name, n).float().numpy(), jdt)
          for n in (False, True)}
    out = _compiled(lambda a, b: {
        k: _plain(k, b if k in EXACT else a, CVAL, interpret_jax=True)
        for k in KINDS}, xs[False], xs[True])(xs[False], xs[True])
    return {k: (str(v.dtype), np.asarray(v.astype(jnp.float64)))
            for k, v in out.items()}


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_matches_pallas_interpret(kind, dtype):
    x = _half_input(dtype, nans=kind in EXACT)
    got = _plain(kind, x, CVAL)
    edt, exp = _pallas_results(dtype)[kind]
    assert edt == dtype
    got = got.double().numpy()
    if kind in EXACT:
        np.testing.assert_array_equal(got, exp)
    else:
        tol = (2 * 3 + 2) * ulp(dtype, np.abs(exp).max())
        np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


# -- the gates, the planner and the kernel's cval ----------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that answers as a CUDA one, for the gates alone."""

    @property
    def is_cuda(self):
        return True


def _on_card(x):
    return torch.Tensor._make_subclass(_OnCard, x)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_gates_admit_half_cuda_tensors(dtype):
    tdt = getattr(torch, dtype)
    for shape in ((8, 9, 10), (40, 52)):
        x = torch.zeros(shape, dtype=tdt)
        card = _on_card(x)
        taps = [(0.5, 0.5)] * x.ndim
        assert fs.supports(card, taps)
        assert not fs.supports(card, [(1.0,) * 65] + taps[1:])
        assert fs.supports_open_close(card, [3] * x.ndim)
        assert fs.supports_pair(card, [3] * x.ndim)
        assert not fs.supports_pair(card, [65] * x.ndim)
        assert not fs.supports(x, taps)  # a CPU tensor: no kernel
        # on the CPU a half tensor keeps the two calls (cupyimg_tpu's CPU
        # path); a float32 one runs the plain versions
        assert fs.supports_open_close(x, [3] * x.ndim) == (dtype == "float32")
        assert fs.supports_pair(x, [3] * x.ndim) == (dtype == "float32")
    for bad in (torch.float64, torch.int32):
        assert not fs.supports(_on_card(torch.zeros(8, 9, dtype=bad)),
                               [(1.0,)] * 2)
    assert not fs.supports(_on_card(torch.zeros(2, 3, 4, 5, dtype=tdt)),
                           [(1.0,)] * 4)


@pytest.mark.parametrize("mode", ["separable", "open_close", "pair"])
def test_shared_bytes_by_element_size(mode):
    for ntaps, t1 in (((5, 5, 5), 16), ((9, 17, 33), 8), ((1, 3, 64), 4)):
        full = fs.smem_bytes(ntaps, t1, fs.T2, mode, stages=4)
        half = fs.smem_bytes(ntaps, t1, fs.T2, mode, stages=4, itemsize=2)
        k0, k1, k2 = ntaps
        w1, w2 = ((t1 + k1 - 1, fs.T2 + k2 - 1) if mode == "open_close"
                  else (t1, fs.T2))
        h1, h2 = w1 + k1 - 1, w2 + k2 - 1
        # the input tiles: 16-byte chunks of 4 samples, or of 8; the
        # separable planes path holds a half type's planes as two tiles
        # widened to float32 (8 words a chunk of 8), not four of 16 bytes
        chunks4, chunks8 = (h2 + 6) // 4, (h2 + 14) // 8
        assert fs._row_chunks(h2) == chunks4
        assert fs._row_chunks(h2, 2) == chunks8
        if mode == "separable":
            assert full - half == 4 * h1 * (16 * chunks4 - 2 * 8 * chunks8)
        else:
            assert full - half == 4 * h1 * 16 * (chunks4 - chunks8)
    # the rows path's stage rows start on a multiple of 8 samples for a
    # half type: up to 7 + 127 + K2 - 1 samples, not 3 + 127 + K2 - 1
    for k2 in (1, 3, 5, 9, 17, 60, 64):
        units4, units8 = fs._row_units(k2), fs._row_units(k2, 2)
        assert 8 * units4 >= 3 + 128 + k2 - 1 and units4 % 4 == 2
        assert 8 * units8 >= 7 + 128 + k2 - 1 and units8 % 4 == 2
        assert (fs.smem_bytes((1, 9, k2), 64, 128, "rows", itemsize=2)
                - fs.smem_bytes((1, 9, k2), 64, 128, "rows")
                == 4 * 16 * 8 * (units8 - units4))
    for rows in ("open_close_rows", "pair_rows"):
        assert (fs.smem_bytes((1, 9, 9), 64, 128, rows, itemsize=2)
                == fs.smem_bytes((1, 9, 9), 64, 128, rows))


@pytest.mark.parametrize("mode", ["separable", "open_close", "pair"])
def test_half_plans_cover_the_volume(mode):
    for shape, ntaps in (((9, 20, 136), (5, 9, 4)), ((1, 37, 300),
                                                     (1, 5, 7)),
                         ((20, 30, 70), (9, 9, 9))):
        p = fs.plan(shape, ntaps, mode, shift=2, itemsize=2)
        assert p.itemsize == 2 and p.smem_bytes <= fs.SMEM_LIMIT
        assert p.smem_bytes == fs.smem_bytes(ntaps, p.t1, p.t2, p.mode,
                                             p.stages, p.window, 2)
        seen = np.zeros(shape, np.int32)
        for bx in range(p.grid[0]):
            for by in range(p.grid[1]):
                seen[p.block_region(bx, by)] += 1
        assert (seen == 1).all()


def _kernel_bytes(ntaps, t1, mode, itemsize):
    """Shared bytes of a block as csrc/fused_separable.cu lays them out
    (its pointer arithmetic, transcribed): the planes path
    (fused_separable_f32_kernel) or the rows path (rows_f32_kernel)."""
    k0, k1, k2 = ntaps
    v = 16 // itemsize
    if mode == "rows":
        nu = (((k2 + 126 + v + 7) >> 3) + 1) // 4 * 4 + 2
        lag = (k1 - 1 + 15) // 16
        return 4 * (2 * 64 + 16 * 8 * nu + 16 * (lag + 1) * 128)
    h1, h2 = t1 + k1 - 1, 64 + k2 - 1
    nch = (h2 + 2 * (v - 1)) // v
    h2p = v * nch
    words = 3 * 64 + (h1 + h2 + 3) // 4 * 4
    # bytes: kStages tiles of the type, or a half type's two float tiles
    s_in = 4 * h1 * h2p * itemsize if itemsize == 4 else 2 * h1 * h2p * 4
    ring = 0 if k0 in (3, 5) else k0 * t1 * 64
    return 4 * words + s_in + 4 * (h1 * 64 + ring)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("mode", ["separable", "rows"])
def test_shared_bytes_are_the_kernel_layout(mode, itemsize):
    for k0, k1, k2 in itertools.product((1, 3, 5, 7, 17), (1, 2, 9, 64),
                                        (1, 3, 8, 17, 64)):
        for t1 in (16, 8, 1):
            ntaps = (1 if mode == "rows" else k0, k1, k2)
            assert (fs.smem_bytes(ntaps, t1, 128 if mode == "rows" else
                                  fs.T2, mode, itemsize=itemsize)
                    == _kernel_bytes(ntaps, t1, mode, itemsize))


# chip_smoke.py's half path: (shape, taps or windows, mode)
HALF_PATH_PLANS = [((256,) * 3, (5, 5, 5), "separable"),
                   ((256,) * 3, (17, 17, 17), "separable"),
                   ((256,) * 3, (5, 5, 5), "open_close"),
                   ((256,) * 3, (3, 3, 3), "pair"),
                   ((1, 4096, 4096), (1, 9, 9), "separable"),
                   ((1, 4096, 4096), (1, 3, 3), "separable"),
                   ((1, 4096, 4096), (1, 5, 5), "open_close")]


@pytest.mark.parametrize("shape, ntaps, mode", HALF_PATH_PLANS)
def test_half_plans_at_the_half_path_shapes(shape, ntaps, mode):
    shift = 0 if mode == "separable" else -sum(
        k // 2 for k in ntaps[2:] * (2 if mode == "open_close" else 1)) % 8
    p = fs.plan(shape, ntaps, mode, shift=shift, itemsize=2)
    assert p.smem_bytes <= fs.SMEM_LIMIT
    assert p.smem_bytes == fs.smem_bytes(ntaps, p.t1, p.t2, p.mode,
                                         p.stages, p.window, 2)
    # the 17-tap gaussian keeps two blocks an SM (228 KB, 1 KB a block
    # reserved): its ring is most of a block
    assert 2 * (p.smem_bytes + 1024) <= 228 * 1024 or p.mode != "separable"
    seen = np.zeros(shape, np.uint8)
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            seen[p.block_region(bx, by)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("kind", ["opening", "grad"])
def test_morph_shift_aligns_the_runs(kind, dtype):
    tdt = getattr(torch, dtype)
    v = 16 // torch.empty(0, dtype=tdt).element_size()
    two = kind == "opening"
    for shape in ((37, 300), (29, 264), (6, 19, 256), (6, 19, 250)):
        for size, origin in ((3, 0), (5, 0), (4, 1), (9, -2)):
            x = torch.zeros(shape, dtype=tdt)
            nd = len(shape)
            args = ((size,) * nd, (origin,) * nd, (0,) * nd,
                    ("reflect",) * nd)
            _, info, geom = fs._morph_args(
                x, *(args if two else (args[0], args[1], args[1], args[3])),
                kind)
            lead2 = int(info[2, 1]) + (int(info[2, 2]) if two else 0)
            a, ow = int(geom[10]), int(geom[9])
            n2 = shape[-1]
            tiles2 = -(-(n2 + a) // ow)
            for bx in range(tiles2):
                xs = bx * ow - a - lead2  # the block's first input column
                if nd == 2:
                    # whole units of 4 samples; of 8 (16 bytes of a half
                    # type) where the strips are a multiple of 8 wide
                    assert xs % 4 == 0
                    assert xs % v == 0 or ow % 8 != 0
                elif a:
                    # the planes path's shifted tiles: runs of aligned
                    # chunks of 4 samples (sh 0 for float32, 0 or 4 else)
                    assert (xs - xs // v * v) % 4 == 0


def test_sixteen_byte_flag_counts_samples_of_the_type():
    for tdt, n2, vec in ((torch.float32, 36, 1), (torch.float16, 36, 0),
                         (torch.bfloat16, 40, 1), (torch.float16, 44, 0)):
        x = torch.zeros((3, n2), dtype=tdt)
        _, geom = fs._plan_args(x, (1, 3, n2), (1, 3, 3), "separable")
        assert geom[6] == (vec if x.data_ptr() % 16 == 0 else 0)


def test_kernel_cval_is_the_value_the_type_holds():
    for tdt in (torch.float16, torch.bfloat16):
        for cval in (0.3, -1e-3, 7.1, np.inf, np.nan):
            want = torch.tensor(cval, dtype=torch.float32).to(tdt).item()
            got = fs._kernel_cval(cval, tdt)
            assert got == want or (np.isnan(got) and np.isnan(want))
    assert fs._kernel_cval(0.1, torch.float32) == np.float32(0.1)


def test_policy_promotes_bfloat16_as_jnp():
    bf = torch.bfloat16
    for other in (bf, np.float16, np.float32, np.float64, np.int32, np.uint8,
                  np.bool_, np.complex64, np.int64):
        jother = jnp.bfloat16 if other is bf else other
        want = jnp.promote_types(jnp.bfloat16, jother)
        got = dtypes.promote_types(bf, other)
        name = "bfloat16" if got is bf else str(np.dtype(got))
        assert name == str(want)
        assert dtypes.promote_types(other, bf) == got
    assert dtypes.resolve_output_dtype(None, bf) is bf
    assert dtypes.resolve_output_dtype(None, bf, np.complex128) == np.complex64
    assert dtypes.promote_weights_dtype(bf, np.float64, "float") == np.float32
    assert dtypes.promote_weights_dtype(bf, np.float64, "ndimage") == np.float64
    assert dtypes.kind(bf) == "f" and dtypes.policy_dtype(bf) is bf
    with pytest.raises(TypeError):
        dtypes.to_numpy(bf)
