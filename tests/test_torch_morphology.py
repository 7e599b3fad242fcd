"""The morphology slice of the torch port against scipy.ndimage, on CPU
tensors (milliseconds a case; no JAX).

- Grey morphology (the min/max filters, B1's two-stage and pair routes
  and the two-call route), binary morphology and the distance transforms,
  exactly, over 2-D/3-D inputs, sizes, footprints, structures, every
  boundary mode, origins and ``axes``; the EDT within 1e-6 relative
  (float32 against scipy's float64).
- The error classes.
- Where ``cupyimg_tpu`` departs from scipy and the port follows it
  (ROADMAP C): the laplace's last rounding, a non-flat ``structure`` on
  float32 data, the EDT's dtype, the chamfer transform's indices, the
  origin of a size-1 axis.
- skimage.morphology against scipy-based statements of its conventions.
"""

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import cupyimg_tpu_torch.scipy.ndimage as ndi
import cupyimg_tpu_torch.skimage.morphology as skm
from cupyimg_tpu_torch.scipy.ndimage import morphology as morph

MODES = ("reflect", "mirror", "nearest", "wrap", "constant", "grid-mirror",
         "grid-wrap", "grid-constant")
RNG = np.random.RandomState(0)
X2 = RNG.rand(24, 20).astype(np.float32)
X3 = RNG.rand(10, 12, 14).astype(np.float32)
B2 = RNG.rand(30, 31) > 0.4
B3 = RNG.rand(9, 10, 11) > 0.35
MASK2 = RNG.rand(30, 31) > 0.2
CROSS = sndi.generate_binary_structure(2, 1)
FP = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 1]], bool)
STRUCT_INT = np.array([[0.0, 1.0], [2.0, 0.0], [1.0, -1.0]])

GREY = ("grey_erosion", "grey_dilation", "grey_opening", "grey_closing",
        "morphological_gradient", "white_tophat", "black_tophat")
GREY_KW = {
    "size": dict(size=(3, 5)),
    "size-even-origin": dict(size=4, origin=1),
    "size-1-axis": dict(size=(1, 5), origin=(0, -2)),
    "ones-footprint": dict(footprint=np.ones((3, 3))),
    "footprint": dict(footprint=FP, origin=(0, 1)),
    "structure": dict(structure=STRUCT_INT),
}


def _same(got, exp):
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.dtype == exp.dtype and got.shape == exp.shape
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("kw", sorted(GREY_KW))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", GREY)
def test_grey_2d_matches_scipy(name, mode, kw):
    got = getattr(ndi, name)(torch.from_numpy(X2), mode=mode, cval=0.3,
                             **GREY_KW[kw])
    _same(got, getattr(sndi, name)(X2, mode=mode, cval=0.3, **GREY_KW[kw]))


@pytest.mark.parametrize("mode", ["reflect", "mirror", "wrap", "nearest",
                                  "constant"])
@pytest.mark.parametrize("name", GREY)
def test_grey_3d_matches_scipy(name, mode):
    for kw in (dict(size=(3, 1, 5)), dict(size=(2, 3, 3), origin=(-1, 0, 1)),
               dict(footprint=np.ones((3, 3, 1))), dict(size=3, axes=(0, 2)),
               dict(footprint=CROSS, axes=(2, 1))):
        got = getattr(ndi, name)(torch.from_numpy(X3), mode=mode, cval=-0.5,
                                 **kw)
        _same(got, getattr(sndi, name)(X3, mode=mode, cval=-0.5, **kw))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float64, np.bool_])
@pytest.mark.parametrize("name", GREY)
def test_grey_other_dtypes_match_scipy(name, dtype):
    x = (X2 * 200).astype(dtype) if dtype != np.bool_ else X2 > 0.5
    for kw in (dict(size=3), dict(footprint=FP)):
        if dtype == np.bool_ and name == "morphological_gradient":
            # numpy's boolean subtract
            with pytest.raises(TypeError):
                sndi.morphological_gradient(x, **kw)
            with pytest.raises(TypeError):
                ndi.morphological_gradient(torch.from_numpy(x), **kw)
            with pytest.raises(TypeError):
                ndi.morphological_laplace(torch.from_numpy(x), **kw)
            continue
        got = getattr(ndi, name)(torch.from_numpy(x), **kw)
        _same(got, getattr(sndi, name)(x, **kw))


def test_laplace_rounds_as_cupyimg_tpu():
    """``(d + e) - 2x`` in float32, as cupyimg_tpu computes it; scipy
    subtracts x twice, which can round one ulp apart (ROADMAP C).  Exact
    for float64 data."""
    for mode in MODES:
        for kw in (dict(size=(5, 3)), dict(size=4), dict(footprint=FP)):
            got = ndi.morphological_laplace(torch.from_numpy(X2), mode=mode,
                                            cval=0.3, **kw).numpy()
            d = sndi.grey_dilation(X2, mode=mode, cval=0.3, **kw)
            e = sndi.grey_erosion(X2, mode=mode, cval=0.3, **kw)
            np.testing.assert_array_equal(got, (d + e) - np.float32(2) * X2)
            exp = sndi.morphological_laplace(X2, mode=mode, cval=0.3, **kw)
            np.testing.assert_allclose(got, exp, rtol=0, atol=2.4e-7)
            x64 = X2.astype(np.float64)
            _same(ndi.morphological_laplace(torch.from_numpy(x64), mode=mode,
                                            cval=0.3, **kw),
                  sndi.morphological_laplace(x64, mode=mode, cval=0.3, **kw))
    got = ndi.morphological_laplace(torch.from_numpy(X2), size=(5, 3),
                                    mode="nearest").numpy()
    assert not np.array_equal(
        got, sndi.morphological_laplace(X2, size=(5, 3), mode="nearest"))


def test_nonflat_structure_float32_as_cupyimg_tpu():
    """Every tap of a non-flat structure is computed in float64 and the
    extremum cast once (cupyimg_tpu); scipy computes the first tap in
    double and the others in float32 (ROADMAP C).  Exact for float64
    data and for structures whose values float32 holds exactly."""
    s = np.random.RandomState(1).rand(3, 2)
    for name in ("grey_erosion", "grey_dilation", "grey_opening"):
        got = getattr(ndi, name)(torch.from_numpy(X2), structure=s).numpy()
        exp = getattr(sndi, name)(X2, structure=s)
        np.testing.assert_allclose(got, exp, rtol=0, atol=1.2e-7)
        x64 = X2.astype(np.float64)
        _same(getattr(ndi, name)(torch.from_numpy(x64), structure=s),
              getattr(sndi, name)(x64, structure=s))
    x = torch.from_numpy(X2)
    xp = np.pad(X2, [(1, 1), (1, 0)], mode="symmetric").astype(np.float64)
    exp = np.min([xp[i:i + 24, k:k + 20] - s[i, k] for i in range(3)
                  for k in range(2)], 0).astype(np.float32)
    np.testing.assert_array_equal(ndi.grey_erosion(x, structure=s).numpy(),
                                  exp)


BINARY = ("binary_erosion", "binary_dilation", "binary_opening",
          "binary_closing")
BINARY_KW = {
    "default": dict(),
    "iterations-3": dict(iterations=3),
    "iterations-0": dict(iterations=0),
    "iterations--1-mask": dict(iterations=-1, mask=MASK2),
    "mask": dict(iterations=2, mask=MASK2),
    "border-origin": dict(structure=sndi.generate_binary_structure(2, 2),
                          border_value=1, origin=(1, 0)),
    "even-structure": dict(structure=[[1, 1, 0, 1]], origin=(0, -1)),
    "axes": dict(structure=[1, 1, 1], axes=(1,), iterations=2),
}


@pytest.mark.parametrize("kw", sorted(BINARY_KW))
@pytest.mark.parametrize("name", BINARY)
def test_binary_matches_scipy(name, kw):
    got = getattr(ndi, name)(torch.from_numpy(B2), **BINARY_KW[kw])
    _same(got, getattr(sndi, name)(B2, **BINARY_KW[kw]))


@pytest.mark.parametrize("name", BINARY)
def test_binary_3d_and_output_dtype_match_scipy(name):
    s26 = sndi.generate_binary_structure(3, 3)
    for kw in (dict(), dict(structure=s26, iterations=2),
               dict(iterations=-1, border_value=1)):
        _same(getattr(ndi, name)(torch.from_numpy(B3), **kw),
              getattr(sndi, name)(B3, **kw))
    # an ``output`` dtype is honoured (cupyimg_tpu); scipy returns bool
    # whatever dtype it is given (ROADMAP C)
    got = getattr(ndi, name)(torch.from_numpy(B3), output=np.uint8)
    exp = getattr(sndi, name)(B3, output=np.uint8)
    assert got.dtype == torch.uint8 and exp.dtype == np.bool_
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.uint8))


def test_empty_structure_matches_scipy():
    for name in BINARY:
        _same(getattr(ndi, name)(torch.from_numpy(B2),
                                 structure=np.zeros((3, 3))),
              getattr(sndi, name)(B2, structure=np.zeros((3, 3))))


def test_hit_or_miss_propagation_fill_holes_match_scipy():
    b = torch.from_numpy(B2)
    _same(ndi.binary_hit_or_miss(b), sndi.binary_hit_or_miss(B2))
    s1, s2 = [[1, 0], [1, 1]], [[0, 1], [0, 0]]
    _same(ndi.binary_hit_or_miss(b, s1, s2, origin1=(0, -1), origin2=(-1, 0)),
          sndi.binary_hit_or_miss(B2, s1, s2, origin1=(0, -1),
                                  origin2=(-1, 0)))
    _same(ndi.binary_propagation(b, mask=MASK2),
          sndi.binary_propagation(B2, mask=MASK2))
    _same(ndi.binary_propagation(b, CROSS, MASK2, border_value=1),
          sndi.binary_propagation(B2, CROSS, MASK2, border_value=1))
    holes = ~B2
    _same(ndi.binary_fill_holes(torch.from_numpy(holes)),
          sndi.binary_fill_holes(holes))
    _same(ndi.binary_fill_holes(torch.from_numpy(B3),
                                sndi.generate_binary_structure(3, 2)),
          sndi.binary_fill_holes(B3, sndi.generate_binary_structure(3, 2)))
    _same(ndi.binary_fill_holes(torch.from_numpy(B3), axes=(1, 2)),
          sndi.binary_fill_holes(B3, axes=(1, 2)))


def test_structures_match_scipy():
    for rank in (1, 2, 3):
        for conn in (0, 1, 2, 3):
            np.testing.assert_array_equal(
                ndi.generate_binary_structure(rank, conn),
                sndi.generate_binary_structure(rank, conn))
    s = sndi.generate_binary_structure(2, 1)
    for it in (1, 2, 3):
        np.testing.assert_array_equal(ndi.iterate_structure(s, it),
                                      sndi.iterate_structure(s, it))
    got, org = ndi.iterate_structure(s, 3, origin=(1, -1))
    exp, eorg = sndi.iterate_structure(s, 3, origin=(1, -1))
    np.testing.assert_array_equal(got, exp)
    assert list(org) == list(eorg)


def test_fixpoint_steps_are_counted():
    before = morph._iterate_binary_op.steps
    ndi.binary_erosion(torch.from_numpy(B2), iterations=3)
    assert morph._iterate_binary_op.steps == before + 3
    before = morph._iterate_binary_op.steps
    ndi.binary_fill_holes(torch.from_numpy(~B2))
    steps = morph._iterate_binary_op.steps - before
    assert steps >= 2 and (steps - 1) % morph._FIXPOINT_CHECK == 0


@pytest.mark.parametrize("sampling", [None, 2.0, (1.5, 0.7)])
def test_edt_matches_scipy(sampling):
    e = np.random.RandomState(2).rand(20, 23) > 0.1
    d, i = ndi.distance_transform_edt(torch.from_numpy(e), sampling=sampling,
                                      return_indices=True)
    dr, ir = sndi.distance_transform_edt(e, sampling=sampling,
                                         return_indices=True)
    # float32 where scipy's is float64 (ROADMAP C)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), dr, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(i.numpy(), ir)
    d3 = ndi.distance_transform_edt(torch.from_numpy(B3), sampling=sampling
                                    if sampling != (1.5, 0.7) else
                                    (1.5, 0.7, 1.1))
    dr3 = sndi.distance_transform_edt(B3, sampling=sampling
                                      if sampling != (1.5, 0.7) else
                                      (1.5, 0.7, 1.1))
    np.testing.assert_allclose(d3.numpy(), dr3, rtol=1e-6, atol=0)


def test_edt_ties_and_no_background_match_scipy():
    # sparse features on a lattice: many outputs equidistant from two
    e = np.ones((17, 19), bool)
    e[::4, ::6] = False
    _, i = ndi.distance_transform_edt(torch.from_numpy(e),
                                      return_indices=True)
    np.testing.assert_array_equal(
        i.numpy(), sndi.distance_transform_edt(e, return_indices=True)[1])
    # no background: scipy's virtual feature at (-1, 0)
    a = np.ones((4, 5), bool)
    d, i = ndi.distance_transform_edt(torch.from_numpy(a), sampling=(2, 3),
                                      return_indices=True)
    dr, ir = sndi.distance_transform_edt(a, sampling=(2, 3),
                                         return_indices=True)
    np.testing.assert_allclose(d.numpy(), dr, rtol=1e-6)
    np.testing.assert_array_equal(i.numpy(), ir)
    np.testing.assert_array_equal(ndi.distance_transform_cdt(
        torch.from_numpy(a)).numpy(), sndi.distance_transform_cdt(a))


@pytest.mark.parametrize("metric", ["taxicab", "chessboard", "cityblock"])
def test_cdt_and_bf_match_scipy(metric):
    e = np.random.RandomState(3).rand(20, 23) > 0.15
    got = ndi.distance_transform_cdt(torch.from_numpy(e), metric)
    _same(got, sndi.distance_transform_cdt(e, metric))
    _same(ndi.distance_transform_cdt(torch.from_numpy(B3), metric),
          sndi.distance_transform_cdt(B3, metric))
    got = ndi.distance_transform_bf(torch.from_numpy(e), metric)
    np.testing.assert_array_equal(got.numpy(),
                                  sndi.distance_transform_bf(e, metric))
    # the indices are the Euclidean argmin (cupyimg_tpu), not scipy's
    # chamfer ones (ROADMAP C)
    _, i = ndi.distance_transform_cdt(torch.from_numpy(e), metric,
                                      return_indices=True)
    _, ie = sndi.distance_transform_edt(e, return_indices=True)
    np.testing.assert_array_equal(i.numpy(), ie)
    _, ic = sndi.distance_transform_cdt(e, metric, return_indices=True)
    assert not np.array_equal(i.numpy(), ic)


def test_bf_euclidean_matches_scipy():
    e = np.random.RandomState(4).rand(12, 13) > 0.1
    d = ndi.distance_transform_bf(torch.from_numpy(e), sampling=(1.0, 2.0))
    np.testing.assert_allclose(d.numpy(), sndi.distance_transform_bf(
        e, sampling=(1.0, 2.0)), rtol=1e-6)


@pytest.mark.parametrize("metric", ["euclidean", "taxicab", "chessboard"])
def test_bf_dtypes_follow_cupyimg_tpu(metric):
    """ROADMAP C: ``distance_transform_bf`` returns float32 for the
    Euclidean metric and int32 for the others, as ``cupyimg_tpu`` does;
    scipy returns float64 and uint32.  The values agree."""
    e = np.random.RandomState(5).rand(14, 15) > 0.2
    got = ndi.distance_transform_bf(torch.from_numpy(e), metric)
    ref = sndi.distance_transform_bf(e, metric)
    euclid = metric == "euclidean"
    assert got.dtype == (torch.float32 if euclid else torch.int32)
    assert ref.dtype == (np.float64 if euclid else np.uint32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_errors_match_scipy():
    x = torch.from_numpy(X2)
    with pytest.raises(ValueError, match="invalid origin"):
        ndi.grey_erosion(x, size=3, origin=2)
    with pytest.raises(ValueError, match="invalid origin"):
        ndi.binary_erosion(torch.from_numpy(B2), origin=(2, 0))
    with pytest.raises(ValueError, match="invalid origin"):
        ndi.grey_opening(x, size=5, origin=(0, 3))
    with pytest.raises(RuntimeError):
        ndi.binary_erosion(torch.from_numpy(B2), structure=np.ones((3, 3, 3)))
    with pytest.raises(RuntimeError):
        sndi.binary_erosion(B2, structure=np.ones((3, 3, 3)))
    with pytest.raises(TypeError):
        ndi.binary_dilation(torch.from_numpy(B2), iterations=1.5)
    with pytest.raises(TypeError):
        sndi.binary_dilation(B2, iterations=1.5)
    with pytest.raises(ValueError):
        ndi.grey_opening(x)
    with pytest.raises(ValueError):
        ndi.distance_transform_cdt(torch.from_numpy(B2), "euclid")
    with pytest.raises(NotImplementedError):
        ndi.distance_transform_cdt(torch.from_numpy(B2), np.ones((3, 3)))
    with pytest.raises(NotImplementedError):
        ndi.distance_transform_edt(torch.from_numpy(B2),
                                   distances=np.zeros(B2.shape))
    with pytest.raises(RuntimeError):
        ndi.distance_transform_edt(torch.from_numpy(B2),
                                   return_distances=False)
    with pytest.raises(RuntimeError):
        ndi.distance_transform_bf(torch.from_numpy(B2), "hamming")


def test_size_1_axis_origin_raises_as_cupyimg_tpu():
    """The port checks the origin of every axis, as cupyimg_tpu's
    two-call route does; scipy's separable min/max skips size-1 axes and
    raises nothing (ROADMAP C)."""
    x = torch.from_numpy(X2)
    for name in ("grey_opening", "grey_closing", "morphological_gradient",
                 "morphological_laplace", "white_tophat", "grey_erosion"):
        with pytest.raises(ValueError, match="invalid origin"):
            getattr(ndi, name)(x, size=(1, 5), origin=(3, 0))
        assert getattr(sndi, name)(X2, size=(1, 5),
                                   origin=(3, 0)).shape == X2.shape


# -- skimage.morphology --------------------------------------------------------

SELEMS = {
    "disk2": skm.disk(2),
    "diamond1": skm.diamond(1),
    "rect-4x3": skm.rectangle(4, 3),
    "square3": skm.square(3),
    "ellipse": skm.ellipse(2, 1),
    "star": skm.star(2),
}


def _shift(selem, shift):
    """skimage's even-side shift of a 2-D selem, in numpy."""
    m, n = selem.shape
    if m % 2 == 0:
        z = np.zeros((1, n), selem.dtype)
        selem = np.vstack((selem, z) if shift else (z, selem))
    m = selem.shape[0]
    if n % 2 == 0:
        z = np.zeros((m, 1), selem.dtype)
        selem = np.hstack((selem, z) if shift else (z, selem))
    return selem


@pytest.mark.parametrize("name", sorted(SELEMS))
def test_skimage_grey_matches_its_scipy_statement(name):
    selem = SELEMS[name]
    x = torch.from_numpy(X2)
    ero = sndi.grey_erosion(X2, footprint=_shift(selem, False))
    dil = sndi.grey_dilation(X2, footprint=_shift(selem, False)[::-1, ::-1])
    _same(skm.erosion(x, selem), ero)
    _same(skm.dilation(x, selem), dil)
    if all(s % 2 for s in selem.shape):
        op = sndi.grey_dilation(ero, footprint=selem[::-1, ::-1])
        cl = sndi.grey_erosion(dil, footprint=selem)
        _same(skm.opening(x, selem), op)
        _same(skm.closing(x, selem), cl)
        _same(skm.white_tophat(x, selem), X2 - op)
        _same(skm.black_tophat(x, selem), cl - X2)


def test_skimage_even_selem_opening_pads_the_image():
    selem = skm.rectangle(4, 2)
    x = torch.from_numpy(X2)
    xp = np.pad(X2, [(3, 3), (1, 1)], mode="edge")
    ero = sndi.grey_erosion(xp, footprint=_shift(selem, False))
    op = sndi.grey_dilation(ero, footprint=_shift(selem, True)[::-1, ::-1])
    _same(skm.opening(x, selem), op[3:-3, 1:-1])
    dil = sndi.grey_dilation(xp, footprint=_shift(selem, False)[::-1, ::-1])
    cl = sndi.grey_erosion(dil, footprint=_shift(selem, True))
    _same(skm.closing(x, selem), cl[3:-3, 1:-1])


def test_skimage_binary_matches_scipy():
    b = torch.from_numpy(B2)
    d = skm.disk(1)
    _same(skm.binary_erosion(b, d),
          sndi.binary_erosion(B2, d, border_value=True))
    _same(skm.binary_dilation(b, d), sndi.binary_dilation(B2, d))
    _same(skm.binary_opening(b), sndi.binary_dilation(
        sndi.binary_erosion(B2, CROSS, border_value=True), CROSS))
    _same(skm.binary_closing(b, d), sndi.binary_erosion(
        sndi.binary_dilation(B2, d), d, border_value=True))
    bb = B2.astype(bool)
    _same(skm.white_tophat(torch.from_numpy(bb), skm.square(3)),
          sndi.white_tophat(bb.astype(np.uint8), footprint=np.ones((3, 3)))
          .astype(bool))
    with pytest.raises(NotImplementedError):
        skm.erosion(b, d, out=torch.empty_like(b))


# ---------------------------------------------------------------------------
# zero-size inputs (ROADMAP C): scipy's empty results, shaped and typed as
# scipy's (the distance transforms in the port's dtypes, ROADMAP C)
# ---------------------------------------------------------------------------

_EMPTY_CALLS = {
    "uniform_filter": (3,), "uniform_filter1d": (3, 0),
    "gaussian_filter": (1,),
    "correlate": (np.ones((3, 3)),), "median_filter": (3,),
    "rank_filter": (1, 3), "percentile_filter": (30, 3),
    "minimum_filter": (3,), "maximum_filter1d": (3, 0),
    "grey_opening": (3,), "grey_closing": (3,), "grey_erosion": (3,),
    "grey_dilation": (3,), "morphological_gradient": (3,),
    "morphological_laplace": (3,), "white_tophat": (3,),
    "black_tophat": (3,), "binary_erosion": (), "binary_fill_holes": (),
    "shift": (1.5,), "zoom": (2,), "rotate": (30,),
    "affine_transform": (np.eye(2),), "spline_filter": (),
    "map_coordinates": (np.zeros((2, 0, 5)),),
    "distance_transform_edt": (), "distance_transform_bf": (),
    "distance_transform_cdt": (),
}
_PORT_DTYPES = {"distance_transform_edt": torch.float32,
                "distance_transform_bf": torch.float32}


@pytest.mark.parametrize("name", sorted(_EMPTY_CALLS))
def test_zero_size_inputs_match_scipy(name):
    """A (0, 5) input gives scipy's result: (0, 5), or (0, 10) for a zoom
    by 2, or ``cval`` over the rotated bounding box."""
    x = np.zeros((0, 5), np.float32)
    if name.startswith("distance") or name.startswith("binary"):
        x = x > 0
    args = _EMPTY_CALLS[name]
    ref = getattr(sndi, name)(x, *args)
    got = getattr(ndi, name)(torch.from_numpy(x), *args)
    assert tuple(got.shape) == ref.shape
    want = _PORT_DTYPES.get(name)
    assert got.dtype == (want or torch.from_numpy(ref).dtype)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_zero_size_interpolation_other_modes():
    """An empty input has nothing to extend: a non-empty output outside
    the constant modes raises, as scipy's prefilter pad does."""
    x = torch.zeros(0, 5)
    assert ndi.shift(x, 1, mode="nearest").shape == (0, 5)
    with pytest.raises(ValueError):
        ndi.affine_transform(x, np.eye(2), output_shape=(2, 3),
                             mode="nearest")
    got = ndi.affine_transform(x, np.eye(2), output_shape=(2, 3),
                               mode="grid-constant", cval=2.5)
    np.testing.assert_array_equal(got.numpy(), np.full((2, 3), 2.5))
    d, i = ndi.distance_transform_edt(x > 0, return_indices=True)
    assert d.shape == (0, 5) and tuple(i.shape) == (2, 0, 5)
