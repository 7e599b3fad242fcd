"""``skimage.measure`` of the torch port (all but ``label``) on CPU
tensors: ``regionprops`` (every property and alias on the suite's
``SAMPLE`` image against ``test_regionprops_suite``'s MATLAB/OpenCV
numbers and against ``cupyimg_tpu``, the 3-D sample, tables, extra
properties, errors), the moments (``test_skimage_moments_suite``'s
invariants and one jit program of ``cupyimg_tpu``'s moments), the
perimeters and the Euler number, ``profile_line``
(``test_skimage_profile_suite``'s profiles, and named calls against
``cupyimg_tpu``), the polygons, ``block_reduce`` (a numpy transcription)
and ``shannon_entropy`` (scipy).  No skimage is installed here.

Tolerances: integer results, bounding boxes, images and coordinates
exactly; float64 measurements within 1e-10 of ``cupyimg_tpu`` (relative
to the value's scale); the suites' golden numbers to their own decimals;
float32 profiles within 2e-6 of ``cupyimg_tpu``'s; float64 ones within
1e-12.
"""

import importlib
import itertools
import math
import types
import warnings
from functools import lru_cache

import numpy as np
import pytest
import scipy.ndimage
import scipy.signal
import scipy.stats
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.skimage.measure as jm
from cupyimg_tpu.skimage.measure import _regionprops as jrp
from cupyimg_tpu_torch.skimage import measure as tm
from cupyimg_tpu_torch.skimage.measure import _regionprops as trp


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def H(x):
    """A result on the host, as numpy (tuples element by element)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple):
        return tuple(H(v) for v in x)
    return np.asarray(x) if hasattr(x, "__array__") else x


def close(got, want, tol=1e-10):
    got = np.asarray(H(got), dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.nanmax(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


SAMPLE = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0],
        [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0],
        [1, 0, 1, 0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0],
        [0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1],
        [0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1],
    ]
)
INTENSITY = SAMPLE.copy()
INTENSITY[1, 9:11] = 2
SAMPLE_3D = np.zeros((6, 6, 6), dtype=np.uint8)
SAMPLE_3D[1:3, 1:3, 1:3] = 1
SAMPLE_3D[3, 2, 2] = 1
MULTIPLE = np.eye(10, dtype=np.int32)
MULTIPLE[3:5, 7:8] = 2

# test_regionprops_suite's numbers (MATLAB / OpenCV), to its decimals
GOLDEN = {
    "area": (72, 9),
    "bbox": ((0, 0, 10, 18), 9),
    "centroid": ((5.66666666666666, 9.444444444444444), 7),
    "convex_area": (125, 9),
    "eccentricity": (0.814629313427, 7),
    "equivalent_diameter": (9.57461472963, 6),
    "euler_number": (0, 9),
    "extent": (0.4, 7),
    "major_axis_length": (16.7924234999, 6),
    "max_intensity": (2, 7),
    "mean_intensity": (1.02777777777777, 6),
    "min_intensity": (1, 7),
    "minor_axis_length": (9.739302807263, 6),
    "moments_hu": ([3.27117627e-01, 2.63869194e-02, 2.35390060e-02,
                    1.23151193e-03, 1.38882330e-06, -2.72586158e-05,
                    -6.48350653e-06], 6),
    "orientation": (-1.4663278802756865, 7),
    "perimeter": (55.2487373415, 6),
    "perimeter_crofton": (61.0800637973, 6),
    "solidity": (0.576, 7),
    "weighted_centroid": ((5.540540540540, 9.445945945945), 6),
    "weighted_moments_hu": ([3.1750587329e-01, 2.1417517159e-02,
                             2.3609322038e-02, 1.2565683360e-03,
                             8.3014209421e-07, -3.5073773473e-05,
                             -6.7936409056e-06], 6),
}


def _np_moments(img, center, order=3):
    """``sum_x img[x] * prod_d (x_d - center_d)^p_d`` for every ``p`` up to
    ``order`` per axis, in numpy."""
    grids = np.indices(img.shape, dtype=np.float64)
    out = np.zeros((order + 1,) * img.ndim)
    for p in np.ndindex(out.shape):
        term = img.astype(np.float64)
        for g, c, e in zip(grids, center, p):
            term = term * (g - c) ** e
        out[p] = term.sum()
    return out


def _np_normalized(mu, order=3):
    total = np.add.outer(np.arange(mu.shape[0]), np.arange(mu.shape[1]))
    nu = mu / mu[0, 0] ** (total / 2 + 1)
    return np.where(total < 2, np.nan, nu)


def _np_inertia(mu):
    return np.array([[mu[0, 2], -mu[1, 1]], [-mu[1, 1], mu[2, 0]]]) / mu[0, 0]


def _np_feret(mask):
    m = np.pad(mask, 2)
    pts = []
    for ax in range(m.ndim):
        lo = np.take(m, range(m.shape[ax] - 1), axis=ax)
        hi = np.take(m, range(1, m.shape[ax]), axis=ax)
        e = np.argwhere(lo != hi).astype(float)
        e[:, ax] += 0.5
        pts.append(e)
    p = np.concatenate(pts)
    return np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1).max())


CONVEX = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0],
        [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0],
        [0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0],
        [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    ], bool)


@lru_cache(maxsize=None)
def _sample_references():
    """Every property of SAMPLE (with INTENSITY) from the suite's numbers
    and numpy/scipy definitions: no port code, no cupyimg_tpu."""
    rows, cols = np.nonzero(SAMPLE)
    c = (rows.mean(), cols.mean())
    m = _np_moments(SAMPLE, (0, 0))
    mu = _np_moments(SAMPLE, c)
    inertia = _np_inertia(mu)
    eig = np.sort(np.clip(np.linalg.eigvalsh(inertia), 0, None))[::-1]
    w = (INTENSITY * SAMPLE).astype(np.float64)
    wm = _np_moments(w, (0, 0))
    wc = (wm[1, 0] / wm[0, 0], wm[0, 1] / wm[0, 0])
    wmu = _np_moments(w, wc)
    ref = {name: value for name, (value, _) in GOLDEN.items()}
    ref.update({
        "bbox_area": SAMPLE.size, "convex_image": CONVEX,
        "coords": np.argwhere(SAMPLE), "feret_diameter_max":
        _np_feret(CONVEX), "filled_area": int(SAMPLE.sum()),
        "filled_image": scipy.ndimage.binary_fill_holes(
            SAMPLE, np.ones((3, 3))),
        "image": SAMPLE.astype(bool), "inertia_tensor": inertia,
        "inertia_tensor_eigvals": eig, "intensity_image": INTENSITY * SAMPLE,
        "label": 1, "local_centroid": c, "moments": m,
        "moments_central": mu, "moments_normalized": _np_normalized(mu),
        "weighted_local_centroid": wc, "weighted_moments": wm,
        "weighted_moments_central": wmu,
        "weighted_moments_normalized": _np_normalized(wmu),
    })
    return ref


@pytest.mark.parametrize("prop", sorted(trp.PROP_VALS))
def test_every_property_on_sample(prop):
    """Each property against its numpy/scipy definition or the suite's
    MATLAB/OpenCV number (to the suite's decimals)."""
    port = tm.regionprops(T(SAMPLE), T(INTENSITY))[0]
    got = port[prop]
    if prop == "slice":
        assert got == (slice(0, 10), slice(0, 18))
        return
    want = _sample_references()[prop]
    if prop in trp.OBJECT_COLUMNS or prop in trp._INT_COLUMNS:
        np.testing.assert_array_equal(np.asarray(H(got)), np.asarray(want))
        if prop in trp.OBJECT_COLUMNS:
            assert got.dtype == {"intensity_image": torch.int64,
                                 "coords": torch.int64}.get(prop, torch.bool)
    elif prop in GOLDEN:
        np.testing.assert_almost_equal(np.asarray(H(got), np.float64),
                                       np.asarray(want, np.float64),
                                       decimal=GOLDEN[prop][1])
    else:
        close(got, want)


def test_named_properties_match_cupyimg_tpu():
    """cupyimg_tpu's regionprops (eager: it reads values on the host) on
    SAMPLE for a short list of properties (the moments are held against
    cupyimg_tpu in one jit program below), exactly."""
    port = tm.regionprops(T(SAMPLE), T(INTENSITY))[0]
    ref = jm.regionprops(jnp.asarray(SAMPLE), jnp.asarray(INTENSITY))[0]
    for prop in ("area", "coords", "max_intensity", "bbox"):
        want = ref[prop]
        want = np.asarray(want) if not isinstance(want, tuple) else tuple(
            np.asarray(v) for v in want)
        close(port[prop], want)


def test_suite_tables_on_sample():
    """test_regionprops_suite's moment tables (OpenCV), the convex image
    and the weighted tables."""
    port = tm.regionprops(T(SAMPLE), T(INTENSITY))[0]
    mu = H(port.moments_central)
    for idx, val, dec in [((2, 0), 436.00000000000045, 7),
                          ((3, 0), -737.333333333333, 5),
                          ((1, 1), -87.33333333333303, 5),
                          ((2, 1), -127.5555555555593, 5),
                          ((0, 2), 1259.7777777777774, 5),
                          ((1, 2), 2000.296296296291, 4),
                          ((0, 3), -760.0246913580195, 4)]:
        np.testing.assert_almost_equal(mu[idx], val, decimal=dec)
    m = H(port.moments)
    for idx, val in [((0, 0), 72.0), ((0, 1), 680.0), ((0, 2), 7682.0),
                     ((0, 3), 95588.0), ((1, 0), 408.0), ((1, 1), 3766.0),
                     ((1, 2), 43882.0), ((2, 0), 2748.0),
                     ((2, 1), 24836.0), ((3, 0), 19776.0)]:
        np.testing.assert_almost_equal(m[idx], val, decimal=3)
    nu = H(port.moments_normalized)
    for idx, val in [((0, 2), 0.24301268861454037),
                     ((0, 3), -0.017278118992041805),
                     ((1, 1), -0.016846707818929982),
                     ((1, 2), 0.045473992910668816),
                     ((2, 0), 0.08410493827160502),
                     ((2, 1), -0.002899800614433943)]:
        np.testing.assert_almost_equal(nu[idx], val)
    wm = np.array([[7.4e01, 6.99e02, 7.863e03, 9.7317e04],
                   [4.1e02, 3.785e03, 4.4063e04, 5.72567e05],
                   [2.75e03, 2.4855e04, 2.93477e05, 3.900717e06],
                   [1.9778e04, 1.75001e05, 2.081051e06, 2.8078871e07]])
    np.testing.assert_array_almost_equal(H(port.weighted_moments), wm, 1)
    wnu = np.array(
        [[np.nan, np.nan, 0.2301467830, -0.0162529732],
         [np.nan, -0.0160405109, 0.0457932622, -0.0104598869],
         [0.0873590903, -0.0031421072, 0.0165315478, -0.0028544152],
         [-0.0161217406, -0.0031376984, 0.0043903193, -0.0011057191]])
    np.testing.assert_array_almost_equal(
        H(port.weighted_moments_normalized), wnu)
    assert int(port.convex_image.sum()) == 125
    np.testing.assert_array_equal(H(port.filled_image), SAMPLE)


def test_aliases_and_iteration():
    port = tm.regionprops(T(SAMPLE), T(INTENSITY))[0]
    for alias, name in trp.PROPS.items():
        if name == "slice":
            continue
        np.testing.assert_array_equal(np.asarray(H(port[alias]), float),
                                      np.asarray(H(port[name]), float))
    no_int = tm.regionprops(T(SAMPLE))[0]
    assert len(list(no_int)) < len(list(port))
    assert set(s for s in dir(port) if not s.startswith("_")) == set(
        trp.PROPS.values())
    assert trp.PROPS == jrp.PROPS and trp.COL_DTYPES == jrp.COL_DTYPES
    assert set(trp.COL_DTYPES).union(trp.OBJECT_COLUMNS) == set(
        trp.PROPS.values())


def _sample_3d_references():
    img = SAMPLE_3D[1:4, 1:3, 1:3]
    pts = np.argwhere(img)
    c = pts.mean(0)
    mu = _np_moments(img, c, 3)
    mu0 = mu[0, 0, 0]
    sec = np.array([mu[2, 0, 0], mu[0, 2, 0], mu[0, 0, 2]])
    inertia = np.diag((sec.sum() - sec) / mu0)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        idx = [0, 0, 0]
        idx[i] = idx[j] = 1
        inertia[i, j] = inertia[j, i] = -mu[tuple(idx)] / mu0
    area = int(img.sum())
    return {
        "area": area, "bbox": (1, 1, 1, 4, 3, 3), "bbox_area": img.size,
        "centroid": tuple(c + 1), "coords": pts + 1,
        "equivalent_diameter": (6 * area / np.pi) ** (1 / 3),
        "euler_number": 1, "extent": area / img.size,
        "filled_image": scipy.ndimage.binary_fill_holes(img,
                                                        np.ones((3,) * 3)),
        "image": img.astype(bool), "inertia_tensor": inertia,
        "inertia_tensor_eigvals": np.sort(np.linalg.eigvalsh(inertia))[::-1],
        "local_centroid": tuple(c), "moments": _np_moments(img, (0, 0, 0)),
        "moments_central": mu, "weighted_moments": _np_moments(img,
                                                               (0, 0, 0)),
        "weighted_moments_central": mu, "weighted_centroid": tuple(c + 1),
        "max_intensity": 1, "mean_intensity": 1.0, "min_intensity": 1,
    }


@pytest.mark.parametrize("prop", sorted(_sample_3d_references()))
def test_3d_properties_match_numpy(prop):
    r = tm.regionprops(T(SAMPLE_3D), T(SAMPLE_3D))[0]
    close(np.asarray(H(r[prop]), np.float64),
          np.asarray(_sample_3d_references()[prop], np.float64), 1e-12)


def test_3d_golden_and_2d_only():
    r = tm.regionprops(T(SAMPLE_3D))[0]
    assert r.area == SAMPLE_3D.sum()
    assert r.bbox == (1, 1, 1, 4, 3, 3)
    np.testing.assert_almost_equal(r.centroid,
                                   (1.66666667, 1.55555556, 1.55555556))
    np.testing.assert_array_equal(H(r.image), SAMPLE_3D[1:4, 1:3, 1:3])
    for prop in ("eccentricity", "moments_hu", "orientation", "perimeter"):
        with pytest.raises(NotImplementedError):
            getattr(r, prop)


def test_region_cases_of_the_suite():
    sample = np.zeros((10, 10), dtype=np.int8)
    coords = np.array([[3, 2], [3, 3], [3, 4]])
    sample[coords[:, 0], coords[:, 1]] = 1
    np.testing.assert_array_equal(H(tm.regionprops(T(sample))[0].coords),
                                  coords)
    padded = np.pad(SAMPLE, ((2, 4), (5, 2)))
    r = tm.regionprops(T(padded))[0]
    assert r.slice == (slice(2, 12), slice(5, 23))
    assert r.bbox_area == SAMPLE.size
    mod = SAMPLE.copy()
    mod[7, -3] = 0
    r = tm.regionprops(T(mod))[0]
    assert r.euler_number == -1 and r.filled_area == SAMPLE.sum()
    dot = np.zeros((5, 5), dtype=int)
    dot[2, 2] = 1
    assert tm.regionprops(T(dot))[0].eccentricity == 0
    diag = np.eye(10, dtype=int)
    for img, sign in ((diag, -1), (np.flipud(diag), 1), (np.fliplr(diag), 1),
                      (np.fliplr(np.flipud(diag)), -1)):
        np.testing.assert_almost_equal(
            tm.regionprops(T(img))[0].orientation, sign * math.pi / 4)
    ps = tm.regionprops(torch.full((2, 2), 2, dtype=torch.int32))
    assert len(ps) == 1 and ps[0].label == 2
    assert tm.regionprops(torch.zeros((2, 2), dtype=torch.int32)) == []
    arr = np.zeros((100, 100), dtype=int)
    arr[0:25, 0:25] = 1
    arr[50:99, 50:99] = 2
    r1, r3 = tm.regionprops(T(arr))
    r2 = tm.regionprops(T(arr))[0]
    assert (r1 == r2) is True and (r1 != r3) is True


def test_errors_as_cupyimg_tpu():
    for dt in (torch.float32, torch.float64, torch.bool):
        with pytest.raises(TypeError):
            tm.regionprops(torch.zeros((10, 10), dtype=dt))
    with pytest.raises(TypeError):
        tm.regionprops(torch.zeros((10, 10, 10, 2), dtype=torch.int32))
    for shape in ((10, 10), (10, 10, 1), (1, 1, 1)):
        tm.regionprops(torch.zeros(shape, dtype=torch.int32))
    tm.regionprops(torch.zeros((10, 10), dtype=torch.uint32))
    r = tm.regionprops(T(SAMPLE))[0]
    with pytest.raises(AttributeError):
        r.intensity_image
    with pytest.raises(ValueError):
        tm.regionprops(T(SAMPLE), T(np.ones((2, 1))))
    with pytest.warns(FutureWarning, match="coordinates keyword argument"):
        tm.regionprops(T(SAMPLE), coordinates="rc")
    with pytest.raises(ValueError):
        tm.regionprops(T(SAMPLE), coordinates="xy")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.int16,
                                   np.float32])
def test_intensity_properties_of_every_dtype(dtype):
    """max/min/mean intensity of each intensity dtype against numpy (the
    extrema of uint16/32 are taken in a wider signed type and keep the
    dtype)."""
    rng = np.random.default_rng(13)
    labels = np.kron(rng.integers(0, 3, (4, 5)), np.ones((3, 3), int))
    inten = (rng.random(labels.shape) * 200).astype(dtype)
    for r in tm.regionprops(T(labels), T(inten)):
        vals = inten[labels == r.label]
        assert r.max_intensity.dtype == T(inten).dtype
        assert H(r.max_intensity) == vals.max()
        assert H(r.min_intensity) == vals.min()
        np.testing.assert_allclose(float(r.mean_intensity),
                                   vals.astype(np.float64).mean(),
                                   rtol=1e-6)


def pixelcount(regionmask):
    return torch.sum(regionmask)


def median_intensity(regionmask, intensity_image):
    return torch.quantile(intensity_image[regionmask].double(), 0.5)


def too_many_args(regionmask, intensity_image, superfluous):
    return 1


def too_few_args():
    return 1


def test_tables_and_extra_properties():
    out = tm.regionprops_table(T(SAMPLE))
    assert {k: v.tolist() for k, v in out.items()} == {
        "label": [1], "bbox-0": [0], "bbox-1": [0], "bbox-2": [10],
        "bbox-3": [18]}
    out = trp._props_to_dict(tm.regionprops(T(SAMPLE)),
                             properties=("label", "area", "bbox"),
                             separator="+")
    assert set(out) == {"label", "area", "bbox+0", "bbox+1", "bbox+2",
                        "bbox+3"}
    assert out["area"].tolist() == [72]
    empty = tm.regionprops_table(torch.zeros((2, 2), dtype=torch.int32),
                                 properties=("label", "area", "bbox"),
                                 separator="+")
    assert len(empty) == 6 and all(len(v) == 0 for v in empty.values())
    r = tm.regionprops(T(SAMPLE), T(INTENSITY),
                       extra_properties=(median_intensity, pixelcount))[0]
    assert float(r.median_intensity) == float(
        np.median(INTENSITY[SAMPLE == 1]))
    assert int(r.pixelcount) == int(SAMPLE.sum())
    with pytest.raises(AttributeError):
        tm.regionprops(T(SAMPLE),
                       extra_properties=(median_intensity,))[0].median_intensity
    for fn in (too_few_args, too_many_args):
        with pytest.raises(AttributeError):
            getattr(tm.regionprops(T(SAMPLE), extra_properties=(fn,))[0],
                    fn.__name__)
    out = tm.regionprops_table(
        T(MULTIPLE), T(MULTIPLE * 2.0), properties=("label",),
        extra_properties=(median_intensity, pixelcount))
    np.testing.assert_array_almost_equal(out["median_intensity"], [2.0, 4.0])
    np.testing.assert_array_equal(out["pixelcount"], [10, 2])


def test_table_of_several_regions():
    """Several labels with an intensity image: each column's dtype from
    COL_DTYPES, area, bbox, centroid and mean intensity against numpy,
    the rest equal to the regions' own properties."""
    rng = np.random.default_rng(5)
    labels = np.kron(rng.integers(0, 4, (6, 7)), np.ones((5, 4), int))
    intensity = rng.random(labels.shape)
    props = ("label", "bbox", "area", "centroid", "eccentricity",
             "mean_intensity", "perimeter", "solidity", "moments_hu",
             "euler_number", "feret_diameter_max", "weighted_centroid")
    got = tm.regionprops_table(T(labels), T(intensity), properties=props)
    regions = tm.regionprops(T(labels), T(intensity))
    present = [k for k in range(1, 4) if (labels == k).any()]
    np.testing.assert_array_equal(got["label"], present)
    for i, k in enumerate(present):
        rr, cc = np.nonzero(labels == k)
        assert (got["bbox-0"][i], got["bbox-1"][i], got["bbox-2"][i],
                got["bbox-3"][i]) == (rr.min(), cc.min(), rr.max() + 1,
                                      cc.max() + 1)
        assert got["area"][i] == rr.size
        close([got["centroid-0"][i], got["centroid-1"][i]],
              [rr.mean(), cc.mean()], 1e-12)
        close(got["mean_intensity"][i], intensity[labels == k].mean(),
              1e-12)
        for prop in ("eccentricity", "perimeter", "solidity",
                     "euler_number", "feret_diameter_max"):
            assert got[prop][i] == H(regions[i][prop])
        np.testing.assert_array_equal(
            [got[f"moments_hu-{j}"][i] for j in range(7)],
            H(regions[i].moments_hu))
    for name, column in got.items():
        base = name.split("-")[0]
        assert column.dtype == np.dtype(trp.COL_DTYPES[base]), name


def test_multichannel_stacks_the_channels():
    rng = np.random.default_rng(42)
    labels = np.kron(np.arange(1, 17).reshape(4, 4), np.ones((16, 16), int))
    intensity = rng.uniform(size=labels.shape + (3,))
    region = tm.regionprops(T(labels), T(intensity[..., 1]))[8]
    multi = tm.regionprops(T(labels), T(intensity))[8]
    for prop in trp.PROPS:
        p, pm = H(region[prop]), H(multi[prop])
        if isinstance(p, tuple):
            p = np.stack([np.asarray(v) for v in p])
        if isinstance(pm, tuple):
            pm = np.stack([np.asarray(v) for v in pm])
        p, pm = np.asarray(p), np.asarray(pm)
        if p.shape == pm.shape:
            np.testing.assert_array_equal(p, pm)
        else:
            np.testing.assert_array_almost_equal(p, pm[..., 1])


# ---------------------------------------------------------------------------
# euler_number, perimeter, perimeter_crofton
# ---------------------------------------------------------------------------


def test_perimeters_and_euler_numbers():
    np.testing.assert_almost_equal(
        float(tm.perimeter(T(SAMPLE.astype(np.float64)), neighbourhood=8)),
        46.8284271247, decimal=6)
    np.testing.assert_almost_equal(
        float(tm.perimeter_crofton(T(SAMPLE.astype(np.float64)),
                                   directions=2)),
        64.4026493985, decimal=6)
    mod = SAMPLE.copy()
    mod[7, -3] = 0
    assert tm.euler_number(T(SAMPLE), 1) == 2
    assert tm.euler_number(T(mod), 1) == 1
    assert tm.euler_number(T(SAMPLE_3D), 1) == 1
    assert tm.euler_number(T(SAMPLE_3D), 3) == 1
    cube = np.zeros((30, 30, 30))
    cube[10:20, 10:20, 10:20] = 1
    assert tm.euler_number(T(cube), 3) == 1
    cube[13:17, 13:17, 13:17] = 0
    assert tm.euler_number(T(cube), 3) == 2
    with pytest.raises(NotImplementedError):
        tm.euler_number(T(SAMPLE_3D), 2)
    with pytest.raises(NotImplementedError):
        tm.perimeter(T(SAMPLE_3D))
    with pytest.raises(NotImplementedError):
        tm.perimeter_crofton(T(SAMPLE_3D))


def _np_euler_closed(img):
    """The Euler characteristic of the union of closed unit pixels
    (voxels): cells of every dimension counted, ``V - E + F (- C)``; the
    Euler number under 8- (26-) connectivity."""
    P = np.pad(img.astype(bool), 1)
    chi = 0
    for S in itertools.product((0, 1), repeat=img.ndim):
        arr = P
        for ax, vertex_like in enumerate(S):
            n = arr.shape[ax]
            lo = np.take(arr, range(0, n - 1), axis=ax)
            hi = np.take(arr, range(1, n), axis=ax)
            arr = (lo | hi) if vertex_like else np.take(arr, range(1, n - 1),
                                                        axis=ax)
        chi += (-1) ** (img.ndim - sum(S)) * int(arr.sum())
    return chi


def _np_euler_4(img):
    """Objects under 4-connectivity minus holes (8-connected background
    components other than the outer one)."""
    fg = scipy.ndimage.label(img)[1]
    bg = scipy.ndimage.label(~np.pad(img.astype(bool), 1),
                             np.ones((3, 3)))[1]
    return fg - (bg - 1)


def _np_perimeter(img, neighbourhood):
    """skimage's perimeter on scipy.ndimage and numpy."""
    strel = (np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
             if neighbourhood == 4 else np.ones((3, 3)))
    img = img.astype(np.uint8)
    border = img - scipy.ndimage.binary_erosion(img, strel, border_value=0)
    codes = scipy.ndimage.convolve(border.astype(np.int32),
                                   [[10, 2, 10], [2, 1, 2], [10, 2, 10]],
                                   mode="constant", cval=0)
    w = np.zeros(50)
    w[[5, 7, 15, 17, 25, 27]] = 1
    w[[21, 33]] = math.sqrt(2)
    w[[13, 23]] = (1 + math.sqrt(2)) / 2
    return np.bincount(codes.ravel(), minlength=50) @ w


def _np_crofton(img, directions):
    """skimage's perimeter_crofton on scipy.ndimage and numpy."""
    img = np.pad((img > 0).astype(np.int32), 1)
    codes = scipy.ndimage.convolve(img, [[0, 0, 0], [0, 1, 4], [0, 2, 8]],
                                   mode="constant", cval=0)
    h = np.bincount(codes.ravel(), minlength=16)
    pi, sq2 = np.pi, math.sqrt(2)
    if directions == 2:
        coefs = [0, pi / 2, 0, 0, 0, pi / 2, 0, 0, pi / 2, pi, 0, 0,
                 pi / 2, pi, 0, 0]
    else:
        coefs = [0, pi / 4 * (1 + 1 / sq2), pi / (4 * sq2),
                 pi / (2 * sq2), 0, pi / 4 * (1 + 1 / sq2), 0,
                 pi / (4 * sq2), pi / 4, pi / 2, pi / (4 * sq2),
                 pi / (4 * sq2), pi / 4, pi / 2, 0, 0]
    return np.dot(coefs, h)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.int64,
                                   np.float32])
def test_codes_of_every_dtype(dtype):
    """The Euler numbers and perimeters of a non-binary image of each
    dtype: those of its non-zero set (uint16/32 compare in a wider
    type)."""
    rng = np.random.default_rng(14)
    img = (rng.random((15, 19)) * 3).astype(dtype)
    nz = img > 0
    assert tm.euler_number(T(img)) == tm.euler_number(T(nz))
    assert tm.euler_number(T(img), 1) == tm.euler_number(T(nz), 1)
    close(tm.perimeter_crofton(T(img)), H(tm.perimeter_crofton(T(nz))), 0)
    close(tm.perimeter(T(nz.astype(dtype))), H(tm.perimeter(T(nz))), 0)


@pytest.mark.parametrize("seed", range(4))
def test_codes_match_independent_counts(seed):
    """Euler numbers against cell counting (8- and 26-connectivity) and
    scipy's labels (4-connectivity); the perimeters against skimage's
    algorithm on scipy."""
    rng = np.random.default_rng(seed)
    img = rng.random((23, 31)) > 0.3 + 0.1 * seed
    assert tm.euler_number(T(img), 2) == _np_euler_closed(img)
    assert tm.euler_number(T(img), 1) == _np_euler_4(img)
    vol = rng.random((9, 11, 10)) > 0.4 + 0.1 * seed
    assert tm.euler_number(T(vol), 3) == _np_euler_closed(vol)
    for nb in (4, 8):
        close(tm.perimeter(T(img), nb), _np_perimeter(img, nb), 1e-13)
    for d in (2, 4):
        got = tm.perimeter_crofton(T(img), d)
        assert got.dtype == torch.float64
        close(got, _np_crofton(img, d), 1e-13)


# ---------------------------------------------------------------------------
# moments
# ---------------------------------------------------------------------------


def _ellipsoid(a, b, c):
    za, zb, zc = int(np.ceil(a)), int(np.ceil(b)), int(np.ceil(c))
    z, y, x = np.mgrid[-za - 1:za + 2, -zb - 1:zb + 2, -zc - 1:zc + 2]
    return (z / a) ** 2 + (y / b) ** 2 + (x / c) ** 2 <= 1.0


def test_moments_suite():
    image = np.zeros((20, 20))
    image[14, 14] = image[15, 15] = 1
    image[14, 15] = image[15, 14] = 0.5
    m = H(tm.moments(T(image)))
    assert m[0, 0] == 3
    np.testing.assert_almost_equal(m[1, 0] / m[0, 0], 14.5)
    np.testing.assert_almost_equal(m[0, 1] / m[0, 0], 14.5)
    mu = H(tm.moments_central(T(image), (14.5, 14.5)))
    np.testing.assert_array_equal(mu, H(tm.moments_central(T(image))))
    image2 = np.roll(image, (2, 2), axis=(0, 1))
    np.testing.assert_array_equal(
        mu, H(tm.moments_central(T(image2), (16.5, 16.5))))
    sq = np.zeros((20, 20))
    sq[13:17, 13:17] = 1
    coords = T(np.array([[r, c] for r in range(13, 17)
                         for c in range(13, 17)], np.float64))
    np.testing.assert_array_almost_equal(H(tm.moments_coords(coords)),
                                         H(tm.moments(T(sq))))
    np.testing.assert_array_almost_equal(
        H(tm.moments_coords_central(coords, (14.5, 14.5))),
        H(tm.moments_central(T(sq), (14.5, 14.5))))
    np.testing.assert_array_almost_equal(
        H(tm.moments_coords_central(coords)),
        H(tm.moments_coords_central(coords, (14.5, 14.5))))
    ell = _ellipsoid(1, 1, 10)
    mu3 = tm.moments_central(T(ell))
    nu3 = H(tm.moments_normalized(mu3))
    assert nu3[0, 0, 2] > nu3[0, 2, 0]
    np.testing.assert_almost_equal(nu3[0, 2, 0], nu3[2, 0, 0])
    pts = tuple(T(c) for c in np.nonzero(ell))
    np.testing.assert_array_almost_equal(H(tm.moments_coords_central(pts)),
                                         H(mu3))
    for order in (3, 4):
        with pytest.raises(ValueError):
            tm.moments_normalized(torch.zeros((3, 3)), order)
    with pytest.raises(ValueError):
        tm.moments_hu(torch.zeros((4, 4, 4)))
    img = np.zeros((20, 20))
    img[14, 14:16] = 1
    img[15, 14:16] = 1 / 3
    np.testing.assert_allclose(H(tm.centroid(T(img))), (14.25, 14.5))
    rect = np.zeros((40, 40))
    rect[15:25, 5:35] = 1
    Tt = tm.inertia_tensor(T(rect))
    assert Tt[0, 0] > Tt[1, 1]
    np.testing.assert_allclose(float(Tt[0, 1]), 0)
    v0, v1 = tm.inertia_tensor_eigvals(T(rect), T=Tt).tolist()
    np.testing.assert_allclose(np.sqrt(v0 / v1), 3, rtol=0.01, atol=0.05)
    T3 = H(tm.inertia_tensor(T(_ellipsoid(10, 5, 3))))
    eig, V = np.linalg.eig(T3)
    v = V[:, np.argmin(eig)]
    assert np.allclose(abs(v), [1, 0, 0])
    sparse = np.zeros((3, 15), int)
    sparse[0, 0] = sparse[1, 7] = sparse[2, 14] = 1
    ev = tm.inertia_tensor_eigvals(T(sparse))
    assert float(ev.min()) >= 0 and ev[0] >= ev[1]


def test_named_calls_match_cupyimg_tpu():
    """One jit program of cupyimg_tpu's traceable measure calls against
    the port's: the moments (2-D and 3-D, raw, central with a given and
    a computed centre, normalized, Hu, centroid, point clouds), both
    perimeters, block_reduce and profile_line (float32, order 3, five
    wide: the chip path's call).  float64 within 1e-12 of max|ref|, the
    float32 profile within 2e-6."""
    rng = np.random.default_rng(3)
    im2 = rng.random((13, 17))
    im3 = rng.random((6, 7, 8))
    pts = rng.random((40, 3)) * 10
    mask = rng.random((19, 23)) > 0.4
    f32 = rng.random((40, 44)).astype(np.float32)

    @jax.jit
    def ref(a, b, p, m, f):
        mu = jm.moments_central(a, order=3)
        nu = jm.moments_normalized(mu, 3)
        return (jm.moments(a, 3), mu, jm.moments_central(a, (6.2, 7.1), 4),
                nu, jm.moments_hu(nu), jm.centroid(a),
                jm.moments_central(b, order=2), jm.centroid(b),
                jm.moments_coords(p, 2), jm.moments_coords_central(p),
                jm.perimeter(m, 4), jm.perimeter(m, 8),
                jm.perimeter_crofton(m, 2), jm.perimeter_crofton(m, 4),
                jm.block_reduce(a, (4, 5), func=jnp.mean, cval=1.5),
                jm.profile_line(f, (3.5, 2), (35.25, 41), linewidth=5,
                                order=3, mode="reflect"))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = ref(jnp.asarray(im2), jnp.asarray(im3), jnp.asarray(pts),
                   jnp.asarray(mask), jnp.asarray(f32))
    mu = tm.moments_central(T(im2), order=3)
    nu = tm.moments_normalized(mu, 3)
    got = (tm.moments(T(im2), 3), mu,
           tm.moments_central(T(im2), (6.2, 7.1), 4), nu, tm.moments_hu(nu),
           tm.centroid(T(im2)), tm.moments_central(T(im3), order=2),
           tm.centroid(T(im3)), tm.moments_coords(T(pts), 2),
           tm.moments_coords_central(T(pts)), tm.perimeter(T(mask), 4),
           tm.perimeter(T(mask), 8), tm.perimeter_crofton(T(mask), 2),
           tm.perimeter_crofton(T(mask), 4),
           tm.block_reduce(T(im2), (4, 5), func=torch.mean, cval=1.5),
           tm.profile_line(T(f32), (3.5, 2), (35.25, 41), linewidth=5,
                           order=3, mode="reflect"))
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == torch.float64
        close(g, np.asarray(w), 1e-12)
    assert got[-1].dtype == torch.float32
    close(got[-1], np.asarray(want[-1]), 2e-6)
    close(tm.inertia_tensor(T(im2)), np.asarray(jm.inertia_tensor(
        jnp.asarray(im2))), 1e-12)


# ---------------------------------------------------------------------------
# profile_line
# ---------------------------------------------------------------------------

RAMP = np.arange(100).reshape((10, 10)).astype(np.float64)


def _pyth_image():
    img = np.zeros((6, 7), np.float64)
    img[(1, 2, 2, 3, 3, 4), (1, 2, 3, 3, 4, 5)] = 1.8
    img[(2, 2, 3, 4, 4, 5), (0, 1, 2, 3, 4, 4)] = 0.6
    img[(0, 1, 1, 2, 3, 3), (2, 2, 3, 4, 5, 6)] = 0.6
    return img


PYTH = _pyth_image()

# (src, dst, order, expected) of test_skimage_profile_suite on RAMP
RAMP_CASES = [
    ((0, 2), (0, 8), 0, np.arange(2, 9)),
    ((0, 8), (0, 2), 0, np.arange(8, 1, -1)),
    ((2, 5), (8, 5), 0, np.arange(25, 95, 10)),
    ((8, 5), (2, 5), 0, np.arange(85, 15, -10)),
    ((2, 2), (8, 8), 0, np.array([22, 33, 33, 44, 55, 55, 66, 77, 77, 88])),
    ((2, 2), (8, 8), 1, np.linspace(22, 88, 10)),
    ((8, 2), (2, 8), 1, np.arange(82, 27, -6)),
    ((8, 8), (2, 2), 1, np.arange(88, 21, -22.0 / 3)),
    ((2, 8), (8, 2), 1, np.arange(28, 83, 6)),
    ((1, 1), (7, 9), 0, np.array([11, 22, 23, 33, 34, 45, 56, 57, 67, 68,
                                  79])),
    ((1, 1), (7, 9), 1, np.linspace(11, 79, 11)),
]


@pytest.mark.parametrize("src, dst, order, expected", RAMP_CASES)
def test_profile_suite_lines(src, dst, order, expected):
    prof = tm.profile_line(T(RAMP), src, dst, order=order, mode="constant")
    np.testing.assert_array_almost_equal(H(prof), expected)


def test_profile_suite_linewidth_and_reduce():
    for img, src, dst in ((PYTH, (1, 1), (4, 5)),
                          (PYTH[::-1, :], (4, 1), (1, 5)),
                          (PYTH.T[:, ::-1], (1, 4), (5, 1))):
        prof = tm.profile_line(T(img), src, dst, linewidth=3, order=0,
                               mode="constant")
        np.testing.assert_array_almost_equal(H(prof), np.ones(6))
    for fn, ref in ((torch.mean, np.mean), (torch.amax, np.max),
                    (torch.sum, np.sum)):
        prof = tm.profile_line(T(PYTH), (0, 1), (3, 1), linewidth=3,
                               order=0, reduce_func=fn, mode="reflect")
        np.testing.assert_array_almost_equal(H(prof), ref(PYTH[:4, :3], 1))
    prof = tm.profile_line(T(PYTH), (0, 1), (3, 1), order=0, mode="constant")
    np.testing.assert_array_almost_equal(H(prof), PYTH[:4, 1])
    prof = tm.profile_line(T(PYTH), (1, 2), (4, 2), order=0,
                           reduce_func=None, mode="constant")
    np.testing.assert_array_almost_equal(H(prof), PYTH[1:5, 2, None])
    prof = tm.profile_line(T(PYTH), (1, 2), (4, 2), linewidth=3, order=0,
                           reduce_func=None, mode="constant")
    np.testing.assert_array_almost_equal(H(prof), PYTH[1:5, 1:4])
    rows = PYTH[1:5, 1:4]
    for fn, ref in ((lambda x: x + x ** 2, rows + rows ** 2),
                    (lambda x: x ** 0.5, rows ** 0.5),
                    (lambda x: (x ** 0.5).sum(), (rows ** 0.5).sum(1))):
        prof = tm.profile_line(T(PYTH), (1, 2), (4, 2), linewidth=3,
                               order=0, reduce_func=fn, mode="constant")
        np.testing.assert_array_almost_equal(H(prof), ref)
    with pytest.warns(FutureWarning, match="out of bounds"):
        tm.profile_line(T(RAMP), (0, 2), (0, 8), order=0)
    u8 = tm.profile_line(T(RAMP.astype(np.uint8)), (1, 1), (1, 6),
                         linewidth=3, order=0, mode="nearest")
    assert u8.dtype == torch.float64
    with pytest.raises(ValueError):
        tm.profile_line(T(RAMP), (0, 2), (0, 8), order=6, mode="constant")


# (name, image dtype, channels, src, dst, linewidth, order, mode)
PROFILE_CASES = [
    ("f32 order 1 w5", np.float32, 0, (3.5, 2), (40.25, 51), 5, 1,
     "reflect"),
    ("f32 order 3 w5", np.float32, 0, (60, 4), (2, 55.5), 5, 3, "constant"),
    ("f64 order 3 w1", np.float64, 0, (0, 0), (63, 63), 1, 3, "mirror"),
    ("f64 order 5 w4", np.float64, 0, (10, 60), (50, 1), 4, 5, "nearest"),
    ("f32 rgb order 2", np.float32, 3, (5, 5), (30, 61), 3, 2, "wrap"),
]


def _np_profile(img, src, dst, linewidth, order, mode):
    """skimage's profile_line on numpy and scipy.ndimage.map_coordinates
    (float64 coordinates), mean across the width."""
    d = np.subtract(dst, src, dtype=float)
    theta = np.arctan2(d[0], d[1])
    n = int(np.ceil(np.hypot(*d) + 1))
    rows = np.linspace(src[0], dst[0], n)
    cols = np.linspace(src[1], dst[1], n)
    frac = np.linspace(-1, 1, linewidth) if linewidth > 1 else np.zeros(1)
    rw = (linewidth - 1) * np.cos(theta) / 2
    cw = (linewidth - 1) * np.sin(-theta) / 2
    coords = np.stack([rows[:, None] + frac * rw, cols[:, None] + frac * cw])
    planes = [img] if img.ndim == 2 else [img[..., c] for c in
                                           range(img.shape[2])]
    out = [scipy.ndimage.map_coordinates(p, coords, order=order, mode=mode,
                                         prefilter=order > 1)[:, ::-1]
           for p in planes]
    out = out[0] if img.ndim == 2 else np.stack(out, -1)
    return out.mean(axis=1)


@pytest.mark.parametrize("case", PROFILE_CASES, ids=[c[0] for c in
                                                     PROFILE_CASES])
def test_profile_matches_scipy(case):
    _, dtype, ch, src, dst, lw, order, mode = case
    rng = np.random.default_rng(11)
    img = rng.random((64, 64) + ((ch,) if ch else ())).astype(dtype)
    got = tm.profile_line(T(img), src, dst, linewidth=lw, order=order,
                          mode=mode)
    assert got.dtype == T(img).dtype
    close(got, _np_profile(img, src, dst, lw, order, mode),
          2e-6 if dtype == np.float32 else 1e-12)


# ---------------------------------------------------------------------------
# polygons, block_reduce, shannon_entropy
# ---------------------------------------------------------------------------


def test_approximate_polygon_matches_cupyimg_tpu():
    t = np.linspace(0, 2 * np.pi, 120)
    rng = np.random.default_rng(2)
    square = np.array([[0, 0], [0, 1], [0, 2], [0, 3], [1, 3], [2, 3],
                       [3, 3], [3, 2], [3, 1], [3, 0], [2, 0], [1, 0],
                       [0, 0]], np.float64)
    chains = [square, np.c_[10 * np.sin(t), 8 * np.cos(3 * t)],
              np.cumsum(rng.standard_normal((200, 2)), axis=0)]
    for coords in chains:
        for tol in (0, 0.1, 0.5, 2.0):
            got = tm.approximate_polygon(T(coords), tol)
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(
                H(got), np.asarray(jm.approximate_polygon(coords, tol)))
        host = tm.approximate_polygon(coords, 0.5)
        assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(
        H(tm.approximate_polygon(T(square), 0.1)),
        np.array([[0, 0], [0, 3], [3, 3], [3, 0], [0, 0]]))


_MASKS = {1: ([1, 1], [1, 1]), 2: ([3, 1], [1, 3]), 3: ([1, 6, 1], [0, 4, 4]),
          4: ([5, 10, 1], [1, 10, 5]), 5: ([1, 15, 15, 1], [0, 6, 20, 6]),
          6: ([7, 35, 21, 1], [1, 21, 35, 7]),
          7: ([1, 28, 70, 28, 1], [0, 8, 56, 56, 8])}


def _np_subdivide(coords, degree, preserve_ends):
    """skimage's subdivide_polygon on scipy.signal.convolve2d."""
    circular = np.all(coords[0] == coords[-1])
    method = "valid"
    if circular:
        coords = coords[:-1]
        method = "same"
    even, odd = (np.atleast_2d(np.array(m, float) / 2 ** degree)
                 for m in _MASKS[degree])
    e = scipy.signal.convolve2d(coords.T, even, mode=method, boundary="wrap")
    o = scipy.signal.convolve2d(coords.T, odd, mode=method, boundary="wrap")
    out = np.zeros((e.shape[1] + o.shape[1], 2))
    out[1::2] = e.T
    out[::2] = o.T
    if circular:
        out = np.vstack([out, out[0]])
    if preserve_ends and not circular:
        out = np.vstack([coords[0], out, coords[-1]])
    return out


@pytest.mark.parametrize("degree", range(1, 8))
def test_subdivide_polygon_matches_scipy(degree):
    rng = np.random.default_rng(degree)
    open_ = rng.random((15, 2)) * 10
    closed = np.vstack([open_, open_[:1]])
    for coords, ends in ((open_, False), (open_, True), (closed, False)):
        got = tm.subdivide_polygon(T(coords), degree, ends)
        close(got, _np_subdivide(coords, degree, ends), 1e-14)


def test_subdivide_polygon_errors():
    with pytest.raises(ValueError):
        tm.subdivide_polygon(torch.zeros((5, 2)), degree=8)
    with pytest.raises(ValueError):
        tm.subdivide_polygon(torch.zeros((5, 2)), degree=0)


def _np_block_reduce(image, block, func, cval):
    pad = [(0, (-s) % b) for s, b in zip(image.shape, block)]
    p = np.pad(image, pad, constant_values=cval)
    shape = []
    for s, b in zip(p.shape, block):
        shape += [s // b, b]
    v = p.reshape(shape).transpose(
        list(range(0, 2 * p.ndim, 2)) + list(range(1, 2 * p.ndim, 2)))
    return func(v, axis=tuple(range(p.ndim, 2 * p.ndim)))


@pytest.mark.parametrize("func, np_func", [
    (torch.sum, np.sum), (torch.mean, np.mean), (torch.amax, np.max),
    (torch.amin, np.min)])
@pytest.mark.parametrize("shape, block, dtype, cval", [
    ((8, 12), (2, 3), np.float32, 0), ((7, 10), (3, 4), np.float64, 1.5),
    ((5, 6, 7), 2, np.float64, 0), ((9, 9), (4, 2), np.int32, 7),
    ((6, 10), (4, 4), np.uint16, 3)])
def test_block_reduce_matches_numpy(func, np_func, shape, block, dtype, cval):
    rng = np.random.default_rng(0)
    img = (rng.random(shape) * 100).astype(dtype)
    if func is torch.mean and np.dtype(dtype).kind != "f":
        img = img.astype(np.float64)
    b = (block,) * len(shape) if np.isscalar(block) else block
    got = tm.block_reduce(T(img), block, func=func, cval=cval)
    want = _np_block_reduce(img, b, np_func, cval)
    if np_func in (np.max, np.min):
        assert got.dtype == T(img).dtype
    np.testing.assert_allclose(H(got).astype(np.float64), want,
                               rtol=1e-6 if dtype == np.float32 else 1e-12)


def test_block_reduce_errors_and_kwargs():
    img = torch.arange(16.0).reshape(4, 4)
    np.testing.assert_array_equal(
        H(tm.block_reduce(img, (2, 2), func=torch.mean,
                          func_kwargs={"dtype": torch.float64})),
        [[2.5, 4.5], [10.5, 12.5]])
    with pytest.raises(ValueError):
        tm.block_reduce(img, (2, 2, 2))
    with pytest.raises(ValueError):
        tm.block_reduce(img, (0, 2))


def test_shannon_entropy_matches_scipy():
    rng = np.random.default_rng(1)
    for img in (rng.integers(0, 7, (13, 9)), rng.random((5, 6)),
                np.zeros((4, 4)), np.array([0, 1] * 8, np.uint8)):
        for base in (2, np.e, 10):
            _, counts = np.unique(img, return_counts=True)
            np.testing.assert_allclose(
                float(tm.shannon_entropy(T(img), base=base)),
                scipy.stats.entropy(counts, base=base), rtol=1e-13,
                atol=1e-15)


# ---------------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------------

MODULES = ["skimage.measure", "skimage.measure.entropy",
           "skimage.measure.block", "skimage.measure._moments",
           "skimage.measure._regionprops_utils",
           "skimage.measure._regionprops", "skimage.measure._polygon",
           "skimage.measure.profile"]


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_cupyimg_tpu(name):
    jmod = importlib.import_module("cupyimg_tpu." + name)
    tmod = importlib.import_module("cupyimg_tpu_torch." + name)

    def public(mod):
        if hasattr(mod, "__all__"):
            return set(mod.__all__)
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    assert public(jmod) - public(tmod) == set()
