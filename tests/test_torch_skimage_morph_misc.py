"""The rest of the torch port's ``skimage.morphology``
(``remove_small_objects``, ``remove_small_holes``, ``reconstruction``,
``convex_hull_image``) and ``skimage.measure.label`` on CPU tensors.  No
skimage is installed, so the grids are held against statements of
skimage's definitions built from scipy: component sizes from
``scipy.ndimage.label`` and ``bincount``; reconstruction as scipy's grey
dilation (erosion) and a minimum (maximum) iterated to the fixpoint; the
hull as the half-plane test of ``scipy.spatial.ConvexHull``'s facets in
numpy; ``measure.label`` as ``scipy.ndimage.label`` per value,
renumbered in raster order.  Then a short named list against
``cupyimg_tpu`` (JAX-CPU, x64).  Every comparison is exact.
"""

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch
from scipy.spatial import ConvexHull

import jax.numpy as jnp

import cupyimg_tpu.skimage.measure as jmeasure
import cupyimg_tpu.skimage.morphology as jmorph
import cupyimg_tpu_torch.skimage.measure as measure
import cupyimg_tpu_torch.skimage.morphology as morph
from cupyimg_tpu_torch.skimage.morphology import greyreconstruct

RNG = np.random.default_rng(0)
BLOBS2 = sndi.uniform_filter(RNG.random((40, 37)), 3) > 0.5
BLOBS3 = sndi.uniform_filter(RNG.random((9, 10, 11)), 3) > 0.5


def _small_objects_reference(b, min_size, connectivity):
    st = sndi.generate_binary_structure(b.ndim, connectivity)
    lab, _ = sndi.label(b, st)
    sizes = np.bincount(lab.ravel())
    return b & (sizes[lab] >= min_size)


@pytest.mark.parametrize("connectivity", [1, 2, 3])
@pytest.mark.parametrize("min_size", [0, 1, 5, 20])
def test_remove_small_objects_and_holes(min_size, connectivity):
    for b in (BLOBS2, BLOBS3):
        if connectivity > b.ndim:
            continue
        got = morph.remove_small_objects(torch.from_numpy(b), min_size,
                                         connectivity)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(
            got.numpy(), _small_objects_reference(b, min_size, connectivity))
        got = morph.remove_small_holes(torch.from_numpy(b), min_size,
                                       connectivity)
        np.testing.assert_array_equal(
            got.numpy(),
            ~_small_objects_reference(~b, min_size, connectivity))


def test_remove_small_objects_labels_and_errors():
    lab, _ = sndi.label(BLOBS2)
    sizes = np.bincount(lab.ravel())
    got = morph.remove_small_objects(torch.from_numpy(lab), 6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(sizes[lab] < 6, 0, lab))
    with pytest.warns(UserWarning, match="Only one label"):
        morph.remove_small_objects(torch.from_numpy(BLOBS2.astype(int)), 3)
    with pytest.warns(UserWarning, match="boolean array"):
        got = morph.remove_small_holes(torch.from_numpy(BLOBS2.astype(int)),
                                       3)
    assert got.dtype == torch.bool
    with pytest.raises(TypeError):
        morph.remove_small_objects(torch.rand(4, 4), 3)
    with pytest.raises(ValueError, match="Negative"):
        morph.remove_small_objects(torch.tensor([[-1, 2], [2, 0]]), 3)
    with pytest.raises(NotImplementedError):
        morph.remove_small_objects(torch.from_numpy(BLOBS2), 3,
                                   in_place=True)
    x = torch.from_numpy(BLOBS2)
    assert morph.remove_small_objects(x, 0) is x


def _reconstruction_reference(seed, mask, method, footprint):
    grow = sndi.grey_dilation if method == "dilation" else sndi.grey_erosion
    clamp = np.minimum if method == "dilation" else np.maximum
    rec = seed
    while True:
        new = clamp(grow(rec, footprint=footprint, mode="nearest"), mask)
        if np.array_equal(new, rec):
            return rec
        rec = new


@pytest.mark.parametrize("method", ["dilation", "erosion"])
@pytest.mark.parametrize("footprint", [None, "cross", "3x5"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "int32"])
def test_reconstruction_matches_fixpoint(dtype, footprint, method):
    img = (RNG.random((30, 31)) * 50).astype(dtype)
    h = np.asarray(7, dtype)
    seed = img - h if method == "dilation" else img + h
    fp = {None: None, "cross": sndi.generate_binary_structure(2, 1),
          "3x5": np.ones((3, 5), bool)}[footprint]
    greyreconstruct.reconstruction.sweeps = 0
    got = morph.reconstruction(torch.from_numpy(seed), torch.from_numpy(img),
                               method, fp)
    assert got.numpy().dtype == np.dtype(dtype)
    assert greyreconstruct.reconstruction.sweeps >= 4
    np.testing.assert_array_equal(got.numpy(), _reconstruction_reference(
        seed, img, method, np.ones((3, 3), bool) if fp is None else fp))


def test_reconstruction_offset_3d_and_errors():
    x = RNG.random(40)
    # a 1-D two-sample footprint anchored at its first sample: values
    # spread one way, x[i] <- max(x[i], x[i - 1])
    got = morph.reconstruction(torch.from_numpy(x - 0.3), torch.from_numpy(x),
                               "dilation", np.ones(2), [0])
    ref = x - 0.3
    while True:
        new = np.minimum(np.maximum(ref, np.r_[-np.inf, ref[:-1]]), x)
        if np.array_equal(new, ref):
            break
        ref = new
    np.testing.assert_array_equal(got.numpy(), ref)
    v = RNG.random((8, 9, 10))
    got = morph.reconstruction(torch.from_numpy(v - 0.2), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), _reconstruction_reference(
        v - 0.2, v, "dilation", np.ones((3, 3, 3), bool)))
    s, m = torch.zeros((4, 4)), torch.ones((4, 4))
    for args, kw in (((m, s), {}), ((s, m), {"method": "erosion"}),
                     ((s, m), {"method": "bogus"}),
                     ((s, torch.ones((4, 5))), {}),
                     ((s, m), {"selem": np.ones((2, 2))}),
                     ((s, m), {"selem": np.ones((3, 3)), "offset": [1]}),
                     ((s, m), {"selem": np.ones(3), "offset": [3]})):
        with pytest.raises(ValueError):
            morph.reconstruction(*args, **kw)


def _hull_reference(mask):
    pts = np.argwhere(mask).astype(float)
    corners = (pts[:, None, :] + np.array(
        [[-0.5, 0], [0.5, 0], [0, -0.5], [0, 0.5]])).reshape(-1, 2)
    eq = ConvexHull(corners).equations
    grid = np.indices(mask.shape).reshape(2, -1).T.astype(float)
    return np.all(grid @ eq[:, :2].T + eq[:, 2] < 1e-10, axis=1).reshape(
        mask.shape)


@pytest.mark.parametrize("n_points", [3, 12, 60])
def test_convex_hull_image(n_points):
    rng = np.random.default_rng(n_points)
    m = np.zeros((30, 40), bool)
    m[rng.integers(0, 30, n_points), rng.integers(0, 40, n_points)] = True
    got = morph.convex_hull_image(torch.from_numpy(m))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), _hull_reference(m))


def test_convex_hull_degenerate_empty_and_errors():
    line = np.zeros((10, 10), bool)
    line[2, 1:8] = True
    # without the pixel corners the points are collinear: the hull is the
    # points themselves
    got = morph.convex_hull_image(torch.from_numpy(line),
                                  offset_coordinates=False)
    np.testing.assert_array_equal(got.numpy(), line)
    np.testing.assert_array_equal(
        morph.convex_hull_image(torch.from_numpy(line)).numpy(), line)
    assert not morph.convex_hull_image(torch.zeros((5, 6))).any()
    with pytest.raises(ValueError):
        morph.convex_hull_image(torch.ones(5))


def _measure_reference(img, connectivity, background=0):
    st = sndi.generate_binary_structure(img.ndim, connectivity)
    out = np.zeros(img.shape, np.int64)
    comps = []
    for v in np.unique(img[img != background]):
        lab, n = sndi.label(img == v, st)
        for k in range(1, n + 1):
            comps.append(lab == k)
    comps.sort(key=lambda c: np.flatnonzero(c)[0])
    for num, c in enumerate(comps, 1):
        out[c] = num
    return out, len(comps)


@pytest.mark.parametrize("background", [None, 2, -1])
@pytest.mark.parametrize("connectivity", [None, 1, 2])
def test_measure_label(connectivity, background):
    img = RNG.integers(0, 4, (25, 26))
    got, n = measure.label(torch.from_numpy(img), background=background,
                           return_num=True, connectivity=connectivity)
    ref, nr = _measure_reference(img, connectivity or 2,
                                 0 if background is None else background)
    assert got.dtype == torch.int32 and n == nr
    np.testing.assert_array_equal(got.numpy(), ref)
    only = measure.label(torch.from_numpy(img.astype(np.float64)),
                         connectivity=connectivity)
    np.testing.assert_array_equal(only.numpy(), _measure_reference(
        img, connectivity or 2)[0])
    with pytest.raises(ValueError):
        measure.label(torch.from_numpy(img), connectivity=3)


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64): its calls check their inputs on the
# host, so they run eagerly, each fixpoint one jit program
# ---------------------------------------------------------------------------


def test_named_calls_match_cupyimg_tpu():
    img = RNG.random((26, 23))
    levels = RNG.integers(0, 4, (26, 23))
    m = np.zeros((30, 40), bool)
    m[RNG.integers(0, 30, 9), RNG.integers(0, 40, 9)] = True
    t, j = torch.from_numpy, jnp.asarray
    pairs = (
        (morph.reconstruction(t(img - 0.2), t(img)),
         jmorph.reconstruction(j(img - 0.2), j(img))),
        (measure.label(t(levels), background=3, connectivity=1),
         jmeasure.label(j(levels), background=3, connectivity=1)),
        (morph.convex_hull_image(t(m)), jmorph.convex_hull_image(m)),
    )
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
