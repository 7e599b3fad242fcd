"""The measurements slice of the torch port (``scipy.ndimage.label`` and
the labeled reductions) on CPU tensors: ``label`` against the bundled
vectors (``tests/data/ndimage/label_*.txt``) and against scipy, exactly,
numbering included; the reductions against scipy over scalar, absent,
list and missing (None) indices; ``find_objects``, ``value_indices``,
``labeled_comprehension`` and the error classes; then a short named list
against ``cupyimg_tpu`` (JAX-CPU, x64), whose reductions sync with the
host and so run eagerly.

Tolerances: the float64 reductions within 1e-12 relative, positions,
extrema, medians, histograms and labels exactly.  Where the port follows
``cupyimg_tpu`` and not scipy (ROADMAP C): ``median`` of an absent label
in a list is NaN (scipy reads a neighbouring segment's value); ties of
the extrema positions take the first minimum and the last maximum
(scipy's order depends on its unstable sort); sum, mean and variance
reject complex data; a histogram of an absent label in a list counts
zeros (scipy: None); the whole-array mean,
variance and median of integers of 32 bits or fewer are float32; NaN
propagates through ``minimum``/``maximum`` as through ``cupyimg_tpu``'s.
Where the two packages give different dtypes, the port gives the narrower
one: the per-label median of float32 data is float32, as scipy's.
"""

import os

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.scipy.ndimage as jndi
import cupyimg_tpu_torch.scipy.ndimage as ndi
from cupyimg_tpu_torch.scipy.ndimage import measurements

DATA = os.path.join(os.path.dirname(__file__), "data", "ndimage")


def _golden():
    data = np.loadtxt(os.path.join(DATA, "label_inputs.txt")).reshape(
        -1, 7, 7)
    strels = np.loadtxt(os.path.join(DATA, "label_strels.txt")).reshape(
        -1, 3, 3)
    results = np.loadtxt(os.path.join(DATA, "label_results.txt")).reshape(
        -1, 7, 7)
    return data, strels, results


@pytest.mark.parametrize("i", range(3))
def test_label_golden_vectors(i):
    data, strels, results = _golden()
    for j in range(strels.shape[0]):
        out, n = ndi.label(torch.from_numpy(data[i]), strels[j])
        np.testing.assert_array_equal(out.numpy(),
                                      results[i * strels.shape[0] + j])
        assert int(n) == int(results[i * strels.shape[0] + j].max())


def _blobs(shape, seed, size=3, level=0.5):
    rng = np.random.default_rng(seed)
    return sndi.uniform_filter(rng.random(shape), size) > level


@pytest.mark.parametrize("shape", [(17,), (30, 41), (9, 10, 11),
                                   (4, 5, 6, 3)])
def test_label_matches_scipy(shape):
    b = _blobs(shape, len(shape))
    for conn in range(1, len(shape) + 1):
        st = sndi.generate_binary_structure(len(shape), conn)
        ref, nr = sndi.label(b, st)
        got, ng = ndi.label(torch.from_numpy(b), st)
        assert got.dtype == torch.int32 and ng.dtype == torch.int32
        assert ng.ndim == 0 and int(ng) == nr
        np.testing.assert_array_equal(got.numpy(), ref)
    if len(shape) == 2:  # an anti-diagonal structure, an integer image
        st = np.array([[0, 0, 1], [1, 1, 1], [1, 0, 0]])
        ref, nr = sndi.label(b.astype(np.int64) * 3, st)
        got, ng = ndi.label(torch.from_numpy(b.astype(np.int64) * 3), st)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_label_snake_sweeps_scalar_empty_and_output():
    snake = np.zeros((41, 41), bool)
    snake[::2, :] = True
    snake[1::4, -1] = True
    snake[3::4, 0] = True
    measurements.label.sweeps = 0
    got, n = ndi.label(torch.from_numpy(snake))
    assert int(n) == 1 and measurements.label.sweeps >= 5
    np.testing.assert_array_equal(got.numpy(), sndi.label(snake)[0])
    got, n = ndi.label(torch.tensor(3.0))
    assert got.shape == () and int(got) == 1 and int(n) == 1
    got, n = ndi.label(torch.zeros((0, 4)))
    assert tuple(got.shape) == (0, 4) and int(n) == 0
    got, n = ndi.label(torch.zeros((3, 4)))
    assert int(got.abs().sum()) == 0 and int(n) == 0
    got, _ = ndi.label(torch.from_numpy(snake), output=np.int64)
    assert got.dtype == torch.int64


def _greyscale_reference(img, structure):
    """scipy.ndimage.label per nonzero value, components renumbered in
    raster order of their first pixel."""
    out = np.zeros(img.shape, np.int64)
    firsts = []
    for v in np.unique(img[img != 0]):
        lab, n = sndi.label(img == v, structure)
        for k in range(1, n + 1):
            mask = lab == k
            firsts.append((np.flatnonzero(mask)[0], mask))
    for num, (_, mask) in enumerate(sorted(firsts, key=lambda t: t[0]), 1):
        out[mask] = num
    return out, len(firsts)


@pytest.mark.parametrize("shape", [(40, 37), (8, 9, 10)])
def test_label_greyscale_mode(shape):
    img = np.random.default_rng(1).integers(0, 4, shape)
    for conn in range(1, len(shape) + 1):
        st = sndi.generate_binary_structure(len(shape), conn)
        ref, nr = _greyscale_reference(img, st)
        got, ng = ndi.label(torch.from_numpy(img), st, greyscale_mode=True)
        assert int(ng) == nr
        np.testing.assert_array_equal(got.numpy(), ref)


def test_label_errors_match_scipy():
    x = np.ones((4, 5))
    for st, exc in ((np.ones((3, 3, 3)), RuntimeError),
                    (np.ones((3, 4)), ValueError)):
        with pytest.raises(exc):
            sndi.label(x, st)
        with pytest.raises(exc):
            ndi.label(torch.from_numpy(x), st)


# ---------------------------------------------------------------------------
# labeled reductions against scipy
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
X = _RNG.permutation(12 * 13).reshape(12, 13) / 7.0 - 9.0  # distinct values
LAB = _RNG.integers(0, 5, (12, 13))
LAB[LAB == 3] = 0  # label 3 is absent
INDICES = {"scalar": 2, "list": [1, 2, 4], "absent-in-list": [4, 3, 7, 1],
           "range": np.arange(5), "none": None}
STATS = ["sum", "mean", "variance", "standard_deviation", "minimum",
         "maximum", "median", "minimum_position", "maximum_position",
         "center_of_mass", "extrema", "sum_labels"]


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
        return np.stack([t.numpy() for t in v])
    return np.asarray(v, dtype=float)


def _agree(got, ref):
    got, ref = _as_np(got), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.astype(float), ref, rtol=1e-12,
                               atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("name, index", [
    (name, index) for name in STATS for index in sorted(INDICES)
    # scipy's list form reads another segment's value for an absent label
    # (the port's NaN: test_named_cases_match_cupyimg_tpu)
    if not (name == "median" and index in ("absent-in-list", "range"))])
def test_reductions_match_scipy(name, index):
    idx = INDICES[index]
    x, lab = torch.from_numpy(X), torch.from_numpy(LAB)
    got = getattr(ndi, name)(x, lab, idx)
    ref = getattr(sndi, name)(X, LAB, idx)
    if name == "extrema":
        for g, r in zip(got, ref):
            _agree(g, r)
    else:
        _agree(got, ref)


@pytest.mark.parametrize("name", ["sum", "mean", "variance", "minimum",
                                  "maximum", "median", "minimum_position",
                                  "maximum_position", "center_of_mass"])
def test_reductions_without_labels_match_scipy(name):
    _agree(getattr(ndi, name)(torch.from_numpy(X)), getattr(sndi, name)(X))
    # labels with the index given, and broadcast labels
    _agree(getattr(ndi, name)(torch.from_numpy(X), None, None),
           getattr(sndi, name)(X, None, None))
    lab1 = LAB[:1]
    _agree(getattr(ndi, name)(torch.from_numpy(X), torch.from_numpy(lab1),
                              [1, 2]),
           getattr(sndi, name)(X, np.broadcast_to(lab1, X.shape), [1, 2]))


def test_absent_scalar_index_and_empty_labels_raise_as_scipy():
    x, lab = torch.from_numpy(X), torch.from_numpy(LAB)
    for name in ("minimum", "maximum", "minimum_position",
                 "maximum_position", "extrema"):
        with pytest.raises(ValueError):
            getattr(sndi, name)(X, LAB, 3)
        with pytest.raises(ValueError):
            getattr(ndi, name)(x, lab, 3)
    zero = torch.zeros_like(lab)
    for name in ("minimum", "maximum", "minimum_position"):
        with pytest.raises(ValueError):
            getattr(ndi, name)(x, zero)
    assert float(ndi.sum(x, lab, 3)) == 0.0
    assert np.isnan(float(ndi.mean(x, lab, 3)))
    assert np.isnan(float(ndi.variance(x, lab, 3)))
    assert np.isnan(float(ndi.median(x, lab, 3)))
    assert np.isnan(float(ndi.mean(x, zero)))


def test_complex_input_raises_as_cupyimg_tpu():
    """ROADMAP C: ``cupyimg_tpu``'s sum, mean and variance reject complex
    data with TypeError (scipy 1.17 computes them); the port follows."""
    z = np.ones((3, 3)) * (1 + 1j)
    lab = np.ones((3, 3), np.int64)
    for name in ("sum", "mean", "variance"):
        assert np.iscomplexobj(getattr(sndi, name)(z, lab, 1))
        with pytest.raises(TypeError):
            getattr(jndi, name)(jnp.asarray(z), jnp.asarray(lab), 1)
        with pytest.raises(TypeError):
            getattr(ndi, name)(torch.from_numpy(z), torch.from_numpy(lab), 1)


def test_unsigned_whole_array_sum_is_int64():
    """ROADMAP C: torch has no uint64 sum, so the whole-array sum of
    unsigned integers is int64 (scipy and cupyimg_tpu: uint64); the value
    is the same below 2^63."""
    u = np.arange(300, dtype=np.uint8).reshape(15, 20) % 251
    got = ndi.sum(torch.from_numpy(u))
    ref = sndi.sum(u)
    assert got.dtype == torch.int64 and np.asarray(ref).dtype == np.uint64
    assert int(got) == int(ref)


@pytest.mark.parametrize("labels, index", [(None, None), (LAB, None),
                                           (LAB, 2), (LAB, [1, 4, 3])])
def test_histogram_matches_scipy(labels, index):
    """An absent label in a list (3) counts zeros, as in ``cupyimg_tpu``;
    scipy gives None there (ROADMAP C)."""
    lab = None if labels is None else torch.from_numpy(labels)
    got = ndi.histogram(torch.from_numpy(X), -8.0, 10.0, 7, lab, index)
    ref = sndi.histogram(X, -8.0, 10.0, 7, labels, index)
    if isinstance(got, list):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(
                g.numpy(), np.zeros(7, np.int64) if r is None else r)
    else:
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), ref)


NEG_X = np.random.default_rng(11).standard_normal((9, 11))
NEG_LAB = np.random.default_rng(12).integers(-2, 3, (9, 11))


@pytest.mark.parametrize("index", [[-2, -1, 0, 1, 2], [-1], -2, [2, -1]])
def test_negative_labels_asked_for_match_scipy(index):
    """ROADMAP C: a negative label that the index asks for reduces over its
    own pixels, as scipy's (``cupyimg_tpu`` clips the index to 0); every
    reduction, on labels in {-2, ..., 2}."""
    x, lab = torch.from_numpy(NEG_X), torch.from_numpy(NEG_LAB)
    for name in STATS:
        got = getattr(ndi, name)(x, lab, index)
        ref = getattr(sndi, name)(NEG_X, NEG_LAB, index)
        if name == "extrema":
            for g, r in zip(got, ref):
                _agree(g, r)
        else:
            _agree(got, ref)
    got = ndi.histogram(x, -2.0, 2.0, 5, lab, index)
    ref = sndi.histogram(NEG_X, -2.0, 2.0, 5, NEG_LAB, index)
    if isinstance(got, list):
        got, ref = torch.stack(got), np.stack(ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert float(ndi.sum(x, lab, [-1])[0]) == pytest.approx(
        NEG_X[NEG_LAB == -1].sum(), rel=1e-12)


@pytest.mark.parametrize("s", [
    [[0, 1, 1], [0, 1, 0], [0, 0, 0]],
    [[1, 1, 0], [1, 1, 0], [0, 0, 0]],
    [[0, 0, 0], [1, 1, 0], [0, 0, 1]]])
def test_label_asymmetric_structure_labels_as_symmetrized(s):
    """ROADMAP C: a structure that is not centrosymmetric labels as its
    symmetrized ``s | s[::-1, ::-1]``; scipy 1.17 raises AssertionError,
    and ``cupyimg_tpu``'s labels depend on the direction of propagation
    (more components than the symmetrized structure gives)."""
    s = np.array(s, bool)
    sym = s | s[::-1, ::-1]
    for seed in range(3):
        b = _blobs((16, 16), 21 + seed, size=2)
        with pytest.raises(AssertionError):
            sndi.label(b, s)
        ref, nr = sndi.label(b, sym)
        got, ng = ndi.label(torch.from_numpy(b), s)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert int(ng) == nr


def test_find_objects_matches_scipy():
    lab = LAB.astype(np.int32)
    t = torch.from_numpy(lab)
    assert ndi.find_objects(t) == sndi.find_objects(lab)
    assert ndi.find_objects(t, 6) == sndi.find_objects(lab, 6)
    assert ndi.find_objects(t, 2) == sndi.find_objects(lab, 2)
    lab3 = sndi.label(_blobs((9, 10, 11), 3))[0]
    assert ndi.find_objects(torch.from_numpy(lab3)) == sndi.find_objects(
        lab3)
    assert ndi.find_objects(torch.zeros((3, 3), dtype=torch.int32)) == []
    assert ndi.find_objects(torch.tensor(2)) == sndi.find_objects(
        np.asarray(2))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
def test_find_objects_of_unsigned_labels_matches_scipy(dtype):
    """uint16 and uint32 labels raised (torch has no max of them) until
    find_objects widened them; regionprops of such labels reaches it."""
    lab = LAB.astype(dtype)
    assert ndi.find_objects(torch.from_numpy(lab)) == sndi.find_objects(lab)
    assert ndi.find_objects(torch.from_numpy(lab), 3) == sndi.find_objects(
        lab, 3)


def test_value_indices_matches_scipy():
    for kw in ({}, {"ignore_value": 0}):
        got = ndi.value_indices(torch.from_numpy(LAB), **kw)
        ref = sndi.value_indices(LAB, **kw)
        assert list(got) == list(ref)
        for k in ref:
            assert type(k) is type(next(iter(got)))
            for a, b in zip(got[k], ref[k]):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        sndi.value_indices(X)
    with pytest.raises(ValueError):
        ndi.value_indices(torch.from_numpy(X))


def test_labeled_comprehension_matches_scipy():
    x, lab = torch.from_numpy(X), torch.from_numpy(LAB)
    for index in ([1, 2, 3, 9], 2, None):
        np.testing.assert_allclose(
            ndi.labeled_comprehension(x, lab, index, np.mean, float, -1.0),
            sndi.labeled_comprehension(X, LAB, index, np.mean, float, -1.0))

    def spread(v, p):
        return float(v.max() - v.min() + p.max())

    np.testing.assert_allclose(
        ndi.labeled_comprehension(x, lab, [1, 4], spread, float, 0.0, True),
        sndi.labeled_comprehension(X, LAB, [1, 4], spread, float, 0.0, True))


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64): ties, NaN, integer data, absent labels
# in a list
# ---------------------------------------------------------------------------

XI = _RNG.integers(-5, 9, (12, 13)).astype(np.int32)  # many ties
XN = X.copy()
XN[4, 4] = np.nan
XN[7, 2] = np.nan


def test_named_cases_match_cupyimg_tpu():
    lab, labj = torch.from_numpy(LAB), jnp.asarray(LAB)
    idx = [4, 3, 1, 2]
    for arr, names in (
            (XI, ("minimum_position", "maximum_position", "median")),
            (XN, ("minimum", "median"))):
        x, xj = torch.from_numpy(arr), jnp.asarray(arr)
        for name in names:
            got = getattr(ndi, name)(x, lab, idx)
            want = getattr(jndi, name)(xj, labj, idx)
            _agree(got, want if isinstance(want, list) else np.asarray(want))
    # ROADMAP C: the median of float32 data per label is float32, as
    # scipy's (the mean of the middle two in float32); cupyimg_tpu's is
    # float64
    x32 = X.astype(np.float32)
    got = ndi.median(torch.from_numpy(x32), lab, idx)
    ref = sndi.median(x32, LAB, idx)
    want = np.asarray(jndi.median(jnp.asarray(x32), labj, idx))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert want.dtype == np.float64
    np.testing.assert_array_equal(got.numpy()[[0, 2, 3]], ref[[0, 2, 3]])
    assert np.isnan(got.numpy()[1])
    # a NaN extremum matches no pixel: its position raises, as in
    # cupyimg_tpu (np.unravel_index of the pixel count)
    with pytest.raises(ValueError):
        ndi.minimum_position(torch.from_numpy(XN), lab, idx)
    # the whole-array statistics of int32 data: cupyimg_tpu's float32
    spec = jax.ShapeDtypeStruct(XI.shape, XI.dtype)
    for name in ("mean", "variance", "median"):
        got = getattr(ndi, name)(torch.from_numpy(XI))
        want = jax.eval_shape(getattr(jndi, name), spec).dtype
        assert got.numpy().dtype == want == np.float32
        np.testing.assert_allclose(got.numpy(), getattr(sndi, name)(XI),
                                   rtol=1e-6)
