"""``skimage.segmentation`` of the torch port on CPU tensors.

- The segmentation suite: the docstring cases of
  ``join_segmentations``, ``relabel_sequential`` and ``find_boundaries``,
  the brute-force oracle of the subpixel boundaries, ``mark_boundaries``,
  the level sets, and the morphological snakes' behaviour and goldens.
- Numpy definitions: the boundaries of uint8, uint16 and uint32 label
  images in every mode (scipy's grey dilation and erosion, the
  subpixel oracle), ``relabel_sequential`` by ``np.unique`` and
  ``searchsorted``, ``clear_border`` by ``scipy.ndimage.label`` and the
  labels found on the border.
- The departures from ``cupyimg_tpu``: ``join_segmentations`` forms its
  pair labels in int64 (the seeded uint8 pair has 690 distinct label
  pairs and so 690 labels; ``cupyimg_tpu`` wraps them into 246), and the
  snakes' smoothing restarts at SIoIS on every call (two identical calls
  give identical results).
- A named list against ``cupyimg_tpu`` on JAX-CPU (x64): chan-vese, GAC
  on the port's ``inverse_gaussian_gradient`` (itself held to scipy's
  definition within 1e-12), ``find_boundaries`` in the thick, inner and
  outer modes and ``mark_boundaries`` as one jit program (the level sets
  and the marked image exactly; ``outline_color`` cannot trace there and
  is held to scipy in ``test_mark_boundaries``), the subpixel boundaries
  and the uint16 relabelling eager (their host reads cannot trace),
  exactly.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import jax

from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.skimage import segmentation as seg


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """numpy and list inputs go to the CPU here (the library's default
    device is CUDA)."""
    monkeypatch.setattr(config, "device", "cpu")


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


LABELS = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 5, 5, 5, 0, 0],
        [0, 0, 1, 1, 1, 5, 5, 5, 0, 0],
        [0, 0, 1, 1, 1, 5, 5, 5, 0, 0],
        [0, 0, 1, 1, 1, 5, 5, 5, 0, 0],
        [0, 0, 0, 0, 0, 5, 5, 5, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    ],
    np.uint8,
)


def _blob():
    x, y = np.mgrid[0:40, 0:40]
    return ((x - 20) ** 2 + (y - 20) ** 2 < 100).astype(float)


def _iou(u, b):
    return (u & b).sum() / (u | b).sum()


def _label_image(shape, seed, dtype, top=None):
    """Blocky labels (3x3 cells of 0-4), scaled to reach near ``top``."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 5, tuple(-(-s // 3) for s in shape))
    lab = np.kron(cells, np.ones((3,) * len(shape), int))[
        tuple(slice(0, s) for s in shape)]
    if top is not None:
        lab = lab * (top // 4)
    return lab.astype(dtype)


# ---------------------------------------------------------------------------
# join, relabel, clear_border
# ---------------------------------------------------------------------------


def test_join_docstring_and_shape_mismatch():
    s1 = np.array([[0, 0, 1, 1], [0, 2, 1, 1], [2, 2, 2, 1]])
    s2 = np.array([[0, 1, 1, 0], [0, 1, 1, 0], [0, 1, 1, 1]])
    j = seg.join_segmentations(s1, s2)
    np.testing.assert_array_equal(
        H(j), [[0, 1, 3, 2], [0, 5, 3, 2], [4, 5, 5, 3]])
    assert j.dtype == torch.int64
    with pytest.raises(ValueError):
        seg.join_segmentations(np.zeros((3, 3), int), np.zeros((4, 4), int))


def test_join_forms_pair_labels_without_wrapping():
    """Two uint8 segmentations of 40 labels: every distinct pair of
    labels is a segment of its own (``cupyimg_tpu`` forms the pair labels
    in uint8 and wraps them into 246)."""
    rng = np.random.default_rng(0)
    s1 = rng.integers(0, 40, (30, 30)).astype(np.uint8)
    s2 = rng.integers(0, 40, (30, 30)).astype(np.uint8)
    pairs = np.unique(s1.astype(np.int64) * 40 + s2)
    assert len(pairs) == 690
    j = seg.join_segmentations(s1, s2)
    # 690 labels do not fit uint8: relabel_sequential's rule widens
    assert j.dtype == torch.uint16
    assert len(torch.unique(j.to(torch.int32))) == 690
    # the same pair, the same label; another pair, another label
    codes = s1.astype(np.int64) * 40 + s2
    lab = H(j.to(torch.int32)).ravel()
    assert np.unique(np.stack([codes.ravel(), lab]), axis=1).shape[1] == 690


def test_relabel_sequential_docstring():
    lf = np.array([1, 1, 5, 5, 8, 99, 42])
    relab, fw, inv = seg.relabel_sequential(lf)
    np.testing.assert_array_equal(H(relab), [1, 1, 2, 2, 3, 5, 4])
    np.testing.assert_array_equal(np.asarray(inv), [0, 1, 5, 8, 42, 99])
    dense_fw = np.asarray(fw)
    assert dense_fw.shape == (100,)
    np.testing.assert_array_equal(dense_fw[[1, 5, 8, 42, 99]],
                                  [1, 2, 3, 4, 5])
    assert (H(fw[lf]) == H(relab)).all()
    assert (H(inv[relab]) == lf).all()
    relab5, _, _ = seg.relabel_sequential(lf, offset=5)
    np.testing.assert_array_equal(H(relab5), [5, 5, 6, 6, 7, 9, 8])
    relab, _, _ = seg.relabel_sequential(np.array([0, 0, 7, 3]))
    np.testing.assert_array_equal(H(relab), [0, 0, 2, 1])


def test_relabel_validation():
    with pytest.raises(ValueError):
        seg.relabel_sequential(np.array([1, 2]), offset=0)
    with pytest.raises(ValueError):
        seg.relabel_sequential(np.array([-1, 2]))
    with pytest.raises(TypeError):
        seg.relabel_sequential(np.array([1.0, 2.0]))


@pytest.mark.parametrize("dtype, offset, top", [
    (np.uint8, 1, None), (np.uint8, 300, None), (np.int32, 1, 2 ** 30),
    (np.uint16, 1, 60000), (np.uint16, 70000, 60000),
    (np.uint32, 1, 2 ** 32 - 5), (np.uint32, 7, None),
    (np.uint64, 3, 2 ** 63 + 11), (np.int64, 1, 2 ** 40)])
def test_relabel_sequential_matches_numpy(dtype, offset, top):
    """skimage's rule: 0 stays 0, the other labels sequential from
    ``offset`` in sorted order, the input's dtype unless the labels need
    a wider one (``np.min_scalar_type``)."""
    lab = _label_image((13, 17), 2, dtype, top)
    got, fw, inv = seg.relabel_sequential(lab, offset=offset)
    vals = np.unique(lab)
    out = np.arange(offset, offset + len(vals))
    if vals[0] == 0:
        out = np.concatenate([[0], out[:-1]])
    required = np.min_scalar_type(out[-1])
    want_type = (required if np.dtype(dtype).itemsize < required.itemsize
                 or out[-1] > np.iinfo(dtype).max else np.dtype(dtype))
    assert str(got.dtype) == "torch." + want_type.name
    np.testing.assert_array_equal(H(got).astype(np.uint64),
                                  out[np.searchsorted(vals, lab)])
    # the maps, in a signed type holding the labels
    np.testing.assert_array_equal(H(fw.in_values).astype(dtype), vals)
    np.testing.assert_array_equal(H(inv[got.to(fw.out_values.dtype)]),
                                  lab.astype(H(inv.out_values).dtype))


def test_clear_border_suite():
    labels = np.array([[0, 0, 0, 0, 0, 0, 0, 1, 0],
                       [1, 1, 0, 0, 1, 0, 0, 1, 0],
                       [1, 1, 0, 1, 0, 1, 0, 0, 0],
                       [0, 0, 0, 1, 1, 1, 1, 0, 0],
                       [0, 1, 1, 1, 1, 1, 1, 1, 0],
                       [0, 0, 0, 0, 0, 0, 0, 0, 0]])
    want = np.array([[0, 0, 0, 0, 0, 0, 0, 0, 0],
                     [0, 0, 0, 0, 1, 0, 0, 0, 0],
                     [0, 0, 0, 1, 0, 1, 0, 0, 0],
                     [0, 0, 0, 1, 1, 1, 1, 0, 0],
                     [0, 1, 1, 1, 1, 1, 1, 1, 0],
                     [0, 0, 0, 0, 0, 0, 0, 0, 0]])
    np.testing.assert_array_equal(H(seg.clear_border(labels)), want)
    np.testing.assert_array_equal(
        H(seg.clear_border(labels.astype(bool))), want.astype(bool))
    np.testing.assert_array_equal(
        H(seg.clear_border(labels, buffer_size=1)), np.zeros_like(labels))
    np.testing.assert_array_equal(H(seg.clear_border(labels, bgval=2)),
                                  np.where((labels == 1) & (want == 0), 2,
                                           want))
    mask = np.ones(labels.shape, bool)
    mask[2:4, 3] = False  # the middle object touches the mask
    comp, _ = sndi.label(labels)
    np.testing.assert_array_equal(H(seg.clear_border(labels, mask=mask)),
                                  np.where(comp == comp[2, 3], 0, labels))
    with pytest.raises(ValueError):
        seg.clear_border(labels, buffer_size=6)
    with pytest.raises(ValueError):
        seg.clear_border(labels, mask=np.ones((2, 2), bool))
    with pytest.raises(TypeError):
        seg.clear_border(labels, mask=np.ones(labels.shape, int))


@pytest.mark.parametrize("dtype, top", [(np.int32, None),
                                        (np.uint16, 60000),
                                        (np.uint32, 2 ** 32 - 5)])
def test_clear_border_of_labels_matches_scipy(dtype, top):
    """Labelled objects touching the border (or within ``buffer_size``
    of it) take ``bgval``; the rest keep their labels and dtype."""
    lab = _label_image((20, 23), 5, dtype, top)
    for buffer_size in (0, 2):
        got = seg.clear_border(lab, buffer_size=buffer_size, bgval=1)
        assert str(got.dtype) == "torch." + np.dtype(dtype).name
        ext = buffer_size + 1
        border = np.ones(lab.shape, bool)
        border[ext:-ext, ext:-ext] = False
        touching = np.setdiff1d(np.unique(lab[border]), [0])
        want = np.where(np.isin(lab, touching), dtype(1), lab)
        np.testing.assert_array_equal(H(got), want)


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------


def _subpixel_oracle(lab):
    """The suite's brute force: an interstitial pixel is a boundary when
    its 3^ndim window of the expanded, zero-padded grid holds more than
    two values (the sentinel and two labels)."""
    ndim = lab.ndim
    lab = lab.astype(np.int64)
    sentinel = lab.max() + 1
    exp = np.full([2 * s - 1 for s in lab.shape], sentinel)
    exp[(slice(None, None, 2),) * ndim] = lab
    edges = np.ones(exp.shape, bool)
    edges[(slice(None, None, 2),) * ndim] = False
    pad = np.pad(exp, 1, mode="constant")
    out = np.zeros_like(edges)
    for idx in np.ndindex(exp.shape):
        if edges[idx]:
            win = pad[tuple(slice(i, i + 3) for i in idx)]
            out[idx] = len(np.unique(win)) > 2
    return out


def _boundaries_reference(lab, mode, connectivity=1, background=0):
    """skimage's definitions on scipy's grey dilation and erosion."""
    lab = lab.astype(np.int64)
    if mode == "subpixel":
        return _subpixel_oracle(lab)
    fp = sndi.generate_binary_structure(lab.ndim, connectivity)
    b = sndi.grey_dilation(lab, footprint=fp) != sndi.grey_erosion(
        lab, footprint=fp)
    if mode == "inner":
        b &= lab != background
    elif mode == "outer":
        bg = lab == background
        full = sndi.generate_binary_structure(lab.ndim, lab.ndim)
        inverted = np.where(bg, 2 ** 62, lab)
        adjacent = (sndi.grey_dilation(lab, footprint=full)
                    != sndi.grey_erosion(inverted, footprint=full)) & ~bg
        b &= bg | adjacent
    return b


def test_find_boundaries_docstring_cases():
    outer = H(seg.find_boundaries(LABELS, mode="outer")).astype(np.uint8)
    exp = np.array([
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, 1, 1, 0, 0],
        [0, 0, 1, 1, 1, 1, 0, 0, 1, 0],
        [0, 1, 0, 0, 1, 1, 0, 0, 1, 0],
        [0, 1, 0, 0, 1, 1, 0, 0, 1, 0],
        [0, 1, 0, 0, 1, 1, 0, 0, 1, 0],
        [0, 0, 1, 1, 1, 1, 0, 0, 1, 0],
        [0, 0, 0, 0, 0, 1, 1, 1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    ], np.uint8)
    np.testing.assert_array_equal(outer, exp)
    thick = H(seg.find_boundaries(LABELS, mode="thick"))
    inner = H(seg.find_boundaries(LABELS, mode="inner"))
    assert (thick & inner == inner).all() and (thick & outer == outer).all()
    assert (~inner[LABELS == 0]).all()
    b = np.zeros((5, 5), bool)
    b[1:, 2:] = True
    np.testing.assert_array_equal(H(seg.find_boundaries(b)).astype(int), [
        [0, 0, 1, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 0, 0], [0, 1, 1, 0, 0],
        [0, 1, 1, 0, 0]])


@pytest.mark.parametrize("mode", ["thick", "inner", "outer", "subpixel"])
@pytest.mark.parametrize("dtype, top", [
    (np.uint8, None), (np.int32, None), (np.uint16, 60000),
    (np.uint32, 2 ** 32 - 5)])
def test_find_boundaries_match_definitions(mode, dtype, top):
    lab = _label_image((11, 13), 3, dtype, top)
    got = seg.find_boundaries(lab, mode=mode, background=0)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(H(got), _boundaries_reference(lab, mode))


def test_find_boundaries_3d_and_connectivity():
    lab = _label_image((7, 8, 9), 4, np.int32)
    for mode in ("thick", "outer", "subpixel"):
        np.testing.assert_array_equal(
            H(seg.find_boundaries(lab, connectivity=2, mode=mode)),
            _boundaries_reference(lab, mode, connectivity=2))
    lab2 = (np.random.RandomState(0).rand(7, 8) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        H(seg.find_boundaries(lab2, mode="subpixel")), _subpixel_oracle(lab2))


def test_mark_boundaries():
    img = np.random.RandomState(0).rand(9, 10)
    marked = H(seg.mark_boundaries(img, LABELS.astype(int),
                                   color=(1, 0, 0)))
    assert marked.shape == (9, 10, 3)
    bnd = H(seg.find_boundaries(LABELS.astype(int), mode="outer"))
    np.testing.assert_array_equal(marked[bnd], np.tile([1, 0, 0],
                                                       (bnd.sum(), 1)))
    np.testing.assert_array_equal(marked[~bnd], np.stack([img] * 3, -1)[~bnd])
    marked2 = H(seg.mark_boundaries(img, LABELS, outline_color=(0, 1, 0)))
    outline = sndi.binary_dilation(bnd, np.ones((3, 3))) & ~bnd
    np.testing.assert_array_equal(marked2[outline], np.tile(
        [0, 1, 0], (outline.sum(), 1)))
    # subpixel: the image zoomed onto the expanded grid (scipy's spline
    # of order 3), the interstitial boundaries marked
    x = img.astype(np.float32)
    sub = seg.mark_boundaries(x, LABELS, mode="subpixel")
    assert sub.dtype == torch.float32 and sub.shape == (17, 19, 3)
    zoom = sndi.zoom(x.astype(np.float64), (17 / 9, 19 / 10), order=3,
                     mode="reflect")
    sb = _subpixel_oracle(LABELS)
    np.testing.assert_allclose(H(sub)[~sb], np.stack([zoom] * 3, -1)[~sb],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(H(sub)[sb], np.tile([1, 1, 0],
                                                      (sb.sum(), 1)))
    # an integer image is scaled to float64
    assert seg.mark_boundaries((img * 255).astype(np.uint8),
                               LABELS).dtype == torch.float64


# ---------------------------------------------------------------------------
# level sets and morphological snakes
# ---------------------------------------------------------------------------


def test_level_sets():
    cb = seg.checkerboard_level_set((6, 6), 2)
    assert cb.dtype == torch.int8 and cb.device.type == "cpu"
    np.testing.assert_array_equal(H(cb), [
        [0, 0, 1, 1, 0, 0], [0, 0, 1, 1, 0, 0], [1, 1, 0, 0, 1, 1],
        [1, 1, 0, 0, 1, 1], [0, 0, 1, 1, 0, 0], [0, 0, 1, 1, 0, 0]])
    d = H(seg.disk_level_set((9, 9), center=(4, 4), radius=3, device="cpu"))
    I, J = np.mgrid[0:9, 0:9]
    np.testing.assert_array_equal(d.astype(bool),
                                  (3 - np.hypot(I - 4, J - 4)) > 0)
    # the rim of a disk in float64: 5^2 = 3^2 + 4^2 lies on it, not in it
    d = H(seg.disk_level_set((11, 11), center=(0, 0), radius=5))
    assert d[3, 4] == 0 and d[4, 2] == 1
    with pytest.warns(FutureWarning):
        c = seg.circle_level_set((9, 9), center=(4, 4), radius=3)
    np.testing.assert_array_equal(H(c), H(seg.disk_level_set(
        (9, 9), center=(4, 4), radius=3)))
    np.testing.assert_array_equal(
        H(seg.checkerboard_level_set((4, 5, 6), 2)),
        ((np.indices((4, 5, 6)) // 2) & 1).sum(0) % 2)


def test_chan_vese_and_gac_on_a_blob():
    blob = _blob()
    b = blob > 0.5
    u = seg.morphological_chan_vese(blob, 60, smoothing=1,
                                    init_level_set="disk")
    assert _iou(H(u).astype(bool), b) > 0.9
    u = H(seg.morphological_chan_vese(blob, 30, smoothing=1)).astype(bool)
    assert max(_iou(u, b), _iou(~u, b)) > 0.9
    gimg = seg.inverse_gaussian_gradient(blob, alpha=1000, sigma=2)
    init = seg.disk_level_set(blob.shape, center=(20, 20), radius=17)
    u = seg.morphological_geodesic_active_contour(
        gimg, 60, init_level_set=init, smoothing=1, balloon=-1)
    assert _iou(H(u).astype(bool), b) > 0.9


def test_snakes_suite_goldens():
    img = np.zeros((11, 11))
    ls = seg.disk_level_set(img.shape, center=(5, 5), radius=3)
    acwe = H(seg.morphological_chan_vese(img, 6, init_level_set=ls))
    np.testing.assert_array_equal(acwe, np.zeros(img.shape))
    gac = H(seg.morphological_geodesic_active_contour(img, 6,
                                                      init_level_set=ls))
    np.testing.assert_array_equal(gac, np.zeros(img.shape))
    gac2 = H(seg.morphological_geodesic_active_contour(
        img, 6, init_level_set=ls, balloon=1, threshold=-1, smoothing=0))
    np.testing.assert_array_equal(gac2, np.ones(img.shape))
    assert acwe.dtype == gac.dtype == gac2.dtype == np.int8

    coords = np.mgrid[-5:6, -5:6]
    img = np.exp(-(coords ** 2).sum(0) / 10)
    a1 = H(seg.morphological_chan_vese(img, 10, init_level_set=seg.
                                       disk_level_set(img.shape, (5, 5), 3)))
    a2 = H(seg.morphological_chan_vese(img, 10, init_level_set=seg.
                                       disk_level_set(img.shape, (5, 5), 6)))
    np.testing.assert_array_equal(a1, a2)

    img = H(seg.disk_level_set((11, 11), center=(5, 5),
                               radius=3.5)).astype(float)
    gimg = seg.inverse_gaussian_gradient(img, alpha=10.0, sigma=1.0)
    ls = seg.disk_level_set(img.shape, center=(5, 5), radius=6)
    ref = np.zeros((11, 11), np.int8)
    ref[2, 5] = ref[8, 5] = 1
    ref[3:8, 3:8] = 1
    ref[5, 2:9] = 1
    gac = H(seg.morphological_geodesic_active_contour(
        gimg, 10, init_level_set=ls, balloon=-1))
    np.testing.assert_array_equal(gac, ref)

    image = np.zeros((6, 6))
    cb = H(seg.morphological_chan_vese(image, 0, "checkerboard"))
    cb_ref = np.zeros((6, 6), np.int8)
    cb_ref[:5, 5] = cb_ref[5, :5] = 1
    np.testing.assert_array_equal(cb, cb_ref)
    disk = H(seg.morphological_geodesic_active_contour(image, 0, "disk"))
    disk_ref = np.zeros((6, 6), np.int8)
    disk_ref[1, 2:5] = disk_ref[5, 2:5] = 1
    disk_ref[2:5, 1:] = 1
    np.testing.assert_array_equal(disk, disk_ref)


def test_snakes_3d_callback_and_validation():
    evolution = []
    ls = seg.morphological_chan_vese(
        np.zeros((7, 7, 7)), 5, "disk",
        iter_callback=lambda x: evolution.append(float(x.sum())))
    assert evolution[0] == 81 and float(ls.sum()) == 0
    assert all(v1 >= v2 for v1, v2 in zip(evolution[:-1], evolution[1:]))
    calls = []
    seg.morphological_chan_vese(_blob(), 3,
                                iter_callback=lambda u: calls.append(1))
    assert len(calls) == 4  # the initial level set and one per iteration
    with pytest.raises(ValueError):
        seg.morphological_chan_vese(np.zeros((4, 4)), 1,
                                    init_level_set=np.zeros((4, 4, 4)))
    with pytest.raises(ValueError):
        seg.morphological_chan_vese(np.zeros((4, 4)), 1,
                                    init_level_set="bogus")
    img, ls = np.zeros((10, 10, 3)), np.zeros((10, 9))
    with pytest.raises(ValueError):
        seg.morphological_chan_vese(img, 1, init_level_set=ls)
    with pytest.raises(ValueError):
        seg.morphological_geodesic_active_contour(img, 1, init_level_set=ls)
    with pytest.raises(ValueError):
        seg.morphological_chan_vese(np.zeros((4, 4, 4, 4)), 1,
                                    init_level_set=np.zeros((4, 4, 4, 4)))


def test_smoothing_restarts_on_every_call():
    """Every call starts the curvature operator at SIoIS, as
    ``cupyimg_tpu`` (skimage carries its cycle over from one call to the
    next): two identical calls give identical results, and an odd
    smoothing count differs from a fresh call of the other phase."""
    img = np.random.RandomState(1).rand(24, 24)
    runs = [H(seg.morphological_chan_vese(img, 3, smoothing=1))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    gimg = seg.inverse_gaussian_gradient(img, sigma=1)
    runs = [H(seg.morphological_geodesic_active_contour(gimg, 3, smoothing=3))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# against cupyimg_tpu (JAX-CPU, x64)
# ---------------------------------------------------------------------------


def test_inverse_gaussian_gradient_matches_its_definition():
    """1 / sqrt(1 + alpha |grad(gaussian(image))|) by scipy, float64."""
    img = sndi.gaussian_filter(np.random.RandomState(3).rand(40, 43), 2)
    for alpha, sigma in ((100.0, 5.0), (200.0, 2.0), (10.0, 1.0)):
        want = 1 / np.sqrt(1 + alpha * sndi.gaussian_gradient_magnitude(
            img, sigma, mode="nearest"))
        got = seg.inverse_gaussian_gradient(img, alpha=alpha, sigma=sigma)
        np.testing.assert_allclose(H(got), want, rtol=0, atol=1e-12)


def test_named_calls_match_cupyimg_tpu():
    """Chan-vese, GAC, the thick, inner and outer boundaries and
    ``mark_boundaries`` on 64^2 inputs as one jit program, and the
    subpixel boundaries and a uint16 relabelling eager (host reads), the
    three compiled side by side in threads (JAX's compiles release the
    interpreter lock)."""
    import cupyimg_tpu.skimage.segmentation as jseg

    rng = np.random.RandomState(2)
    img = sndi.gaussian_filter(rng.rand(64, 64), 3)
    img = (img - img.min()) / np.ptp(img)
    g = H(seg.inverse_gaussian_gradient(img, alpha=200.0, sigma=2.0))
    lab = _label_image((64, 64), 6, np.int32)
    lab16 = (lab * 7000).astype(np.uint16)

    def program(img, g, lab):
        return (jseg.morphological_chan_vese(img, 8, smoothing=2),
                jseg.morphological_geodesic_active_contour(
                    g, 8, balloon=-1, threshold=0.7),
                [jseg.find_boundaries(lab, mode=m)
                 for m in ("thick", "inner", "outer")],
                jseg.mark_boundaries(img, lab))

    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(jax.jit(program), img, g, lab),
                pool.submit(jseg.find_boundaries, lab, mode="subpixel"),
                pool.submit(lambda: jseg.relabel_sequential(lab16,
                                                            offset=3)[0])]
        want, subpixel, relabelled = (jax.tree_util.tree_map(
            np.asarray, job.result()) for job in jobs)
    np.testing.assert_array_equal(
        H(seg.morphological_chan_vese(img, 8, smoothing=2)), want[0])
    np.testing.assert_array_equal(
        H(seg.morphological_geodesic_active_contour(
            g, 8, balloon=-1, threshold=0.7)), want[1])
    for m, w in zip(("thick", "inner", "outer"), want[2]):
        np.testing.assert_array_equal(H(seg.find_boundaries(lab, mode=m)), w)
    np.testing.assert_array_equal(H(seg.mark_boundaries(img, lab)), want[3])
    np.testing.assert_array_equal(
        H(seg.find_boundaries(lab, mode="subpixel")), subpixel)
    got = seg.relabel_sequential(lab16, offset=3)[0]
    assert str(got.dtype) == "torch." + relabelled.dtype.name
    np.testing.assert_array_equal(H(got), relabelled)
