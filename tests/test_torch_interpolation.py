"""scipy.ndimage interpolation in the torch port, against scipy.ndimage.

On CPU tensors: every spline order 0-5 and scipy's eight modes for the
six public functions (spline_filter, map_coordinates, affine_transform,
shift, zoom, rotate), in float32 and float64, within 1e-5 (float32) and
1e-10 (float64) of the input's range; order 0 exactly.  Integer outputs
(rounded half away from zero, saturated), ``output=`` dtypes, complex
data, volume ``rotate`` (plane by plane), ``grid_mode``,
``geometric_transform`` and ``spline_filter1d`` likewise.  The two
``opencv`` modes, which scipy lacks, against their definition built from
scipy: the input padded by one sample of ``cval``, mode 'constant' at
the coordinates + 1 (``zoom``: pixel-centre sampling, edge replicated).
Error classes as scipy's and cupyimg_tpu's.  Three of the ten cases
held against cupyimg_tpu itself are here (``spline_filter1d``,
``spline_filter``, ``geometric_transform``); the other seven are in
``test_torch_interpolation_jax.py``.
"""

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

import cupyimg_tpu_torch.scipy.ndimage as tndi

MODES = ("constant", "nearest", "mirror", "reflect", "wrap", "grid-wrap",
         "grid-mirror", "grid-constant")
# long enough axes that scipy's truncated reflect/mirror boundary sums
# agree with the exact ones to 1e-10 at order 5
SHAPE = (34, 31)
MATRIX = [[0.9, 0.3], [-0.2, 1.1]]
OFFSET = (1.37, -2.21)


def _map_coords():
    return np.random.RandomState(1).uniform(-9, 43, (2, 12, 9))


# name: (torch call, scipy call), each taking (x, order, mode, **kw)
FUNCS = {
    "shift": lambda nd, x, order, mode, **kw: nd.shift(
        x, (2.3, -5.6), order=order, mode=mode, cval=0.7, **kw),
    "zoom": lambda nd, x, order, mode, **kw: nd.zoom(
        x, (1.7, 0.8), order=order, mode=mode, cval=0.7, **kw),
    "rotate": lambda nd, x, order, mode, **kw: nd.rotate(
        x, 27, order=order, mode=mode, cval=0.7, **kw),
    "affine_transform": lambda nd, x, order, mode, **kw: nd.affine_transform(
        x, MATRIX, OFFSET, (38, 27), order=order, mode=mode, cval=0.7, **kw),
    "map_coordinates": lambda nd, x, order, mode, **kw: nd.map_coordinates(
        x, _map_coords() if nd is sndi else torch.from_numpy(_map_coords()),
        order=order, mode=mode, cval=0.7, **kw),
    "spline_filter": lambda nd, x, order, mode, **kw: nd.spline_filter(
        x, max(order, 2), mode=mode, **kw),
}


def _input(dtype, seed=0):
    return np.random.RandomState(seed).rand(*SHAPE).astype(dtype)


def _check(got, exp, dtype, exact, scale=1.0):
    """Exact, or within 1e-5 (float32) / 1e-10 (float64) of ``scale``,
    the input's range."""
    got = got.numpy()
    assert got.shape == exp.shape
    if exact:
        np.testing.assert_array_equal(got, exp)
    else:
        tol = 1e-5 if dtype in (np.float32, np.complex64) else 1e-10
        np.testing.assert_allclose(got, exp, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_matches_scipy(name, order, mode):
    fn = FUNCS[name]
    for dtype in (np.float32, np.float64):
        x = _input(dtype)
        exp = fn(sndi, x, order, mode)
        got = fn(tndi, torch.from_numpy(x), order, mode)
        assert got.dtype == torch.from_numpy(exp).dtype
        _check(got, exp, dtype, order == 0 and name != "spline_filter")


@pytest.mark.parametrize("output", [np.uint8, np.int16, np.int32])
@pytest.mark.parametrize("name", sorted(set(FUNCS) - {"spline_filter"}))
def test_integer_outputs_exact(name, output):
    """Rounded half away from zero and saturated, as scipy does (the
    spikes overshoot the uint8 range under the cubic spline)."""
    x = np.round(_input(np.float64, 2) * 200 - 40)
    x[5, 7], x[20, 3] = 300.0, -120.0
    for order in (0, 1, 3):
        exp = FUNCS[name](sndi, x, order, "mirror", output=output)
        got = FUNCS[name](tndi, torch.from_numpy(x), order, "mirror",
                          output=output)
        _check(got, exp, np.float64, True)


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_output_dtype_and_integer_input(name):
    x = (_input(np.float64, 3) * 250).astype(np.uint8)
    # spline_filter's integer outputs are a plain cast, not interpolation's
    # rounding: only float outputs are compared
    outputs = (np.float32, np.float64) if name == "spline_filter" else (
        None, np.float32, np.float64)
    for output in outputs:
        exp = FUNCS[name](sndi, x, 1, "reflect", output=output)
        got = FUNCS[name](tndi, torch.from_numpy(x), 1, "reflect",
                          output=output)
        assert got.dtype == torch.from_numpy(exp).dtype
        if output is None:  # uint8 out of float32 work: rounding ties
            assert np.abs(got.numpy().astype(int) - exp).max() <= 1
        else:
            _check(got, exp, np.float32, False, scale=255.0)


@pytest.mark.parametrize("name", sorted(set(FUNCS) - {"spline_filter"}))
def test_complex_matches_scipy(name):
    rng = np.random.RandomState(4)
    x = rng.rand(*SHAPE) + 1j * rng.rand(*SHAPE)
    for order in (1, 3):
        exp = FUNCS[name](sndi, x, order, "grid-wrap")
        got = FUNCS[name](tndi, torch.from_numpy(x), order, "grid-wrap")
        assert got.dtype == torch.complex128
        _check(got, exp, np.complex128, False)


@pytest.mark.parametrize("order", [0, 1, 3, 5])
def test_volume_rotate_plane_by_plane(order):
    """A 3-D rotate resamples each plane with the same 2-D affine: with
    prefilter=False the other axis is not smoothed."""
    x = np.random.RandomState(5).rand(5, 14, 11)
    for axes, reshape, mode in (((1, 2), False, "nearest"),
                                ((0, 2), True, "grid-constant"),
                                ((2, 1), True, "constant")):
        kw = dict(axes=axes, reshape=reshape, order=order, mode=mode,
                  cval=0.3)
        for prefilter in (True, False):
            exp = sndi.rotate(x, 33, prefilter=prefilter, **kw)
            got = tndi.rotate(torch.from_numpy(x), 33, prefilter=prefilter,
                              **kw)
            _check(got, exp, np.float64, order == 0)


@pytest.mark.parametrize("mode", ["constant", "grid-constant", "wrap",
                                  "grid-wrap", "reflect", "nearest"])
def test_zoom_grid_mode(mode):
    x = _input(np.float64, 6)
    for order in (0, 1, 3):
        for zoom in ((1.7, 0.8), (3, 1 / 31)):
            with _warns(mode):
                got = tndi.zoom(torch.from_numpy(x), zoom, order=order,
                                mode=mode, grid_mode=True)
            with _warns(mode):
                exp = sndi.zoom(x, zoom, order=order, mode=mode,
                                grid_mode=True)
            _check(got, exp, np.float64, order == 0)


def _warns(mode):
    if mode in ("constant", "wrap"):
        return pytest.warns(UserWarning, match="recommended")
    import contextlib

    return contextlib.nullcontext()


@pytest.mark.parametrize("order", [0, 1, 3])
def test_exact_right_angles(order):
    """rotate by multiples of 90 degrees uses exact 0/+-1 entries, so
    order 0 lands exactly on samples, as scipy's sindg/cosdg do."""
    x = _input(np.float64, 7)
    for angle in (90, 180, -90, 270, 450):
        exp = sndi.rotate(x, angle, order=order)
        got = tndi.rotate(torch.from_numpy(x), angle, order=order)
        _check(got, exp, np.float64, order == 0)


def test_geometric_transform():
    x = _input(np.float64, 8)

    def mapping(idx, a, b=0.0):
        return idx[0] * a + 0.37, idx[1] * 0.8 - b

    for order in (0, 1, 3):
        exp = sndi.geometric_transform(
            x, mapping, (20, 25), order=order, extra_arguments=(1.3,),
            extra_keywords={"b": 0.61})
        got = tndi.geometric_transform(
            torch.from_numpy(x), mapping, (20, 25), order=order,
            extra_arguments=(1.3,), extra_keywords={"b": 0.61})
        _check(got, exp, np.float64, order == 0)


@pytest.mark.parametrize("order", range(6))
def test_spline_filter1d(order):
    x = _input(np.float64, 9)
    for axis, mode in ((0, "mirror"), (-1, "reflect"), (1, "grid-wrap"),
                       (0, "nearest")):
        exp = sndi.spline_filter1d(x, order, axis, mode=mode)
        got = tndi.spline_filter1d(torch.from_numpy(x), order, axis,
                                   mode=mode)
        _check(got, exp, np.float64, False)


def test_map_coordinates_coordinate_dtypes():
    """Integer coordinates promote to float; float32 ones stay float32
    (the weights are formed in float32)."""
    x = _input(np.float64, 10)
    ci = np.random.RandomState(2).randint(-3, 36, (2, 5, 6))
    exp = sndi.map_coordinates(x, ci, order=3)
    got = tndi.map_coordinates(torch.from_numpy(x), torch.from_numpy(ci),
                               order=3)
    _check(got, exp, np.float64, False)
    cf = _map_coords().astype(np.float32)
    exp = sndi.map_coordinates(x, cf.astype(np.float64), order=1)
    got = tndi.map_coordinates(torch.from_numpy(x), torch.from_numpy(cf),
                               order=1)
    _check(got, exp, np.float32, False)


@pytest.mark.parametrize("precision, allow_float32, want", [
    ("auto", True, torch.float64),
    ("f64", True, torch.float64),
    ("f32", True, torch.float32),
    ("f32", False, torch.float64),
])
def test_coord_precision_reaches_the_gather(precision, allow_float32, want,
                                            monkeypatch):
    """config.coord_precision decides the dtype of the coordinates that
    affine_transform, shift, zoom and rotate hand to the gather ('auto'
    is float64; 'f32' only with allow_float32)."""
    from cupyimg_tpu_torch.core.config import config
    from cupyimg_tpu_torch.ops import interp

    seen = []
    gather = interp.gather_general

    def spy(x, coords, *args):
        seen.append(coords[0].dtype)
        return gather(x, coords, *args)

    monkeypatch.setattr(interp, "gather_general", spy)
    monkeypatch.setattr(config, "coord_precision", precision)
    x = torch.from_numpy(_input(np.float32, 11))
    kw = dict(order=1, allow_float32=allow_float32)
    for y in (tndi.affine_transform(x, MATRIX, OFFSET, **kw),
              tndi.shift(x, (2.3, -5.6), **kw), tndi.zoom(x, 1.7, **kw),
              tndi.rotate(x, 27, **kw)):
        assert torch.isfinite(y).all()
    assert seen == [want] * 4


def test_coord_precision_rejects_other_values(monkeypatch):
    from cupyimg_tpu_torch.core.config import config

    monkeypatch.setattr(config, "coord_precision", "float64")
    with pytest.raises(ValueError, match="coord_precision"):
        tndi.shift(torch.rand(5, 5), 1.5)


def test_affine_knife_edge_rounding():
    """Where a coordinate is a tie in exact arithmetic, its float64
    rounding decides order 0.  At output (14, 5) the second coordinate
    -0.2 * 14 + 1.1 * 5 - 2.2 is 0.5 exactly, 0.49999999999999956 as the
    port and cupyimg_tpu sum it (matrix terms, then the offset), and 0.5
    in scipy's C code: scipy takes the sample above, the port (like
    cupyimg_tpu, test_torch_interpolation_jax.py) the one below."""
    x = np.random.RandomState(0).rand(12, 10)
    kw = dict(offset=(1.5, -2.2), output_shape=(15, 9), order=0,
              mode="nearest")
    m = [[0.9, 0.3], [-0.2, 1.1]]
    got = tndi.affine_transform(torch.from_numpy(x), m, **kw).numpy()
    exp = sndi.affine_transform(x, m, **kw)
    assert np.argwhere(got != exp).tolist() == [[14, 5]]
    c = (0 + -0.2 * 14 + 1.1 * 5) + -2.2
    assert c < 0.5
    assert got[14, 5] == x[min(round(0.9 * 14 + 0.3 * 5 + 1.5), 11), 0]


# ---------------------------------------------------------------------------
# opencv modes: against their definition
# ---------------------------------------------------------------------------


def _opencv_definition(x, coords, order, cval):
    """Pad one sample of cval, then mode 'constant' at coordinates + 1."""
    xp = np.pad(x, 1, constant_values=cval)
    return sndi.map_coordinates(xp, coords + 1, order=order,
                                mode="constant", cval=cval)


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("mode", ["opencv", "_opencv_edge"])
def test_opencv_map_coordinates_definition(order, mode):
    x = _input(np.float64, 11)
    c = _map_coords() * 0.7
    exp = _opencv_definition(x, c, order, 0.4)
    got = tndi.map_coordinates(torch.from_numpy(x), torch.from_numpy(c),
                               order=order, mode=mode, cval=0.4)
    _check(got, exp, np.float64, order == 0)


def _affine_field(matrix, offset, out_shape):
    idx = np.indices(out_shape).reshape(len(out_shape), -1)
    c = np.asarray(matrix) @ idx + np.asarray(offset)[:, None]
    return c.reshape((len(out_shape),) + tuple(out_shape))


@pytest.mark.parametrize("order", [0, 1, 3])
def test_opencv_shift_rotate_affine_definition(order):
    x = _input(np.float64, 12)
    cval = -0.2
    # shift: coordinates o - s
    exp = _opencv_definition(
        x, _affine_field(np.eye(2), (-2.3, 5.6), SHAPE), order, cval)
    got = tndi.shift(torch.from_numpy(x), (2.3, -5.6), order=order,
                     mode="opencv", cval=cval)
    _check(got, exp, np.float64, order == 0)
    # rotate: scipy's rotation matrix about the centres
    a = np.deg2rad(27)
    rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
    out = sndi.rotate(x, 27).shape
    off = (np.asarray(SHAPE) - 1) / 2 - rot @ ((np.asarray(out) - 1) / 2)
    exp = _opencv_definition(x, _affine_field(rot, off, out), order, cval)
    got = tndi.rotate(torch.from_numpy(x), 27, order=order, mode="opencv",
                      cval=cval)
    _check(got, exp, np.float64, False)
    # affine_transform: OpenCV's matrix convention (inverted, x/y swapped)
    m = np.array([[1.1, 0.2, 3.0], [-0.1, 0.9, -1.5], [0, 0, 1]])
    inv = np.linalg.inv(m)
    inv[:2] = np.roll(inv[:2], 1, axis=0)
    inv[:2, :2] = np.roll(inv[:2, :2], 1, axis=1)
    exp = _opencv_definition(
        x, _affine_field(inv[:2, :2], inv[:2, 2], (30, 33)), order, cval)
    got = tndi.affine_transform(torch.from_numpy(x), m[:2, :2], m[:2, 2],
                                (30, 33), order=order, mode="opencv",
                                cval=cval)
    _check(got, exp, np.float64, False)


@pytest.mark.parametrize("zoom", [3, 0.3])
def test_opencv_zoom(zoom):
    """cv2.resize: coordinate (o + 0.5) / zoom - 0.5, edge replicated."""
    x = _input(np.float64, 13)
    out = tuple(int(round(s * zoom)) for s in SHAPE)
    coords = np.meshgrid(*[(np.arange(n) + 0.5) * (SHAPE[a] / out[a]) - 0.5
                           for a, n in enumerate(out)], indexing="ij")
    exp = sndi.map_coordinates(x, np.stack(coords), order=1, mode="nearest")
    got = tndi.zoom(torch.from_numpy(x), zoom, order=1, mode="opencv")
    _check(got, exp, np.float64, False)


# ---------------------------------------------------------------------------
# against cupyimg_tpu (float64 coordinates on both sides)
# ---------------------------------------------------------------------------


def _mapping(idx):
    return idx[0] * 0.8 + 0.3, idx[1] * 1.1 - 0.45


JAX_CASES = {
    "spline_filter1d-order4-mirror": lambda nd, x: nd.spline_filter1d(
        x, 4, axis=0, mode="mirror"),
    "spline_filter-order5-reflect": lambda nd, x: nd.spline_filter(
        x, 5, mode="reflect"),
    "geometric_transform-order1-constant": lambda nd, x: (
        nd.geometric_transform(x, _mapping, (6, 5), order=1)),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_matches_cupyimg_tpu(name, monkeypatch):
    import cupyimg_tpu.scipy.ndimage as jndi
    from cupyimg_tpu.core.config import config as jax_config

    monkeypatch.setattr(jax_config, "coord_precision", "f64")
    x = np.random.RandomState(0).rand(12, 10)
    exp = np.asarray(JAX_CASES[name](jndi, x))
    got = JAX_CASES[name](tndi, torch.from_numpy(x)).numpy()
    assert got.dtype == exp.dtype
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


ERRORS = [
    ("order 6", lambda nd, x: nd.shift(x, 1, order=6), ValueError),
    ("order -1", lambda nd, x: nd.zoom(x, 2, order=-1), ValueError),
    ("bad mode", lambda nd, x: nd.rotate(x, 10, mode="unknown"),
     ValueError),
    ("coordinate rank", lambda nd, x: nd.map_coordinates(
        x, np.zeros((3, 4, 4))), RuntimeError),
    ("complex coordinates", lambda nd, x: nd.map_coordinates(
        x, np.zeros((2, 4, 4), complex)), ValueError),
    ("rotation plane", lambda nd, x: nd.rotate(x, 10, axes=(0, 0)),
     ValueError),
    ("affine shape", lambda nd, x: nd.affine_transform(x, np.eye(3)[:, :2]),
     RuntimeError),
    ("affine rank", lambda nd, x: nd.affine_transform(x, np.ones((2, 2, 2))),
     RuntimeError),
    ("spline_filter order 1", lambda nd, x: nd.spline_filter(x, 1),
     RuntimeError),
    ("spline_filter1d order 6", lambda nd, x: nd.spline_filter1d(x, 6),
     RuntimeError),
    ("shift length", lambda nd, x: nd.shift(x, (1, 2, 3)), RuntimeError),
]


@pytest.mark.parametrize("name, call, exc", ERRORS,
                         ids=[e[0] for e in ERRORS])
def test_error_classes(name, call, exc):
    import cupyimg_tpu.scipy.ndimage as jndi

    x = _input(np.float64)[:8, :8]
    with pytest.raises(exc):
        call(tndi, torch.from_numpy(x))
    with pytest.raises(exc):
        call(jndi, x)


def test_tensor_output_raises():
    x = torch.rand(5, 5, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tndi.shift(x, 1, output=torch.empty(5, 5))
