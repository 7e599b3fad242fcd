"""The multi-device package of the torch port (``cupyimg_tpu_torch.parallel``,
``models.sharded_edge_enhance``, ``graft_entry.dryrun_multichip``) in a
4-rank gloo world on the CPU.

One world (``run_world(device="cpu")``, spawned once for the file by a
module-scoped fixture) computes every case below and returns the results
as numpy arrays; the tests compare them:

- against SciPy/numpy in float64 (the FFT convolutions against
  ``numpy.fft``): rtol = atol = 2e-5 for the float32
  filters and interpolations (the tolerance of ``tests/test_parallel.py``;
  3e-5 for the affine transforms, as there), exactly for min/max, the
  median, the binary morphology and the labels (scipy's numbering),
  1e-4 / 1e-3 for the distributed FFT, 2e-4 for the spatially sharded FFT
  convolution, 1e-4 for the batch-sharded one;
- against the port's single-device call on the same input (CPU tensors):
  2e-5 (float32 sums in another order), exactly where scipy is matched
  exactly;
- against ``cupyimg_tpu`` (JAX on 4 of the conftest's 8 virtual CPU
  devices, each call under one ``jax.jit``): ``sharded_edge_enhance`` on
  a (2, 2) ("batch", "x") mesh and ``sharded_uniform_filter`` on a (4,)
  mesh, rtol = atol = 2e-5; and the error classes of four misuses.

Every JAX import is inside the JAX tests: the ranks import none (the world
returns what its rank 0 holds of ``jax``, ``jaxlib`` and ``cupyimg_tpu``).
The ranks import this module for their body, so its top level imports
nothing slow (``scipy.signal`` costs seconds a rank).
"""

import sys

import numpy as np
import pytest
import scipy.ndimage as sndi
import torch

MODES = ["reflect", "nearest", "constant", "wrap", "mirror"]
HALO_MODES = {"reflect": "symmetric", "nearest": "edge", "mirror": "reflect",
              "wrap": "wrap", "constant": "constant"}
SHIFT_CASES = [(order, mode) for order in (0, 1, 3)
               for mode in ("reflect", "constant", "nearest", "grid-wrap")]
AFFINE_CASES = [(order, mode) for order in (0, 1, 3)
                for mode in ("reflect", "constant", "nearest")]
ERRORS = ["halo_over_extent", "legacy_wrap", "non_dividing_axis",
          "fft2_two_axes", "placements_disagree"]


def _rs(seed):
    return np.random.RandomState(seed)


def _inputs():
    """Every case's input, from its seed (the ranks and the tests alike)."""
    r, c = np.mgrid[0:96, 0:80].astype(np.float64)
    w = _rs(5).randn(5, 7).astype(np.float32)
    w[np.abs(w) < 0.3] = 0.0
    return {
        "u1": _rs(0).randn(64, 17).astype(np.float32),
        "g2": _rs(1).randn(48, 32).astype(np.float32),
        "bs": _rs(2).randn(4, 32, 9).astype(np.float32),
        "mm": _rs(3).randn(40, 24).astype(np.float32),
        "med": _rs(4).randn(64, 19).astype(np.float32),
        "fc": _rs(5).randn(8, 24, 25).astype(np.float32),
        "fck": _rs(6).randn(5, 5).astype(np.float32),
        "corr": _rs(5).randn(48, 40).astype(np.float32),
        "corrw": w,
        "conv": _rs(6).randn(64, 21).astype(np.float32),
        "convw": _rs(7).randn(4, 3).astype(np.float32),
        "bin": _rs(7).rand(64, 33) > 0.4,
        "bin2": _rs(8).rand(32, 19) > 0.5,
        "mo": _rs(9).randn(64, 24).astype(np.float32),
        "sh": _rs(7).randn(128, 19).astype(np.float32),
        "mc": _rs(8).randn(96, 80).astype(np.float32),
        "mcc": np.stack([r + 2.0 * np.sin(c / 13.0),
                         c - 1.5 * np.cos(r / 11.0)]),
        "mce": _rs(9).randn(128, 17).astype(np.float32),
        "af": _rs(11).randn(96, 88).astype(np.float32),
        "f2": _rs(2).randn(64, 48).astype(np.float32),
        "f2t": _rs(3).randn(32, 64).astype(np.float32),
        "fs": _rs(4).randn(72, 40).astype(np.float32),
        "fsk": _rs(5).randn(9, 7).astype(np.float32),
        "l2": _rs(3).rand(64, 50) > 0.6,
        "l1": _rs(21).rand(24, 32) > 0.55,
        "lt": _rs(22).rand(40, 36) > 0.5,
        "ee": _rs(12).randn(4, 32, 24).astype(np.float32),
    }


def _label3d():
    # a snake crossing every shard boundary forces multi-round merging
    x = np.zeros((32, 9, 7), bool)
    x[:, 4, 3] = True          # vertical column through all shards
    x[::3, :, 3] = True        # combs off the column
    x[5, 1, 1] = True          # isolated voxel
    return x


def _affine(shape):
    th = np.deg2rad(2.0)
    c = np.array([(shape[0] - 1) / 2, (shape[1] - 1) / 2])
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return R, c - R @ c


def _mean3(ext):
    """A user's local 3x3 mean (torch), consuming one pad on each side."""
    acc = sum(ext[i:ext.shape[0] - 2 + i, j:ext.shape[1] - 2 + j]
              for i in range(3) for j in range(3)) / 9.0
    return torch.nn.functional.pad(acc, (1, 1, 1, 1))


def _world_body(world):
    """Rank body: every case; rank 0's results go back as numpy."""
    from cupyimg_tpu_torch import graft_entry, parallel as par
    from cupyimg_tpu_torch.models import sharded_edge_enhance
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    from torch.distributed.tensor import DTensor, Shard

    full = par.full_tensor
    a = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    m4 = world.mesh((4,), ("x",))
    m22 = world.mesh((2, 2), ("x", "y"))
    mb = world.mesh((2, 2), ("batch", "x"))
    row, col, tile = ("x", None), (None, "x"), ("x", "y")
    out = {}
    for mode in HALO_MODES:
        # every rank's block of 16 rows extended by (2, 3), stacked
        ext = par.halo_exchange(par.distribute(a["u1"], m4, row).to_local(),
                                2, 3, 0, "x", mode, cval=2.0, mesh=m4)
        out[f"halo/{mode}"] = full(DTensor.from_local(ext, m4, [Shard(0)]))
    for mode in MODES:
        out[f"uniform/{mode}"] = full(par.sharded_uniform_filter(
            a["u1"], 5, m4, row, mode=mode, cval=2.0))
    for mode in ("reflect", "wrap"):
        out[f"gaussian/{mode}"] = full(par.sharded_gaussian_filter(
            a["g2"], 1.5, m22, tile, mode=mode))
    out["batch_spatial"] = full(par.sharded_uniform_filter(
        a["bs"], (1, 5, 3), mb, ("batch", "x", None)))
    # a DTensor in: the same block layout as the array
    xd = par.distribute(a["mm"], m22, tile)
    out["minimum/tiles"] = full(par.sharded_minimum_filter(xd, 5, m22, tile))
    out["maximum/tiles"] = full(par.sharded_maximum_filter(xd, 5, m22, tile))
    out["minimum/rows"] = full(par.sharded_minimum_filter(
        a["med"], 5, m4, row, mode="nearest"))
    out["maximum/rows"] = full(par.sharded_maximum_filter(
        a["med"], (3, 5), m4, row, mode="constant", cval=0.5))
    out["median/rows"] = full(par.sharded_median_filter(
        a["med"], 3, m4, row, mode="nearest"))
    for size in ((5, 5), (7, 3)):
        out[f"median/rows{size}"] = full(par.sharded_median_filter(
            a["med"], size, m4, row))
    out["median/tiles"] = full(par.sharded_median_filter(xd, 3, m22, tile))
    for mode in ("reflect", "wrap", "constant"):
        out[f"correlate/{mode}"] = full(par.sharded_correlate(
            a["corr"], a["corrw"], m22, tile, mode=mode, cval=1.5))
    out["convolve"] = full(par.sharded_convolve(
        a["conv"], a["convw"], m4, row, mode="nearest", origin=(1, 0)))
    st = ndi.generate_binary_structure(2, 2)
    for bv in (0, 1):
        out[f"erosion/{bv}"] = full(par.sharded_binary_erosion(
            a["bin"], st, mesh=m4, spec=row, border_value=bv))
        out[f"dilation/{bv}"] = full(par.sharded_binary_dilation(
            a["bin"], st, mesh=m4, spec=row, border_value=bv))
    out["erosion/default"] = full(par.sharded_binary_erosion(
        a["bin2"], mesh=m4, spec=row))
    out["map_overlap"] = full(par.sharded_map_overlap(
        _mean3, a["mo"], 1, m4, row, mode="reflect"))
    out["fftconvolve"] = full(par.sharded_fftconvolve(
        a["fc"], a["fck"], m4, ("x", None, None)))
    for order, mode in SHIFT_CASES:
        out[f"shift/{order}/{mode}"] = full(par.sharded_shift(
            a["sh"], (2.3, -1.7), m4, row, order=order, mode=mode, cval=0.5))
    for order in (1, 3):
        out[f"map_coordinates/{order}"] = full(par.sharded_map_coordinates(
            a["mc"], a["mcc"], m22, tile, max_displacement=2.0, order=order,
            mode="reflect"))
    n0, n1 = a["mce"].shape
    r, c = np.mgrid[0:n0, 0:n1].astype(np.float64)
    out["map_coordinates/constant"] = full(par.sharded_map_coordinates(
        a["mce"], np.stack([r - 2.5, c + 1.25]), m4, row,
        max_displacement=2.5, order=1, mode="constant", cval=3.5))
    R, off = _affine(a["af"].shape)
    for order, mode in AFFINE_CASES:
        out[f"affine/{order}/{mode}"] = full(par.sharded_affine_transform(
            a["af"], R, off, m22, tile, order=order, mode=mode, cval=1.5))
    out["fft2/0"] = full(par.sharded_fft2(a["f2"], m4, row))
    out["fft2/1"] = full(par.sharded_fft2(a["f2"], m4, col))
    F = par.sharded_fft2(a["f2t"], m4, row, transposed_out=True)
    out["fft2/transposed_placements"] = [getattr(p, "dim", None)
                                          for p in F.placements]
    out["fft2/roundtrip"] = full(par.sharded_fft2(F, m4, col, inverse=True))
    for mode in ("same", "full"):
        out[f"fftconvolve2d/{mode}"] = full(
            par.sharded_fftconvolve2d_spatial(a["fs"], a["fsk"], m4, row,
                                              mode=mode))
    for name, x, mesh, spec, s in (
            ("label/cross", a["l2"], m4, row, None),
            ("label/box", a["l2"], m4, row, np.ones((3, 3))),
            ("label/3d", torch.from_numpy(_label3d()), m4,
             ("x", None, None), None),
            ("label/axis1", a["l1"], m4, col, None),
            ("label/tiles", a["lt"], m22, tile, None)):
        lab, num = par.sharded_label(x, mesh, spec, structure=s)
        out[name] = (full(lab), int(num))
    out["edge_enhance"] = full(sharded_edge_enhance(
        a["ee"], mb, ("batch", "x", None)))
    out["dryrun"] = graft_entry.dryrun_rank(world, world.size)

    def error(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 -- the class is the result
            return type(e).__name__
        return None

    z = torch.zeros(8, 8)
    out["error/halo_over_extent"] = error(
        lambda: par.sharded_uniform_filter(z, 7, m4, row))
    out["error/legacy_wrap"] = error(lambda: par.sharded_shift(
        torch.zeros(64, 8), (1.0, 0.0), m4, row, mode="wrap"))
    out["error/non_dividing_axis"] = error(
        lambda: par.sharded_label(torch.zeros(30, 8), m4, row))
    out["error/fft2_two_axes"] = error(
        lambda: par.sharded_fft2(torch.zeros(16, 16), m22, tile))
    out["error/placements_disagree"] = error(
        lambda: par.sharded_uniform_filter(xd, 3, m22, ("y", "x")))
    out["modules"] = sorted(k for k in sys.modules
                            if k.split(".")[0] in ("jax", "jaxlib",
                                                   "cupyimg_tpu"))
    return out


@pytest.fixture(scope="module")
def world():
    from cupyimg_tpu_torch.parallel import run_world

    return run_world(_world_body, 4, "cpu")


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _port(fn, *args, **kwargs):
    """The port's single-device call on CPU tensors, as numpy."""
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]
    out = fn(*args, **kwargs)
    return out.numpy() if isinstance(out, torch.Tensor) else out


def _close(got, ref, tol=2e-5):
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", list(HALO_MODES))
def test_halo_exchange(world, inputs, mode):
    x = inputs["u1"]
    kw = {"constant_values": 2.0} if mode == "constant" else {}
    padded = np.pad(x, ((2, 3), (0, 0)), HALO_MODES[mode], **kw)
    exp = np.concatenate([padded[16 * r:16 * r + 21] for r in range(4)])
    np.testing.assert_array_equal(world[f"halo/{mode}"], exp)


@pytest.mark.parametrize("mode", MODES)
def test_uniform_filter_modes(world, inputs, mode):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    x = inputs["u1"]
    got = world[f"uniform/{mode}"]
    assert got.dtype == np.float32
    _close(got, sndi.uniform_filter(x.astype(np.float64), 5, mode=mode,
                                    cval=2.0))
    _close(got, _port(ndi.uniform_filter, x, 5, mode=mode, cval=2.0,
                      dtype_mode="float"))


@pytest.mark.parametrize("mode", ["reflect", "wrap"])
def test_gaussian_on_tiles(world, inputs, mode):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    x = inputs["g2"]
    got = world[f"gaussian/{mode}"]
    _close(got, sndi.gaussian_filter(x.astype(np.float64), 1.5, mode=mode))
    _close(got, _port(ndi.gaussian_filter, x, 1.5, mode=mode,
                      dtype_mode="float"))


def test_batch_times_spatial(world, inputs):
    x = inputs["bs"]
    exp = np.stack([sndi.uniform_filter(v.astype(np.float64), size=(5, 3))
                    for v in x])
    _close(world["batch_spatial"], exp)


@pytest.mark.parametrize("case", ["minimum/tiles", "maximum/tiles",
                                  "minimum/rows", "maximum/rows"])
def test_min_max(world, inputs, case):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    kind, layout = case.split("/")
    name = f"{kind}_filter"
    if layout == "tiles":
        x, args = inputs["mm"], dict(size=5, mode="reflect")
    elif kind == "minimum":
        x, args = inputs["med"], dict(size=5, mode="nearest")
    else:
        x, args = inputs["med"], dict(size=(3, 5), mode="constant", cval=0.5)
    exp = getattr(sndi, name)(x, **args)
    np.testing.assert_array_equal(world[case], exp)
    np.testing.assert_array_equal(world[case], _port(getattr(ndi, name), x,
                                                     **args))


@pytest.mark.parametrize("case,size,mode", [
    ("median/rows", 3, "nearest"), ("median/rows(5, 5)", (5, 5), "reflect"),
    ("median/rows(7, 3)", (7, 3), "reflect"),
    ("median/tiles", 3, "reflect")])
def test_median(world, inputs, case, size, mode):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    x = inputs["mm" if case.endswith("tiles") else "med"]
    exp = sndi.median_filter(x, size=size, mode=mode)
    np.testing.assert_array_equal(world[case], exp)
    np.testing.assert_array_equal(
        world[case], _port(ndi.median_filter, x, size=size, mode=mode))


@pytest.mark.parametrize("mode", ["reflect", "wrap", "constant"])
def test_correlate_on_tiles(world, inputs, mode):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    x, w = inputs["corr"], inputs["corrw"]
    got = world[f"correlate/{mode}"]
    _close(got, sndi.correlate(x.astype(np.float64), w.astype(np.float64),
                               mode=mode, cval=1.5))
    _close(got, _port(ndi.correlate, x, w, mode=mode, cval=1.5,
                      dtype_mode="float"))


def test_convolve_origin(world, inputs):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    x, w = inputs["conv"], inputs["convw"]
    got = world["convolve"]
    _close(got, sndi.convolve(x.astype(np.float64), w.astype(np.float64),
                              mode="nearest", origin=(1, 0)))
    _close(got, _port(ndi.convolve, x, w, mode="nearest", origin=(1, 0),
                      dtype_mode="float"))


@pytest.mark.parametrize("case", ["erosion/0", "erosion/1", "dilation/0",
                                  "dilation/1", "erosion/default"])
def test_binary_morphology(world, inputs, case):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    kind, bv = case.split("/")
    name = f"binary_{kind}"
    if bv == "default":
        x, args = inputs["bin2"], {}
    else:
        x = inputs["bin"]
        args = dict(structure=sndi.generate_binary_structure(2, 2),
                    border_value=int(bv))
    exp = getattr(sndi, name)(x, **args)
    assert world[case].dtype == np.bool_
    np.testing.assert_array_equal(world[case], exp)
    np.testing.assert_array_equal(world[case],
                                  _port(getattr(ndi, name), x, **args))


def test_map_overlap_with_a_torch_function(world, inputs):
    x = inputs["mo"]
    _close(world["map_overlap"],
           sndi.uniform_filter(x.astype(np.float64), 3, mode="reflect"))


def _fftconvolve(x, k, mode):
    """numpy's float64 FFT convolution of the last two axes (scipy's
    fftconvolve, whose import costs seconds, in a few lines)."""
    full = [n + m - 1 for n, m in zip(x.shape[-2:], k.shape)]
    out = np.fft.irfft2(np.fft.rfft2(x.astype(np.float64), full)
                        * np.fft.rfft2(k.astype(np.float64), full), full)
    if mode == "full":
        return out
    starts = [(f - n) // 2 for f, n in zip(full, x.shape[-2:])]
    return out[..., starts[0]:starts[0] + x.shape[-2],
               starts[1]:starts[1] + x.shape[-1]]


def test_fftconvolve_batch_sharded(world, inputs):
    from cupyimg_tpu_torch.scipy import signal

    x, k = inputs["fc"], inputs["fck"]
    exp = _fftconvolve(x, k, "same")
    _close(world["fftconvolve"], exp, 1e-4)
    _close(world["fftconvolve"],
           _port(signal.fftconvolve, x, k[None], mode="same", axes=(1, 2)),
           1e-4)


@pytest.mark.parametrize("order,mode", SHIFT_CASES)
def test_shift(world, inputs, order, mode):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    x = inputs["sh"]
    got = world[f"shift/{order}/{mode}"]
    _close(got, sndi.shift(x.astype(np.float64), (2.3, -1.7), order=order,
                           mode=mode, cval=0.5))
    _close(got, _port(ndi.shift, x, (2.3, -1.7), order=order, mode=mode,
                      cval=0.5))


@pytest.mark.parametrize("case", ["map_coordinates/1", "map_coordinates/3",
                                  "map_coordinates/constant"])
def test_map_coordinates(world, inputs, case):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    if case.endswith("constant"):
        x = inputs["mce"]
        r, c = np.mgrid[0:x.shape[0], 0:x.shape[1]].astype(np.float64)
        coords = np.stack([r - 2.5, c + 1.25])
        args = dict(order=1, mode="constant", cval=3.5)
    else:
        x, coords = inputs["mc"], inputs["mcc"]
        args = dict(order=int(case[-1]), mode="reflect")
    got = world[case]
    _close(got, sndi.map_coordinates(x.astype(np.float64), coords, **args))
    _close(got, _port(ndi.map_coordinates, x, torch.from_numpy(coords),
                      **args))


@pytest.mark.parametrize("order,mode", AFFINE_CASES)
def test_affine_small_rotation(world, inputs, order, mode):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    x = inputs["af"]
    R, off = _affine(x.shape)
    got = world[f"affine/{order}/{mode}"]
    _close(got, sndi.affine_transform(x.astype(np.float64), R, off,
                                      order=order, mode=mode, cval=1.5),
           3e-5)
    _close(got, _port(ndi.affine_transform, x, R, off, order=order,
                      mode=mode, cval=1.5), 3e-5)


@pytest.mark.parametrize("case", ["fft2/0", "fft2/1"])
def test_fft2(world, inputs, case):
    x = inputs["f2"]
    got = world[case]
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, np.fft.fft2(x.astype(np.float64)),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, torch.fft.fft2(torch.from_numpy(
        x).to(torch.complex64)).numpy(), rtol=1e-4, atol=1e-3)


def test_fft2_transposed_out_round_trip(world, inputs):
    assert world["fft2/transposed_placements"] == [1]
    np.testing.assert_allclose(world["fft2/roundtrip"].real, inputs["f2t"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["same", "full"])
def test_fftconvolve2d_spatial(world, inputs, mode):
    from cupyimg_tpu_torch.scipy import signal

    x, k = inputs["fs"], inputs["fsk"]
    got = world[f"fftconvolve2d/{mode}"]
    _close(got, _fftconvolve(x, k, mode), 2e-4)
    _close(got, _port(signal.fftconvolve, x, k, mode=mode), 2e-4)


@pytest.mark.parametrize("case", ["label/cross", "label/box", "label/3d",
                                  "label/axis1", "label/tiles"])
def test_label_is_scipys(world, inputs, case):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    x = {"label/3d": _label3d(), "label/axis1": inputs["l1"],
         "label/tiles": inputs["lt"]}.get(case, inputs["l2"])
    s = np.ones((3, 3)) if case == "label/box" else None
    lab, num = world[case]
    exp, n = sndi.label(x, structure=s)
    assert num == n
    np.testing.assert_array_equal(lab, exp)
    plab, pnum = ndi.label(torch.from_numpy(x), structure=s)
    np.testing.assert_array_equal(lab, plab.numpy())
    assert int(pnum) == num


def test_edge_enhance_against_single_device(world, inputs):
    from cupyimg_tpu_torch.models import edge_enhance_pipeline

    x = inputs["ee"]
    exp = np.stack([edge_enhance_pipeline(torch.from_numpy(v)).numpy()
                    for v in x])
    _close(world["edge_enhance"], exp)


def test_dryrun_rank_body(world):
    out = world["dryrun"]
    assert out["edge_enhance"] == (4, 32, 24)
    assert out["median5"] == (4, 32, 24)
    shape, num = out["label"]
    assert shape == (32, 24) and num > 0
    assert out["fftconvolve2d"] == (32, 24)


@pytest.mark.parametrize("case", ERRORS)
def test_error_classes(world, case):
    want = {"legacy_wrap": "NotImplementedError"}.get(case, "ValueError")
    assert world[f"error/{case}"] == want


def test_ranks_import_no_jax(world):
    assert world["modules"] == []


def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def test_edge_enhance_against_cupyimg_tpu(world, inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cupyimg_tpu.models import sharded_edge_enhance

    mesh = _jax_mesh((2, 2), ("batch", "x"))
    spec = P("batch", "x", None)
    xg = jax.device_put(jnp.asarray(inputs["ee"]), NamedSharding(mesh, spec))
    exp = jax.jit(lambda v: sharded_edge_enhance(v, mesh, spec))(xg)
    _close(world["edge_enhance"], np.asarray(exp))


def test_uniform_filter_against_cupyimg_tpu(world, inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cupyimg_tpu import parallel

    mesh = _jax_mesh((4,), ("x",))
    spec = P("x", None)
    xg = jax.device_put(jnp.asarray(inputs["u1"]), NamedSharding(mesh, spec))
    exp = jax.jit(lambda v: parallel.sharded_uniform_filter(
        v, 5, mesh, spec, mode="reflect", cval=2.0))(xg)
    _close(world["uniform/reflect"], np.asarray(exp))


@pytest.mark.parametrize("case", ERRORS[:4])
def test_error_classes_match_cupyimg_tpu(world, case):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cupyimg_tpu import parallel

    m4 = _jax_mesh((4,), ("x",))
    calls = {
        "halo_over_extent": lambda: parallel.sharded_uniform_filter(
            jnp.zeros((8, 8)), 7, m4, P("x", None)),
        "legacy_wrap": lambda: parallel.sharded_shift(
            jnp.zeros((64, 8)), (1.0, 0.0), m4, P("x", None), mode="wrap"),
        "non_dividing_axis": lambda: parallel.sharded_label(
            jnp.zeros((30, 8)), m4, P("x", None)),
        "fft2_two_axes": lambda: parallel.sharded_fft2(
            jnp.zeros((16, 16)), _jax_mesh((2, 2), ("x", "y")),
            P("x", "y")),
    }
    with pytest.raises(Exception) as info:
        calls[case]()
    assert type(info.value).__name__ == world[f"error/{case}"]
