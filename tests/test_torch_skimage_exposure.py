"""``skimage.exposure`` of the torch port on CPU tensors: the cases of
``test_skimage_exposure_suite`` (integer and float histograms, the
equalization's CDF slope, ``intensity_range``, ``rescale_intensity``,
the gamma, log and sigmoid corrections against their numpy formulas,
``is_low_contrast``, CLAHE's invariants), numpy transcriptions
(``np.histogram``, ``np.interp`` with its edge rules,
``match_histograms``' quantile mapping) and a named list against
``cupyimg_tpu``: ``rescale_intensity`` eager (it reads the extremes on
the host), ``match_histograms``, ``clip_histogram`` and
``map_histogram`` as one jit program, and CLAHE's core as another.

Tolerances: histograms, counts and integer outputs exactly; float64
outputs within 1e-12 of ``cupyimg_tpu``'s and numpy's; CLAHE within one
grey level of 2^14 (the float32 cumulative sums of the two packages
round differently before the truncation to a level).
"""

import importlib
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.skimage.exposure as je
from cupyimg_tpu.skimage.exposure._adapthist import (
    clip_histogram as jclip,
    map_histogram as jmap,
)
from cupyimg_tpu_torch.skimage import exposure as te
from cupyimg_tpu_torch.skimage import img_as_float, img_as_ubyte
from cupyimg_tpu_torch.skimage.color import rgb2gray
from cupyimg_tpu_torch.skimage.exposure._adapthist import (
    NR_OF_GRAY,
    clip_histogram,
    map_histogram,
)
from cupyimg_tpu_torch.skimage.exposure.exposure import _interp
from cupyimg_tpu_torch.skimage.util.dtype import dtype_range


def T(x):
    return torch.from_numpy(np.array(x))


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _camera_like(shape=(256, 256), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(shape[0] // 8 + 2, shape[1] // 8 + 2))
    up = np.kron(base, np.ones((8, 8)))[: shape[0], : shape[1]]
    return (up * 220 + 10).astype(np.uint8)


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


def test_integer_histograms_of_the_suite():
    with pytest.raises(ValueError):
        te.histogram(T(np.array([-1, 100], np.int8)), source_range="foobar")
    for values, dtype, source, centers in (
            ([-1, 100], np.int8, "image", np.arange(-1, 101)),
            ([-100, -1], np.int8, "image", np.arange(-100, 0)),
            ([10, 100], np.uint8, "dtype", np.arange(0, 256)),
            ([10, 100], np.int8, "dtype", np.arange(-128, 128)),
            ([10, 10], np.uint16, "image", np.arange(10, 11)),
            ([7, 65535], np.uint16, "image", np.arange(7, 65536))):
        im = np.array(values, dtype)
        hist, c = te.histogram(T(im), source_range=source)
        np.testing.assert_array_equal(H(c), centers)
        want = np.bincount(im.astype(np.int64) - centers[0],
                           minlength=centers.size)
        np.testing.assert_array_equal(H(hist), want)
        assert hist.dtype == torch.int64
    hist, c = te.histogram(T(np.array([0, 255, 255], np.uint8)),
                           normalize=True)
    expected = np.zeros(256)
    expected[0], expected[255] = 1 / 3, 2 / 3
    np.testing.assert_array_almost_equal(H(hist), expected)
    with pytest.warns(UserWarning, match="color image"):
        te.histogram(torch.zeros((4, 4, 3), dtype=torch.uint8))


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
@pytest.mark.parametrize("source", ["image", "dtype"])
def test_float_histograms_match_numpy(dtype, source):
    rng = np.random.default_rng(1)
    im = (rng.random((31, 17)) * 1.6 - 0.8).astype(dtype)
    nbins = 10 if source == "dtype" else 37
    hist, centers = te.histogram(T(im), nbins, source_range=source)
    rng_ = (float(im.min()), float(im.max())) if source == "image" else (
        -1, 1)
    want, edges = np.histogram(im.ravel(), nbins, range=rng_)
    np.testing.assert_array_equal(H(hist), want)
    np.testing.assert_allclose(H(centers), (edges[:-1] + edges[1:]) / 2,
                               rtol=1e-6)


def test_cumulative_distribution_and_interp():
    img = _camera_like(seed=1)
    cdf, centers = te.cumulative_distribution(T(img))
    h = np.bincount(img.ravel() - img.min())
    np.testing.assert_array_equal(H(cdf), np.cumsum(h) / h.sum())
    np.testing.assert_array_equal(H(centers), np.arange(img.min(),
                                                        img.max() + 1))
    xp = np.array([0.0, 1.0, 1.0, 2.5, 4.0, 7.0])
    fp = np.array([3.0, -1.0, 2.0, 2.0, 5.0, 0.5])
    x = np.array([-3, 0, 0.5, 1.0, 1.5, 2.5, 3.0, 4.0, 6.9, 7.0, 8.0,
                  np.inf, -np.inf])
    np.testing.assert_array_equal(H(_interp(T(x), T(xp), T(fp))),
                                  np.interp(x, xp, fp))
    rng = np.random.default_rng(2)
    xs = np.sort(rng.random(50))
    q = rng.random(400) * 1.4 - 0.2
    fs = rng.standard_normal(50)
    np.testing.assert_array_equal(H(_interp(T(q), T(xs), T(fs))),
                                  np.interp(q, xs, fs))


def _check_cdf_slope(cdf):
    slope, _ = np.polyfit(np.linspace(0, 1, len(cdf)), H(cdf), 1)
    assert 0.9 < slope < 1.1


def _test_img():
    img = img_as_float(T(_camera_like(seed=1)))
    return te.rescale_intensity(img / 5.0 + 100)


def test_equalize_cases_of_the_suite():
    a = te.equalize_hist(T(_camera_like(seed=1)))
    b = te.equalize_hist(T(_camera_like(seed=1)), nbins=3)
    np.testing.assert_allclose(H(a), H(b))
    img_eq = te.equalize_hist(img_as_ubyte(_test_img()))
    _check_cdf_slope(te.cumulative_distribution(img_eq)[0])
    img = img_as_float(_test_img())
    img_eq = te.equalize_hist(img)
    _check_cdf_slope(te.cumulative_distribution(img_eq)[0])
    mask = np.zeros(img.shape)
    mask[50:150, 50:150] = 1
    masked = te.equalize_hist(img, mask=T(mask))
    _check_cdf_slope(te.cumulative_distribution(masked)[0])
    assert not bool(torch.all(img_eq == masked))
    assert masked.dtype == torch.float64


def test_equalize_matches_numpy():
    """skimage's equalization in numpy: the CDF of the masked pixels,
    np.interp at every pixel."""
    rng = np.random.default_rng(3)
    img = rng.random((40, 30))
    mask = rng.random(img.shape) > 0.5
    h, e = np.histogram(img[mask], 64, range=(img[mask].min(),
                                              img[mask].max()))
    cdf = np.cumsum(h) / h.sum()
    want = np.interp(img.ravel(), (e[:-1] + e[1:]) / 2, cdf).reshape(
        img.shape)
    np.testing.assert_allclose(H(te.equalize_hist(T(img), 64, T(mask))),
                               want, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# intensity_range and rescale_intensity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("test_input, expected", [
    ("image", [0, 1]), ("dtype", [0, 255]), ((10, 20), [10, 20])])
def test_intensity_range_uint8(test_input, expected):
    out = te.intensity_range(T(np.array([0, 1], np.uint8)),
                             range_values=test_input)
    np.testing.assert_array_equal(out, expected)


@pytest.mark.parametrize("test_input, expected", [
    ("image", [0.1, 0.2]), ("dtype", [-1, 1]), ((0.3, 0.4), [0.3, 0.4])])
def test_intensity_range_float(test_input, expected):
    out = te.intensity_range(T(np.array([0.1, 0.2])),
                             range_values=test_input)
    np.testing.assert_array_almost_equal(out, expected)


def test_rescale_cases_of_the_suite():
    u8 = T(np.array([51, 102, 153], np.uint8))
    out = te.rescale_intensity(u8)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(H(out), [0, 127, 255])
    f = T(np.array([51.0, 102.0, 153.0]))
    np.testing.assert_array_almost_equal(H(te.rescale_intensity(f)),
                                         [0, 0.5, 1])
    np.testing.assert_array_almost_equal(
        H(te.rescale_intensity(f, in_range=(0, 255))), [0.2, 0.4, 0.6])
    np.testing.assert_array_almost_equal(
        H(te.rescale_intensity(f, in_range=(0, 102))), [0.5, 1, 1])
    out = te.rescale_intensity(T(np.array([-10, 0, 10], np.int8)),
                               out_range=(0, 127))
    assert out.is_floating_point()
    np.testing.assert_array_almost_equal(H(out), [0, 63.5, 127])
    u16 = np.array([0, 1023, 1123], np.uint16)
    np.testing.assert_array_almost_equal(
        H(te.rescale_intensity(T(u16), "uint10")), [0, 65535, 65535])
    top = T(np.array([0, 65535], np.uint16))
    for name, limit in (("uint10", 1023), ("uint12", 4095),
                        ("uint14", 16383)):
        out = te.rescale_intensity(top, out_range=name)
        assert out.dtype == torch.uint16
        np.testing.assert_array_equal(H(out), [0, limit])
    zeros = torch.zeros((10, 10), dtype=torch.uint8)
    np.testing.assert_array_equal(H(te.rescale_intensity(zeros)), 0)
    np.testing.assert_array_equal(
        H(te.rescale_intensity(T(np.array([130, 130], np.uint16)),
                               out_range=(0, 127))), [127, 127])
    i8 = T(np.array([-128, 0, 127], np.int8))
    for out_range, dtype in (("uint8", torch.uint8), ("uint10", torch.uint16),
                             ("uint12", torch.uint16),
                             ("uint16", torch.uint16),
                             ("float", torch.float64)):
        assert te.rescale_intensity(i8, out_range=out_range).dtype == dtype
    np.testing.assert_array_equal(H(te.rescale_intensity(i8, out_range=(
        0, 255))), [0, 128, 255])
    np.testing.assert_array_equal(
        H(te.rescale_intensity(i8, out_range=np.uint8)), [0, 128, 255])
    with pytest.raises(ValueError):
        te.rescale_intensity(i8, out_range="flat")
    with pytest.warns(UserWarning, match="NaN"):
        te.rescale_intensity(T(np.array([np.nan, 0.5])), in_range="image")


def test_rescale_matches_numpy():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4096, (23, 19)).astype(np.uint16)
    got = te.rescale_intensity(T(x), in_range=(100, 4000))
    want = ((np.clip(x.astype(np.float64), 100, 4000) - 100) / 3900
            * 65535).astype(np.uint16)
    np.testing.assert_array_equal(H(got), want)
    f = rng.random((9, 8)) * 3 - 1
    got = te.rescale_intensity(T(f), out_range=(-2.0, 5.0))
    want = (f - f.min()) / (f.max() - f.min()) * 7 - 2
    np.testing.assert_allclose(H(got), want, rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# gamma, log, sigmoid, is_low_contrast
# ---------------------------------------------------------------------------

RAMP = np.arange(0, 255, 4, np.uint8).reshape((8, 8))
X = RAMP.astype(np.float64) / 255


@pytest.mark.parametrize("call, expected", [
    (lambda: te.adjust_gamma(T(RAMP), 0.5), (X ** 0.5 * 255)),
    (lambda: te.adjust_gamma(T(RAMP), 2), (X ** 2 * 255)),
    (lambda: te.adjust_log(T(RAMP), 1), np.log2(1 + X) * 255),
    (lambda: te.adjust_log(T(RAMP), 1, True), (2 ** X - 1) * 255),
    (lambda: te.adjust_sigmoid(T(RAMP), 1, 5),
     255 / (1 + np.exp(5 * (1 - X)))),
    (lambda: te.adjust_sigmoid(T(RAMP), 0, 10),
     255 / (1 + np.exp(10 * (0 - X)))),
    (lambda: te.adjust_sigmoid(T(RAMP), 0.5, 10),
     255 / (1 + np.exp(10 * (0.5 - X)))),
    (lambda: te.adjust_sigmoid(T(RAMP), 0.5, 10, True),
     (1 - 1 / (1 + np.exp(10 * (0.5 - X)))) * 255),
])
def test_corrections_match_numpy(call, expected):
    out = call()
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(H(out), expected.astype(np.uint8))


def test_corrections_of_the_suite():
    for fn, args in ((te.adjust_gamma, (1.5,)), (te.adjust_log, (1,)),
                     (te.adjust_sigmoid, (1, 5))):
        assert fn(torch.ones((1, 1)), *args).shape == (1, 1)
    image = T(np.random.default_rng(8).uniform(0, 255, (8, 8)))
    np.testing.assert_array_almost_equal(H(te.adjust_gamma(image, 1)),
                                         H(image))
    np.testing.assert_array_almost_equal(H(te.adjust_gamma(image, 0)),
                                         dtype_range[np.float64][1])
    with pytest.raises(ValueError):
        te.adjust_gamma(T(RAMP), -1)
    with pytest.raises(ValueError):
        te.adjust_gamma(T(np.arange(-10, 245, 4).reshape((8, 8)).astype(
            np.double)))
    u16 = T(RAMP.astype(np.uint16) * 257)
    assert te.adjust_gamma(u16, 2).dtype == torch.uint16
    f32 = T(X.astype(np.float32))
    assert te.adjust_log(f32).dtype == torch.float32
    np.testing.assert_allclose(H(te.adjust_log(f32)), np.log2(1 + X),
                               rtol=1e-6)


def test_is_low_contrast_of_the_suite():
    image = np.linspace(0, 0.04, 100)
    assert te.is_low_contrast(T(image))
    image[-1] = 1
    assert te.is_low_contrast(T(image))
    assert not te.is_low_contrast(T(image), upper_percentile=100)
    u8 = (image * 255).astype(np.uint8)
    assert te.is_low_contrast(T(u8))
    assert not te.is_low_contrast(T(u8), upper_percentile=100)
    u16 = u8.astype(np.uint16) * 2 ** 8
    assert te.is_low_contrast(T(u16))
    assert not te.is_low_contrast(T(u16), upper_percentile=100)
    rgb = np.dstack([np.linspace(0, 1, 64).reshape(8, 8)] * 3)
    assert not te.is_low_contrast(T(rgb))
    assert te.is_low_contrast(T(rgb * 0.01))


# ---------------------------------------------------------------------------
# CLAHE and match_histograms
# ---------------------------------------------------------------------------


def test_adapthist_invariants_of_the_suite():
    img = img_as_float(T(_camera_like((128, 128), seed=2)))
    img3 = torch.stack([img] * 3, -1)
    adapted = te.equalize_adapthist(img3, kernel_size=(37, 31),
                                    clip_limit=0.01, nbins=128)
    assert adapted.shape == img3.shape
    assert float(adapted.min()) >= 0 and float(adapted.max()) <= 1
    assert float(rgb2gray(adapted).std()) > 0.5 * float(
        rgb2gray(te.rescale_intensity(img3)).std())
    rng = np.random.default_rng(3)
    u16 = T((rng.uniform(size=(64, 64, 3)) * 65535).astype(np.uint16))
    adapted = te.equalize_adapthist(u16, clip_limit=0.01)
    assert float(adapted.min()) == 0 and float(adapted.max()) == 1.0
    assert adapted.shape == u16.shape
    rgba = torch.cat([img3[:32, :32], torch.ones((32, 32, 1),
                                                 dtype=torch.float64)], -1)
    assert te.equalize_adapthist(rgba).shape == (32, 32, 3)
    img2d = img_as_float(T(_camera_like((34, 34), seed=5)))
    img3d = torch.stack([img2d] * 34)
    a2 = te.equalize_adapthist(img2d, kernel_size=5, clip_limit=0.05)
    a3 = te.equalize_adapthist(img3d, kernel_size=5, clip_limit=0.05)
    assert a2.shape == img2d.shape and a3.shape == img3d.shape
    assert float((a2 - a3[17]).abs().mean()) < 0.02
    for const in (torch.full((8, 8), 2, dtype=torch.uint16),
                  torch.full((8, 8), 0.1, dtype=torch.float64)):
        out = te.equalize_adapthist(const, 3)
        assert float(out.min()) == float(out.max())
    u = T(_camera_like((64, 64), seed=7))
    for x in (u, img_as_float(u)):
        assert torch.equal(te.equalize_adapthist(x, clip_limit=0),
                           te.equalize_adapthist(x, clip_limit=1))
    with pytest.raises(ValueError):
        te.equalize_adapthist(u, kernel_size=(3, 3, 3))


def test_adapthist_borders_of_the_suite():
    img = img_as_float(T(_camera_like((128, 128), seed=6))) / 100.0
    img[64, 64] = 1.0
    for kernel_size in (25, 35):
        adapted = te.equalize_adapthist(img, kernel_size, clip_limit=0.5)
        assert abs(float(adapted[:, -1].mean() - img[:, -1].mean())) > 0.1
        assert abs(float(adapted[-1].mean() - img[-1].mean())) > 0.1


def test_adapthist_matches_cupyimg_tpu():
    """CLAHE's core (``_clahe``, levels of 2^14) against cupyimg_tpu's as
    one jit program, within one level; the public call against its
    definition around the port's core (``img_as_uint``, levels,
    ``_clahe``, ``img_as_float`` and the stretch) in numpy, exactly."""
    from cupyimg_tpu.skimage.exposure._adapthist import _clahe as jclahe
    from cupyimg_tpu_torch.skimage.exposure._adapthist import _clahe

    rng = np.random.default_rng(6)
    u16 = (np.kron(rng.random((8, 6)), np.ones((8, 8))) * 60000
           + rng.random((64, 48)) * 5000).astype(np.uint16)
    levels = np.round((u16 - u16.min()) / float(u16.max() - u16.min())
                      * (NR_OF_GRAY - 1)).astype(np.int32)
    core = H(_clahe(T(levels), [8, 6], 0.01, 256))
    want = np.asarray(jax.jit(lambda x: jclahe(x, [8, 6], 0.01, 256))(
        jnp.asarray(levels)))
    assert core.dtype == want.dtype
    diff = np.abs(core.astype(np.uint16).astype(np.int64)
                  - want.astype(np.uint16))
    assert diff.max() <= 1
    out = core.astype(np.uint16) / 65535.0
    out = (out - out.min()) / (out.max() - out.min())
    got = te.equalize_adapthist(T(u16))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(H(got), out, rtol=0, atol=1e-15)


def _np_match(src, tmpl):
    s = np.sort(src.ravel())
    q = np.searchsorted(s, src.ravel(), side="right") / src.size
    t = np.sort(tmpl.ravel()).astype(np.float64)
    return np.interp(q, np.arange(1, t.size + 1) / t.size, t).reshape(
        src.shape)


def test_match_histograms_matches_numpy():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 50, (20, 21, 3)).astype(np.uint8)
    ref = (rng.random((17, 16, 3)) * 10).astype(np.float32)
    got = te.match_histograms(T(img), T(ref), channel_axis=-1)
    assert got.dtype == torch.float64
    want = np.stack([_np_match(img[..., c], ref[..., c]) for c in range(3)],
                    -1)
    np.testing.assert_allclose(H(got), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(H(te.match_histograms(T(img[..., 0]),
                                                     T(ref[..., 1]))),
                               _np_match(img[..., 0], ref[..., 1]), atol=1e-12)
    u16 = rng.integers(0, 65536, (9, 9)).astype(np.uint16)
    np.testing.assert_allclose(H(te.match_histograms(T(u16), T(u16[::-1]))),
                               _np_match(u16, u16[::-1]), atol=1e-12)
    with pytest.raises(ValueError):
        te.match_histograms(T(img), T(ref[..., 0]))
    with pytest.raises(ValueError):
        te.match_histograms(T(img), T(ref[..., :2]), multichannel=True)


def test_clip_and_map_histogram():
    """clip_histogram conserves the mass and respects the limit."""
    rng = np.random.default_rng(8)
    hist = np.floor(rng.exponential(20, (6, 64)) ** 1.3)
    hist[0, :4] = [900, 0, 0, 0]
    got = clip_histogram(T(hist), 40.0)
    assert float(got.max()) <= 40.0
    np.testing.assert_allclose(H(got.sum(-1)), np.minimum(
        hist.sum(-1), 40.0 * 64))
    lut = map_histogram(got, 10, 200, 6400)
    want = np.minimum(np.cumsum(H(got), -1) * 190 / 6400 + 10, 200)
    np.testing.assert_array_equal(H(lut), want.astype(np.int64))


def test_calls_match_cupyimg_tpu():
    """rescale_intensity eager as cupyimg_tpu runs it (it reads the
    extremes on the host); match_histograms, clip_histogram (a
    while_loop there, a host-tested loop here) and map_histogram as one
    jit program.  (histogram and equalize_hist: against numpy above;
    cupyimg_tpu counts float histograms in float64, the port in int64 as
    numpy.)"""
    rng = np.random.default_rng(10)
    i16 = rng.integers(-300, 900, (30, 20)).astype(np.int16)
    got = te.rescale_intensity(T(i16), out_range="uint8")
    want = je.rescale_intensity(jnp.asarray(i16), out_range="uint8")
    np.testing.assert_array_equal(H(got), np.asarray(want))
    tmpl = rng.random((25, 24, 3))
    src = rng.random((30, 20, 3)).astype(np.float32)
    hist = np.floor(rng.exponential(20, (6, 64)) ** 1.3)
    hist[0, :4] = [900, 0, 0, 0]

    @jax.jit
    def ref(a, b, h):
        c = jclip(h, 40.0)
        return (je.match_histograms(a, b, channel_axis=-1), c,
                jmap(c, 10, 200, 6400))

    matched, clipped, lut = ref(jnp.asarray(src), jnp.asarray(tmpl),
                                jnp.asarray(hist))
    np.testing.assert_allclose(
        H(te.match_histograms(T(src), T(tmpl), channel_axis=-1)),
        np.asarray(matched), rtol=0, atol=1e-12)
    got = clip_histogram(T(hist), 40.0)
    np.testing.assert_array_equal(H(got), np.asarray(clipped))
    np.testing.assert_array_equal(H(map_histogram(got, 10, 200, 6400)),
                                  np.asarray(lut))


MODULES = ["skimage.exposure", "skimage.exposure.exposure",
           "skimage.exposure.histogram_matching",
           "skimage.exposure._adapthist"]


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_cupyimg_tpu(name):
    jmod = importlib.import_module("cupyimg_tpu." + name)
    tmod = importlib.import_module("cupyimg_tpu_torch." + name)

    def public(mod):
        if hasattr(mod, "__all__"):
            return set(mod.__all__)
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    own = {"annotations", "np", "jnp", "jax", "lax", "itertools", "math",
           "numbers", "warnings", "torch"}
    assert (public(jmod) - own) - public(tmod) == set()
    for helper in ("clip_histogram", "map_histogram", "DTYPE_RANGE",
                   "intensity_range"):
        if hasattr(jmod, helper):
            assert hasattr(tmod, helper)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        te.histogram(torch.zeros(4, dtype=torch.uint8))
