"""``skimage.util`` of the torch port on CPU tensors: the dtype
conversions (the cases of ``test_skimage_dtype_suite``; every (input,
output) pair against ``_np_convert``, skimage's rules written here in
numpy; and a named list of nine pairs against ``cupyimg_tpu``'s
``_convert`` as one jit program), ``view_as_blocks``/``view_as_windows``
(``test_skimage_shape_block_suite``'s values, and numpy's
``sliding_window_view`` over shapes and steps), ``invert`` and
``map_array``/``ArrayMap`` (``test_skimage_invert_maparray_suite``) and
``random_noise`` by its statistics (``test_skimage_noise_suite``): clip
bounds, dtypes, salt and pepper fractions within a binomial 5-sigma band,
gaussian mean and variance within 5 sigma, poisson's scaling, the error
classes, and the same output for the same seed.  No skimage is installed
here, so the skimage layer is held against ``cupyimg_tpu`` and the
suites' expected values.

Tolerances: conversions exactly, dtype included; views and maps
exactly.
"""

import itertools
import warnings

import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view
from numpy.testing import assert_array_equal

import jax
import jax.numpy as jnp

import cupyimg_tpu.skimage.util as jutil
from cupyimg_tpu.skimage.util.dtype import _convert as jconvert
from cupyimg_tpu_torch.skimage import (
    dtype_limits,
    img_as_bool,
    img_as_float,
    img_as_float32,
    img_as_float64,
    img_as_int,
    img_as_ubyte,
    img_as_uint,
)
from cupyimg_tpu_torch.skimage.util import (
    ArrayMap,
    invert,
    map_array,
    random_noise,
    view_as_blocks,
    view_as_windows,
)
from cupyimg_tpu_torch.skimage.util.dtype import _convert, convert, dtype_range


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# dtype
# ---------------------------------------------------------------------------

RANGE = {np.uint8: (0, 255), np.uint16: (0, 65535), np.int8: (-128, 127),
         np.int16: (-32768, 32767), np.float32: (-1.0, 1.0),
         np.float64: (-1.0, 1.0)}
FUNCS = [(img_as_int, np.int16), (img_as_float64, np.float64),
         (img_as_float32, np.float32), (img_as_uint, np.uint16),
         (img_as_ubyte, np.uint8)]


@pytest.mark.parametrize("dtype, f_and_dt",
                         list(itertools.product(RANGE, FUNCS)))
def test_range(dtype, f_and_dt):
    imin, imax = RANGE[dtype]
    x = T(np.linspace(imin, imax, 10).astype(dtype))
    f, dt = f_and_dt
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        y = f(x).numpy()
    omin, omax = RANGE[dt]
    if imin == 0 or omin == 0:
        omin = 0
    assert y[0] == omin and y[-1] == omax and y.dtype == np.dtype(dt)


EXTRA = {**RANGE, np.int32: (-2147483648, 2147483647),
         np.uint32: (0, 4294967295)}


@pytest.mark.parametrize("dtype_in, dt", [
    (np.uint8, np.uint32), (np.int8, np.uint32), (np.int8, np.int32),
    (np.int32, np.int8), (np.float64, np.float32), (np.int32, np.float32)])
def test_range_extra_dtypes(dtype_in, dt):
    imin, imax = EXTRA[dtype_in]
    y = _convert(T(np.linspace(imin, imax, 10).astype(dtype_in)), dt).numpy()
    omin, omax = EXTRA[dt]
    assert y[0] == omin and y[-1] == omax and y.dtype == np.dtype(dt)


_TYPES = [np.bool_, np.uint8, np.int8, np.uint16, np.int16, np.uint32,
          np.int32, np.uint64, np.int64, np.float16, np.float32, np.float64]


def _sample(dtype, rng):
    if np.dtype(dtype).kind == "f":
        x = (rng.random(40) * 2 - 1).astype(dtype)
        x[:3] = [-1, 1, 0]
    elif dtype == np.bool_:
        x = rng.random(40) > 0.5
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, 40, dtype=dtype, endpoint=True)
        x[:2] = [info.min, info.max]
    return x


def _bits(kind, b):
    return np.dtype(kind + str(next(
        i for i in (1, 2, 4, 8)
        if b < i * 8 or (b == i * 8 and kind == "u"))))


def _np_saturate(y, dout):
    """Integral floats to an integer type, saturating at its limits (NaN
    gives 0): where numpy's cast is undefined, as XLA's and the port's."""
    lo, hi = np.iinfo(dout).min, np.iinfo(dout).max
    yf = y.astype(np.float64)
    top, bottom = yf >= hi, yf <= lo
    safe = np.where(top | bottom | np.isnan(yf), 0, yf).astype(dout)
    return np.where(top, dout.type(hi), np.where(bottom, dout.type(lo),
                                                 safe))


def _np_scale(a, n, m, kind):
    """skimage's ``_scale`` in numpy (the definition the port follows)."""
    bits = _bits
    if n == m:
        return a
    if n > m:
        if (int(a.max()) if a.size else 0) < 2 ** m:
            return a.astype(bits(kind, m))
        return (a // 2 ** (n - m)).astype(bits(kind, m))
    if m % n == 0:
        return a.astype(bits(kind, m)) * ((2 ** m - 1) // (2 ** n - 1))
    o = (m // n + 1) * n
    b = a.astype(bits(kind, o)) * ((2 ** o - 1) // (2 ** n - 1))
    return (b // 2 ** (o - m)).astype(bits(kind, m))


def _np_convert(image, dtype, uniform=False):
    """skimage's ``_convert`` in numpy, as ``cupyimg_tpu``'s."""
    din, dout = image.dtype, np.dtype(dtype)
    if din == dout:
        return image
    kin, kout = din.kind, dout.kind
    if kout == "b":
        return image > din.type(dtype_range[din.type][1] / 2)
    if kin == "b":
        r = image.astype(dout)
        return r if kout == "f" else r * dout.type(dtype_range[dout.type][1])
    if kin == "f":
        if kout == "f":
            return image.astype(dout)
        ct = next(t for t in (din, np.float32, np.float64)
                  if np.dtype(t).itemsize >= dout.itemsize)
        x = image.astype(ct)
        lo, hi = np.iinfo(dout).min, np.iinfo(dout).max
        if not uniform:
            y = x * hi if kout == "u" else x * ((hi - lo) / 2) - 0.5
            y = np.rint(y)
        elif kout == "u":
            y = x * (hi + 1)
        else:
            y = np.floor(x * ((hi - lo + 1.0) / 2.0))
        return _np_saturate(np.clip(y, lo, hi), dout)
    if kout == "f":
        ct = next(t for t in (dout, np.float32, np.float64)
                  if np.dtype(t).itemsize >= din.itemsize)
        info = np.iinfo(din)
        if kin == "u":
            return (image.astype(ct) * (1.0 / info.max)).astype(dout)
        return ((image.astype(ct) + 0.5)
                * (2 / (info.max - info.min))).astype(dout)
    if kin == "u":
        if kout == "i":
            return _np_scale(image, 8 * din.itemsize,
                             8 * dout.itemsize - 1, "u").astype(dout)
        return _np_scale(image, 8 * din.itemsize, 8 * dout.itemsize,
                         "u").astype(dout)
    if kout == "u":
        y = _np_scale(image, 8 * din.itemsize - 1, 8 * dout.itemsize, "i")
        return np.maximum(y, 0).astype(dout)
    if din.itemsize > dout.itemsize:
        return _np_scale(image, 8 * din.itemsize - 1,
                         8 * dout.itemsize - 1, "i").astype(dout)
    y = image.astype(_bits("i", 8 * dout.itemsize))
    y = y - np.iinfo(din).min
    y = _np_scale(y, 8 * din.itemsize, 8 * dout.itemsize, "i")
    return (y.astype(np.int64) + np.iinfo(dout).min).astype(dout)


@pytest.mark.parametrize("dtype_in", _TYPES)
def test_every_conversion_matches_skimage_rules(dtype_in):
    """Every (input, output) pair, ``uniform`` both ways, exactly as
    skimage's rules in numpy (``_np_convert``); where numpy has no type
    for the arithmetic (int to int64, int32 to uint64) both raise, and
    where a float result leaves the integer range (a float bound that
    rounds past the limit, float16's overflow) both saturate."""
    rng = np.random.default_rng(_TYPES.index(dtype_in))
    x = _sample(dtype_in, rng)
    for dtype_out, uniform in itertools.product(_TYPES, (False, True)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                want = _np_convert(x, dtype_out, uniform)
            except StopIteration:
                with pytest.raises((StopIteration, RuntimeError)):
                    _convert(T(x), dtype_out, uniform=uniform)
                continue
            got = _convert(T(x), dtype_out, uniform=uniform).numpy()
        assert got.dtype == want.dtype, (dtype_out, uniform)
        assert_array_equal(got, want, err_msg=f"{dtype_out} {uniform}")


def test_named_conversions_match_cupyimg_tpu():
    """A short named list against ``cupyimg_tpu``'s ``_convert`` on
    JAX-CPU (x64), as one jit program (its traced path always scales, so
    the inputs exceed every downcast's range)."""
    rng = np.random.default_rng(8)
    u8 = _sample(np.uint8, rng)
    i16 = _sample(np.int16, rng)
    u16 = _sample(np.uint16, rng)
    f32 = _sample(np.float32, rng)
    pairs = [(u8, np.float32, False), (u8, np.uint16, False),
             (u8, np.int16, False), (i16, np.uint8, False),
             (i16, np.float64, False), (u16, np.int8, False),
             (f32, np.uint8, False), (f32, np.int16, True),
             (u16, np.bool_, False)]

    @jax.jit
    def jax_calls(u8, i16, u16, f32):
        src = {np.uint8: u8, np.int16: i16, np.uint16: u16,
               np.float32: f32}
        return [jconvert(src[x.dtype.type], dt, uniform=uni)
                for x, dt, uni in pairs]

    want = jax_calls(u8, i16, u16, f32)
    for (x, dt, uni), w in zip(pairs, want):
        got = _convert(T(x), dt, uniform=uni).numpy()
        assert got.dtype == np.asarray(w).dtype
        assert_array_equal(got, np.asarray(w))


def test_downcast_and_errors():
    with pytest.warns(UserWarning, match="Downcasting uint64 to int16"):
        y = img_as_int(T(np.arange(10).astype(np.uint64)))
    assert_array_equal(y.numpy(), np.arange(10))
    assert y.dtype == torch.int16
    for v in (2, -2):
        with pytest.raises(ValueError):
            img_as_int(T(np.array([v], np.float32)))
    with pytest.raises(ValueError):
        _convert(T(np.ones(3, np.complex64)), np.float32)
    with pytest.raises(ValueError):
        img_as_float(T(np.ones(3, np.complex128)))
    with pytest.warns(FutureWarning):
        assert convert(T(np.array([255], np.uint8)), np.float32) == 1.0


def test_float_passthrough_copy_bool_and_limits():
    a = T(np.array([[-10.0, 10.0, 1e20]], np.float32))
    assert img_as_float(a) is a
    c = img_as_float(a, force_copy=True)
    assert c is not a and torch.equal(c, a)
    y = img_as_float32(T(np.array([-128, 127], np.int8)))
    assert float(y.max()) == 1.0
    img = np.zeros((10, 10), bool)
    img[1, 1] = True
    for func, dt in [(img_as_int, np.int16), (img_as_float, np.float64),
                     (img_as_uint, np.uint16), (img_as_ubyte, np.uint8)]:
        out = func(T(img))
        assert out.numpy().dtype == np.dtype(dt)
        assert float(out.double().sum()) == (1.0 if dt == np.float64
                                             else dtype_range[dt][1])
    assert img_as_bool(T(np.array([0.2, 0.7]))).tolist() == [False, True]
    for t, limits in dtype_range.items():
        got = dtype_limits(T(np.zeros(1, t)))
        assert got == limits
    assert dtype_limits(T(np.zeros(1, np.int8)), clip_negative=True) == (
        0, 127)
    for dt_in in (float, np.double, np.single, "float32", "float64"):
        for dt_out in (float, np.double, np.single, "float32", "float64"):
            x = T(np.array([-1, 1]).astype(dt_in))
            assert _convert(x, dt_out).numpy().dtype == np.dtype(dt_out)


# ---------------------------------------------------------------------------
# view_as_blocks / view_as_windows
# ---------------------------------------------------------------------------


def test_view_as_blocks_suite():
    a = T(np.arange(10))
    for block, err in (([5], TypeError), ((-2,), ValueError),
                       ((11,), ValueError), ((2, 2), ValueError),
                       ((3,), ValueError)):
        with pytest.raises(err):
            view_as_blocks(a, block)
    assert_array_equal(view_as_blocks(a, (5,)).numpy(),
                       [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]])
    B = view_as_blocks(T(np.arange(16).reshape(4, 4)), (2, 2))
    assert_array_equal(B[0, 1].numpy(), [[2, 3], [6, 7]])
    assert int(B[1, 0, 1, 1]) == 13
    A = T(np.arange(4 * 4 * 6).reshape(4, 4, 6))
    B = view_as_blocks(A, (1, 2, 2))
    assert B.shape == (4, 2, 3, 1, 2, 2)
    assert_array_equal(B[2:, 0, 2].numpy(),
                       [[[[52, 53], [58, 59]]], [[[76, 77], [82, 83]]]])
    assert B.data_ptr() == A.data_ptr()  # a view


def test_view_as_windows_suite():
    a = T(np.arange(10))
    with pytest.raises(TypeError):
        view_as_windows([1, 2, 3, 4, 5], (2,))
    for win, kw in (((2, 2), {}), ((-1,), {}), ((11,), {}),
                    ((11,), {"step": 0.9}), ((3,), {"step": (1, 1)})):
        with pytest.raises(ValueError):
            view_as_windows(a, win, **kw)
    assert_array_equal(view_as_windows(a, (3,)).numpy(),
                       sliding_window_view(np.arange(10), 3))
    A = np.arange(20).reshape(5, 4)
    B = view_as_windows(T(A), (4, 3))
    assert B.shape == (2, 2, 4, 3)
    assert_array_equal(B.numpy(), sliding_window_view(A, (4, 3)))
    assert_array_equal(
        view_as_windows(T(A), 2, step=2).numpy(),
        [[[[0, 1], [4, 5]], [[2, 3], [6, 7]]],
         [[[8, 9], [12, 13]], [[10, 11], [14, 15]]]])
    assert view_as_windows(T(A), 2, step=4).shape == (1, 1, 2, 2)


@pytest.mark.parametrize("shape", [(9,), (7, 8), (5, 6, 7)])
@pytest.mark.parametrize("step", [1, 2, 3])
def test_view_as_windows_matches_numpy(shape, step):
    x = np.random.default_rng(len(shape)).random(shape)
    win = tuple(range(2, 2 + len(shape)))
    sl = tuple(slice(None, None, step) for _ in shape)
    ref = sliding_window_view(x, win)[sl]
    got = view_as_windows(T(x), win, step=step)
    assert got.shape == ref.shape
    assert_array_equal(got.numpy(), ref)
    blocks = tuple(1 if n % 2 else 2 for n in shape)
    vb = view_as_blocks(T(x), blocks)
    inter = x.reshape([v for n, b in zip(shape, blocks) for v in (n // b, b)])
    nd = len(shape)
    assert_array_equal(vb.numpy(), inter.transpose(
        list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))))


# ---------------------------------------------------------------------------
# invert, map_array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bool", "uint8", "uint16", "uint32",
                                   "uint64", "int8", "int16", "int32",
                                   "int64", "float32", "float64"])
def test_invert_matches_the_suite(dtype):
    image = np.zeros((3, 3), dtype=dtype)
    lo, hi = dtype_limits(T(image))
    if dtype == "bool":
        image[1, :] = True
        expected = ~image
    elif np.dtype(dtype).kind == "f":
        image[1, :] = lo
        image[2, :] = hi
        expected = 1.0 - image
        assert_array_equal(invert(T(image), signed_float=True).numpy(),
                           -image)
    else:
        image[1, :] = lo
        image[2, :] = hi
        expected = (hi + lo - image.astype(object)).astype(dtype)
    assert_array_equal(invert(T(image)).numpy(), expected)
    if dtype != "bool":
        assert_array_equal(invert(invert(T(image))).numpy(), image)


def test_map_array_and_arraymap_suite():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 5, size=(24, 25))
    in_values = np.unique(labels)
    out_values = rng.random_sample(in_values.shape)
    with pytest.raises(NotImplementedError):  # functional, as cupyimg_tpu
        map_array(T(labels), T(in_values), T(out_values),
                  out=np.empty((24, 24)))
    with pytest.raises(TypeError):
        map_array(T(labels.astype(float)), T(in_values), T(out_values))
    got = map_array(T(labels), T(in_values[1:]), T(out_values[1:]))
    lut = np.zeros(5)
    lut[in_values[1:]] = out_values[1:]
    assert_array_equal(got.numpy(), lut[labels])
    want = jax.jit(jutil.map_array)(jnp.asarray(labels),
                                    jnp.asarray(in_values[1:]),
                                    jnp.asarray(out_values[1:]))
    assert_array_equal(got.numpy(), np.asarray(want))
    labels = rng.randint(0, 40, size=(24, 25))
    in_values = np.unique(labels)
    m = ArrayMap(T(in_values), T(rng.random_sample(in_values.shape)))
    assert len(str(m).split("\n")) == m._max_str_lines + 2
    for seed, index in ((1, "slice"), (2, "bool")):
        r = np.random.RandomState(seed)
        ins = np.unique(r.randint(0, 200, size=5))
        m = ArrayMap(T(ins), T(r.random_sample(len(ins))))
        image = T(r.randint(1, len(m), size=(64, 64)))
        assert bool((m[image] < 1).all())  # missing values map to 0
        if index == "slice":
            m[1:] = m[1:] + 1
        else:
            positive = np.ones(len(m), dtype=bool)
            positive[0] = False
            m[positive] = m[positive] + 1
        assert bool((m[image] >= 1).all())
    assert np.asarray(m).shape == (len(m),)
    assert float(m[int(ins[0])]) == pytest.approx(
        float(np.asarray(m)[ins[0]]))


# ---------------------------------------------------------------------------
# random_noise
# ---------------------------------------------------------------------------


def _cam():
    rng = np.random.RandomState(3)
    return np.clip(rng.rand(128, 128) * 0.8 + 0.1, 0, 1)


def _binomial_band(n, p):
    sd = np.sqrt(n * p * (1 - p))
    return n * p - 5 * sd, n * p + 5 * sd


def test_same_seed_same_output_and_float_dtypes():
    cam = _cam()
    a = random_noise(T(cam), seed=42)
    assert torch.equal(a, random_noise(T(cam), seed=42))
    assert not torch.equal(a, random_noise(T(cam), seed=43))
    assert a.dtype == torch.float64
    assert random_noise(T(cam.astype(np.float32))).dtype == torch.float32
    assert random_noise(T((cam * 255).astype(np.uint8))).dtype == (
        torch.float64)


@pytest.mark.parametrize("mode", ["salt", "pepper", "s&p"])
def test_salt_and_pepper_fractions(mode):
    cam = _cam()
    n = cam.size
    noisy = random_noise(T(cam), seed=42, mode=mode, amount=0.15,
                         salt_vs_pepper=0.25).numpy()
    changed = cam != noisy
    lo, hi = _binomial_band(n, 0.15)
    assert lo < changed.sum() < hi
    if mode == "salt":
        assert_array_equal(noisy[changed], 1.0)
    elif mode == "pepper":
        assert_array_equal(noisy[changed], 0.0)
        signed = cam * 2.0 - 1.0
        ns = random_noise(T(signed), seed=42, mode="pepper",
                          amount=0.15).numpy()
        assert lo < ((ns == -1).sum() - (signed == -1).sum()) < hi
    else:
        salt = changed & (noisy == 1.0)
        pepper = changed & (noisy == 0.0)
        assert salt.sum() + pepper.sum() == changed.sum()
        slo, shi = _binomial_band(changed.sum(), 0.25)
        assert slo < salt.sum() < shi
    assert_array_equal(random_noise(T(np.random.rand(2, 3)), mode="salt",
                                    amount=1).numpy(), np.ones((2, 3)))


def test_gaussian_speckle_localvar_statistics():
    data = np.zeros((128, 128)) + 0.5
    n = data.size

    def within(stat, want, sd):
        assert abs(stat - want) < 5 * sd

    noisy = random_noise(T(data), seed=42, var=0.01).numpy()
    within(noisy.var(), 0.01, 0.01 * np.sqrt(2 / n))
    noisy = random_noise(T(data), seed=42, mean=0.3, var=0.015,
                         clip=False).numpy()
    within(noisy.mean() - 0.5, 0.3, np.sqrt(0.015 / n))
    within(noisy.var(), 0.015, 0.015 * np.sqrt(2 / n))
    d = np.zeros((128, 128)) + 0.1
    noisy = random_noise(T(d), mode="speckle", seed=42, mean=0.1, var=0.02,
                         clip=False).numpy()
    within(noisy.mean(), 0.11, 0.1 * np.sqrt(0.02 / n))
    within(noisy.var(), 0.01 * 0.02, 0.01 * 0.02 * np.sqrt(2 / n))
    lv = np.zeros((128, 128)) + 0.001
    lv[:64, 64:] = 0.1
    lv[64:, :64] = 0.25
    lv[64:, 64:] = 0.45
    noisy = random_noise(T(data), mode="localvar", seed=42,
                         local_vars=T(lv), clip=False).numpy()
    for sl, v in (((slice(None, 64), slice(None, 64)), 0.001),
                  ((slice(None, 64), slice(64, None)), 0.1),
                  ((slice(64, None), slice(None, 64)), 0.25),
                  ((slice(64, None), slice(64, None)), 0.45)):
        within(noisy[sl].var(), v, v * np.sqrt(2 / (n / 4)))
    for bad in (np.zeros_like(data), np.where(np.eye(128, dtype=bool), -1,
                                              0.1)):
        with pytest.raises(ValueError):
            random_noise(T(data), mode="localvar", local_vars=T(bad))
    with pytest.raises(KeyError):
        random_noise(T(np.zeros((8, 8))), mode="bogus")


def test_poisson_scaling_and_clip_bounds():
    data = (_cam() * 255).astype(np.uint8)
    x = img_as_float(T(data)).numpy()
    vals = 2 ** np.ceil(np.log2(len(np.unique(x))))
    noisy = random_noise(T(data), mode="poisson", seed=42,
                         clip=False).numpy()
    # Poisson(x * vals) / vals: integer multiples of 1 / vals, mean x,
    # variance x / vals
    assert_array_equal(noisy * vals, np.round(noisy * vals))
    n = x.size
    assert abs(noisy.mean() - x.mean()) < 5 * np.sqrt(x.mean() / vals / n)
    resid = (noisy - x).var()
    assert abs(resid - x.mean() / vals) < 0.1 * x.mean() / vals
    signed = x * 2.0 - 1.0
    for mode in ("poisson", "gaussian", "speckle"):
        unsigned = random_noise(T(data), mode=mode, seed=42).numpy()
        s = random_noise(T(signed), mode=mode, seed=42).numpy()
        assert unsigned.min() >= 0.0 and unsigned.max() <= 1.0
        assert s.min() >= -1.0 and s.max() <= 1.0
        free = random_noise(T(data), mode=mode, seed=42, clip=False).numpy()
        assert free.max() > 1.0
    g = random_noise(T(data), mode="gaussian", seed=42).numpy()
    assert g.min() == 0.0 and g.max() == 1.0
