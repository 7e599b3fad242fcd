"""The port's FFT kernel (``cupyimg_tpu_torch/ops/fused_fft.py``): its
gate and planner, its plain version against numpy and against
``cupyimg_tpu``'s Pallas FFT (``ops/pallas_fft.py``, interpret mode on
JAX-CPU), and the signal routes built on it against ``cupyimg_tpu``'s
``_pallas_fft*_real_conv``.

The JAX package leaves its spectra in a permuted bin order; these tests
bring it to natural order with ``permfft.perm_indices`` (the port has no
such order).  Tolerances are the JAX suite's (``tests/test_pallas_fft.py``):
5e-5 * max|X| for a forward transform, 1e-4 * max|X| for a round trip and
5e-4 * max|ref| for a convolution.  The Pallas-interpret references cost
a second or two each: each test's JAX calls are one jit program, six
here.  CUDA tests (the kernel against its plain
version, the launches of every public route, TF32 off in the small-DFT
product) skip without a card.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax
import jax.numpy as jnp

from cupyimg_tpu.ops import pallas_fft, permfft
from cupyimg_tpu.scipy.signal import signaltools as jsig
from cupyimg_tpu_torch.ops import fused_fft as ff
from cupyimg_tpu_torch.scipy.signal import signaltools as sig


def _natural(xp, axes):
    """A JAX permuted-order spectrum in natural bin order."""
    out = np.asarray(xp)
    for ax in axes:
        p = permfft.perm_indices(out.shape[ax])
        nat = np.empty_like(out)
        idx = [slice(None)] * out.ndim
        idx[ax] = p
        nat[tuple(idx)] = out
        out = nat
    return out


def _permuted(x, axes):
    """A natural-order spectrum in the JAX package's permuted order."""
    for ax in axes:
        x = np.take(x, permfft.perm_indices(x.shape[ax]), axis=ax)
    return x


def _c64(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------------------
# gate and planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,ok", [
    (4320, True), (1215, True), (270, True), (384, True), (2000, True),
    (257, False),           # at most 256: torch.fft
    (256, False),
    (7 * 64, False),        # a factor 7
    (4126, False),          # 2 * 2063
    (14400, True),          # the largest 5-smooth size within one column
    (14580, False),         # two buffers of one column exceed 227 KB
])
def test_gate(n, ok):
    assert ff.supports(n) is ok
    if ok:
        radices = ff.factorize(n)
        assert int(np.prod(radices)) == n and set(radices) <= {2, 3, 4, 5}
    else:
        with pytest.raises(ValueError):
            ff.plan(n, "rows", 8)


def test_gate_bounds():
    """The largest admitted size, and the shared-memory rule at it."""
    smooth = [n for n in range(257, 16000) if ff.factorize(n)]
    admitted = [n for n in smooth if ff.supports(n)]
    assert admitted[0] == 270 and admitted[-1] == 14400
    assert ff.smem_bytes(14400, 1) <= ff.SMEM_LIMIT < ff.smem_bytes(14580, 1)


@pytest.mark.parametrize("n,entry,count,tile", [
    (4320, "strided", 4320, 3),   # 3 complex64 columns: 207,360 bytes
    (4320, "rows", 4320, 1),
    (1215, "rows", 4374, 1),      # the 257-tap overlap-add block
    (1215, "strided", 100, 11),
    (384, "rows", 3, 3),
    (384, "strided", 2, 2),
    (14400, "strided", 50, 1),
])
def test_plan(n, entry, count, tile):
    p = ff.plan(n, entry, count)
    assert p.tile == tile and p.smem == ff.smem_bytes(n, tile)
    assert p.smem <= ff.SMEM_LIMIT and p.threads in (256, 512)


# ---------------------------------------------------------------------------
# the plain version against numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [270, 384, 1215, 2000, 4320, 14400])
@pytest.mark.parametrize("entry", ["rows", "strided"])
def test_plain_version_against_numpy(n, entry):
    rng = np.random.default_rng(n)
    shape = (3, n) if entry == "rows" else (2, n, 3)
    ax = 1
    x = _c64(rng, shape)
    xr = rng.standard_normal(shape).astype(np.float32)
    m = _c64(rng, shape[1:])
    ref = np.fft.fft(x.astype(np.complex128), axis=ax)
    tol = 5e-5 * np.abs(ref).max()
    got = ff.fused_fft_ref(torch.from_numpy(x), entry)
    np.testing.assert_allclose(got.numpy(), ref, atol=tol)
    got = ff.fused_fft_ref(torch.from_numpy(xr), entry)
    np.testing.assert_allclose(got.numpy(), np.fft.fft(xr, axis=ax),
                               atol=5e-5 * np.abs(ref).max())
    # the inverse with a broadcast product, the scale and a real output
    back = ff.fused_fft_ref(torch.from_numpy(ref.astype(np.complex64)),
                            entry, inverse=True, real_out=True,
                            mul=torch.from_numpy(m), scale=1.0 / n)
    want = np.fft.ifft(ref * m, axis=ax).real
    assert back.dtype == torch.float32
    np.testing.assert_allclose(back.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_fft2_and_axis_helpers_against_numpy():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 270, 384)).astype(np.float32)
    f = ff.fft2(torch.from_numpy(x))
    ref = np.fft.fft2(x)
    np.testing.assert_allclose(f.numpy(), ref, atol=5e-5 * np.abs(ref).max())
    k = _c64(rng, (270, 384))
    y = ff.fft2(f, inverse=True, real_out=True, mul=torch.from_numpy(k))
    want = np.fft.ifft2(ref * k).real
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4 * np.abs(
        want).max())
    for ax in (0, 1, 2):
        z = ff.fft_axis(torch.from_numpy(x.astype(np.complex64)), ax)
        np.testing.assert_allclose(z.numpy(), np.fft.fft(x, axis=ax),
                                   atol=5e-5 * np.abs(ref).max())


def test_cpu_tensors_never_launch():
    before = (ff.fft_rows.launches, ff.fft_strided.launches)
    ff.fft2(torch.rand(300, 320))
    sig._fused_fft1_real_conv(torch.rand(2, 300), torch.rand(1, 20), [1],
                              [320])
    assert (ff.fft_rows.launches, ff.fft_strided.launches) == before


@pytest.mark.parametrize("kw,err", [
    (dict(x=torch.zeros(3, 384, dtype=torch.float64)), ValueError),
    (dict(x=torch.zeros(3, 384, 2, dtype=torch.complex64)), ValueError),
    (dict(mul=torch.zeros(5, dtype=torch.complex64)), ValueError),
    (dict(mul=torch.zeros(384)), ValueError),
])
def test_argument_errors(kw, err):
    x = kw.pop("x", torch.zeros(3, 384, dtype=torch.complex64))
    with pytest.raises(err):
        ff.fft_rows(x, **kw)


def test_kernel_source_contract():
    """The CUDA source keeps the plain version's twiddle-index rule, its
    two entries and no library call."""
    src = (ff.__file__.rsplit("/", 2)[0] + "/csrc/fused_fft.cu")
    text = open(src).read()
    assert 'extern "C" int fft_rows(' in text
    assert 'extern "C" int fft_strided(' in text
    assert "r * k * stride" in text and "(j - k) * R + k" in text
    for banned in ("cufft", "cublas", "torch/"):
        assert banned not in text.lower()


# ---------------------------------------------------------------------------
# against cupyimg_tpu's Pallas FFT (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,ax", [((3, 384), -1), ((384, 128), 0),
                                      ((2, 384, 64), 1)])
def test_plain_version_against_pallas_fft_axis(shape, ax):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    r, i = jax.jit(lambda v: pallas_fft.fft_axis(v, None, ax, interpret=True))(
        jnp.asarray(x))
    ref = _natural(np.asarray(r) + 1j * np.asarray(i), (ax % x.ndim,))
    got = ff.fft_axis(torch.from_numpy(x), ax)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5 * scale)
    back = ff.fft_axis(got, ax, inverse=True, real_out=True)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4 * scale)


def test_plain_version_against_pallas_fft2():
    """fft2 forward, then the inverse with a product and a real output,
    each against the JAX package's two fused-transpose passes."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((384, 512)).astype(np.float32)
    k = _c64(rng, (384, 512))
    kp = _permuted(k, (0, 1))

    @jax.jit
    def both(v, kr, ki):
        r, i = pallas_fft.fft2(v, None, interpret=True)
        out, _ = pallas_fft.fft2(r, i, inverse=True, real_out=True,
                                 interpret=True, mul=(kr, ki))
        return r, i, out

    r, i, out = both(jnp.asarray(x), jnp.asarray(kp.real),
                     jnp.asarray(kp.imag))
    ref = _natural(np.asarray(r) + 1j * np.asarray(i), (0, 1))
    got = ff.fft2(torch.from_numpy(x))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5 * scale)
    port = ff.fft2(got, inverse=True, real_out=True, mul=torch.from_numpy(k))
    want = np.asarray(out)
    np.testing.assert_allclose(port.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_fft2_route_against_pallas_small_operand():
    """_fused_fft2_real_conv with a 13x31 second operand (the direct DFT
    product) against _pallas_fft2_real_conv and scipy."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((300, 280)).astype(np.float32)
    b = rng.standard_normal((13, 31)).astype(np.float32)
    fshape = (320, 320)
    want = np.asarray(jsig._pallas_fft2_real_conv(
        jnp.asarray(a), jnp.asarray(b), (0, 1), fshape))
    got = sig._fused_fft2_real_conv(torch.from_numpy(a), torch.from_numpy(b),
                                    [0, 1], fshape)
    assert got.shape == (320, 320) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=5e-4 * np.abs(want).max())
    full = ss.fftconvolve(a, b)
    np.testing.assert_allclose(got.numpy()[:312, :310], full,
                               atol=5e-4 * np.abs(full).max())


def test_fft1_route_against_pallas_full_operand():
    """_fused_fft1_real_conv with a 200-tap second operand (a full forward
    pass) broadcast over four rows."""
    rng = np.random.default_rng(6)
    a = rng.standard_normal((4, 300)).astype(np.float32)
    b = rng.standard_normal((1, 200)).astype(np.float32)
    want = np.asarray(jsig._pallas_fft1_real_conv(
        jnp.asarray(a), jnp.asarray(b), (1,), (512,)))
    got = sig._fused_fft1_real_conv(torch.from_numpy(a), torch.from_numpy(b),
                                    [1], (512,))
    assert got.shape == (4, 512)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=5e-4 * np.abs(want).max())
    full = np.stack([ss.fftconvolve(r, b[0]) for r in a])
    np.testing.assert_allclose(got.numpy()[:, :499], full,
                               atol=5e-4 * np.abs(full).max())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [270, 384, 1215, 2000, 4320, 14400])
@pytest.mark.parametrize("entry", ["rows", "strided"])
def test_kernel_matches_plain_version(cuda, n, entry):
    rng = np.random.default_rng(n)
    shape = (5, n) if entry == "rows" else (2, n, 7)
    launch = ff.fft_rows if entry == "rows" else ff.fft_strided
    x = torch.from_numpy(_c64(rng, shape))
    xr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    m = torch.from_numpy(_c64(rng, shape[1:]))
    for inp, kw in ((x, {}), (xr, {}),
                    (x, dict(inverse=True, real_out=True, mul=m,
                             scale=1.0 / n))):
        ref = ff.fused_fft_ref(inp, entry, **kw)
        kwc = {k: (v.cuda() if torch.is_tensor(v) else v)
               for k, v in kw.items()}
        got = launch(inp.cuda(), **kwc).cpu()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        tol = 5e-5 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_public_routes_launch_the_kernel(cuda, monkeypatch):
    """Each public FFT route of a CUDA float32 call inside the gate
    launches the kernel, as many times as planned; a silent torch.fft
    route cannot pass."""
    import cupyimg_tpu_torch.scipy.signal as tsig

    monkeypatch.setattr(sig, "_FUSED_FFT_MIN_POINTS", 0)
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.random((300, 280), dtype=np.float32)).cuda()
    k = torch.from_numpy(rng.random((13, 31), dtype=np.float32)).cuda()
    a1 = torch.from_numpy(rng.random(6000, dtype=np.float32)).cuda()
    h1 = torch.from_numpy(rng.random(257, dtype=np.float32)).cuda()
    cases = [  # (call, rows launches, strided launches)
        (lambda: tsig.fftconvolve(a, k, "same"), 2, 2),
        (lambda: tsig.convolve(a, k, "same", method="fft"), 2, 2),
        (lambda: tsig.correlate(a, k, "same", method="fft"), 2, 2),
        (lambda: tsig.fftconvolve(a, torch.flip(a, (0,)), "same"), 3, 3),
        (lambda: tsig.oaconvolve(a1, h1, "same"), 3, 0),
    ]
    for call, rows, strided in cases:
        before = (ff.fft_rows.launches, ff.fft_strided.launches)
        y = call()
        torch.cuda.synchronize()
        assert (ff.fft_rows.launches - before[0],
                ff.fft_strided.launches - before[1]) == (rows, strided)
        assert y.is_cuda and y.dtype == torch.float32


@pytest.mark.cuda
def test_small_dft_product_runs_without_tf32(cuda):
    """With TF32 allowed globally, the small-operand spectrum still comes
    out at float32 accuracy (TF32 keeps about three digits), and the
    caller's setting is restored."""
    rng = np.random.default_rng(5)
    b = rng.standard_normal((31, 31)).astype(np.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a = torch.zeros(1024, 1024, device="cuda")
        a[0, 0] = 1.0  # the result is the kernel itself
        got = sig._fused_fft2_real_conv(a, torch.from_numpy(b).cuda(),
                                        [0, 1], (1080, 1080))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    err = np.abs(got.cpu().numpy()[:31, :31] - b).max()
    assert err <= 1e-5 * np.abs(b).max()
