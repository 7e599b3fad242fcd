"""One FFT of one axis in one pass over device memory: the CUDA kernel,
its planner and its plain PyTorch version.

The counterpart of ``cupyimg_tpu/ops/pallas_fft.py``: B4 (``_kernel_last``
via ``_fft_last``) becomes the **rows** entry, B5 (``_kernel_first`` via
``_fft_first`` and ``fft2``) the **strided** entry of
``csrc/fused_fft.cu``.

- :func:`fft_rows`: the contiguous last axis of an ``(R, n)`` array; a
  block transforms ``tile`` whole rows in shared memory.
- :func:`fft_strided`: the middle axis of an ``(L, n, C)`` view; a block
  takes ``tile`` neighbouring columns (reads coalesced along C), each
  column whole in shared memory.

Both fold in what the JAX kernels fold into their pass: a real input
(imaginary part read as 0), a real output (only the real part written),
a pointwise complex product by a second operand before the transform
(broadcast over the leading axis, as a kernel spectrum is used), and a
constant scale applied as each value is written (the inverse's 1/n, or
1/(n0*n1) on the second pass of :func:`fft2`).

The algorithm is the port's own, not the TPU's four-step matmul form: a
mixed-radix (4, 2, 3, 5) Stockham autosort FFT, ping-ponging between two
shared-memory buffers, so the spectrum comes out in natural order.  The
JAX package's permuted bin order (``ops/permfft.py``: ``perm_indices``,
``neg_bins``) is a TPU mechanism with no counterpart here, and so are its
bf16 hi/lo splits, its Karatsuba products and ``ops/mxfft.py``.  Complex
values are native ``complex64`` (the JAX package's (re, im) float32 plane
pairs of ``core/complexutil.py`` have no counterpart).  The twiddles are
one table of ``exp(-2 pi i k / n)``, computed on the host in float64 and
rounded once to complex64; the inverse is the forward transform of the
conjugate, conjugated.

The gate (:func:`supports`) and the tiles (:func:`plan`) are plain Python:
n > 256 (as ``permfft._MAX_A``), n a product of 2, 3 and 5, and two
buffers of one column within the 227 KB a block can use.  A CUDA tensor
launches the kernel (counting one in the entry's ``launches``) or raises;
only a CPU tensor takes :func:`fused_fft_ref`, which runs the kernel's
stages in PyTorch, complex64 throughout.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "factorize",
    "fft2",
    "fft_axis",
    "fft_rows",
    "fft_strided",
    "fused_fft_ref",
    "plan",
    "smem_bytes",
    "supports",
    "twiddles",
]

#: the gate's lower bound: shorter axes stay on torch.fft (permfft._MAX_A)
MIN_N = 256
#: shared memory one block can use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
#: columns a strided block takes at most
MAX_TILE = 16
THREADS = {"rows": 256, "strided": 512}
#: rows per block of the rows entry aim at this many points
ROWS_POINTS = 2048
ENTRIES = ("rows", "strided")


def factorize(n):
    """The radices of the kernel's stages for length ``n``, in order
    (4s, then a 2, then 3s, then 5s), or None when ``n`` has a prime
    factor above 5."""
    n = int(n)
    if n < 1:
        return None
    exps = {}
    m = n
    for p in (2, 3, 5):
        exps[p] = 0
        while m % p == 0:
            m //= p
            exps[p] += 1
    if m != 1:
        return None
    return ([4] * (exps[2] // 2) + [2] * (exps[2] % 2) + [3] * exps[3]
            + [5] * exps[5])


def smem_bytes(n, tile):
    """Dynamic shared memory of one block: two complex64 buffers of
    ``tile`` sequences of ``n``."""
    return 2 * 8 * int(n) * int(tile)


def supports(n):
    """The gate: the kernel takes an axis of length ``n``."""
    n = int(n)
    return (n > MIN_N and factorize(n) is not None
            and smem_bytes(n, 1) <= SMEM_LIMIT)


@dataclass(frozen=True)
class Plan:
    n: int
    entry: str
    radices: tuple
    tile: int      # rows (rows entry) or columns (strided) per block
    threads: int
    smem: int      # dynamic shared memory bytes per block


def plan(n, entry, count):
    """The launch plan of one pass over ``count`` rows (rows entry) or
    ``count`` columns C (strided entry, views ``(L, n, C)``).  Raises
    ValueError when the gate declines ``n``.
    """
    n = int(n)
    if entry not in ENTRIES:
        raise ValueError(f"fused_fft: unknown entry {entry!r}")
    if not supports(n):
        raise ValueError(f"fused_fft: the kernel does not take n={n} (needs "
                         f"n > {MIN_N}, 5-smooth, one column within "
                         f"{SMEM_LIMIT} bytes of shared memory)")
    count = max(1, int(count))
    fit = SMEM_LIMIT // smem_bytes(n, 1)
    if entry == "rows":
        tile = max(1, min(count, ROWS_POINTS // n, fit))
    else:
        tile = max(1, min(count, MAX_TILE, fit))
    return Plan(n, entry, tuple(factorize(n)), tile, THREADS[entry],
                smem_bytes(n, tile))


@functools.lru_cache(maxsize=64)
def _twiddles(n, device):
    k = np.arange(n, dtype=np.float64)
    return torch.from_numpy(
        np.exp(-2j * np.pi * k / n).astype(np.complex64)).to(device)


def twiddles(n, device="cpu"):
    """The kernel's twiddle table: ``exp(-2 pi i k / n)`` for k < n,
    formed in float64 and rounded once to complex64."""
    return _twiddles(int(n), str(torch.device(device)))


# ---------------------------------------------------------------------------
# plain version: the kernel's stages in PyTorch
# ---------------------------------------------------------------------------

# the radix-3 and radix-5 butterfly constants, rounded once to float32 as
# the kernel's literals are
_C3 = float(np.float32(-0.5))
_S3 = float(np.float32(np.sin(2 * np.pi / 3)))
_C51 = float(np.float32(np.cos(2 * np.pi / 5)))
_S51 = float(np.float32(np.sin(2 * np.pi / 5)))
_C52 = float(np.float32(np.cos(4 * np.pi / 5)))
_S52 = float(np.float32(np.sin(4 * np.pi / 5)))


def _mi(v):
    """-1j * v, exactly (swap and negate)."""
    return torch.complex(v.imag, -v.real)


def _butterfly(v, radix):
    """The forward DFT of length ``radix`` over axis -2, with the kernel's
    arithmetic."""
    a = v.unbind(-2)
    if radix == 2:
        y = (a[0] + a[1], a[0] - a[1])
    elif radix == 4:
        t0, t1 = a[0] + a[2], a[0] - a[2]
        t2, t3 = a[1] + a[3], _mi(a[1] - a[3])
        y = (t0 + t2, t1 + t3, t0 - t2, t1 - t3)
    elif radix == 3:
        s = a[1] + a[2]
        t = a[0] + _C3 * s
        u = _mi(_S3 * (a[1] - a[2]))
        y = (a[0] + s, t + u, t - u)
    else:
        b1, b2 = a[1] + a[4], a[2] + a[3]
        d1, d2 = a[1] - a[4], a[2] - a[3]
        t1 = a[0] + _C51 * b1 + _C52 * b2
        t2 = a[0] + _C52 * b1 + _C51 * b2
        u1 = _mi(_S51 * d1 + _S52 * d2)
        u2 = _mi(_S52 * d1 - _S51 * d2)
        y = (a[0] + b1 + b2, t1 + u1, t2 + u2, t2 - u2, t1 - u1)
    return torch.stack(y, -2)


@functools.lru_cache(maxsize=64)
def _stage_maps(n, radices):
    """Per stage: (radix, twiddle index of each butterfly input (radix
    x n/radix, flattened) or None, the butterfly output that lands at
    each position).  The plain version gathers with ``index_select``:
    advanced indexing and scatters take tens of milliseconds a call in
    PyTorch's multi-threaded CPU path at these sizes."""
    maps = []
    ns = 1
    for r in radices:
        nb = n // r
        j = np.arange(nb)
        k = j % ns
        rr = np.arange(r)[:, None]
        tw = None if ns == 1 else torch.from_numpy(
            (rr * k[None, :] * (n // (ns * r))).reshape(-1))
        # output r of butterfly j goes to (j - k) * r + k + r * ns
        dest = (((j - k) * r + k)[None, :] + rr * ns).reshape(-1)
        src = np.empty(n, np.int64)
        src[dest] = np.arange(n)
        maps.append((r, tw, torch.from_numpy(src)))
        ns *= r
    return maps


def _stages_ref(z, n, radices):
    """The Stockham stages on the last axis of complex64 ``z``."""
    tw = twiddles(n, z.device)
    for r, tidx, src in _stage_maps(n, tuple(radices)):
        v = z.reshape(*z.shape[:-1], r, n // r)
        if tidx is not None:
            v = v * tw.index_select(0, tidx.to(z.device)).reshape(r, -1)
        y = _butterfly(v, r).reshape(*z.shape[:-1], n)
        z = y.index_select(-1, src.to(z.device))
    return z


def fused_fft_ref(x, entry, inverse=False, real_out=False, mul=None,
                  scale=1.0):
    """Plain version of :func:`fft_rows` (``entry="rows"``, ``x`` of shape
    ``(R, n)``) and :func:`fft_strided` (``entry="strided"``, ``x`` of
    shape ``(L, n, C)``), with the same options: the load (real input,
    product by ``mul``, conjugate for the inverse), the kernel's stages
    (complex64 throughout, the same twiddle table and butterflies) and
    the store (conjugate, ``scale``, real part)."""
    _check_args(x, entry, inverse, mul)
    n = x.shape[-1] if entry == "rows" else x.shape[1]
    radices = factorize(n)
    if radices is None:
        raise ValueError(f"fused_fft_ref: n={n} is not 5-smooth")
    z = x.to(torch.complex64)
    if mul is not None:
        z = z * mul
    if entry == "strided":
        z = z.transpose(1, 2)
    if inverse:
        z = torch.conj_physical(z)
    z = _stages_ref(z.contiguous(), n, radices)
    if inverse:
        z = torch.conj_physical(z)
    if scale != 1.0:
        z = z * np.float32(scale)
    if entry == "strided":
        z = z.transpose(1, 2).contiguous()
    return z.real.contiguous() if real_out else z


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------


def _check_args(x, entry, inverse, mul):
    if entry not in ENTRIES:
        raise ValueError(f"fused_fft: unknown entry {entry!r}")
    want = 2 if entry == "rows" else 3
    if x.ndim != want:
        raise ValueError(f"fused_fft {entry}: a {want}-D tensor expected, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"fused_fft takes float32 (real input) or "
                         f"complex64 data, got {x.dtype}")
    if mul is not None:
        if mul.dtype != torch.complex64:
            raise ValueError("fused_fft: mul must be complex64")
        if mul.shape[-(want - 1):] != x.shape[1:]:
            raise ValueError(f"fused_fft: mul {tuple(mul.shape)} does not "
                             f"broadcast over {tuple(x.shape)}")


def _mul_stride(x, mul):
    """(contiguous mul, stride of its leading axis: 0 when broadcast)."""
    inner = x.shape[1:]
    m = mul.reshape((-1,) + tuple(inner))
    if m.shape[0] not in (1, x.shape[0]):
        raise ValueError(f"fused_fft: mul {tuple(mul.shape)} does not "
                         f"broadcast over {tuple(x.shape)}")
    m = m.contiguous()
    return m, (0 if m.shape[0] == 1 else int(np.prod(inner)))


def _library():
    from cupyimg_tpu_torch.ops import _build

    lib = _build.load("fused_fft")
    common = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_double, ctypes.c_void_p]
    # x, mul, out, twiddles, R, mul row stride, then n, tile, threads,
    # nstages, radices, inverse, real_in, real_out, scale, stream
    lib.fft_rows.argtypes = ([ctypes.c_void_p] * 4
                             + [ctypes.c_longlong] * 2 + common)
    # x, mul, out, twiddles, L, C, mul batch stride, then as above
    lib.fft_strided.argtypes = ([ctypes.c_void_p] * 4
                                + [ctypes.c_longlong] * 3 + common)
    lib.fft_rows.restype = ctypes.c_int
    lib.fft_strided.restype = ctypes.c_int
    return lib


def _launch(x, entry, inverse, real_out, mul, scale):
    if not x.is_cuda:
        raise ValueError("fused_fft kernel: a CUDA tensor expected")
    if not x.is_contiguous():
        raise ValueError("fused_fft kernel takes a contiguous tensor")
    n = x.shape[-1] if entry == "rows" else x.shape[1]
    p = plan(n, entry, x.shape[0] if entry == "rows" else x.shape[2])
    out = torch.empty(x.shape, device=x.device,
                      dtype=torch.float32 if real_out else torch.complex64)
    if out.numel() == 0:
        return out
    mptr, mstride = 0, 0
    if mul is not None:
        if mul.device != x.device:
            raise ValueError("fused_fft kernel: mul on another device")
        mul, mstride = _mul_stride(x, mul)
        mptr = mul.data_ptr()
    tw = twiddles(n, x.device)
    radices = np.asarray(p.radices, np.int32)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        common = (n, p.tile, p.threads, len(p.radices),
                  radices.ctypes.data, int(inverse), int(not x.is_complex()),
                  int(real_out), float(scale), stream)
        if entry == "rows":
            err = lib.fft_rows(x.data_ptr(), mptr, out.data_ptr(),
                               tw.data_ptr(), x.shape[0], mstride, *common)
        else:
            err = lib.fft_strided(x.data_ptr(), mptr, out.data_ptr(),
                                  tw.data_ptr(), x.shape[0], x.shape[2],
                                  mstride, *common)
    if err != 0:
        raise RuntimeError(f"fused_fft kernel ({entry}) launch failed: CUDA "
                           f"error {err}")
    return out


def fft_rows(x, inverse=False, real_out=False, mul=None, scale=1.0):
    """Transform every row of ``x``, an ``(R, n)`` float32 (real input)
    or complex64 tensor: forward, or with ``inverse`` the unnormalized
    inverse (``scale`` supplies any normalization).  ``mul``, complex64
    of shape ``(n,)``, ``(1, n)`` or ``(R, n)``, multiplies the input
    before the transform; ``real_out`` returns the real part as float32.

    A CUDA tensor launches the kernel's rows entry (and counts one in
    ``fft_rows.launches``); a CPU tensor runs :func:`fused_fft_ref`.
    """
    _check_args(x, "rows", inverse, mul)
    if x.device.type == "cpu":
        return fused_fft_ref(x, "rows", inverse, real_out, mul, scale)
    y = _launch(x, "rows", inverse, real_out, mul, scale)
    fft_rows.launches += 1
    return y


fft_rows.launches = 0


def fft_strided(x, inverse=False, real_out=False, mul=None, scale=1.0):
    """Transform the middle axis of ``x``, an ``(L, n, C)`` float32 (real
    input) or complex64 tensor; the options as :func:`fft_rows`, with
    ``mul`` of shape ``(n, C)``, ``(1, n, C)`` or ``(L, n, C)``.

    A CUDA tensor launches the kernel's strided entry (and counts one in
    ``fft_strided.launches``); a CPU tensor runs :func:`fused_fft_ref`.
    """
    _check_args(x, "strided", inverse, mul)
    if x.device.type == "cpu":
        return fused_fft_ref(x, "strided", inverse, real_out, mul, scale)
    y = _launch(x, "strided", inverse, real_out, mul, scale)
    fft_strided.launches += 1
    return y


fft_strided.launches = 0


def _mul_view(mul, x, ax):
    """``mul`` as the entry takes it: its axes from ``ax`` on as
    ``x``'s, its leading axes all 1 (broadcast by the kernel) or all as
    ``x``'s; any other broadcast is materialized."""
    mshape = (1,) * (x.ndim - mul.ndim) + tuple(mul.shape)
    mul = mul.reshape(mshape)
    lead = mshape[:ax]
    if mshape[ax:] != tuple(x.shape[ax:]) or not (
            all(s == 1 for s in lead) or lead == tuple(x.shape[:ax])):
        mul = mul.broadcast_to(x.shape)
    return mul


def _fft_axis(x, axis, inverse, real_out, mul, scale):
    ax = axis % x.ndim
    n = x.shape[ax]
    if mul is not None:
        mul = _mul_view(mul, x, ax)
    if ax == x.ndim - 1:
        rows = x.reshape(-1, n)
        m = None if mul is None else mul.reshape(-1, n)
        y = fft_rows(rows.contiguous(), inverse, real_out, m, scale)
    else:
        lead = int(np.prod(x.shape[:ax], dtype=np.int64))
        c = int(np.prod(x.shape[ax + 1:], dtype=np.int64))
        m = None if mul is None else mul.reshape(-1, n, c)
        y = fft_strided(x.reshape(lead, n, c).contiguous(), inverse,
                        real_out, m, scale)
    return y.reshape(x.shape)


def fft_axis(x, axis, inverse=False, real_out=False, mul=None):
    """Natural-order transform of ``x`` along ``axis`` (counterpart of
    ``pallas_fft.fft_axis``): the last axis on the rows entry, any other
    on the strided entry.  The inverse is normalized by 1/n; ``mul``
    broadcasts against ``x``."""
    n = x.shape[axis]
    return _fft_axis(x, axis, inverse, real_out, mul,
                     1.0 / n if inverse else 1.0)


def fft2(x, inverse=False, real_out=False, mul=None):
    """Natural-order 2-D transform over the last two axes (leading axes
    are batch), as two passes: forward rows then strided (a real input is
    read by the rows pass); inverse strided then rows, with ``mul``
    folded into the first pass, and 1/(n0*n1) and ``real_out`` into the
    second (counterpart of ``pallas_fft.fft2``)."""
    n0, n1 = x.shape[-2:]
    if not inverse:
        y = _fft_axis(x, -1, False, False, mul, 1.0)
        return _fft_axis(y, -2, False, real_out, None, 1.0)
    y = _fft_axis(x, -2, True, False, mul, 1.0)
    return _fft_axis(y, -1, True, real_out, None, 1.0 / (n0 * n1))
