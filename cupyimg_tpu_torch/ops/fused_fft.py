"""One FFT of one axis over device memory: the CUDA kernel, its planner
and its plain PyTorch version.

The counterpart of ``cupyimg_tpu/ops/pallas_fft.py``: B4 (``_kernel_last``
via ``_fft_last``) becomes the **rows** entry, B5 (``_kernel_first`` via
``_fft_first`` and ``fft2``) the **strided** entry of
``csrc/fused_fft.cu``.

- :func:`fft_rows`: the contiguous last axis of an ``(R, n)`` array; a
  block transforms ``tile`` whole rows, one launch.
- :func:`fft_strided`: the middle axis of an ``(L, n, C)`` view, as two
  launches of a four-step split n = n1 * n2 (:func:`split`): length-n1
  transforms of the ``(L, n1, n2*C)`` view with the twiddle
  ``w_n^(j2*k1)`` at their store, then length-n2 transforms of the
  ``(L*n1, n2, C)`` result, output row k1 + n1*k2 stored in natural
  order.  A block of either step takes at least ``STRIDED_TILE``
  neighbouring columns, so every load and store is a row segment of 16
  values or more.

Both fold in what the JAX kernels fold into their pass: a real input
(imaginary part read as 0), a real output (only the real part written),
a pointwise complex product by a second operand before the transform
(broadcast over the leading axis, as a kernel spectrum is used), and a
constant scale applied as each value is written (the inverse's 1/n, or
1/(n0*n1) on the second pass of :func:`fft2`).  They also fold in a zero
pad (``n`` larger than the input's axis: the samples beyond its end read
as 0) and a crop (``window=(start, length)``: only those outputs of the
axis are written), so that a convolution reads its unpadded operands and
writes only its ``mode`` window.

The algorithm is the port's own, not the TPU's four-step matmul form: a
Stockham autosort FFT of few passes (:func:`passes`), each pass one
butterfly of radix up to 32 per thread in registers (a composite radix is
split into 2, 3, 4 and 5 inside the thread, its inner twiddles constants),
with one shared-memory exchange between passes, so the spectrum comes out
in natural order.  The JAX package's permuted bin order
(``ops/permfft.py``: ``perm_indices``, ``neg_bins``) is a TPU mechanism
with no counterpart here, and so are its bf16 hi/lo splits, its Karatsuba
products and ``ops/mxfft.py``.  Complex values are native ``complex64``
(the JAX package's (re, im) float32 plane pairs of
``core/complexutil.py`` have no counterpart).  A pass twiddle
``exp(-2 pi i e / n)`` is the product of two entries of host-made tables
(:func:`twiddle_tables`: ``e mod 128`` and ``128 * (e div 128)``, float64
rounded once to complex64), staged in shared memory; the inverse is the
forward transform of the conjugate, conjugated.

The gate (:func:`supports`) and the plan (:func:`plan`) are plain Python:
n > 256 (as ``permfft._MAX_A``), n a product of 2, 3 and 5, and two
buffers of one row within the 227 KB a block can use.  A CUDA tensor
launches the kernel (counting each launch in the entry's ``launches``) or
raises; only a CPU tensor takes :func:`fused_fft_ref`, which runs the
kernel's passes in PyTorch, complex64 throughout.
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
    "passes",
    "plan",
    "smem_bytes",
    "split",
    "supports",
    "twiddle_tables",
]

#: the gate's lower bound: shorter axes stay on torch.fft (permfft._MAX_A)
MIN_N = 256
#: shared memory one block can use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
#: the largest radix of one pass: one thread's butterfly in registers
MAX_RADIX = 32
#: columns a strided block takes: a row segment of 16 complex64 (128
#: bytes) or float32 (64 bytes) values per load and store
STRIDED_TILE = 16
#: threads of a block at most (the kernel's launch bound); a rows block
#: of radices up to 20 takes at most ROWS_THREADS (two blocks an SM)
MAX_THREADS = 512
ROWS_THREADS = 320
#: rows per block of the rows entry aim at this many points
ROWS_POINTS = 2048
#: the twiddle tables' split: e = TW_SPLIT * hi + lo
TW_SPLIT = 128
ENTRIES = ("rows", "strided")


def factorize(n):
    """The prime factors of ``n``, ascending, or None when ``n`` has a
    prime factor above 5."""
    n = int(n)
    if n < 1:
        return None
    out = []
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
            out.append(p)
    return out if n == 1 else None


@functools.lru_cache(maxsize=None)
def passes(m):
    """The radices of the Stockham passes for a sequence of ``m``
    (5-smooth): the fewest passes with every radix at most MAX_RADIX,
    then the largest smallest radix (the fewest butterflies of a pass:
    the block's threads), ties to the largest radix first."""
    m = int(m)
    primes = factorize(m)
    if primes is None:
        raise ValueError(f"fused_fft: {m} is not 5-smooth")
    if m == 1:
        return ()
    best = None
    # every way of grouping the prime factors into k radices
    for k in range(1, len(primes) + 1):
        found = []

        def assign(i, groups):
            if i == len(primes):
                if all(g > 1 for g in groups):
                    found.append(tuple(sorted(groups, reverse=True)))
                return
            seen = set()
            for j in range(k):
                g = groups[j] * primes[i]
                if g > MAX_RADIX or groups[j] in seen:
                    continue
                seen.add(groups[j])
                assign(i + 1, groups[:j] + [g] + groups[j + 1:])

        assign(0, [1] * k)
        if found:
            best = max(found, key=lambda g: (min(g), g))
            break
    return best


def split(n):
    """The four-step split n = n1 * n2 of the strided entry: n1 <= n2,
    the pair closest to sqrt(n)."""
    n = int(n)
    n1 = max(d for d in range(1, int(np.sqrt(n)) + 1) if n % d == 0)
    return n1, n // n1


def twiddle_entries(n):
    """Complex64 entries of :func:`twiddle_tables` for length ``n``."""
    return TW_SPLIT + -(-int(n) // TW_SPLIT)


def smem_bytes(n, tile):
    """Dynamic shared memory of a rows block: two complex64 buffers of
    ``tile`` sequences of ``n`` (the gate's rule), plus its twiddle
    tables."""
    return 2 * 8 * int(n) * int(tile) + 8 * twiddle_entries(n)


def supports(n):
    """The gate: the kernel takes an axis of length ``n``."""
    n = int(n)
    return (n > MIN_N and factorize(n) is not None
            and smem_bytes(n, 1) <= SMEM_LIMIT)


def _threads(radices, m):
    """Threads for the butterflies of the widest pass."""
    return max(m // r for r in radices) if radices else 1


def rows_thread_cap(radices):
    """Threads a rows block may have: the kernel's rows_threads."""
    return ROWS_THREADS if max(radices) <= 20 else MAX_THREADS




@dataclass(frozen=True)
class Step:
    """One launch: sequences of ``m`` along an axis, in ``radices``
    passes; ``block`` the block's (x, y) threads; ``smem`` its dynamic
    shared bytes."""
    m: int
    radices: tuple
    block: tuple
    smem: int


@dataclass(frozen=True)
class Plan:
    n: int
    entry: str
    tile: int      # rows (rows entry) or columns (strided) per block
    steps: tuple   # one Step (rows) or two (strided: n1, then n2)
    segment_bytes: int  # the shortest contiguous run a load reads

    @property
    def launches(self):
        return len(self.steps)

    @property
    def smem(self):
        return max(s.smem for s in self.steps)


def plan(n, entry, count):
    """The launch plan of one transform over ``count`` rows (rows entry)
    or ``count`` columns C (strided entry, views ``(L, n, C)``).  Raises
    ValueError when the gate declines ``n``.
    """
    n = int(n)
    if entry not in ENTRIES:
        raise ValueError(f"fused_fft: unknown entry {entry!r}")
    if not supports(n):
        raise ValueError(f"fused_fft: the kernel does not take n={n} (needs "
                         f"n > {MIN_N}, 5-smooth, one row within "
                         f"{SMEM_LIMIT} bytes of shared memory)")
    count = max(1, int(count))
    if entry == "rows":
        fit = (SMEM_LIMIT - 8 * twiddle_entries(n)) // (16 * n)
        tile = max(1, min(count, ROWS_POINTS // n, fit))
        radices = passes(n)
        tx = min(_threads(radices, n), rows_thread_cap(radices) // tile)
        step = Step(n, radices, (tx, tile), smem_bytes(n, tile))
        return Plan(n, entry, tile, (step,), 4 * n)
    n1, n2 = split(n)
    steps = []
    for m, cols in ((n1, n2 * count), (n2, count)):
        radices = passes(m)
        ty = _threads(radices, m)
        # a step of few butterflies a sequence takes more columns, so that
        # a block has at least 128 threads
        tile = min(cols, STRIDED_TILE * max(1, 8 // ty))
        ty = min(ty, MAX_THREADS // tile)
        smem = 2 * 8 * m * tile + 8 * (twiddle_entries(m)
                                       + twiddle_entries(n))
        steps.append(Step(m, radices, (tile, ty), smem))
    tile = min(s.block[0] for s in steps)
    return Plan(n, entry, tile, tuple(steps), 4 * tile)


@functools.lru_cache(maxsize=64)
def _twiddle_tables(n):
    k = np.arange(TW_SPLIT, dtype=np.float64)
    h = np.arange(twiddle_entries(n) - TW_SPLIT, dtype=np.float64) * TW_SPLIT
    both = np.concatenate([k, h])
    return torch.from_numpy(np.exp(-2j * np.pi * both / n).astype(
        np.complex64))


@functools.lru_cache(maxsize=64)
def _device_tables(n, device):
    return _twiddle_tables(n).to(device)


def twiddle_tables(n, device="cpu"):
    """The kernel's twiddle tables for length ``n``, one complex64
    tensor: ``exp(-2 pi i k / n)`` for k < 128, then ``exp(-2 pi i 128 h
    / n)`` for h < ceil(n / 128), each formed in float64 and rounded once.
    The twiddle of exponent e is ``t[e % 128] * t[128 + e // 128]``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _twiddle_tables(int(n))
    return _device_tables(int(n), str(dev))


def _twiddle(tables, e):
    """The kernel's twiddle of integer exponents ``e`` (a tensor)."""
    return (tables.index_select(0, (e % TW_SPLIT).reshape(-1))
            * tables.index_select(0, (TW_SPLIT + e // TW_SPLIT).reshape(-1))
            ).reshape(e.shape)


# ---------------------------------------------------------------------------
# plain version: the kernel's passes in PyTorch
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


def first_factor(r):
    """The radix a composite butterfly of ``r`` splits off first (the
    kernel's ``dft<R>``): 4, else 2, 3, 5."""
    for a in (4, 2, 3, 5):
        if r % a == 0:
            return a
    raise ValueError(r)


@functools.lru_cache(maxsize=None)
def _inner_twiddles(r):
    """The composite butterfly's constants exp(-2 pi i m / r), float64
    rounded to complex64 (the kernel's constant table)."""
    m = np.arange(r, dtype=np.float64)
    return torch.from_numpy(np.exp(-2j * np.pi * m / r).astype(np.complex64))


def _butterfly(v, radix):
    """The forward DFT of length ``radix`` over axis -2, with the kernel's
    arithmetic: 2, 3, 4, 5 directly; a composite radix r = a * b as
    a-point DFTs of the inputs b apart, the constants
    exp(-2 pi i j2 k1 / r), then b-point DFTs (output k1 + a*k2)."""
    if radix not in (2, 3, 4, 5):
        a = first_factor(radix)
        b = radix // a
        lead, nb = v.shape[:-2], v.shape[-1]
        # input b*j1 + j2 at [j1, j2]: a-point DFTs over j1
        u = _butterfly(v.reshape(*lead, a, b * nb), a).reshape(
            *lead, a, b, nb)
        k1 = torch.arange(a)[:, None]
        j2 = torch.arange(b)[None, :]
        tw = _inner_twiddles(radix).to(v.device)[(k1 * j2) % radix]
        u = torch.where((k1 * j2 % radix == 0).to(v.device)[..., None], u,
                        u * tw[..., None])
        y = _butterfly(u, b)          # [k1, k2]
        return y.transpose(-3, -2).reshape(*lead, radix, nb)
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
def _pass_maps(m, radices):
    """Per pass: (radix, the twiddle exponent of each butterfly input
    (radix x m/radix, flattened) or None, the butterfly output that lands
    at each position).  The plain version gathers with ``index_select``:
    advanced indexing and scatters take tens of milliseconds a call in
    PyTorch's multi-threaded CPU path at these sizes."""
    maps = []
    ns = 1
    for r in radices:
        nb = m // r
        j = np.arange(nb)
        k = j % ns
        rr = np.arange(r)[:, None]
        tw = None if ns == 1 else torch.from_numpy(
            (rr * k[None, :] * (m // (ns * r))).reshape(-1))
        # output r of butterfly j goes to (j - k) * r + k + r * ns
        dest = (((j - k) * r + k)[None, :] + rr * ns).reshape(-1)
        src = np.empty(m, np.int64)
        src[dest] = np.arange(m)
        maps.append((r, tw, torch.from_numpy(src)))
        ns *= r
    return maps


def _passes_ref(z, m, radices):
    """The Stockham passes on the last axis of complex64 ``z``."""
    tables = twiddle_tables(m, z.device)
    for r, texp, src in _pass_maps(m, tuple(radices)):
        v = z.reshape(*z.shape[:-1], r, m // r)
        if texp is not None:
            v = v * _twiddle(tables, texp.to(z.device)).reshape(r, -1)
        y = _butterfly(v, r).reshape(*z.shape[:-1], m)
        z = y.index_select(-1, src.to(z.device))
    return z


def _window(window, n):
    start, length = (0, n) if window is None else (int(window[0]),
                                                   int(window[1]))
    if not (0 <= start and length >= 0 and start + length <= n):
        raise ValueError(f"fused_fft: window {window} outside 0..{n}")
    return start, length


def fused_fft_ref(x, entry, inverse=False, real_out=False, mul=None,
                  scale=1.0, n=None, window=None):
    """Plain version of :func:`fft_rows` (``entry="rows"``, ``x`` of shape
    ``(R, m)``) and :func:`fft_strided` (``entry="strided"``, ``x`` of
    shape ``(L, m, C)``), with the same options: the load (the zero pad
    of the axis from m to ``n``, real input, product by ``mul``,
    conjugate for the inverse), the kernel's passes (complex64
    throughout, the same twiddle tables and butterflies; the strided
    entry's four steps) and the store (conjugate, ``scale``, real part,
    the crop to ``window``)."""
    _check_args(x, entry, inverse, mul, n)
    ax = -1 if entry == "rows" else 1
    m_in = x.shape[ax]
    n = m_in if n is None else int(n)
    if factorize(n) is None:
        raise ValueError(f"fused_fft_ref: n={n} is not 5-smooth")
    start, length = _window(window, n)
    z = x.to(torch.complex64)
    if n > m_in:
        zeros = list(z.shape)
        zeros[ax] = n - m_in
        z = torch.cat([z, z.new_zeros(zeros)], dim=ax)
    if mul is not None:
        z = z * mul
    if inverse:
        z = torch.conj_physical(z)
    if entry == "rows":
        z = _passes_ref(z.contiguous(), n, passes(n))
    else:
        z = _four_step_ref(z, n)
    if inverse:
        z = torch.conj_physical(z)
    if scale != 1.0:
        z = z * np.float32(scale)
    z = z.narrow(ax, start, length).contiguous()
    return z.real.contiguous() if real_out else z


def _four_step_ref(z, n):
    """The strided entry's two steps on (L, n, C): length-n1 passes of
    the (L, n1, n2, C) view with the twiddle w_n^(j2*k1) at their store,
    then length-n2 passes, output row k1 + n1*k2."""
    L, _, C = z.shape
    n1, n2 = split(n)
    v = z.reshape(L, n1, n2, C).permute(0, 2, 3, 1)   # (L, j2, c, j1)
    v = _passes_ref(v.contiguous(), n1, passes(n1))   # (L, j2, c, k1)
    e = torch.arange(n2)[:, None] * torch.arange(n1)[None, :]
    tw = _twiddle(twiddle_tables(n, z.device), e.to(z.device))
    v = v * tw[:, None, :]
    v = v.permute(0, 3, 2, 1).contiguous()            # (L, k1, c, j2)
    v = _passes_ref(v, n2, passes(n2))                # (L, k1, c, k2)
    return v.permute(0, 3, 1, 2).reshape(L, n, C)     # row k1 + n1*k2


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------


def _check_args(x, entry, inverse, mul, n=None):
    if entry not in ENTRIES:
        raise ValueError(f"fused_fft: unknown entry {entry!r}")
    want = 2 if entry == "rows" else 3
    if x.ndim != want:
        raise ValueError(f"fused_fft {entry}: a {want}-D tensor expected, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"fused_fft takes float32 (real input) or "
                         f"complex64 data, got {x.dtype}")
    m_in = x.shape[-1] if entry == "rows" else x.shape[1]
    if n is not None and int(n) < m_in:
        raise ValueError(f"fused_fft: n={n} is shorter than the axis "
                         f"({m_in})")
    if mul is not None:
        if mul.dtype != torch.complex64:
            raise ValueError("fused_fft: mul must be complex64")
        if n is not None and int(n) != m_in:
            raise ValueError("fused_fft: mul with a zero-padded input")
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
    # x, mul, out, tables, then rows: R, m_in, mul row stride, n, start,
    # length, tile, threads, npasses, radices, flags, scale, stream
    lib.fft_rows.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_void_p])
    # x, mul, out, tables of m, tables of the twiddle's n, then planes,
    # columns M, input plane stride, mul plane stride, m, the input's rows
    # and their multiplier, the output row multiplier P, the twiddle's n
    # and its column divisor, start, length, tile, threads y, npasses,
    # radices, flags, scale, stream
    lib.fft_strided.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 11
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_void_p])
    lib.fft_rows.restype = ctypes.c_int
    lib.fft_strided.restype = ctypes.c_int
    return lib


# flags of a launch (the kernel's kReal* / kConj* bits)
_REAL_IN, _CONJ_IN, _CONJ_OUT, _REAL_OUT = 1, 2, 4, 8


def _raise(err, entry):
    if err != 0:
        raise RuntimeError(f"fused_fft kernel ({entry}) launch failed: CUDA "
                           f"error {err}")


def _launch_rows(x, inverse, real_out, mul, scale, n, window):
    rows, m_in = x.shape
    p = plan(n, "rows", rows)
    start, length = _window(window, n)
    out = torch.empty((rows, length), device=x.device,
                      dtype=torch.float32 if real_out else torch.complex64)
    if out.numel() == 0:
        return out
    mptr, mstride = 0, 0
    if mul is not None:
        mul, mstride = _mul_stride(x, mul)
        mptr = mul.data_ptr()
    step = p.steps[0]
    radices = np.asarray(step.radices, np.int32)
    flags = ((_REAL_IN if not x.is_complex() else 0)
             | ((_CONJ_IN | _CONJ_OUT) if inverse else 0)
             | (_REAL_OUT if real_out else 0))
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.fft_rows(
            x.data_ptr(), mptr, out.data_ptr(),
            twiddle_tables(n, x.device).data_ptr(), rows, m_in, mstride, n,
            start, length, p.tile, step.block[0], len(radices),
            radices.ctypes.data, flags, float(scale),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise(err, "rows")
    fft_rows.launches += 1
    return out


def _launch_strided(x, inverse, real_out, mul, scale, n, window):
    L, m_in, C = x.shape
    p = plan(n, "strided", C)
    if split(n)[1] * C >= 2 ** 31:  # the first step's row, 32-bit
        raise ValueError(f"fused_fft strided: {C} columns exceed the "
                         "kernel's 32-bit rows")
    start, length = _window(window, n)
    out = torch.empty((L, length, C), device=x.device,
                      dtype=torch.float32 if real_out else torch.complex64)
    if out.numel() == 0:
        return out
    mptr, mstride = 0, 0
    if mul is not None:
        mul, mstride = _mul_stride(x, mul)
        mptr = mul.data_ptr()
    (n1, r1, b1), (n2, r2, b2) = ((s.m, s.radices, s.block)
                                  for s in p.steps)
    mid = torch.empty((L, n, C), device=x.device, dtype=torch.complex64)
    tw_n = twiddle_tables(n, x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # step 1: (L, n1, n2*C) -> mid, the twiddle w_n^(j2*k1) at the store
        rad = np.asarray(r1, np.int32)
        err = lib.fft_strided(
            x.data_ptr(), mptr, mid.data_ptr(),
            twiddle_tables(n1, x.device).data_ptr(), tw_n.data_ptr(), L,
            n2 * C, m_in * C, mstride, n1, m_in, n2, 1, n, C, 0, n1, b1[0],
            b1[1],
            len(rad), rad.ctypes.data,
            (_REAL_IN if not x.is_complex() else 0)
            | (_CONJ_IN if inverse else 0), 1.0, stream)
        _raise(err, "strided")
        fft_strided.launches += 1
        # step 2: (L*n1, n2, C) -> out rows k1 + n1*k2 inside the window
        rad = np.asarray(r2, np.int32)
        err = lib.fft_strided(
            mid.data_ptr(), 0, out.data_ptr(),
            twiddle_tables(n2, x.device).data_ptr(), tw_n.data_ptr(),
            L * n1, C, n2 * C, 0, n2, n2, 1, n1, 0, C, start, length,
            b2[0], b2[1], len(rad), rad.ctypes.data,
            ((_CONJ_OUT if inverse else 0)
             | (_REAL_OUT if real_out else 0)), float(scale), stream)
    _raise(err, "strided")
    fft_strided.launches += 1
    return out


def _launch_check(x, mul):
    if not x.is_cuda:
        raise ValueError("fused_fft kernel: a CUDA tensor expected")
    if not x.is_contiguous():
        raise ValueError("fused_fft kernel takes a contiguous tensor")
    if mul is not None and mul.device != x.device:
        raise ValueError("fused_fft kernel: mul on another device")


def fft_rows(x, inverse=False, real_out=False, mul=None, scale=1.0, n=None,
             window=None):
    """Transform every row of ``x``, an ``(R, m)`` float32 (real input)
    or complex64 tensor, at length ``n`` (default m; a longer n reads
    zeros beyond the row's end): forward, or with ``inverse`` the
    unnormalized inverse (``scale`` supplies any normalization).
    ``mul``, complex64 of shape ``(m,)``, ``(1, m)`` or ``(R, m)``,
    multiplies the input before the transform; ``real_out`` returns the
    real part as float32; ``window=(start, length)`` returns only those
    outputs of each row.

    A CUDA tensor launches the kernel's rows entry (and counts one in
    ``fft_rows.launches``); a CPU tensor runs :func:`fused_fft_ref`.
    """
    _check_args(x, "rows", inverse, mul, n)
    n = x.shape[-1] if n is None else int(n)
    if x.device.type == "cpu":
        return fused_fft_ref(x, "rows", inverse, real_out, mul, scale, n,
                             window)
    _launch_check(x, mul)
    return _launch_rows(x, inverse, real_out, mul, scale, n, window)


fft_rows.launches = 0


def fft_strided(x, inverse=False, real_out=False, mul=None, scale=1.0,
                n=None, window=None):
    """Transform the middle axis of ``x``, an ``(L, m, C)`` float32 (real
    input) or complex64 tensor; the options as :func:`fft_rows`, with
    ``mul`` of shape ``(m, C)``, ``(1, m, C)`` or ``(L, m, C)`` and the
    window over the middle axis.

    A CUDA tensor launches the kernel's strided entry twice (the two
    steps, each counted in ``fft_strided.launches``); a CPU tensor runs
    :func:`fused_fft_ref`.
    """
    _check_args(x, "strided", inverse, mul, n)
    n = x.shape[1] if n is None else int(n)
    if x.device.type == "cpu":
        return fused_fft_ref(x, "strided", inverse, real_out, mul, scale, n,
                             window)
    _launch_check(x, mul)
    return _launch_strided(x, inverse, real_out, mul, scale, n, window)


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


def _fft_axis(x, axis, inverse, real_out, mul, scale, n=None, window=None):
    ax = axis % x.ndim
    m = x.shape[ax]
    n = m if n is None else int(n)
    if mul is not None:
        mul = _mul_view(mul, x, ax)
    if ax == x.ndim - 1:
        rows = x.reshape(-1, m)
        mm = None if mul is None else mul.reshape(-1, m)
        y = fft_rows(rows.contiguous(), inverse, real_out, mm, scale, n,
                     window)
    else:
        lead = int(np.prod(x.shape[:ax], dtype=np.int64))
        c = int(np.prod(x.shape[ax + 1:], dtype=np.int64))
        mm = None if mul is None else mul.reshape(-1, m, c)
        y = fft_strided(x.reshape(lead, m, c).contiguous(), inverse,
                        real_out, mm, scale, n, window)
    shape = list(x.shape)
    shape[ax] = _window(window, n)[1]
    return y.reshape(shape)


def fft_axis(x, axis, inverse=False, real_out=False, mul=None, n=None,
             window=None):
    """Natural-order transform of ``x`` along ``axis`` at length ``n``
    (default the axis'; longer reads zeros) (counterpart of
    ``pallas_fft.fft_axis``): the last axis on the rows entry, any other
    on the strided entry.  The inverse is normalized by 1/n; ``mul``
    broadcasts against ``x``; ``window=(start, length)`` keeps only those
    outputs of the axis."""
    n = x.shape[axis] if n is None else int(n)
    return _fft_axis(x, axis, inverse, real_out, mul,
                     1.0 / n if inverse else 1.0, n, window)


def fft2(x, inverse=False, real_out=False, mul=None, s=None, window=None):
    """Natural-order 2-D transform over the last two axes (leading axes
    are batch) at sizes ``s`` (default the axes'; longer reads zeros), as
    two passes: forward rows then strided (a real input is read by the
    rows pass, only its rows); inverse strided then rows, with ``mul``
    folded into the first pass, and 1/(n0*n1), ``real_out`` and the crop
    ``window=((start0, length0), (start1, length1))`` into the passes'
    stores (counterpart of ``pallas_fft.fft2``)."""
    n0, n1 = (x.shape[-2:] if s is None else (int(s[0]), int(s[1])))
    w0, w1 = (None, None) if window is None else window
    if not inverse:
        y = _fft_axis(x, -1, False, False, mul, 1.0, n1, w1)
        return _fft_axis(y, -2, False, real_out, None, 1.0, n0, w0)
    y = _fft_axis(x, -2, True, False, mul, 1.0, n0, w0)
    return _fft_axis(y, -1, True, real_out, None, 1.0 / (n0 * n1), n1, w1)
