"""scipy.signal's FFT-domain convolution family on torch tensors.

The port of ``cupyimg_tpu/scipy/signal/signaltools.py``'s FFT half:
``fftconvolve``, ``oaconvolve``, ``convolve``/``correlate`` with their
method dispatch (``choose_conv_method``), ``hilbert``, ``hilbert2``,
``resample`` and ``next_fast_len``.

A real float32 (or narrower) product on a CUDA tensor runs on the
hand-written FFT kernel (``ops/fused_fft.py``) when the gate takes the
padded sizes: over the last two axes (:func:`_fused_fft2_real_conv`) or the
last axis (:func:`_fused_fft1_real_conv`), with at least
``_FUSED_FFT_MIN_POINTS`` transform points.  Everything else takes
``torch.fft``: float64, complex, CPU tensors, other axes, sizes the gate
declines.  The route is decided before any launch; a CUDA tensor inside
the gate launches the kernel or raises.  The direct method's correlation
runs on the dense kernel (``ops/fused_dense.py``) where its gate admits
the call.

Where the JAX package branches on a TPU backend (``next_fast_len``'s
multiples of 128, ``choose_conv_method``'s measured per-tap costs,
``convolve(method="fft")``'s 1-D overlap-add detour, ``oaconvolve``'s
``min_long``), the port takes the other branch on every device.
"""

from __future__ import annotations

import contextlib
import functools
import math
import timeit

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.ops import fused_dense, fused_fft

__all__ = [
    "choose_conv_method",
    "convolve",
    "correlate",
    "fftconvolve",
    "oaconvolve",
    "hilbert",
    "hilbert2",
    "resample",
    "next_fast_len",
]

# Below this many transform points a product stays on torch.fft;
# module-level so that tests can lower it.
_FUSED_FFT_MIN_POINTS = 1 << 20
# A second operand of at most this many samples along every transformed
# axis has its spectrum computed by a direct DFT matrix product: it is
# never padded to the full size, and the first operand's forward pass
# stays real-input.
_SMALL_DFT_MAX = 128


def next_fast_len(target: int) -> int:
    """The smallest 5-smooth size (a product of 2, 3 and 5) >= target."""
    target = int(target)
    if target <= 6:
        return max(target, 1)
    if not (target & (target - 1)):  # power of 2
        return target
    best = 1 << (target - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            quotient = -(-target // p35)
            p2 = 1 << (int(quotient) - 1).bit_length() if quotient > 1 else 1
            n = p2 * p35
            if n == target:
                return n
            if n < best:
                best = n
            p35 *= 3
        p5 *= 5
    return best


def _np_dtype(t):
    return dtypes.to_numpy(t.dtype)


def _promote(a, b):
    """numpy's promotion of two tensors' dtypes, as a torch dtype."""
    return dtypes.to_torch(np.promote_types(_np_dtype(a), _np_dtype(b)))


def _operands(in1, in2):
    in1 = util.as_tensor(in1)
    return in1, util.as_tensor(in2, device=in1.device)


def _reverse_and_conj(x):
    x = torch.flip(x, tuple(range(x.ndim)))
    return torch.conj_physical(x) if x.is_complex() else x


def _inputs_swap_needed(mode, shape1, shape2, axes=None):
    if mode != "valid":
        return False
    if axes is None:
        axes = range(len(shape1))
    ok1 = all(shape1[i] >= shape2[i] for i in axes)
    ok2 = all(shape2[i] >= shape1[i] for i in axes)
    if not (ok1 or ok2):
        raise ValueError(
            "For 'valid' mode, one must be at least "
            "as large as the other in every dimension"
        )
    return not ok1


def _centered(arr, newshape):
    starts = [(c - n) // 2 for c, n in zip(arr.shape, newshape)]
    return arr[tuple(slice(s, s + int(n)) for s, n in zip(starts, newshape))]


def _apply_conv_mode(ret, s1, s2, mode, axes):
    if mode == "full":
        return ret
    if mode == "same":
        return _centered(ret, s1)
    if mode == "valid":
        shape_valid = [
            ret.shape[a] if a not in axes else s1[a] - s2[a] + 1
            for a in range(ret.ndim)
        ]
        return _centered(ret, shape_valid)
    raise ValueError("acceptable mode flags are 'valid', 'same', or 'full'")


def _init_freq_conv_axes(in1, in2, mode, axes, sorted_axes=False):
    s1, s2 = in1.shape, in2.shape
    if axes is None:
        axes = list(range(in1.ndim))
    else:
        axes = [util.check_axis(int(a), in1.ndim) for a in np.atleast_1d(axes)]
        if not len(axes):
            raise ValueError("when provided, axes cannot be empty")
    axes = [a for a in axes if s1[a] != 1 or s2[a] != 1]
    if sorted_axes:
        axes.sort()
    for a in range(in1.ndim):
        if a not in axes and s1[a] != s2[a] and s1[a] != 1 and s2[a] != 1:
            raise ValueError(
                f"incompatible shapes for in1 and in2: {tuple(s1)} and "
                f"{tuple(s2)}"
            )
    if _inputs_swap_needed(mode, s1, s2, axes=axes):
        in1, in2 = in2, in1
    return in1, in2, axes


def _zero_pad(x, pads):
    """``x`` zero-extended by ``pads``, one (before, after) per axis."""
    if not any(lo or hi for lo, hi in pads):
        return x
    shape = [s + lo + hi for s, (lo, hi) in zip(x.shape, pads)]
    out = x.new_zeros(shape)
    out[tuple(slice(lo, lo + s) for s, (lo, _) in zip(x.shape, pads))] = x
    return out


@contextlib.contextmanager
def _no_tf32():
    """Full float32 matrix products and convolutions on the card (no TF32),
    restoring the caller's settings after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# the routes of the frequency-domain product
# ---------------------------------------------------------------------------


def _narrow_real(t):
    """float32 or narrower real data (the kernel's float32 path)."""
    return t.dtype in (torch.float16, torch.bfloat16, torch.float32)


def _fused_fft2_applies(in1, in2, axes, fshape):
    """Route a real product over exactly the last two axes through the
    FFT kernel's two passes (:func:`fused_fft.fft2`)?"""
    nd = in1.ndim
    if not in1.is_cuda or nd < 2 or sorted(axes) != [nd - 2, nd - 1]:
        return False
    if not (_narrow_real(in1) and _narrow_real(in2)):
        return False
    lead = int(np.prod(in1.shape[:nd - 2], dtype=np.int64))
    if lead * int(fshape[0]) * int(fshape[1]) < _FUSED_FFT_MIN_POINTS:
        return False
    return fused_fft.supports(fshape[0]) and fused_fft.supports(fshape[1])


def _fused_fft1_applies(in1, in2, axes, fshape):
    """Route a real product over the last axis through the kernel's rows
    entry?  Covers 1-D fftconvolve and the batched blocks of 1-D
    overlap-add; leading axes are batch and broadcast."""
    nd = in1.ndim
    if not in1.is_cuda or list(axes) != [nd - 1]:
        return False
    if not (_narrow_real(in1) and _narrow_real(in2)):
        return False
    n = int(fshape[0])
    lead = max(int(np.prod(in1.shape[:nd - 1], dtype=np.int64)),
               int(np.prod(in2.shape[:nd - 1], dtype=np.int64)))
    if lead * n < _FUSED_FFT_MIN_POINTS:
        return False
    return fused_fft.supports(n)


@functools.lru_cache(maxsize=16)
def _dft_consts(n, m, device):
    """(Er, Ei) float32 (n, m): E[k, t] = exp(-2j pi k t / n), a DFT
    matrix restricted to the first m inputs, natural bin order."""
    k = np.arange(n, dtype=np.float64)
    t = np.arange(m, dtype=np.float64)
    ang = (-2.0 * np.pi / n) * np.outer(k, t)
    return tuple(torch.from_numpy(v.astype(np.float32)).to(device)
                 for v in (np.cos(ang), np.sin(ang)))


def _pad_to(v, axes, fshape):
    pads = [(0, 0)] * v.ndim
    for a, n in zip(axes, fshape):
        pads[a] = (0, int(n) - v.shape[a])
    return _zero_pad(v.to(torch.float32), pads)


def _product_inverse(f1, f2, inverse):
    """``inverse(x, mul)`` of the product of two spectra whose leading
    axes broadcast: the full-shaped one is the kernel's input, the other
    its ``mul`` (the kernel broadcasts it)."""
    common = torch.broadcast_shapes(f1.shape, f2.shape)
    if f1.shape != common:
        f1, f2 = f2, f1
    if f1.shape != common:
        f1 = f1.broadcast_to(common).contiguous()
    return inverse(f1, f2)


def _fused_fft2_real_conv(in1, in2, axes, fshape):
    """Real convolution over the last two axes on the FFT kernel: two
    forward passes per operand (a direct DFT product for a small second
    operand), the spectrum product folded into the inverse's first pass,
    1/(n0*n1) and the real part into its second."""
    n0, n1 = (int(s) for s in fshape)
    last2 = (in1.ndim - 2, in1.ndim - 1)
    m = tuple(int(s) for s in in2.shape[-2:])
    f1 = fused_fft.fft2(_pad_to(in1, last2, fshape))
    if max(m) <= _SMALL_DFT_MAX and (m[0] < n0 or m[1] < n1):
        e0r, e0i = _dft_consts(n0, m[0], str(in2.device))
        e1r, e1i = _dft_consts(n1, m[1], str(in2.device))
        b = in2.to(torch.float32)
        with _no_tf32():
            t0r, t0i = e0r @ b, e0i @ b
            kr = t0r @ e1r.T - t0i @ e1i.T
            ki = t0r @ e1i.T + t0i @ e1r.T
        f2 = torch.complex(kr, ki)
    else:
        f2 = fused_fft.fft2(_pad_to(in2, last2, fshape))
    return _product_inverse(f1, f2, lambda x, mul: fused_fft.fft2(
        x, inverse=True, real_out=True, mul=mul))


def _fused_fft1_real_conv(in1, in2, axes, fshape):
    """Real last-axis convolution on the kernel's rows entry: the product
    folded into the inverse pass; a short second operand is transformed
    by one direct DFT product."""
    n = int(fshape[0])
    last = (in1.ndim - 1,)
    m = int(in2.shape[-1])
    f1 = fused_fft.fft_axis(_pad_to(in1, last, fshape), -1)
    if m <= _SMALL_DFT_MAX and m < n:
        er, ei = _dft_consts(n, m, str(in2.device))
        b = in2.to(torch.float32)
        with _no_tf32():
            f2 = torch.complex(b @ er.T, b @ ei.T)
    else:
        f2 = fused_fft.fft_axis(_pad_to(in2, last, fshape), -1)
    return _product_inverse(f1, f2, lambda x, mul: fused_fft.fft_axis(
        x, -1, inverse=True, real_out=True, mul=mul))


def _transform_dtype(t):
    """scipy.fft's transform dtype: integers and bool in float64, float16
    (and bfloat16) in float32."""
    if t.is_complex() or t.dtype in (torch.float32, torch.float64):
        return t
    if t.is_floating_point():
        return t.to(torch.float32)
    return t.to(torch.float64)


def _freq_domain_conv(in1, in2, axes, shape, calc_fast_len=False):
    """Multiply the spectra of ``in1`` and ``in2`` along ``axes``."""
    if not len(axes):
        return in1 * in2
    complex_result = in1.is_complex() or in2.is_complex()
    if calc_fast_len:
        fshape = [next_fast_len(shape[a]) for a in axes]
    else:
        fshape = [shape[a] for a in axes]
    if not complex_result and _fused_fft2_applies(in1, in2, axes, fshape):
        ret = _fused_fft2_real_conv(in1, in2, axes, fshape)
    elif not complex_result and _fused_fft1_applies(in1, in2, axes, fshape):
        ret = _fused_fft1_real_conv(in1, in2, axes, fshape)
    else:
        in1, in2 = _transform_dtype(in1), _transform_dtype(in2)
        if not complex_result:
            sp1 = torch.fft.rfftn(in1, fshape, dim=axes)
            sp2 = torch.fft.rfftn(in2, fshape, dim=axes)
            ret = torch.fft.irfftn(sp1 * sp2, fshape, dim=axes)
        else:
            sp1 = torch.fft.fftn(in1, fshape, dim=axes)
            sp2 = torch.fft.fftn(in2, fshape, dim=axes)
            ret = torch.fft.ifftn(sp1 * sp2, dim=axes)
    sl = [slice(None)] * ret.ndim
    for a in axes:
        sl[a] = slice(0, shape[a])
    return ret[tuple(sl)]


def _empty_result(in1, in2):
    return torch.tensor([], dtype=_promote(in1, in2), device=in1.device)


def fftconvolve(in1, in2, mode="full", axes=None):
    """Convolve two N-d tensors by FFT (scipy.signal.fftconvolve)."""
    in1, in2 = _operands(in1, in2)
    if in1.ndim == in2.ndim == 0:
        return in1 * in2
    if in1.ndim != in2.ndim:
        raise ValueError("in1 and in2 should have the same dimensionality")
    if in1.numel() == 0 or in2.numel() == 0:
        return _empty_result(in1, in2)
    in1, in2, axes = _init_freq_conv_axes(in1, in2, mode, axes)
    s1, s2 = in1.shape, in2.shape
    shape = [
        max(s1[i], s2[i]) if i not in axes else s1[i] + s2[i] - 1
        for i in range(in1.ndim)
    ]
    ret = _freq_domain_conv(in1, in2, axes, shape, calc_fast_len=True)
    return _apply_conv_mode(ret, s1, s2, mode, axes)


def oaconvolve(in1, in2, mode="full", axes=None):
    """Convolve two N-d tensors by overlap-add (scipy.signal.oaconvolve).

    The axis where blocking pays most is cut into blocks of scipy's
    Lambert-W optimum length; all blocks convolve with the short operand
    in one batched frequency-domain product, and the overlapping tails
    fold back with one shift-add.  Axes that do not benefit fall through
    to :func:`fftconvolve`.
    """
    in1, in2 = _operands(in1, in2)
    if in1.ndim == in2.ndim == 0:
        return in1 * in2
    if in1.ndim != in2.ndim:
        raise ValueError("in1 and in2 should have the same dimensionality")
    if in1.numel() == 0 or in2.numel() == 0:
        return _empty_result(in1, in2)
    if in1.shape == in2.shape:
        return fftconvolve(in1, in2, mode=mode, axes=axes)
    in1, in2, axes = _init_freq_conv_axes(in1, in2, mode, axes,
                                          sorted_axes=True)
    s1, s2 = in1.shape, in2.shape

    # the axis with the largest length ratio, at least 4
    best_axis, best_ratio = None, 4.0
    for a in axes:
        lo, hi = sorted((s1[a], s2[a]))
        if lo > 1 and hi / lo > best_ratio:
            best_axis, best_ratio = a, hi / lo
    if best_axis is None:
        return fftconvolve(in1, in2, mode=mode, axes=axes)
    a = best_axis

    swapped = s2[a] > s1[a]
    x_long, x_short = (in2, in1) if swapped else (in1, in2)
    L = x_short.shape[a]
    n_long = x_long.shape[a]
    # the optimal block length (scipy's Lambert-W derivation), on the host
    from scipy.special import lambertw

    overlap = L - 1
    opt = -overlap * np.real(lambertw(-1 / (2 * math.e * overlap), k=-1)) / 2
    block = max(next_fast_len(int(math.ceil(opt))), 2 * L - 1)
    step = block - L + 1

    nblocks = -(-n_long // step)
    pads = [(0, 0)] * x_long.ndim
    pads[a] = (0, nblocks * step - n_long)
    xp = _zero_pad(x_long, pads)
    xb = xp.reshape(xp.shape[:a] + (nblocks, step) + xp.shape[a + 1:])
    short_b = x_short.unsqueeze(a)  # broadcast over the blocks

    shape_arg = [max(xb.shape[ax], short_b.shape[ax])
                 for ax in range(xb.ndim)]
    for ax in axes:
        if ax == a:
            shape_arg[a + 1] = block
        else:
            axm = ax + 1 if ax > a else ax
            shape_arg[axm] = xb.shape[axm] + short_b.shape[axm] - 1
    ret = _freq_domain_conv(
        xb, short_b, [ax + 1 if ax >= a else ax for ax in axes], shape_arg,
        calc_fast_len=False,
    )

    # overlap-add along (nblocks, block) -> nblocks*step + L - 1
    main = ret.narrow(a + 1, 0, step)
    tail_pad = [(0, 0)] * ret.ndim
    tail_pad[a + 1] = (0, step - (L - 1))
    tail = _zero_pad(ret.narrow(a + 1, step, block - step), tail_pad)
    flat_shape = ret.shape[:a] + (nblocks * step,) + ret.shape[a + 2:]
    zpad = [(0, 0)] * len(flat_shape)
    zpad[a] = (0, step)
    main_ext = _zero_pad(main.reshape(flat_shape), zpad)
    zpad[a] = (step, 0)
    tail_ext = _zero_pad(tail.reshape(flat_shape), zpad)
    full = (main_ext + tail_ext).narrow(a, 0, n_long + L - 1)
    return _apply_conv_mode(full, s1, s2, mode, axes)


# ---------------------------------------------------------------------------
# direct method and its dispatch
# ---------------------------------------------------------------------------


def _shift_add_corr(xp, w, out_shape):
    """VALID correlation as shifted multiply-adds over every tap."""
    out = None
    for idx in np.ndindex(*w.shape):
        sl = tuple(slice(i, i + n) for i, n in zip(idx, out_shape))
        term = float(w[idx]) * xp[sl]
        out = term if out is None else out + term
    return out


def _direct_corr_real(xp, w, out_shape):
    """VALID real correlation ``out[i] = sum_k w[k] xp[i + k]`` of a
    pre-padded tensor with host weights ``w`` (numpy, in ``xp``'s dtype).

    A CUDA float32 2-D/3-D call that the dense kernel's gate admits runs
    on it; elsewhere up to 64 taps (or more than three axes) are summed
    as shifted slices, and larger kernels go to one convolution
    (TF32 off)."""
    nd = xp.ndim
    if fused_dense.supports_dense(xp, w):
        # the interior of the centred constant-mode correlation
        full = fused_dense.fused_dense_correlate(
            xp.contiguous(), w.astype(np.float64), [0] * nd, "constant", 0.0)
        return full[tuple(slice(s // 2, s // 2 + n)
                          for s, n in zip(w.shape, out_shape))]
    if nd > 3 or w.size <= 64:
        return _shift_add_corr(xp, w, out_shape)
    conv = (torch.nn.functional.conv1d, torch.nn.functional.conv2d,
            torch.nn.functional.conv3d)[nd - 1]
    wt = torch.from_numpy(np.ascontiguousarray(w)).to(xp.device)
    with _no_tf32():
        return conv(xp[None, None], wt[None, None])[0, 0]


def _direct_correlate_nd(in1, w, mode):
    """Direct nd correlation ``out[i] = sum_k w[k] in1[i+k]`` with zero
    extension, modes full/same/valid; ``w`` (numpy) is used as given
    (callers conjugate or flip)."""
    s1, s2 = in1.shape, w.shape
    dtype = np.promote_types(_np_dtype(in1), w.dtype)
    is_int = dtype.kind in "iub"
    acc = np.dtype(np.float64 if is_int else dtype)
    if acc.kind == "f":
        acc = np.promote_types(acc, np.float32)
    if mode in ("full", "same"):
        pads = [(k - 1, k - 1) for k in s2]
    elif mode == "valid":
        pads = [(0, 0)] * in1.ndim
    else:
        raise ValueError("acceptable mode flags are 'valid', 'same', or "
                         "'full'")
    xp = _zero_pad(in1.to(dtypes.to_torch(acc)), pads)
    out_shape = tuple(xp.shape[i] - s2[i] + 1 for i in range(in1.ndim))
    if acc.kind == "c":
        real = np.dtype(acc.char.lower())
        wr, wi = w.real.astype(real), w.imag.astype(real)
        xr, xi = xp.real.contiguous(), xp.imag.contiguous()
        rr = _direct_corr_real(xr, wr, out_shape)
        ii = _direct_corr_real(xi, wi, out_shape)
        ri = _direct_corr_real(xr, wi, out_shape)
        ir = _direct_corr_real(xi, wr, out_shape)
        out = torch.complex(rr - ii, ir + ri)
    else:
        out = _direct_corr_real(xp, w.astype(acc), out_shape)
    if mode == "same":
        out = _centered(out, s1)
    if is_int:
        out = torch.round(out)
    return out.to(dtypes.to_torch(dtype))


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def choose_conv_method(in1, in2, mode="full", measure=False):
    """'direct' or 'fft', by scipy's operation counts
    (scipy.signal.choose_conv_method); ``measure=True`` times both and
    returns ``(method, times)``."""
    volume, kernel = _operands(in1, in2)
    if measure:
        times = {}
        for method in ("fft", "direct"):
            def run(m=method):
                _sync(convolve(volume, kernel, mode=mode, method=m))

            times[method] = timeit.timeit(run, number=3)
        chosen = "fft" if times["fft"] < times["direct"] else "direct"
        return chosen, times
    kinds = _np_dtype(volume).kind + _np_dtype(kernel).kind
    if all(k in "iu" for k in kinds):
        # the fft result must round-trip exactly through float64
        max_value = float(volume.abs().max()) * float(kernel.abs().max()) * (
            min(volume.numel(), kernel.numel()))
        if max_value > 2 ** np.finfo(np.float64).nmant - 1:
            return "direct"
    if volume.dtype == torch.bool or kernel.dtype == torch.bool:
        return "direct"
    s1, s2 = volume.shape, kernel.shape
    if mode == "full":
        out_shape = [a + b - 1 for a, b in zip(s1, s2)]
    elif mode == "valid":
        out_shape = [abs(a - b) + 1 for a, b in zip(s1, s2)]
    else:
        out_shape = list(s1)
    direct_ops = float(min(np.prod(s1), np.prod(s2))) * float(
        np.prod(out_shape))
    n = float(np.prod([a + b - 1 for a, b in zip(s1, s2)]))
    fft_ops = 3.0 * n * np.log(max(n, 2.0))
    constant = 10963.92 if volume.ndim == 1 else 8899.11
    fft = (direct_ops > constant / 1e4 * fft_ops and direct_ops > 1e4
           and direct_ops > fft_ops * 2.5)
    return "fft" if fft else "direct"


def convolve(in1, in2, mode="full", method="auto"):
    """N-d convolution with method dispatch (scipy.signal.convolve)."""
    volume, kernel = _operands(in1, in2)
    if volume.ndim == kernel.ndim == 0:
        return volume * kernel
    if volume.ndim != kernel.ndim:
        raise ValueError("volume and kernel should have the same "
                         "dimensionality")
    if _inputs_swap_needed(mode, volume.shape, kernel.shape):
        volume, kernel = kernel, volume
    if method == "auto":
        method = choose_conv_method(volume, kernel, mode=mode)
    if method == "fft":
        out = fftconvolve(volume, kernel, mode=mode)
        result = _promote(volume, kernel)
        if not (result.is_floating_point or result.is_complex):
            out = torch.round(out)
        return out.to(result)
    if method == "direct":
        # convolution is correlation with the flipped kernel (no conj)
        w = np.flip(kernel.cpu().numpy())
        return _direct_correlate_nd(volume, w, mode)
    raise ValueError("Acceptable method flags are 'auto', 'direct', or "
                     "'fft'.")


def correlate(in1, in2, mode="full", method="auto"):
    """N-d cross-correlation with method dispatch
    (scipy.signal.correlate)."""
    in1, in2 = _operands(in1, in2)
    if in1.ndim == in2.ndim == 0:
        return in1 * (in2.conj() if in2.is_complex() else in2)
    if in1.ndim != in2.ndim:
        raise ValueError("in1 and in2 should have the same dimensionality")
    if method == "fft" or (
            method == "auto"
            and choose_conv_method(in1, in2, mode=mode) == "fft"):
        return convolve(in1, _reverse_and_conj(in2), mode, "fft")
    if method not in ("auto", "direct"):
        raise ValueError("Acceptable method flags are 'auto', 'direct', or "
                         "'fft'.")
    swapped = _inputs_swap_needed(mode, in1.shape, in2.shape)
    if swapped:
        in1, in2 = in2, in1
    w = in2.cpu().numpy()
    out = _direct_correlate_nd(in1, np.conj(w) if w.dtype.kind == "c" else w,
                               mode)
    if swapped:
        out = _reverse_and_conj(out)
    return out


# ---------------------------------------------------------------------------
# analytic signal and Fourier resampling (plain torch.fft)
# ---------------------------------------------------------------------------


def _real_input(x):
    x = util.as_tensor(x)
    if x.is_complex():
        raise ValueError("x must be real.")
    return _transform_dtype(x)


def hilbert(x, N=None, axis=-1):
    """The analytic signal of ``x`` along ``axis`` (scipy.signal.hilbert)."""
    x = _real_input(x)
    if N is None:
        N = x.shape[axis]
    if N <= 0:
        raise ValueError("N must be positive.")
    xf = torch.fft.fft(x, N, dim=axis).movedim(axis, -1)
    if N % 2 == 0:
        xf[..., 1:N // 2] *= 2.0
        xf[..., N // 2 + 1:N] = 0.0
    else:
        xf[..., 1:(N + 1) // 2] *= 2.0
        xf[..., (N + 1) // 2:N] = 0.0
    return torch.fft.ifft(xf.movedim(-1, axis), dim=axis)


def hilbert2(x, N=None, *, axes=(-2, -1)):
    """The 2-D analytic signal over ``axes`` (scipy.signal.hilbert2)."""
    x = _real_input(x)
    while x.ndim < 2:
        x = x.unsqueeze(0)
    if len(axes) != 2:
        raise ValueError("axes must be a tuple of length 2")
    if axes[0] == axes[1]:
        raise ValueError("axes must contain 2 distinct axes")
    if N is None:
        N = (x.shape[axes[0]], x.shape[axes[1]])
    elif isinstance(N, int):
        if N <= 0:
            raise ValueError("N must be positive.")
        N = (N, N)
    elif len(N) != 2 or np.any(np.asarray(N) <= 0):
        raise ValueError("When given as a tuple, N must hold exactly "
                         "two positive integers")
    xf = torch.fft.fft2(x, tuple(N), dim=axes).movedim(axes, (-2, -1))
    k0, k1 = (N[0] + 1) // 2, (N[1] + 1) // 2
    xf[..., 1:k0, :] *= 2.0
    xf[..., :, 1:k1] *= 2.0
    xf[..., k0:, :] = 0.0
    xf[..., :, k1:] = 0.0
    return torch.fft.ifft2(xf.movedim((-2, -1), axes), dim=axes)


def _spectral_window(window, n_x, device):
    """scipy.signal.resample's window: a callable of the frequencies, an
    array of ``n_x`` values, or a named window (scipy, on the host),
    centred by ``fftshift``; a float64 tensor."""
    if callable(window):
        w = window(np.fft.fftfreq(n_x))
    elif hasattr(window, "shape"):
        if tuple(window.shape) != (n_x,):
            raise ValueError(f"window.shape={tuple(window.shape)} != "
                             f"({n_x},), i.e., window length is not equal "
                             "to number of frequency bins!")
        w = window
    else:
        from scipy.signal import get_window

        w = np.fft.fftshift(get_window(window, n_x))
    w = util.as_tensor(w, device=device)
    return w.to(torch.float64) if not w.is_floating_point() else w.clone()


def resample(x, num, t=None, axis=0, window=None, domain="time"):
    """Resample ``x`` to ``num`` samples along ``axis`` in the Fourier
    domain (scipy.signal.resample); with ``t``, also returns the new
    sample positions."""
    if domain not in ("time", "freq"):
        raise ValueError(f"Parameter domain={domain!r} not in "
                         "('time', 'freq')!")
    x = util.as_tensor(x)
    x = _transform_dtype(x).movedim(axis, -1)
    num = int(num)
    n_x = x.shape[-1]
    s_fac = n_x / num
    m = min(num, n_x)
    m2 = m // 2 + 1
    w = None if window is None else _spectral_window(window, n_x, x.device)
    if domain == "time" and not x.is_complex():
        X = torch.fft.rfft(x)
        if w is not None:  # fold the window: (W[l] + W[-l]) / 2 for l > 0
            n_X = X.shape[-1]
            w[1:n_X] += torch.flip(w[-n_X + 1:], (0,))
            w[1:n_X] /= 2
            X = X * w[:n_X].to(X.real.dtype)
        X = X[..., :m2].clone()
        if m % 2 == 0 and num != n_x:  # the unpaired bin at m//2
            X[..., m // 2] *= 2 if num < n_x else 0.5
        y = torch.fft.irfft(X / s_fac, n=num)
    else:
        X = torch.fft.fft(x) if domain == "time" else x
        if w is not None:
            X = X * w.to(X.real.dtype if X.is_complex() else X.dtype)
        Y = X.new_zeros(X.shape[:-1] + (num,))
        Y[..., :m2] = X[..., :m2]
        if m2 < m:  # the negative frequencies
            Y[..., m2 - m:] = X[..., m2 - m:]
        if m % 2 == 0:  # the unpaired bin at m//2
            if num < n_x:
                Y[..., -m // 2] += X[..., -m // 2]
            elif n_x < num:
                Y[..., m // 2] /= 2
                Y[..., num - m // 2] = Y[..., m // 2]
        y = torch.fft.ifft(Y / s_fac, n=num)
    y = y.movedim(-1, axis)
    if t is None:
        return y
    t = util.as_tensor(t, device=y.device)
    t = t if t.is_floating_point() else t.to(torch.float64)
    return y, t[0] + (t[1] - t[0]) * s_fac * torch.arange(
        num, dtype=t.dtype, device=t.device)
