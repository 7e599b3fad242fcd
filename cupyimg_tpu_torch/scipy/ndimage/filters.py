"""scipy.ndimage filters on torch tensors.

API parity with scipy.ndimage for correlate/convolve (and their 1-d
forms), the uniform and gaussian filters, the derivative filters
(prewitt/sobel/laplace family), the min/max filters, the
rank/median/percentile filters and the generic filters, with the 8
ndimage boundary modes, the ``dtype_mode`` precision policy, and
complex-dtype support.

Routing of a CUDA call (every other call, CPU tensors included, takes
plain torch: ``ops/stencil.py``, ``ops/sorting_networks.py``):

- the separable filters, float32 2-D/3-D: ONE launch of the fused
  separable kernel (``ops/fused_separable.py``), whatever ``dtype_mode``
  says;
- ``correlate1d``/``convolve1d`` accumulating in float32
  (``dtype_mode="float"``; the default ``"ndimage"`` accumulates in
  float64 on the plain path), 2-D/3-D, at most 64 real taps: ONE launch
  of the fused separable kernel;
- ``correlate``/``convolve`` accumulating in float32
  (``dtype_mode="float"``) with weights the dense kernel admits: ONE
  launch of the dense kernel (``ops/fused_dense.py``);
- min/max filters over a full rectangle of sizes <= 64, float32
  2-D/3-D: ONE launch of the fused separable kernel's min/max op;
- rank/median/percentile filters of 3..64 taps whose output dtype is the
  input's, int32/float32 2-D/3-D: ONE launch of the rank kernel
  (``ops/fused_rank.py``); rank 0 and rank K-1 go to the min/max path.

Differences from scipy:

- ``output`` may be a dtype (or None) but not a preallocated array.
- A numpy or list ``input`` goes to ``config.device``; a tensor keeps its
  device.
- ``generic_filter``/``generic_filter1d`` take a function of torch
  tensors that ``torch.func.vmap`` can map over the windows (lines).
- ``dtype_mode="numpy"`` (the ``numpy`` layer's mode): the output dtype
  is ``np.promote_types(input, weights)``, integers accumulate in their
  own type and wrap as numpy's, float16 accumulates in float32, and
  ``output`` raises ValueError.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, dtypes, util
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.ops import fused_rank, fused_separable, stencil
from cupyimg_tpu_torch.ops.sorting_networks import rank_select

__all__ = [
    "generic_filter",
    "generic_filter1d",
    "correlate",
    "convolve",
    "correlate1d",
    "convolve1d",
    "uniform_filter",
    "uniform_filter1d",
    "gaussian_filter",
    "gaussian_filter1d",
    "prewitt",
    "sobel",
    "generic_laplace",
    "laplace",
    "gaussian_laplace",
    "generic_gradient_magnitude",
    "gaussian_gradient_magnitude",
    "minimum_filter",
    "maximum_filter",
    "minimum_filter1d",
    "maximum_filter1d",
    "rank_filter",
    "median_filter",
    "percentile_filter",
]


def _default_dtype_mode(dtype_mode):
    return config.default_dtype_mode if dtype_mode is None else dtype_mode


def _as_weights(weights):
    """Filter taps as a host numpy array (zero taps are skipped and
    symmetric taps folded when the accumulation is built); bfloat16 taps,
    which numpy lacks, as float32, which holds their values."""
    if isinstance(weights, torch.Tensor):
        weights = dtypes.host_numpy(weights)
    return np.asarray(weights)


def _taps_dtype(weights):
    """The dtype the policy reckons ``weights`` in, before
    :func:`_as_weights`: torch.bfloat16 for bfloat16 taps, else numpy's."""
    if isinstance(weights, torch.Tensor):
        return dtypes.policy_dtype(weights.dtype)
    return np.asarray(weights).dtype


def _cast_output(acc, out_dtype):
    """Cast accumulator to the output dtype with ndimage semantics.

    scipy.ndimage truncates toward zero for integer outputs (C cast) and
    wraps on overflow (incl. negative -> unsigned); torch's float -> int
    cast is undefined out of range, so go through int64.  Values beyond
    the int64 range are first reduced mod 2^64 into the int64 window.
    Complex -> real drops the imaginary part.
    """
    kind = dtypes.kind(out_dtype)
    if acc.is_complex() and kind != "c":
        acc = acc.real
    if kind in "iu" and acc.is_floating_point():
        acc = torch.trunc(acc)
        two63, two64 = 2.0 ** 63, 2.0 ** 64
        big = (acc >= two63) | (acc < -two63)
        wrapped = acc - torch.floor(acc / two64) * two64
        wrapped = torch.where(wrapped >= two63, wrapped - two64, wrapped)
        acc = torch.where(big, wrapped, acc).to(torch.int64)
    return acc.to(dtypes.to_torch(out_dtype))


def _acc_and_out_dtypes(input, weights_dtype, output, dtype_mode):
    """(accumulation, output) numpy dtypes of a correlation (bfloat16 as
    ``torch.bfloat16``).  ``dtype_mode="numpy"`` gives numpy's: the
    promoted type of input and weights for both (integers wrap), float16
    accumulating in float32 (bfloat16 in itself, as cupyimg_tpu), and no
    ``output``."""
    if dtype_mode == "numpy":
        if output is not None:
            raise ValueError(
                "dtype_mode == 'numpy' does not support the output argument"
            )
        out_dtype = dtypes.promote_types(input.dtype, weights_dtype)
        acc_dtype = (np.dtype(np.float32) if out_dtype == np.float16
                     else out_dtype)
        return acc_dtype, out_dtype
    acc_dtype = dtypes.promote_weights_dtype(input.dtype, weights_dtype,
                                             dtype_mode)
    return acc_dtype, dtypes.resolve_output_dtype(output, input.dtype,
                                                  acc_dtype)


def _check_nd_weights(input, weights, origin):
    """Validate the weights' rank and normalize per-axis origins."""
    if weights.ndim != input.ndim:
        raise RuntimeError("filter weights array has incorrect shape")
    origins = util.fix_sequence_arg(origin, input.ndim, "origin", int)
    for o, w in zip(origins, weights.shape):
        util.check_origin(o, w)
    return origins


def _correlate_or_convolve(
    input, weights, output, mode, cval, origin, convolution, dtype_mode
):
    """Shared body of :func:`correlate` and :func:`convolve`."""
    dtype_mode = _default_dtype_mode(dtype_mode)
    input = util.as_tensor(input)
    taps_dtype = _taps_dtype(weights)
    weights = _as_weights(weights)
    boundary.check_mode(mode)
    origins = _check_nd_weights(input, weights, origin)
    if weights.size == 0:
        return torch.zeros_like(input)
    util.check_cval(
        mode, cval, dtypes.is_integer_dtype(output or input.dtype)
    )
    if convolution:
        # convolve(x, w) == correlate(x, flip(w)) with mirrored origins
        # (even sizes shift by one), the scipy convention
        weights = np.flip(weights)
        origins = [
            -o - 1 if wsize % 2 == 0 else -o
            for o, wsize in zip(origins, weights.shape)
        ]
    elif weights.dtype.kind == "c":
        weights = weights.conj()  # numpy.correlate conjugates the weights
    acc_dtype, out_dtype = _acc_and_out_dtypes(input, taps_dtype, output,
                                               dtype_mode)
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=dtypes.to_torch(out_dtype))
    acc = stencil.correlate_nd(input, weights, mode, cval, origins, acc_dtype)
    return _cast_output(acc, out_dtype)


def correlate(
    input,
    weights,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    *,
    use_weights_mask=False,
    axes=None,
    dtype_mode=None,
):
    """Multi-dimensional correlation (scipy.ndimage.correlate parity).

    ``use_weights_mask`` is accepted for API parity and does nothing:
    zero weights are always skipped.  ``axes`` restricts the correlation
    to those axes: ``weights`` then spans ``len(axes)`` dimensions.
    """
    del use_weights_mask
    input = util.as_tensor(input)
    ax = util.check_axes(axes, input.ndim)
    if len(ax) != input.ndim:
        weights = _axes_embed_array(
            _as_weights(weights), ax, input.ndim, "filter weights")
        origin = util.expand_axes_arg(origin, ax, input.ndim, "origin", 0,
                                      int)
    return _correlate_or_convolve(
        input, weights, output, mode, cval, origin, False, dtype_mode
    )


def convolve(
    input,
    weights,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    *,
    use_weights_mask=False,
    axes=None,
    dtype_mode=None,
):
    """Multi-dimensional convolution (scipy.ndimage.convolve parity;
    ``axes`` as in :func:`correlate`)."""
    del use_weights_mask
    input = util.as_tensor(input)
    ax = util.check_axes(axes, input.ndim)
    if len(ax) != input.ndim:
        weights = _axes_embed_array(
            _as_weights(weights), ax, input.ndim, "filter weights")
        origin = util.expand_axes_arg(origin, ax, input.ndim, "origin", 0,
                                      int)
    return _correlate_or_convolve(
        input, weights, output, mode, cval, origin, True, dtype_mode
    )


def _correlate1d(
    input, weights, axis, output, mode, cval, origin, convolution, dtype_mode,
    crop=True,
):
    """1-d correlate/convolve along an axis; ``crop=False`` gives the
    'full' correlation, ``n + size - 1`` samples along ``axis``.  A pass
    that accumulates in the input's dtype goes to the fused kernel where
    it applies (CUDA float32 under ``dtype_mode="float"``, 2-D or 3-D, at
    most 64 real taps)."""
    dtype_mode = _default_dtype_mode(dtype_mode)
    input = util.as_tensor(input)
    taps_dtype = _taps_dtype(weights)
    weights = _as_weights(weights)
    if weights.ndim != 1:
        raise RuntimeError("weights must be 1-d")
    boundary.check_mode(mode)
    axis = util.check_axis(axis, input.ndim)
    origin = int(origin)
    if crop:
        util.check_origin(origin, weights.shape[0])
    if convolution:
        weights = weights[::-1]
        origin = -origin
        if weights.shape[0] % 2 == 0:
            origin -= 1
    elif weights.dtype.kind == "c":
        weights = weights.conj()

    acc_dtype, out_dtype = _acc_and_out_dtypes(input, taps_dtype, output,
                                               dtype_mode)
    if not crop:
        acc = _full_correlate1d(input, weights, axis, mode, cval, acc_dtype)
        return _cast_output(acc, out_dtype)
    if weights.dtype.kind != "c" and (
            acc_dtype == out_dtype == dtypes.policy_dtype(input.dtype)):
        fused = _try_fused_separable(
            input, [(axis, weights, mode, cval, origin)], out_dtype)
        if fused is not None:
            return fused
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=dtypes.to_torch(out_dtype))
    acc = stencil.correlate1d_axis(
        input, weights, axis, mode, cval, origin, acc_dtype
    )
    return _cast_output(acc, out_dtype)


def _full_correlate1d(x, weights, axis, mode, cval, acc_dtype):
    """'full' 1-d correlation: ``n + size - 1`` samples along ``axis``,
    the input extended by ``size - 1`` on both sides (the per-axis plain
    path: the output is longer than the input, which B1 does not write)."""
    size = weights.shape[0]
    out_len = x.shape[axis] + size - 1
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (size - 1, size - 1)
    xp = boundary.pad(x, pad_width, mode, cval).to(
        dtypes.to_torch(acc_dtype))
    out = None
    for k in np.flatnonzero(weights):
        term = stencil._scalar(weights[k]) * xp.narrow(axis, int(k), out_len)
        out = term if out is None else out + term
    if out is None:  # all-zero weights
        shape = list(x.shape)
        shape[axis] = out_len
        out = xp.new_zeros(shape)
    return out


def correlate1d(
    input,
    weights,
    axis=-1,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    *,
    backend=None,
    dtype_mode=None,
    crop=True,
):
    """1-d correlation along the given axis (scipy.ndimage.correlate1d
    parity).  ``crop=False`` returns the 'full' correlation, ``n + size -
    1`` samples along ``axis`` (``origin`` is then ignored).  ``backend``
    is accepted for API parity and ignored: there is one engine.  A CUDA
    float32 2-D or 3-D array under ``dtype_mode="float"`` is one launch of
    the fused separable kernel (at most 64 taps)."""
    del backend
    return _correlate1d(
        input, weights, axis, output, mode, cval, origin, False, dtype_mode,
        crop=crop,
    )


def convolve1d(
    input,
    weights,
    axis=-1,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    *,
    backend=None,
    dtype_mode=None,
    crop=True,
):
    """1-d convolution along the given axis (scipy.ndimage.convolve1d
    parity; ``crop`` and ``backend`` as in :func:`correlate1d`)."""
    del backend
    if not crop:
        # the full convolution: flipped weights, no origin; the
        # correlation conjugates complex weights, which a convolution must
        # not, so they are conjugated here first to cancel it
        w = (weights.flip(0) if isinstance(weights, torch.Tensor)
             else _as_weights(weights)[::-1])  # a tensor keeps bfloat16
        if dtypes.is_complex_dtype(_taps_dtype(w)):
            w = w.conj()
        return _correlate1d(input, w, axis, output, mode, cval, 0, False,
                            dtype_mode, crop=False)
    return _correlate1d(
        input, weights, axis, output, mode, cval, origin, True, dtype_mode
    )


# ---------------------------------------------------------------------------
# separable smoothing filters
# ---------------------------------------------------------------------------


def _try_fused_separable(x, axes_params, out_dtype):
    """Route a chain of per-axis 1-d correlations to the fused kernel
    (ops/fused_separable) when it applies: CUDA float32 data, 2-/3-d,
    at most 64 taps per axis.  Returns None when the per-axis path
    should run instead."""
    if dtypes.kind(out_dtype) != "f" or not x.is_floating_point():
        return None
    weights = [None] * x.ndim
    origins = [0] * x.ndim
    modes = ["reflect"] * x.ndim
    cvals = set()
    for axis, w, mode, cval, origin in axes_params:
        if w is None:
            continue
        if weights[axis] is not None:
            return None  # two passes on one axis: not fusable
        weights[axis] = tuple(float(v) for v in np.asarray(w))
        origins[axis] = int(origin)
        modes[axis] = mode
        cvals.add(float(cval))
    if len(cvals) > 1:
        return None
    cval = cvals.pop() if cvals else 0.0
    if cval != 0.0 and any(
        m in ("constant", "grid-constant") for m in modes
    ):
        # The fused kernel extends the RAW input once with cval; scipy's
        # separable filters re-extend each pass's OUTPUT with cval.  The
        # two agree iff cval is 0 or every filtered axis's taps sum to 1
        # (uniform/gaussian-order-0); derivative kernels must take the
        # sequential path.
        for w in weights:
            if w is not None and abs(sum(w) - 1.0) > 1e-9:
                return None
    if not fused_separable.supports(x, weights):
        return None
    # No try/except: supports() is the applicability gate, and a failure
    # past it is a kernel fault that must surface, not a silent fallback.
    out = fused_separable.fused_separable_correlate(
        x.contiguous(), weights, origins, modes, cval
    )
    return out.to(dtypes.to_torch(out_dtype))


def _run_1d_filters(input, axes_params, output, dtype_mode):
    """Apply a chain of per-axis 1-d correlations; each pass casts to the
    output dtype, matching scipy, where pass k writes into the output
    array read by pass k+1."""
    x = util.as_tensor(input)
    out_dtype = dtypes.resolve_output_dtype(output, x.dtype)
    if x.numel() == 0:  # scipy shape-preserves empty inputs
        return x.new_zeros(x.shape, dtype=dtypes.to_torch(out_dtype))
    fused = _try_fused_separable(x, axes_params, out_dtype)
    if fused is not None:
        return fused
    ran = False
    for axis, weights, mode, cval, origin in axes_params:
        if weights is None:
            continue
        x = _correlate1d(
            x, weights, axis, out_dtype, mode, cval, origin, False, dtype_mode
        )
        ran = True
    if not ran:
        x = x.to(dtypes.to_torch(out_dtype), copy=True)  # never alias input
    return x


def uniform_filter1d(
    input,
    size,
    axis=-1,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    *,
    dtype_mode=None,
):
    """1-d uniform (box) filter.

    Matches scipy's rounding exactly: the window is summed first and
    scaled by 1/size once (scipy's NI_UniformFilter1D), not correlated
    with 1/size-valued taps; the distinction matters for integer outputs.
    """
    dtype_mode = _default_dtype_mode(dtype_mode)
    if size < 1:
        raise RuntimeError("incorrect filter size")
    input = util.as_tensor(input)
    boundary.check_mode(mode)
    axis = util.check_axis(axis, input.ndim)
    util.check_origin(origin, size)
    acc_dtype = dtypes.promote_weights_dtype(
        input.dtype, np.float64, dtype_mode
    )
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype, acc_dtype)
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=dtypes.to_torch(out_dtype))
    acc = stencil.correlate1d_axis(
        input, np.ones(size), axis, mode, cval, origin, acc_dtype
    )
    acc = acc * (1.0 / size)
    return _cast_output(acc, out_dtype)


def uniform_filter(
    input,
    size=3,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    *,
    axes=None,
    dtype_mode=None,
):
    """Multi-dimensional uniform filter: separable per-axis box passes.
    ``axes`` restricts filtering to those axes."""
    input = util.as_tensor(input)
    axes = util.check_axes(axes, input.ndim)
    sizes = util.expand_axes_arg(size, axes, input.ndim, "size", 1, int)
    origins = util.expand_axes_arg(origin, axes, input.ndim, "origin", 0,
                                   int)
    modes = util.expand_axes_arg(mode, axes, input.ndim, "mode",
                                 "reflect", str)
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype)
    axes_params = [
        (
            ax,
            np.full(sizes[ax], 1.0 / sizes[ax]) if sizes[ax] > 1 else None,
            modes[ax],
            cval,
            origins[ax],
        )
        for ax in range(input.ndim)
    ]
    fused = _try_fused_separable(input, axes_params, out_dtype)
    if fused is not None:
        return fused
    x = input
    ran = False
    for axis in range(input.ndim):
        if sizes[axis] > 1:
            x = uniform_filter1d(
                x, sizes[axis], axis, out_dtype, modes[axis], cval,
                origins[axis], dtype_mode=dtype_mode,
            )
            ran = True
    if not ran:
        x = x.to(dtypes.to_torch(out_dtype), copy=True)  # never alias input
    return x


def _gaussian_kernel1d(sigma, order, radius):
    """1-d Gaussian (derivative) kernel, scipy's _gaussian_kernel1d math."""
    if order < 0:
        raise ValueError("order must be non-negative")
    exponent_range = np.arange(order + 1)
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1)
    phi_x = np.exp(-0.5 / sigma2 * x ** 2)
    phi_x = phi_x / phi_x.sum()
    if order == 0:
        return phi_x
    # f(x) = q(x) * phi(x) = q(x) * exp(p(x)); recurrence on q coefficients
    q = np.zeros(order + 1)
    q[0] = 1
    D = np.diag(exponent_range[1:], 1)  # D @ q(x) = q'(x)
    P = np.diag(np.ones(order) / -sigma2, -1)  # P @ q(x) = q(x) * p'(x)
    Q_deriv = D + P
    for _ in range(order):
        q = Q_deriv.dot(q)
    q = (x[:, None] ** exponent_range).dot(q)
    return q * phi_x


def gaussian_filter1d(
    input,
    sigma,
    axis=-1,
    order=0,
    output=None,
    mode="reflect",
    cval=0.0,
    truncate=4.0,
    *,
    radius=None,
    dtype_mode=None,
):
    """1-d Gaussian filter."""
    sd = float(sigma)
    lw = int(truncate * sd + 0.5)
    if radius is not None:
        lw = int(radius)
    if lw < 0:
        raise ValueError("Radius must be a nonnegative integer.")
    weights = _gaussian_kernel1d(sd, order, lw)[::-1]
    return correlate1d(
        input, weights, axis, output, mode, cval, 0, dtype_mode=dtype_mode
    )


def gaussian_filter(
    input,
    sigma,
    order=0,
    output=None,
    mode="reflect",
    cval=0.0,
    truncate=4.0,
    *,
    radius=None,
    axes=None,
    dtype_mode=None,
):
    """Multi-dimensional Gaussian filter.  ``axes`` restricts filtering to
    those axes."""
    input = util.as_tensor(input)
    axes = util.check_axes(axes, input.ndim)
    orders = util.expand_axes_arg(order, axes, input.ndim, "order", 0, int)
    sigmas = util.expand_axes_arg(sigma, axes, input.ndim, "sigma", 0.0,
                                  float)
    modes = util.expand_axes_arg(mode, axes, input.ndim, "mode",
                                 "reflect", str)
    radii = util.expand_axes_arg(radius, axes, input.ndim, "radius", None,
                                 lambda v: v)
    axes_params = []
    for axis in range(input.ndim):
        if sigmas[axis] > 1e-15:
            lw = int(truncate * sigmas[axis] + 0.5)
            if radii[axis] is not None:
                lw = int(radii[axis])
            weights = _gaussian_kernel1d(sigmas[axis], orders[axis], lw)[::-1]
        else:
            weights = None
        axes_params.append((axis, weights, modes[axis], cval, 0))
    return _run_1d_filters(input, axes_params, output, dtype_mode)


# ---------------------------------------------------------------------------
# derivative filters
# ---------------------------------------------------------------------------


def _prewitt_or_sobel(input, axis, output, mode, cval, smooth, dtype_mode):
    """Shared body of prewitt and sobel."""
    input = util.as_tensor(input)
    axis = util.check_axis(axis, input.ndim)
    modes = util.fix_sequence_arg(mode, input.ndim, "mode", str)
    # scipy runs the derivative pass FIRST, then the smoothing axes in
    # ascending order; each pass casts into the output dtype, so the pass
    # order is observable for integer outputs (wraparound between passes).
    axes_params = [
        (axis, np.array([-1.0, 0.0, 1.0]), modes[axis], cval, 0)
    ]
    for ax in range(input.ndim):
        if ax != axis:
            axes_params.append((ax, smooth, modes[ax], cval, 0))
    return _run_1d_filters(input, axes_params, output, dtype_mode)


def prewitt(input, axis=-1, output=None, mode="reflect", cval=0.0, *,
            dtype_mode=None):
    """Prewitt derivative filter (scipy parity)."""
    return _prewitt_or_sobel(
        input, axis, output, mode, cval, np.ones(3), dtype_mode
    )


def sobel(input, axis=-1, output=None, mode="reflect", cval=0.0, *,
          dtype_mode=None):
    """Sobel derivative filter (scipy parity)."""
    return _prewitt_or_sobel(
        input, axis, output, mode, cval, np.array([1.0, 2.0, 1.0]), dtype_mode
    )


def generic_laplace(
    input,
    derivative2,
    output=None,
    mode="reflect",
    cval=0.0,
    extra_arguments=(),
    extra_keywords=None,
    *,
    axes=None,
):
    """Sum of per-axis second derivatives.  ``axes`` selects which axes the
    derivatives are taken over."""
    if extra_keywords is None:
        extra_keywords = {}
    input = util.as_tensor(input)
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype)
    axes = util.check_axes(axes, input.ndim)
    modes = util.fix_sequence_arg(mode, len(axes), "mode", str)
    if input.ndim == 0 or not axes:
        return input.to(dtypes.to_torch(out_dtype), copy=True)
    acc = derivative2(
        input, axes[0], out_dtype, modes[0], cval,
        *extra_arguments, **extra_keywords
    )
    for i, ax in enumerate(axes[1:], start=1):
        acc = acc + derivative2(
            input, ax, out_dtype, modes[i], cval,
            *extra_arguments, **extra_keywords
        )
    return acc.to(dtypes.to_torch(out_dtype))


def laplace(input, output=None, mode="reflect", cval=0.0, *, axes=None,
            dtype_mode=None):
    """N-d Laplace filter via [1, -2, 1] second differences (scipy parity)."""

    def derivative2(x, axis, out_dtype, mode, cval):
        return correlate1d(
            x, np.array([1.0, -2.0, 1.0]), axis, out_dtype, mode, cval, 0,
            dtype_mode=dtype_mode,
        )

    return generic_laplace(input, derivative2, output, mode, cval,
                           axes=axes)


def gaussian_laplace(
    input, sigma, output=None, mode="reflect", cval=0.0, *,
    axes=None, dtype_mode=None, **kwargs
):
    """Laplace of Gaussian (scipy parity)."""
    input = util.as_tensor(input)
    ax = util.check_axes(axes, input.ndim)
    sigmas = util.expand_axes_arg(sigma, ax, input.ndim, "sigma", 0.0, float)

    def derivative2(x, axis, out_dtype, mode, cval):
        order = [0] * x.ndim
        order[axis] = 2
        return gaussian_filter(
            x, sigmas, order, out_dtype, mode, cval,
            dtype_mode=dtype_mode, **kwargs
        )

    return generic_laplace(input, derivative2, output, mode, cval,
                           axes=axes)


def _abs2(d):
    return (d * d.conj()).real if d.is_complex() else d * d


def generic_gradient_magnitude(
    input,
    derivative,
    output=None,
    mode="reflect",
    cval=0.0,
    extra_arguments=(),
    extra_keywords=None,
    *,
    axes=None,
):
    """sqrt of sum of squared per-axis derivatives.  ``axes`` selects the
    derivative axes."""
    if extra_keywords is None:
        extra_keywords = {}
    input = util.as_tensor(input)
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype)
    axes = util.check_axes(axes, input.ndim)
    modes = util.fix_sequence_arg(mode, len(axes), "mode", str)
    if input.ndim == 0 or not axes:
        return input.to(dtypes.to_torch(out_dtype), copy=True)
    acc = _abs2(derivative(
        input, axes[0], out_dtype, modes[0], cval,
        *extra_arguments, **extra_keywords
    ))
    for i, ax in enumerate(axes[1:], start=1):
        acc = acc + _abs2(derivative(
            input, ax, out_dtype, modes[i], cval,
            *extra_arguments, **extra_keywords
        ))
    root_dtype = dtypes.promote_types(acc.dtype, np.float32)
    return _cast_output(
        torch.sqrt(acc.to(dtypes.to_torch(root_dtype))), out_dtype
    )


def gaussian_gradient_magnitude(
    input, sigma, output=None, mode="reflect", cval=0.0, *,
    axes=None, dtype_mode=None, **kwargs
):
    """Gradient magnitude of Gaussian derivatives (scipy parity).

    scipy quirk (1.17): with ``axes`` given, the SMOOTHING still spans
    every axis (sigma is forwarded to gaussian_filter raw, full rank);
    only the derivative sum is restricted to ``axes``, unlike
    gaussian_laplace, which smooths only over ``axes``.  Reproduced."""

    def derivative(x, axis, out_dtype, mode, cval):
        order = [0] * x.ndim
        order[axis] = 1
        return gaussian_filter(
            x, sigma, order, out_dtype, mode, cval,
            dtype_mode=dtype_mode, **kwargs
        )

    return generic_gradient_magnitude(input, derivative, output, mode, cval,
                                      axes=axes)


# ---------------------------------------------------------------------------
# min/max filters
# ---------------------------------------------------------------------------


def _axes_embed_array(arr, axes, ndim, name):
    """Insert singleton dims into a len(axes)-rank footprint/structure/
    weights array so it spans the full input rank (scipy ``axes``)."""
    if arr is None:
        return None
    a = np.asarray(arr)
    if a.ndim != len(axes):
        raise RuntimeError(f"{name} array has incorrect shape")
    if len(axes) == ndim:
        return arr
    for ax in range(ndim):
        if ax not in axes:
            a = np.expand_dims(a, ax)
    return a


def _get_footprint(input, size, footprint, allow_separable=True):
    """Normalize size/footprint: ``(None, sizes)`` for a full rectangle
    (when ``allow_separable``), else ``(footprint, shape)``."""
    if size is not None and footprint is not None:
        warnings.warn(
            "ignoring size because footprint is set", UserWarning, stacklevel=3
        )
    if footprint is None:
        if size is None:
            raise RuntimeError("no footprint or filter size provided")
        sizes = util.fix_sequence_arg(size, input.ndim, "size", int)
        return None, sizes
    footprint = np.asarray(footprint, dtype=bool)
    if footprint.ndim != input.ndim:
        raise RuntimeError("footprint array has incorrect shape")
    if not footprint.any():
        raise ValueError("All-zero footprint is not supported.")
    if allow_separable and footprint.all():
        return None, list(footprint.shape)
    return footprint, list(footprint.shape)


def _min_or_max_1d(x, size, axis, mode, cval, origin, is_min):
    """Running min/max over a ``size`` window along ``axis``."""
    lo = size // 2 + origin
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (lo, size - 1 - lo)
    taps = []
    for k in range(size):
        off = [0] * x.ndim
        off[axis] = k
        taps.append(tuple(off))
    reducer = torch.minimum if is_min else torch.maximum
    return stencil.reduce_window(x, (taps, pad_width), mode, cval, reducer)


# torch has no minimum, maximum or sort of these types
_UNSIGNED_WIDE = (torch.uint16, torch.uint32, torch.uint64)
_SIGN_BIT = -2**63


def _via_signed(filter_fn, input, output, cval):
    """``filter_fn(x, cval)`` of a uint16/32/64 ``input`` computed in a
    signed type that keeps the order of its values, cast to ``output``'s
    dtype (default the input's). uint16 and uint32 widen; uint64 flips
    its sign bit into int64 (``v - 2**63``), and so does ``cval``."""
    out_dtype = dtypes.to_torch(dtypes.resolve_output_dtype(output,
                                                            input.dtype))
    if input.dtype != torch.uint64:
        return filter_fn(dtypes.widen_unsigned(input), cval).to(out_dtype)
    res = filter_fn(input.view(torch.int64) ^ _SIGN_BIT,
                    boundary.fill_value(cval, torch.uint64) + _SIGN_BIT)
    return (res ^ _SIGN_BIT).view(torch.uint64).to(out_dtype)


def _min_or_max_filter(
    input, size, footprint, structure, output, mode, cval, origin, is_min
):
    """Shared body of the min/max filters.

    With ``structure`` (the grey morphology path) each tap contributes
    ``x - structure`` (minimum) or ``x + structure`` (maximum).
    """
    input = util.as_tensor(input)
    if input.dtype in _UNSIGNED_WIDE and structure is None:
        return _via_signed(
            lambda x, c: _min_or_max_filter(x, size, footprint, None, None,
                                            mode, c, origin, is_min),
            input, output, cval)
    if structure is None:
        footprint, sizes = _get_footprint(input, size, footprint)
    else:
        structure = np.asarray(structure, dtype=np.float64)
        if footprint is None:
            footprint = np.ones(structure.shape, bool)
        else:
            footprint = np.asarray(footprint, bool)
        sizes = list(structure.shape)
    origins = util.fix_sequence_arg(origin, input.ndim, "origin", int)
    for o, w in zip(origins, sizes):
        util.check_origin(o, w)
    modes = util.fix_sequence_arg(mode, input.ndim, "mode", str)
    for m in modes:
        boundary.check_mode(m)
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype)
    out_torch = dtypes.to_torch(out_dtype)
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=out_torch)

    # scipy's minimum_filter and maximum_filter reduce over the SAME
    # window (no footprint mirroring for max); only grey_dilation
    # mirrors, and it does so itself before calling this function.
    if footprint is None and structure is None:
        windows = [(1.0,) * sz if sz > 1 else None for sz in sizes]
        if fused_separable.supports(input, windows):
            # supports() is the gate: a failure past it is a kernel
            # fault that must surface, never a silent fallback
            out = fused_separable.fused_separable_minmax(
                input.contiguous(), sizes, origins, modes, cval, is_min
            )
            return out.to(out_torch)
        x = input
        for axis in range(input.ndim):
            if sizes[axis] > 1:
                x = _min_or_max_1d(
                    x, sizes[axis], axis, modes[axis], cval, origins[axis],
                    is_min,
                )
        return x.to(out_torch, copy=x is input)

    if structure is not None and (structure != 0).any():
        taps, pad_width = stencil.footprint_offsets(footprint, origins)
        # the float64 structure promotes every input, integers included
        xp = boundary.pad(input, pad_width, modes[0], cval).to(
            torch.promote_types(input.dtype, torch.float64))
        comp = None
        for off in taps:
            sl = tuple(slice(o, o + n) for o, n in zip(off, input.shape))
            sval = float(structure[off])
            piece = xp[sl] - sval if is_min else xp[sl] + sval
            if comp is None:
                comp = piece
            else:
                comp = (torch.minimum(comp, piece) if is_min
                        else torch.maximum(comp, piece))
        return _cast_output(comp, out_dtype)

    offsets = stencil.footprint_offsets(footprint, origins)
    reducer = torch.minimum if is_min else torch.maximum
    # ndimage applies a single mode for footprint filters
    out = stencil.reduce_window(input, offsets, modes[0], cval, reducer)
    return out.to(out_torch, copy=out is input)


def _axes_minmax_args(input, size, footprint, mode, origin, axes):
    """Expand size/footprint/mode/origin from ``axes``-relative to
    full rank (identity on the excluded axes)."""
    ndim = input.ndim
    axes = util.check_axes(axes, ndim)
    if len(axes) == ndim:
        return size, footprint, mode, origin
    if footprint is not None:
        footprint = _axes_embed_array(footprint, axes, ndim, "footprint")
    elif size is not None:
        size = util.expand_axes_arg(size, axes, ndim, "size", 1, int)
    mode = util.expand_axes_arg(mode, axes, ndim, "mode", "reflect", str)
    origin = util.expand_axes_arg(origin, axes, ndim, "origin", 0, int)
    return size, footprint, mode, origin


def minimum_filter(
    input, size=None, footprint=None, output=None, mode="reflect", cval=0.0,
    origin=0, *, axes=None,
):
    """Multi-dimensional minimum filter (scipy parity incl. ``axes``)."""
    input = util.as_tensor(input)
    size, footprint, mode, origin = _axes_minmax_args(
        input, size, footprint, mode, origin, axes
    )
    return _min_or_max_filter(
        input, size, footprint, None, output, mode, cval, origin, True
    )


def maximum_filter(
    input, size=None, footprint=None, output=None, mode="reflect", cval=0.0,
    origin=0, *, axes=None,
):
    """Multi-dimensional maximum filter (scipy parity incl. ``axes``)."""
    input = util.as_tensor(input)
    size, footprint, mode, origin = _axes_minmax_args(
        input, size, footprint, mode, origin, axes
    )
    return _min_or_max_filter(
        input, size, footprint, None, output, mode, cval, origin, False
    )


def _min_or_max_filter1d(input, size, axis, output, mode, cval, origin,
                         is_min):
    input = util.as_tensor(input)
    axis = util.check_axis(axis, input.ndim)
    util.check_origin(origin, size)
    boundary.check_mode(mode)
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype)
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=dtypes.to_torch(out_dtype))
    out = _min_or_max_1d(input, size, axis, mode, cval, origin, is_min)
    return out.to(dtypes.to_torch(out_dtype), copy=out is input)


def minimum_filter1d(
    input, size, axis=-1, output=None, mode="reflect", cval=0.0, origin=0
):
    """1-d minimum filter (scipy parity)."""
    return _min_or_max_filter1d(input, size, axis, output, mode, cval,
                                origin, True)


def maximum_filter1d(
    input, size, axis=-1, output=None, mode="reflect", cval=0.0, origin=0
):
    """1-d maximum filter (scipy parity)."""
    return _min_or_max_filter1d(input, size, axis, output, mode, cval,
                                origin, False)


# ---------------------------------------------------------------------------
# rank filters
# ---------------------------------------------------------------------------


def _rank_filter(input, rank_fn, size, footprint, output, mode, cval, origin):
    """Shared body of the rank filters.

    Footprints of at most 64 taps run a rank-pruned Batcher network
    (``ops/sorting_networks.py``): on the card in the rank kernel, else
    over shifted slices; larger footprints sort the stacked windows.
    """
    input = util.as_tensor(input)
    if input.dtype in _UNSIGNED_WIDE:
        return _via_signed(
            lambda x, c: _rank_filter(x, rank_fn, size, footprint, None,
                                      mode, c, origin),
            input, output, cval)
    footprint, sizes = _get_footprint(input, size, footprint,
                                      allow_separable=False)
    if footprint is None:
        footprint = np.ones(tuple(sizes), dtype=bool)
    origins = util.fix_sequence_arg(origin, input.ndim, "origin", int)
    for o, w in zip(origins, footprint.shape):
        util.check_origin(o, w)
    boundary.check_mode(mode)
    out_dtype = dtypes.to_torch(dtypes.resolve_output_dtype(output,
                                                            input.dtype))
    filter_size = int(footprint.sum())
    rank = rank_fn(filter_size)
    if rank < 0:
        rank += filter_size
    if rank < 0 or rank >= filter_size:
        raise RuntimeError("rank not within filter footprint size")
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=out_dtype)
    if rank == 0:
        return _min_or_max_filter(
            input, None, footprint, None, output, mode, cval, origins, True
        )
    if rank == filter_size - 1:
        return _min_or_max_filter(
            input, None, footprint, None, output, mode, cval, origins, False
        )
    if filter_size <= fused_rank.MAX_RANK_TAPS:
        if (fused_rank.supports_rank(input, filter_size)
                and out_dtype == input.dtype):
            return fused_rank.fused_rank_filter(
                input.contiguous(), footprint, origins, rank, mode, cval
            )
        taps, pad_width = stencil.footprint_offsets(footprint, origins)
        xp = boundary.pad(input, pad_width, mode, cval)
        vals = [
            xp[tuple(slice(o, o + n) for o, n in zip(off, input.shape))]
            for off in taps
        ]
        return rank_select(vals, rank).to(out_dtype)
    windows = stencil.gather_windows(input, footprint, origins, mode, cval)
    return torch.sort(windows, dim=0).values[rank].to(out_dtype)


def _axes_rank_args(input, size, footprint, origin, axes):
    ndim = input.ndim
    axes = util.check_axes(axes, ndim)
    if len(axes) == ndim:
        return size, footprint, origin
    if footprint is not None:
        footprint = _axes_embed_array(footprint, axes, ndim, "footprint")
    elif size is not None:
        size = util.expand_axes_arg(size, axes, ndim, "size", 1, int)
    origin = util.expand_axes_arg(origin, axes, ndim, "origin", 0, int)
    return size, footprint, origin


def rank_filter(
    input, rank, size=None, footprint=None, output=None, mode="reflect",
    cval=0.0, origin=0, *, axes=None,
):
    """Multi-dimensional rank filter (scipy parity incl. ``axes``)."""
    if not isinstance(rank, (int, np.integer)):
        raise TypeError("rank must be an integer")  # as scipy: no float rank
    rank = int(rank)
    input = util.as_tensor(input)
    size, footprint, origin = _axes_rank_args(input, size, footprint,
                                              origin, axes)
    return _rank_filter(
        input, lambda fs: rank, size, footprint, output, mode, cval, origin
    )


def median_filter(
    input, size=None, footprint=None, output=None, mode="reflect", cval=0.0,
    origin=0, *, axes=None,
):
    """Multi-dimensional median filter (scipy parity incl. ``axes``)."""
    input = util.as_tensor(input)
    size, footprint, origin = _axes_rank_args(input, size, footprint,
                                              origin, axes)
    return _rank_filter(
        input, lambda fs: fs // 2, size, footprint, output, mode, cval, origin
    )


def percentile_filter(
    input, percentile, size=None, footprint=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Multi-dimensional percentile filter (scipy parity incl. ``axes``)."""
    percentile = float(percentile)
    if percentile < 0.0:
        percentile += 100.0
    if percentile < 0 or percentile > 100:
        raise RuntimeError("invalid percentile")

    def get_rank(fs):
        if percentile == 100.0:
            return fs - 1
        return int(float(fs) * percentile / 100.0)

    input = util.as_tensor(input)
    size, footprint, origin = _axes_rank_args(input, size, footprint,
                                              origin, axes)
    return _rank_filter(
        input, get_rank, size, footprint, output, mode, cval, origin
    )


# ---------------------------------------------------------------------------
# generic filters
# ---------------------------------------------------------------------------


def generic_filter(
    input,
    function,
    size=None,
    footprint=None,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    extra_arguments=(),
    extra_keywords=None,
):
    """Multi-dimensional filter with a user-supplied window reduction.

    ``function`` receives the footprint values of one window as a 1-d
    tensor and returns a scalar tensor.  It is mapped over every window
    with ``torch.func.vmap``, so it must be written in torch ops that
    vmap supports (no Python side effects, no data-dependent control
    flow).
    """
    if extra_keywords is None:
        extra_keywords = {}
    input = util.as_tensor(input)
    footprint, sizes = _get_footprint(
        input, size, footprint, allow_separable=False
    )
    if footprint is None:
        footprint = np.ones(tuple(sizes), bool)
    origins = util.fix_sequence_arg(origin, input.ndim, "origin", int)
    for o, w in zip(origins, footprint.shape):
        util.check_origin(o, w)
    boundary.check_mode(mode)
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype)
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=dtypes.to_torch(out_dtype))
    windows = stencil.gather_windows(input, footprint, origins, mode, cval)
    flat = windows.reshape(windows.shape[0], -1).T

    def apply_fn(w):
        return function(w, *extra_arguments, **extra_keywords)

    out = torch.func.vmap(apply_fn)(flat)
    return out.reshape(input.shape).to(dtypes.to_torch(out_dtype))


def generic_filter1d(
    input,
    function,
    filter_size,
    axis=-1,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    extra_arguments=(),
    extra_keywords=None,
):
    """1-d generic filter along ``axis`` (scipy parity).

    ``function`` receives one boundary-extended input line (length
    ``line + filter_size - 1``) and returns the filtered line of the
    original length: the functional form of scipy's in-place
    ``(iline, oline)`` callback.  It is mapped over the lines with
    ``torch.func.vmap`` and must be written in torch ops vmap supports.
    """
    if extra_keywords is None:
        extra_keywords = {}
    input = util.as_tensor(input)
    if filter_size < 1:
        raise RuntimeError("invalid filter size")
    axis = util.check_axis(axis, input.ndim)
    util.check_origin(origin, filter_size)
    boundary.check_mode(mode)
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype)
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=dtypes.to_torch(out_dtype))

    size = int(filter_size)
    lo = size // 2 + int(origin)
    pad_width = [(0, 0)] * input.ndim
    pad_width[axis] = (lo, size - 1 - lo)
    xp = boundary.pad(input, pad_width, mode, cval)
    moved = torch.movedim(xp, axis, -1)
    lines = moved.reshape(-1, moved.shape[-1])

    def apply_fn(iline):
        return function(iline, *extra_arguments, **extra_keywords)

    out = torch.func.vmap(apply_fn)(lines)
    n = input.shape[axis]
    if out.shape[-1] != n:
        raise RuntimeError(
            "function must return lines of the original length"
        )
    out = out.reshape(moved.shape[:-1] + (n,))
    return torch.movedim(out, -1, axis).to(dtypes.to_torch(out_dtype))
