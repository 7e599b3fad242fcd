"""scipy.ndimage filters on torch tensors: the separable family.

API parity with scipy.ndimage for correlate1d/convolve1d, the uniform and
gaussian filters, and the derivative filters (prewitt/sobel/laplace
family), with the 8 ndimage boundary modes, the ``dtype_mode`` precision
policy, and complex-dtype support.

Routing: a CUDA float32 2-D/3-D call of the separable filters runs as ONE
launch of the fused kernel (``ops/fused_separable.py``), whatever
``dtype_mode`` says.  Every other call (CPU tensors, integer, float64 or
complex data, 1-D or 4-D+) takes the per-axis torch path
(``ops/stencil.py``).

Differences from scipy:

- ``output`` may be a dtype (or None) but not a preallocated array.
- A numpy or list ``input`` goes to ``config.device``; a tensor keeps its
  device.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, dtypes, util
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.ops import fused_separable, stencil

__all__ = [
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
]


def _default_dtype_mode(dtype_mode):
    return config.default_dtype_mode if dtype_mode is None else dtype_mode


def _as_weights(weights):
    """Filter taps as a host numpy array (zero taps are skipped and
    symmetric taps folded when the accumulation is built)."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    return np.asarray(weights)


def _cast_output(acc, out_dtype):
    """Cast accumulator to the output dtype with ndimage semantics.

    scipy.ndimage truncates toward zero for integer outputs (C cast) and
    wraps on overflow (incl. negative -> unsigned); torch's float -> int
    cast is undefined out of range, so go through int64.  Values beyond
    the int64 range are first reduced mod 2^64 into the int64 window.
    Complex -> real drops the imaginary part.
    """
    out_dtype = np.dtype(out_dtype)
    if acc.is_complex() and out_dtype.kind != "c":
        acc = acc.real
    if out_dtype.kind in "iu" and acc.is_floating_point():
        acc = torch.trunc(acc)
        two63, two64 = 2.0 ** 63, 2.0 ** 64
        big = (acc >= two63) | (acc < -two63)
        wrapped = acc - torch.floor(acc / two64) * two64
        wrapped = torch.where(wrapped >= two63, wrapped - two64, wrapped)
        acc = torch.where(big, wrapped, acc).to(torch.int64)
    return acc.to(dtypes.to_torch(out_dtype))


def _correlate1d(
    input, weights, axis, output, mode, cval, origin, convolution, dtype_mode
):
    """1-d correlate/convolve along an axis."""
    dtype_mode = _default_dtype_mode(dtype_mode)
    input = util.as_tensor(input)
    weights = _as_weights(weights)
    if weights.ndim != 1:
        raise RuntimeError("weights must be 1-d")
    boundary.check_mode(mode)
    axis = util.check_axis(axis, input.ndim)
    origin = int(origin)
    util.check_origin(origin, weights.shape[0])
    if convolution:
        weights = weights[::-1]
        origin = -origin
        if weights.shape[0] % 2 == 0:
            origin -= 1
    elif weights.dtype.kind == "c":
        weights = weights.conj()

    acc_dtype = dtypes.promote_weights_dtype(
        input.dtype, weights.dtype, dtype_mode
    )
    out_dtype = dtypes.resolve_output_dtype(output, input.dtype, acc_dtype)
    if input.numel() == 0:  # scipy shape-preserves empty inputs
        return input.new_zeros(input.shape, dtype=dtypes.to_torch(out_dtype))
    acc = stencil.correlate1d_axis(
        input, weights, axis, mode, cval, origin, acc_dtype
    )
    return _cast_output(acc, out_dtype)


def correlate1d(
    input,
    weights,
    axis=-1,
    output=None,
    mode="reflect",
    cval=0.0,
    origin=0,
    *,
    dtype_mode=None,
):
    """1-d correlation along the given axis (scipy.ndimage.correlate1d parity)."""
    return _correlate1d(
        input, weights, axis, output, mode, cval, origin, False, dtype_mode
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
    dtype_mode=None,
):
    """1-d convolution along the given axis (scipy.ndimage.convolve1d parity)."""
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
    if np.dtype(out_dtype).kind != "f" or not x.is_floating_point():
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
    root_dtype = np.promote_types(dtypes.to_numpy(acc.dtype), np.float32)
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
