"""scipy.ndimage interpolation on torch tensors.

API parity with ``cupyimg_tpu.scipy.ndimage.interpolation``:
``spline_filter1d``/``spline_filter``, ``map_coordinates``,
``affine_transform``, ``shift``, ``zoom``, ``rotate`` and
``geometric_transform``; spline orders 0-5, the eight ndimage modes plus
``opencv``, complex dtypes, integer outputs rounded half away from zero
and saturated, ``allow_float32``.

Routing of a CUDA call (every CPU tensor takes the plain paths:
``ops/iir.py``'s recursion and ``ops/interp.gather_general``):

- the spline prefilter of float32 2-D/3-D data: one launch of the fused
  separable kernel per pole (``ops/iir.spline_filter_fir``); other data
  takes the recursion;
- ``affine_transform``, ``rotate``, ``shift`` and ``zoom``: one launch of
  the spline gather's affine entry (``ops/spline_gather.spline_affine``),
  ``shift`` and ``zoom`` with a diagonal matrix; a volume ``rotate``
  resamples every plane in the same launch (order 0 on the other axes);
- ``map_coordinates`` and ``geometric_transform``: one launch of its map
  entry (``ops/spline_gather.spline_map``);
- data or an output of more than 3 axes: the plain gather on the card
  (``ops/spline_gather.supports``), after the recursion where it
  prefilters.

Differences from scipy:

- ``output`` may be a dtype (or None) but not a preallocated array.
- A numpy or list ``input`` goes to ``config.device``; a tensor keeps its
  device.
- ``allow_float32=True`` (the default) works in float32 for float32 and
  integer data, as cupyimg does; coordinates are float64
  (``config.coord_precision``).
- ``mode='opencv'`` (cupyimg's extension) resamples as OpenCV does: the
  input padded by one sample of ``cval``, mode 'constant' at the
  coordinates + 1 (``zoom`` replicates the edge instead).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, dtypes, util
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.ops import iir, spline_gather

__all__ = [
    "spline_filter1d",
    "spline_filter",
    "map_coordinates",
    "affine_transform",
    "shift",
    "zoom",
    "rotate",
    "geometric_transform",
]


def _check_parameter(order, mode):
    if order is None:
        order = 3
    if order < 0 or 5 < order:
        raise ValueError("spline order is not supported")
    if mode not in (
        "constant",
        "grid-constant",
        "nearest",
        "mirror",
        "reflect",
        "grid-mirror",
        "wrap",
        "grid-wrap",
        "opencv",
        "_opencv_edge",
    ):
        raise ValueError("boundary mode is not supported")
    return order


def _resolve_out_dtype(output, input):
    if isinstance(output, (np.ndarray, torch.Tensor)):
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: preallocated `output` arrays "
            "are not supported; pass a dtype instead"
        )
    return dtypes.to_numpy(input.dtype if output is None else output)


def _float_work_dtype(dtype, allow_float32):
    dtype = dtypes.to_numpy(dtype)
    if dtype.kind == "c":
        minf = np.complex64 if allow_float32 else np.complex128
    else:
        minf = np.float32 if allow_float32 else np.float64
    if dtype.kind in "iub":
        return np.dtype(minf)
    return np.promote_types(dtype, minf)


def _coord_dtype(allow_float32):
    """Coordinate precision (``config.coord_precision``): float64 unless
    set to 'f32'.  SciPy and the reference cupyimg form coordinates in C
    double whatever the image dtype, which decides knife-edge cases (a
    coordinate exactly on a domain edge or a half-integer) as SciPy
    does."""
    precision = config.coord_precision
    if precision not in ("auto", "f32", "f64"):
        raise ValueError("config.coord_precision must be 'auto', 'f32' or "
                         f"'f64', not {precision!r}")
    if allow_float32 and precision == "f32":
        return torch.float32
    return torch.float64


def _finalize(out, out_dtype):
    """Cast an interpolation result: integer outputs round half away from
    zero and SATURATE at the dtype's bounds (spline overshoot on a uint8
    image clamps to 0/255, it does not wrap); a complex result going to a
    real output keeps the real part."""
    out_dtype = np.dtype(out_dtype)
    if out.is_complex() and out_dtype.kind != "c":
        out = out.real
    if out_dtype.kind in "iu":
        out = torch.where(out >= 0, torch.floor(out + 0.5),
                          torch.ceil(out - 0.5))
        info = np.iinfo(out_dtype)
        out = torch.clamp(out, float(info.min), float(info.max))
        out = out.to(torch.int64)
    return out.to(dtypes.to_torch(out_dtype))


def _empty_input(x, output_shape, out_dtype, mode, cval):
    """scipy's result for an input without samples: an empty output, or
    ``cval`` everywhere in the constant modes; other modes have nothing
    to extend and raise, as scipy's prefilter pad does."""
    if int(np.prod(output_shape)) == 0 or mode in ("constant",
                                                   "grid-constant"):
        out = torch.full(tuple(output_shape), float(cval),
                         dtype=torch.float64, device=x.device)
        return _finalize(out, out_dtype)
    raise ValueError(f"can't extend an empty input in mode {mode!r}")


def _host(a):
    """A matrix/offset argument as a host float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _spline_axes(x, order, mode, axes):
    """Spline prefilter along ``axes``: one B1 launch per pole on a CUDA
    float32 2-D/3-D tensor, else the recursion axis by axis."""
    y = iir.spline_filter_fir(x, order, axes, mode)
    if y is not None:
        return y
    for axis in axes:
        x = iir.spline_filter1d(x, order, axis, mode)
    return x


def spline_filter1d(
    input, order=3, axis=-1, output=np.float64, mode="mirror", *,
    allow_float32=True,
):
    """Spline prefilter along one axis (scipy parity)."""
    if order < 0 or order > 5:
        raise RuntimeError("spline order not supported")
    x = util.as_tensor(input)
    out_dtype = _resolve_out_dtype(output, x)
    if order < 2 or x.ndim == 0 or (
            x.shape[util.check_axis(axis, x.ndim)] == 1):
        return x.to(dtypes.to_torch(out_dtype))
    work = np.promote_types(out_dtype,
                            _float_work_dtype(x.dtype, allow_float32))
    y = _spline_axes(x.to(dtypes.to_torch(work)).contiguous(), order, mode,
                     (util.check_axis(axis, x.ndim),))
    return y.to(dtypes.to_torch(out_dtype))


def spline_filter(
    input, order=3, output=np.float64, mode="mirror", *, allow_float32=True
):
    """Multidimensional spline prefilter (scipy parity)."""
    if order < 2 or order > 5:
        raise RuntimeError("spline order not supported")
    x = util.as_tensor(input)
    out_dtype = _resolve_out_dtype(output, x)
    work = np.promote_types(out_dtype,
                            _float_work_dtype(x.dtype, allow_float32))
    y = x.to(dtypes.to_torch(work)).contiguous()
    if x.numel() > 0:
        y = _spline_axes(y, order, mode, tuple(range(x.ndim)))
    return y.to(dtypes.to_torch(out_dtype))


def _prepad_for_spline_filter(x, mode, cval, axes):
    """Pad ``axes`` by 12 samples for the modes without exact prefilter
    boundary conditions (nearest, grid-constant)."""
    if mode not in ("nearest", "grid-constant"):
        return x, 0
    npad = 12
    pads = [(npad, npad) if ax in axes else (0, 0) for ax in range(x.ndim)]
    return boundary.pad(x, pads, mode, cval), npad


def _prefiltered(x, order, mode, cval, prefilter, allow_float32, axes=None):
    """Cast to the working float dtype and prefilter ``axes`` (default
    all) if needed.  Returns (filtered, npad): the prepad of each
    prefiltered axis."""
    x = x.to(dtypes.to_torch(_float_work_dtype(x.dtype, allow_float32)))
    if prefilter and order > 1:
        axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
        padded, npad = _prepad_for_spline_filter(x, mode, cval, axes)
        return _spline_axes(padded.contiguous(), order, mode, axes), npad
    return x.contiguous(), 0


def _opencv_pad(x, cval):
    """``mode='opencv'``: one sample of ``cval`` around ``x``; the caller
    adds 1 to the coordinates and interpolates in mode 'constant'."""
    return boundary.pad(x, [(1, 1)] * x.ndim, "constant", cval)


def map_coordinates(
    input,
    coordinates,
    output=None,
    order=3,
    mode="constant",
    cval=0.0,
    prefilter=True,
    *,
    allow_float32=True,
):
    """Map the input to new coordinates by spline interpolation (scipy
    parity).  The coordinates keep their float dtype (integers and
    float16 are promoted to float32 with ``allow_float32``, else to
    float64); the weights are formed in it."""
    order = _check_parameter(order, mode)
    x = util.as_tensor(input)
    coordinates = util.as_tensor(coordinates, device=x.device)
    if coordinates.ndim == 0 or coordinates.shape[0] != x.ndim:
        raise RuntimeError("invalid shape for coordinate array")

    if mode in ("opencv", "_opencv_edge"):
        x = _opencv_pad(x, cval)
        coordinates = coordinates + 1
        mode = "constant"

    out_dtype = _resolve_out_dtype(output, x)
    ckind = dtypes.to_numpy(coordinates.dtype).kind
    if ckind not in "iuf":
        raise ValueError("coordinates should have floating point dtype")
    coord_work = np.float32 if allow_float32 else np.float64
    cdt = np.promote_types(dtypes.to_numpy(coordinates.dtype), coord_work)
    coordinates = coordinates.to(dtypes.to_torch(cdt))
    if x.numel() == 0:
        return _empty_input(x, coordinates.shape[1:], out_dtype, mode, cval)

    filtered, npad = _prefiltered(x, order, mode, cval, prefilter,
                                  allow_float32)
    if npad:
        coordinates = coordinates + npad
    flat = coordinates.reshape(x.ndim, -1).contiguous()
    out = spline_gather.spline_map(filtered, flat, order, mode, cval)
    return _finalize(out.reshape(coordinates.shape[1:]), out_dtype)


def _resample(filtered, matrix, offsets, output_shape, order, mode, cval,
              coord_dtype, pre=None):
    """The affine resample of the prefiltered input through the spline
    gather's affine entry (on CUDA the kernel).  ``matrix`` is (ndim,)
    (a diagonal) or (ndim, ndim); ``offsets`` include the prepad."""
    full = np.diag(matrix) if matrix.ndim == 1 else matrix
    return spline_gather.spline_affine(
        filtered, full, offsets, tuple(output_shape), order, mode, cval,
        coord_dtype, pre)


def affine_transform(
    input,
    matrix,
    offset=0.0,
    output_shape=None,
    output=None,
    order=3,
    mode="constant",
    cval=0.0,
    prefilter=True,
    *,
    allow_float32=True,
):
    """Affine transform: output[o] = input[matrix @ o + offset] (scipy
    parity).  ``matrix`` may be (ndim,), (ndim, ndim), (ndim, ndim+1) or
    homogeneous (ndim+1, ndim+1)."""
    order = _check_parameter(order, mode)
    x = util.as_tensor(input)
    matrix = _host(matrix)
    ndim = x.ndim

    if mode == "opencv":
        # OpenCV's warpAffine convention: the matrix maps input to output
        # with (x, y) axes; invert it and swap the first two axes
        m = np.zeros((ndim + 1, ndim + 1))
        m[:-1, :-1] = matrix
        m[:-1, -1] = _host(offset).reshape(-1)
        m[-1, -1] = 1.0
        m = np.linalg.inv(m)
        m[:2] = np.roll(m[:2], 1, axis=0)
        m[:2, :2] = np.roll(m[:2, :2], 1, axis=1)
        matrix = m[:-1, :-1]
        offset = m[:-1, -1]
        mode = "_opencv_edge"

    if output_shape is None:
        output_shape = x.shape
    output_shape = tuple(int(s) for s in output_shape)

    if matrix.ndim not in (1, 2):
        raise RuntimeError("no proper affine matrix provided")
    if matrix.ndim == 2:
        if matrix.shape[0] == ndim + 1 and matrix.shape[1] == ndim + 1:
            offset = matrix[:-1, -1]
            matrix = matrix[:-1, :-1]
        elif matrix.shape[0] == ndim and matrix.shape[1] == ndim + 1:
            offset = matrix[:, -1]
            matrix = matrix[:, :-1]
        if matrix.shape != (ndim, ndim):
            raise RuntimeError("improper affine shape")
    elif matrix.shape[0] != ndim:
        raise RuntimeError("improper affine shape")
    offsets = _host(offset)
    if offsets.ndim == 0:
        offsets = np.full(ndim, float(offsets))

    if mode == "_opencv_edge":
        x = _opencv_pad(x, cval)
        offsets = offsets + 1.0
        mode = "constant"

    out_dtype = _resolve_out_dtype(output, x)
    if x.numel() == 0:
        return _empty_input(x, output_shape, out_dtype, mode, cval)
    filtered, npad = _prefiltered(x, order, mode, cval, prefilter,
                                  allow_float32)
    # prepadding happens only for nearest/grid-constant, so in mode
    # 'constant' the outer mask is taken against the unpadded shape
    out = _resample(filtered, matrix, offsets + npad, output_shape, order,
                    mode, cval, _coord_dtype(allow_float32))
    return _finalize(out, out_dtype)


def shift(
    input,
    shift,
    output=None,
    order=3,
    mode="constant",
    cval=0.0,
    prefilter=True,
    *,
    allow_float32=True,
):
    """Shift an array (scipy parity): output[o] = input[o - shift]."""
    order = _check_parameter(order, mode)
    x = util.as_tensor(input)
    shifts = util.fix_sequence_arg(shift, x.ndim, "shift", float)
    if mode == "opencv":
        mode = "_opencv_edge"
    if mode == "_opencv_edge":
        return affine_transform(
            x, np.ones(x.ndim), [-s for s in shifts], None, output, order,
            mode, cval, prefilter, allow_float32=allow_float32,
        )
    out_dtype = _resolve_out_dtype(output, x)
    if x.numel() == 0:
        return _empty_input(x, x.shape, out_dtype, mode, cval)
    filtered, npad = _prefiltered(x, order, mode, cval, prefilter,
                                  allow_float32)
    out = _resample(filtered, np.ones(x.ndim),
                    np.asarray([npad - s for s in shifts]), x.shape, order,
                    mode, cval, _coord_dtype(allow_float32))
    return _finalize(out, out_dtype)


def zoom(
    input,
    zoom,
    output=None,
    order=3,
    mode="constant",
    cval=0.0,
    prefilter=True,
    *,
    grid_mode=False,
    allow_float32=True,
):
    """Zoom an array (scipy parity, ``grid_mode`` included)."""
    order = _check_parameter(order, mode)
    x = util.as_tensor(input)
    zooms = util.fix_sequence_arg(zoom, x.ndim, "zoom", float)
    output_shape = tuple(int(round(s * z)) for s, z in zip(x.shape, zooms))

    if mode == "opencv":
        # cv2.resize: pixel-centre aligned sampling, the edge replicated
        z = []
        off = []
        for in_size, out_size in zip(x.shape, output_shape):
            if out_size > 1:
                z.append(float(in_size) / out_size)
                off.append((z[-1] - 1) / 2.0)
            else:
                z.append(0.0)
                off.append(0.0)
        return affine_transform(
            x, np.asarray(z), off, output_shape, output, order, "nearest",
            cval, prefilter, allow_float32=allow_float32,
        )

    if grid_mode:
        suggest = {"constant": "grid-constant", "wrap": "grid-wrap"}.get(mode)
        if suggest is not None:
            warnings.warn(
                f"It is recommended to use mode = {suggest} instead of "
                f"{mode} when grid_mode is True.", UserWarning,
            )

    factors = []
    for in_size, out_size in zip(x.shape, output_shape):
        if grid_mode:
            # scipy applies in/out unconditionally (a size-1 output axis
            # still samples at the scaled cell centre, not at index 0)
            factors.append(in_size / out_size)
        elif out_size > 1:
            factors.append((in_size - 1) / (out_size - 1))
        else:
            factors.append(0.0)

    out_dtype = _resolve_out_dtype(output, x)
    if x.numel() == 0:
        return _empty_input(x, output_shape, out_dtype, mode, cval)
    filtered, npad = _prefiltered(x, order, mode, cval, prefilter,
                                  allow_float32)
    # grid_mode samples at (o + 0.5) * factor - 0.5
    pre = [0.5] * x.ndim if grid_mode else None
    offsets = np.full(x.ndim, (-0.5 if grid_mode else 0.0) + npad)
    out = _resample(filtered, np.asarray(factors), offsets, output_shape,
                    order, mode, cval, _coord_dtype(allow_float32), pre)
    return _finalize(out, out_dtype)


def _sincosdg(angle):
    """Degree-exact sin/cos (scipy uses special.sindg/cosdg so that right
    angles give exact 0/+-1 matrix entries)."""
    a = float(angle) % 360.0
    if a % 90.0 == 0.0:
        k = int(a // 90.0) % 4
        return [0.0, 1.0, 0.0, -1.0][k], [1.0, 0.0, -1.0, 0.0][k]
    rad = math.radians(float(angle))
    return math.sin(rad), math.cos(rad)


def rotate(
    input,
    angle,
    axes=(1, 0),
    reshape=True,
    output=None,
    order=3,
    mode="constant",
    cval=0.0,
    prefilter=True,
    *,
    allow_float32=True,
):
    """Rotate an array in the plane of two axes (scipy parity)."""
    order = _check_parameter(order, mode)
    if mode == "opencv":
        mode = "_opencv_edge"
    x = util.as_tensor(input)
    axes = list(axes)
    if axes[0] < 0:
        axes[0] += x.ndim
    if axes[1] < 0:
        axes[1] += x.ndim
    if axes[0] > axes[1]:
        axes = [axes[1], axes[0]]
    if axes[0] < 0 or x.ndim <= axes[1] or axes[0] == axes[1]:
        raise ValueError("invalid rotation plane specified")

    ndim = x.ndim
    sin, cos = _sincosdg(angle)
    rot_matrix = np.array([[cos, sin], [-sin, cos]])

    img_shape = np.asarray(x.shape)
    in_plane_shape = img_shape[axes]
    if reshape:
        iy, ix = in_plane_shape
        out_bounds = rot_matrix @ [[0, 0, iy, iy], [0, ix, 0, ix]]
        out_plane_shape = (np.ptp(out_bounds, axis=1) + 0.5).astype(int)
    else:
        out_plane_shape = img_shape[axes]

    out_center = rot_matrix @ ((out_plane_shape - 1) / 2)
    in_center = (in_plane_shape - 1) / 2

    output_shape = img_shape.copy()
    output_shape[axes] = out_plane_shape
    output_shape = tuple(int(s) for s in output_shape)

    matrix = np.identity(ndim)
    matrix[axes[0], axes[0]] = cos
    matrix[axes[0], axes[1]] = sin
    matrix[axes[1], axes[0]] = -sin
    matrix[axes[1], axes[1]] = cos

    offset = np.zeros(ndim, dtype=float)
    offset[axes] = in_center - out_center

    if ndim > 2 and mode != "_opencv_edge":
        # scipy applies the 2-D affine to every plane parallel to the
        # rotation axes: prefilter (and prepad) only those two axes, and
        # read the other axes at their integer output index with order 0
        # (an nd spline would smooth them when prefilter=False)
        out_dtype = _resolve_out_dtype(output, x)
        if x.numel() == 0:
            return _empty_input(x, output_shape, out_dtype, mode, cval)
        filtered, npad = _prefiltered(x, order, mode, cval, prefilter,
                                      allow_float32, axes)
        offset[axes] += npad
        orders = [order if ax in axes else 0 for ax in range(ndim)]
        out = spline_gather.spline_affine(
            filtered, matrix, offset, output_shape, orders, mode, cval,
            _coord_dtype(allow_float32))
        return _finalize(out, out_dtype)

    return affine_transform(
        x, matrix, offset, output_shape, output, order, mode, cval, prefilter,
        allow_float32=allow_float32,
    )


def geometric_transform(
    input,
    mapping,
    output_shape=None,
    output=None,
    order=3,
    mode="constant",
    cval=0.0,
    prefilter=True,
    extra_arguments=(),
    extra_keywords=None,
    *,
    allow_float32=True,
):
    """Arbitrary coordinate transform via a Python callback (scipy
    parity).  ``mapping(output_index, *extra_arguments,
    **extra_keywords)`` returns the input coordinate of each output
    index; like scipy, the callback runs per output point on the host,
    and the coordinate field then feeds :func:`map_coordinates`."""
    x = util.as_tensor(input)
    if output_shape is None:
        output_shape = x.shape
    output_shape = tuple(int(s) for s in output_shape)
    if extra_keywords is None:
        extra_keywords = {}
    coords = np.empty((x.ndim,) + output_shape, dtype=np.float64)
    for idx in np.ndindex(*output_shape):
        coords[(slice(None),) + idx] = mapping(
            idx, *extra_arguments, **extra_keywords
        )
    return map_coordinates(
        x, torch.from_numpy(coords).to(x.device), output, order, mode, cval,
        prefilter, allow_float32=allow_float32,
    )
