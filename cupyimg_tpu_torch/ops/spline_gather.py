"""Spline gather at per-output coordinates: the CUDA kernel and its plain
version.

The counterpart of the interpolation kernels of ``cupyimg_tpu``:
``ops/gtg_interp.py`` (B6), ``ops/warp_gather.py`` (B7) and
``ops/pallas_interp.py`` (B8, B9).  One kernel, ``csrc/spline_gather.cu``,
with two entry points:

- :func:`spline_affine`: the input coordinate of output ``o`` is
  ``matrix @ o + offset``, formed by the kernel in the coordinate dtype
  (float64 unless the caller asks for float32).  Each axis has its own
  spline order, so an axis with an identity matrix row and order 0 reads
  one plane: a volume ``rotate`` is one launch.
- :func:`spline_map`: the coordinates come from a ``(ndim, *out_shape)``
  field of float32 or float64.

Both take 1-D to 3-D float32/float64 data, real or complex (the kernel
interpolates the real and imaginary parts in one launch), orders 0-5 and
the eight ndimage modes.  A CUDA tensor launches the kernel (and counts
one in the module's ``launches``) or raises; a CPU tensor runs the plain
version, :func:`ops.interp.gather_general` at the same coordinates.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cupyimg_tpu_torch.ops import interp

__all__ = [
    "affine_coords",
    "spline_affine",
    "spline_affine_ref",
    "spline_map",
    "spline_map_ref",
]

MAX_DIM = 3
_MODE_CODES = {
    "reflect": 0, "grid-mirror": 1, "mirror": 2, "nearest": 3,
    "wrap": 4, "grid-wrap": 5, "constant": 6, "grid-constant": 7,
}
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_REAL = {torch.float32: torch.float32, torch.float64: torch.float64,
         torch.complex64: torch.float32, torch.complex128: torch.float64}

#: launches of the kernel, both entry points together
launches = 0


def _orders(order, ndim):
    orders = [order] * ndim if isinstance(order, int) else list(order)
    if len(orders) != ndim or not all(0 <= o <= 5 for o in orders):
        raise ValueError(f"one spline order in 0..5 per axis expected, "
                         f"got {order}")
    return orders


def _cast(v, coord_dtype):
    """A host float64 value rounded to the coordinate dtype."""
    return float(np.asarray(v, np.float32 if coord_dtype == torch.float32
                            else np.float64))


def affine_coords(matrix, offset, output_shape, coord_dtype, device,
                  pre=None):
    """The coordinate field ``matrix @ (o + pre) + offset`` as the kernel
    forms it: matrix, offset and ``pre`` (default 0) rounded to
    ``coord_dtype``, the matrix terms summed first and the offset added
    last (scipy's order).  One broadcast tensor of ``output_shape`` per
    input axis."""
    ndim = len(output_shape)
    pre = [0.0] * ndim if pre is None else pre
    grids = []
    for k, s in enumerate(output_shape):
        shape = [1] * ndim
        shape[k] = s
        grids.append((torch.arange(s, dtype=coord_dtype, device=device)
                      + _cast(pre[k], coord_dtype)).reshape(shape))
    coords = []
    for j in range(ndim):
        c = 0
        for k in range(ndim):
            c = c + _cast(matrix[j][k], coord_dtype) * grids[k]
        c = c + _cast(offset[j], coord_dtype)
        coords.append(c.expand(tuple(output_shape)))
    return coords


def _check(x, what):
    if x.dtype not in _REAL:
        raise ValueError(f"{what} takes float32/float64/complex data, got "
                         f"{x.dtype}")


def _check_kernel(x, out_shape, what):
    if not (1 <= x.ndim <= MAX_DIM and len(out_shape) <= MAX_DIM):
        raise ValueError(f"{what} kernel takes 1-D to {MAX_DIM}-D data and "
                         f"outputs, got {x.ndim}-D and {len(out_shape)}-D")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous tensor")


def _pad3(values, fill):
    return [fill] * (MAX_DIM - len(values)) + list(values)


def _planes(x, out_shape):
    """(data pointer's tensor, output, output's pointer tensor, ncomp)."""
    out = torch.empty(tuple(out_shape), dtype=x.dtype, device=x.device)
    if x.is_complex():
        return torch.view_as_real(x), out, torch.view_as_real(out), 2
    return x, out, out, 1


def _library():
    from cupyimg_tpu_torch.ops import _build

    lib = _build.load("spline_gather")
    lib.spline_affine.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
    lib.spline_map.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
    lib.spline_affine.restype = ctypes.c_int
    lib.spline_map.restype = ctypes.c_int
    return lib


def _common(x, out_shape, orders, mode, cval):
    if mode not in _MODE_CODES:
        raise ValueError(f"spline_gather kernel: unsupported mode {mode}")
    cv = complex(cval)
    return (
        np.asarray(_pad3(x.shape, 1), np.int64),
        np.asarray(_pad3(out_shape, 1), np.int64),
        np.asarray(_pad3(orders, 0), np.int32),
        _MODE_CODES[mode], cv.real, cv.imag,
    )


def _finish(err, what):
    global launches
    if err != 0:
        raise RuntimeError(f"spline_gather kernel ({what}) launch failed: "
                           f"CUDA error {err}")
    launches += 1


def spline_affine(x, matrix, offset, output_shape, order, mode, cval=0.0,
                  coord_dtype=torch.float64, pre=None):
    """Interpolate ``x`` at ``matrix @ (o + pre) + offset`` for every
    output index ``o`` of ``output_shape``.

    Parameters
    ----------
    x : float32/float64/complex tensor; on CUDA 1-D to 3-D, contiguous
    matrix : (ndim, ndim) host float64 array; offset : (ndim,)
    order : int or one int per axis, 0..5
    mode : one of the eight ndimage modes
    cval : number (complex for complex data)
    coord_dtype : torch.float64 or torch.float32
    pre : (ndim,) added to the output index first (None: zeros)
    """
    _check(x, "spline_affine")
    orders = _orders(order, x.ndim)
    if x.device.type == "cpu":
        return spline_affine_ref(x, matrix, offset, output_shape, orders,
                                 mode, cval, coord_dtype, pre)
    _check_kernel(x, output_shape, "spline_affine")
    ndim = x.ndim
    m3 = np.eye(MAX_DIM)
    off3 = np.zeros(MAX_DIM)
    pre3 = np.zeros(MAX_DIM)
    for j in range(ndim):
        jj = j + MAX_DIM - ndim
        off3[jj] = _cast(offset[j], coord_dtype)
        pre3[jj] = 0.0 if pre is None else _cast(pre[j], coord_dtype)
        for k in range(ndim):
            m3[jj, k + MAX_DIM - ndim] = _cast(matrix[j][k], coord_dtype)
    in_dims, out_dims, ords, mode_code, cre, cim = _common(
        x, output_shape, orders, mode, cval)
    src, out, dst, ncomp = _planes(x, output_shape)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.spline_affine(
            src.data_ptr(), dst.data_ptr(), _DTYPE_CODES[_REAL[x.dtype]],
            _DTYPE_CODES[coord_dtype], ncomp, in_dims.ctypes.data,
            out_dims.ctypes.data, m3.ctypes.data, off3.ctypes.data,
            pre3.ctypes.data, ords.ctypes.data, mode_code, cre, cim,
            torch.cuda.current_stream(x.device).cuda_stream)
    _finish(err, "affine")
    return out


def spline_affine_ref(x, matrix, offset, output_shape, order, mode,
                      cval=0.0, coord_dtype=torch.float64, pre=None):
    """Plain version of :func:`spline_affine`: :func:`affine_coords`,
    then :func:`ops.interp.gather_general`."""
    coords = affine_coords(matrix, offset, tuple(output_shape), coord_dtype,
                           x.device, pre)
    return interp.gather_general(x, coords, order, mode, cval)


def spline_map(x, coords, order, mode, cval=0.0):
    """Interpolate ``x`` at the coordinate field ``coords``, a float32 or
    float64 tensor of shape ``(x.ndim, *out_shape)`` (weights formed in
    its dtype)."""
    _check(x, "spline_map")
    orders = _orders(order, x.ndim)
    if coords.shape[0] != x.ndim:
        raise ValueError("spline_map: one coordinate plane per input axis")
    if x.device.type == "cpu":
        return spline_map_ref(x, coords, orders, mode, cval)
    if coords.dtype not in _DTYPE_CODES or not coords.is_contiguous() or (
            coords.device != x.device):
        raise ValueError("spline_map kernel takes a contiguous float32/"
                         "float64 coordinate field on the data's device")
    out_shape = tuple(coords.shape[1:])
    _check_kernel(x, out_shape, "spline_map")
    in_dims, out_dims, ords, mode_code, cre, cim = _common(
        x, out_shape, orders, mode, cval)
    src, out, dst, ncomp = _planes(x, out_shape)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.spline_map(
            src.data_ptr(), coords.data_ptr(), dst.data_ptr(),
            _DTYPE_CODES[_REAL[x.dtype]], _DTYPE_CODES[coords.dtype], ncomp,
            x.ndim, in_dims.ctypes.data, out_dims.ctypes.data,
            ords.ctypes.data, mode_code, cre, cim,
            torch.cuda.current_stream(x.device).cuda_stream)
    _finish(err, "map")
    return out


def spline_map_ref(x, coords, order, mode, cval=0.0):
    """Plain version of :func:`spline_map`:
    :func:`ops.interp.gather_general` at ``coords``."""
    return interp.gather_general(x, list(coords.unbind(0)), order, mode,
                                 cval)
