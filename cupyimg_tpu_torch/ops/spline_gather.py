"""Spline gather at per-output coordinates: the CUDA kernel and its plain
version.

The counterpart of the interpolation kernels of ``cupyimg_tpu``:
``ops/gtg_interp.py`` (B6), ``ops/warp_gather.py`` (B7) and
``ops/pallas_interp.py`` (B8, B9).  One kernel source,
``csrc/spline_gather.cu``, with two entry points:

- :func:`spline_affine`: the input coordinate of output ``o`` is
  ``matrix @ o + offset``, formed by the kernel in the coordinate dtype
  (float64 unless the caller asks for float32).  Each axis has its own
  spline order, so an axis with an identity matrix row and order 0 reads
  one plane: a volume ``rotate`` is one launch.
- :func:`spline_map`: the coordinates come from a ``(ndim, *out_shape)``
  field of float32 or float64.

Both take float32/float64 data, real or complex (the kernel
interpolates the real and imaginary parts in one launch), orders 0-5 and
the eight ndimage modes.  The applicability gate :func:`supports` decides
the route: a CUDA tensor of 1 to 3 axes with an output of at most 3
launches the kernel (and counts one in the module's ``launches``) or
raises; any other tensor runs the plain version,
:func:`ops.interp.gather_general` at the same coordinates, on its own
device (a CUDA tensor of 4 or more axes on the card).

The kernel is a family of template instances, picked on the host by
:func:`instance`: one per (data type, coordinate type, components, order
pattern) for the patterns in :data:`AFFINE_PATTERNS` / :data:`MAP_PATTERNS`
(every pattern ``scipy/ndimage/interpolation.py`` produces), with
compile-time tap counts and 32-bit indices; any other combination (mixed
orders, 2^31 elements or more) runs on the kernel's generic instance.
Never on the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from cupyimg_tpu_torch.ops import interp

__all__ = [
    "AFFINE_PATTERNS",
    "MAP_PATTERNS",
    "Instance",
    "affine_coords",
    "instance",
    "pattern_key",
    "spline_affine",
    "spline_affine_ref",
    "spline_map",
    "spline_map_ref",
    "supports",
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

#: the order patterns with an instance of their own (the kernel's
#: SG_UNIFORM_PATTERNS / SG_AFFINE_PATTERNS / SG_MAP_PATTERNS): every
#: uniform order of 1-3 axes, and for the affine entry a volume rotate's
#: patterns, one axis of order 0 and the other two of the same order
_UNIFORM = tuple((o,) * nd for nd in (1, 2, 3) for o in range(6))
AFFINE_PATTERNS = _UNIFORM + tuple(
    tuple(0 if j == zero else o for j in range(3))
    for zero in range(3) for o in range(1, 6))
MAP_PATTERNS = _UNIFORM
#: the fast instances' indices are 32-bit: input, output and coordinate
#: field stay below this many elements (the grid's last block included)
MAX_FAST_ELEMENTS = 2 ** 31 - 2 ** 20


@dataclass(frozen=True)
class Instance:
    """One instance of the kernel: ``entry`` "affine" or "map"; ``part``
    the library it is compiled into (data type, coordinate type and
    components); ``key`` its order pattern (:func:`pattern_key`), or
    None for the generic instance (part 0)."""
    entry: str
    part: int
    key: int | None


def pattern_key(orders):
    """An order pattern's key in the kernel: the number of axes, then each
    axis' order, as decimal digits."""
    return int(str(len(orders)) + "".join(str(int(o)) for o in orders))


def _part(dtype, coord_dtype, ncomp):
    return (4 * _DTYPE_CODES[dtype] + 2 * _DTYPE_CODES[coord_dtype]
            + ncomp - 1)


def instance(entry, orders, dtype, coord_dtype, n_in, n_out, out_ndim=None):
    """The kernel instance that serves a call: ``entry`` "affine" or
    "map", ``orders`` one per input axis, ``dtype`` the data's (real or
    complex), ``coord_dtype`` float32/float64, ``n_in``/``n_out`` the
    input's and output's element counts, ``out_ndim`` the affine output's
    number of axes (default: the input's)."""
    orders = tuple(int(o) for o in orders)
    ncomp = 2 if dtype.is_complex else 1
    patterns = AFFINE_PATTERNS if entry == "affine" else MAP_PATTERNS
    fits = max(n_in, n_out * (len(orders) if entry == "map" else 1)) <= (
        MAX_FAST_ELEMENTS)
    same_ndim = entry == "map" or out_ndim in (None, len(orders))
    if orders in patterns and fits and same_ndim:
        return Instance(entry, _part(_REAL[dtype], coord_dtype, ncomp),
                        pattern_key(orders))
    return Instance(entry, 0, None)


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


def supports(x, out_shape):
    """Whether the kernel serves a call: a CUDA tensor of 1 to
    ``MAX_DIM`` axes and an output of at most ``MAX_DIM`` axes.  Every
    other call takes the plain gather on the tensor's device."""
    return (x.is_cuda and 1 <= x.ndim <= MAX_DIM
            and len(out_shape) <= MAX_DIM)


def _check(x, what):
    if x.dtype not in _REAL:
        raise ValueError(f"{what} takes float32/float64/complex data, got "
                         f"{x.dtype}")


def _check_kernel(x, what):
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


def _library(part=0):
    from cupyimg_tpu_torch.ops import _build

    lib = _build.load("spline_gather", part)
    tail = [ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    lib.spline_affine_fast.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
        + tail)
    lib.spline_map_fast.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p,
                                                      ctypes.c_int] + tail)
    fns = [lib.spline_affine_fast, lib.spline_map_fast]
    if part == 0:  # the generic instance
        lib.spline_affine.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 6 + tail)
        lib.spline_map.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 3 + tail)
        fns += [lib.spline_affine, lib.spline_map]
    for fn in fns:
        fn.restype = ctypes.c_int
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
    x : float32/float64/complex tensor; contiguous where the kernel
        serves it (:func:`supports`)
    matrix : (ndim, ndim) host float64 array; offset : (ndim,)
    order : int or one int per axis, 0..5
    mode : one of the eight ndimage modes
    cval : number (complex for complex data)
    coord_dtype : torch.float64 or torch.float32
    pre : (ndim,) added to the output index first (None: zeros)
    """
    _check(x, "spline_affine")
    orders = _orders(order, x.ndim)
    if not supports(x, output_shape):
        return spline_affine_ref(x, matrix, offset, output_shape, orders,
                                 mode, cval, coord_dtype, pre)
    _check_kernel(x, "spline_affine")
    ndim = x.ndim
    src, out, dst, ncomp = _planes(x, output_shape)
    if out.numel() == 0:
        return out
    in_dims, out_dims, ords, mode_code, cre, cim = _common(
        x, output_shape, orders, mode, cval)
    inst = instance("affine", orders, x.dtype, coord_dtype, x.numel(),
                    out.numel(), len(output_shape))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dt, ct = _DTYPE_CODES[_REAL[x.dtype]], _DTYPE_CODES[coord_dtype]
    lib = _library(inst.part)
    if inst.key is not None:
        m = np.asarray([[_cast(matrix[j][k], coord_dtype)
                         for k in range(ndim)] for j in range(ndim)])
        off = np.asarray([_cast(offset[j], coord_dtype) for j in range(ndim)])
        pr = np.asarray([0.0 if pre is None else _cast(pre[j], coord_dtype)
                         for j in range(ndim)])
        dims = np.asarray([*x.shape, *output_shape], np.int32)
        with torch.cuda.device(x.device):
            err = lib.spline_affine_fast(
                src.data_ptr(), dst.data_ptr(), dt, ct, ncomp, inst.key,
                ndim, dims.ctypes.data, dims[ndim:].ctypes.data,
                m.ctypes.data, off.ctypes.data, pr.ctypes.data, mode_code,
                cre, cim, stream)
        _finish(err, "affine")
        return out
    m3 = np.eye(MAX_DIM)
    off3 = np.zeros(MAX_DIM)
    pre3 = np.zeros(MAX_DIM)
    for j in range(ndim):
        jj = j + MAX_DIM - ndim
        off3[jj] = _cast(offset[j], coord_dtype)
        pre3[jj] = 0.0 if pre is None else _cast(pre[j], coord_dtype)
        for k in range(ndim):
            m3[jj, k + MAX_DIM - ndim] = _cast(matrix[j][k], coord_dtype)
    with torch.cuda.device(x.device):
        err = lib.spline_affine(
            src.data_ptr(), dst.data_ptr(), dt, ct, ncomp,
            in_dims.ctypes.data, out_dims.ctypes.data, m3.ctypes.data,
            off3.ctypes.data, pre3.ctypes.data, ords.ctypes.data, mode_code,
            cre, cim, stream)
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
    out_shape = tuple(coords.shape[1:])
    if not supports(x, out_shape):
        return spline_map_ref(x, coords, orders, mode, cval)
    if coords.dtype not in _DTYPE_CODES or not coords.is_contiguous() or (
            coords.device != x.device):
        raise ValueError("spline_map kernel takes a contiguous float32/"
                         "float64 coordinate field on the data's device")
    _check_kernel(x, "spline_map")
    in_dims, out_dims, ords, mode_code, cre, cim = _common(
        x, out_shape, orders, mode, cval)
    src, out, dst, ncomp = _planes(x, out_shape)
    if out.numel() == 0:
        return out
    inst = instance("map", orders, x.dtype, coords.dtype, x.numel(),
                    out.numel())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dt, ct = _DTYPE_CODES[_REAL[x.dtype]], _DTYPE_CODES[coords.dtype]
    lib = _library(inst.part)
    with torch.cuda.device(x.device):
        if inst.key is not None:
            dims = np.asarray(x.shape, np.int32)
            err = lib.spline_map_fast(
                src.data_ptr(), coords.data_ptr(), dst.data_ptr(), dt, ct,
                ncomp, inst.key, x.ndim, dims.ctypes.data, out.numel(),
                mode_code, cre, cim, stream)
        else:
            err = lib.spline_map(
                src.data_ptr(), coords.data_ptr(), dst.data_ptr(), dt, ct,
                ncomp, x.ndim, in_dims.ctypes.data, out_dims.ctypes.data,
                ords.ctypes.data, mode_code, cre, cim, stream)
    _finish(err, "map")
    return out


def spline_map_ref(x, coords, order, mode, cval=0.0):
    """Plain version of :func:`spline_map`:
    :func:`ops.interp.gather_general` at ``coords``."""
    return interp.gather_general(x, list(coords.unbind(0)), order, mode,
                                 cval)
