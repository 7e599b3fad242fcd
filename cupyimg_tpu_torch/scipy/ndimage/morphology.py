"""scipy.ndimage morphology on torch tensors.

API parity with scipy.ndimage for binary erosion/dilation/opening/
closing/hit-or-miss/propagation/fill-holes and grey-scale morphology,
``axes`` included.

Routing of a call:

- grey erosion and dilation are the min/max filters
  (``filters._min_or_max_filter``): ONE launch of the fused separable
  kernel's min/max op for a float32 2-D/3-D CUDA tensor over a full
  rectangle;
- grey opening and closing over a flat rectangle (``size``, or an
  all-ones ``footprint``) of a float32 2-D/3-D tensor: ONE two-stage
  pass (``fused_separable.fused_separable_open_close``) where extending
  the input once by both windows equals scipy's two calls (odd windows
  with origin 0 under reflect/mirror/grid-mirror, any window under
  wrap/grid-wrap) and the planner fits a tile; else the two calls, two
  min/max launches on CUDA;
- morphological gradient and laplace over a flat rectangle of odd sizes
  and origin 0: ONE pair pass (``fused_separable_morph_pair``), exact
  under every mode; else a dilation and an erosion;
- binary operations are plain torch on any device: pad with
  ``border_value``, then AND/OR over the structure's offsets.  Iterating
  to a fixpoint (``iterations < 1``, propagation, hole filling) checks
  for convergence once every ``_FIXPOINT_CHECK`` steps: each check waits
  for the device.

Differences from scipy: ``output`` may be a dtype (or None) but not a
preallocated array; ``morphological_laplace`` computes
``(dilation + erosion) - 2 * input`` where scipy subtracts the input
twice, which can round one ulp apart (as ``cupyimg_tpu`` does).
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, dtypes, util
from cupyimg_tpu_torch.ops import fused_separable, stencil
from cupyimg_tpu_torch.scipy.ndimage.filters import (_axes_embed_array,
                                                     _min_or_max_filter)

__all__ = [
    "generate_binary_structure",
    "iterate_structure",
    "binary_erosion",
    "binary_dilation",
    "binary_opening",
    "binary_closing",
    "binary_hit_or_miss",
    "binary_propagation",
    "binary_fill_holes",
    "grey_erosion",
    "grey_dilation",
    "grey_opening",
    "grey_closing",
    "morphological_gradient",
    "morphological_laplace",
    "white_tophat",
    "black_tophat",
]

# steps of a binary fixpoint loop between two convergence checks: a check
# waits for the device, a step past the fixpoint changes nothing
_FIXPOINT_CHECK = 8


def generate_binary_structure(rank, connectivity):
    """Binary structuring element (scipy parity; a host numpy array)."""
    if connectivity < 1:
        connectivity = 1
    if rank < 1:
        return np.asarray(True, dtype=bool)
    output = np.abs(np.indices([3] * rank) - 1)
    output = np.add.reduce(output, 0)
    return np.asarray(output <= connectivity)


def iterate_structure(structure, iterations, origin=None):
    """Dilate a structure with itself ``iterations - 1`` times (scipy
    parity; a host numpy array)."""
    structure = np.asarray(structure)
    if iterations < 2:
        return structure.copy()
    ni = iterations - 1
    shape = [ii + ni * (ii - 1) for ii in structure.shape]
    pos = [ni * (structure.shape[ii] // 2) for ii in range(len(shape))]
    slc = tuple(
        slice(pos[ii], pos[ii] + structure.shape[ii])
        for ii in range(len(shape))
    )
    out = np.zeros(shape, bool)
    out[slc] = structure != 0
    out = binary_dilation(torch.from_numpy(out), structure != 0,
                          iterations=ni).numpy()
    if origin is None:
        return out
    origin = util.fix_sequence_arg(origin, structure.ndim, "origin", int)
    return out, [iterations * o for o in origin]


def _normalize_structure(structure, input, origin):
    if structure is None:
        structure = generate_binary_structure(input.ndim, 1)
    else:
        if isinstance(structure, torch.Tensor):
            structure = structure.cpu().numpy()
        structure = np.asarray(structure) != 0
    if structure.ndim != input.ndim:
        raise RuntimeError("structure rank must equal input rank")
    origins = util.fix_sequence_arg(origin, input.ndim, "origin", int)
    return structure, origins


def _binary_step(shape, device, taps, pad_width, border_value, dilate):
    """One erosion (AND over the structure's taps) or dilation (OR) of a
    bool tensor of ``shape``, the border extended with ``border_value``.
    The padded buffer is made once and its border never written, so a
    step copies the interior and reduces: no index tables per step."""
    buf = torch.full([n + lo + hi for n, (lo, hi) in zip(shape, pad_width)],
                     border_value, dtype=torch.bool, device=device)
    inner = buf[tuple(slice(lo, lo + n)
                      for n, (lo, _) in zip(shape, pad_width))]
    pieces = [buf[tuple(slice(o, o + n) for o, n in zip(off, shape))]
              for off in taps]

    def step(y):
        if not pieces:  # an empty structure: AND of nothing, OR of nothing
            return torch.full(shape, not dilate, dtype=torch.bool,
                              device=device)
        inner.copy_(y)
        out = pieces[0].clone()
        for piece in pieces[1:]:
            if dilate:
                out |= piece
            else:
                out &= piece
        return out

    return step


def _iterate_binary_op(x0, step, iterations, mask):
    """Apply ``step`` repeatedly with scipy's mask/iterations semantics.

    ``iterations >= 1``: that many steps.  ``iterations < 1``: to the
    fixpoint, checked once every ``_FIXPOINT_CHECK`` steps (the last two
    states compared): a check waits for the device, and the steps run
    past the fixpoint change nothing.  The steps taken are added to
    ``_iterate_binary_op.steps``.
    """
    if not isinstance(iterations, (int, np.integer)):
        # scipy rejects float iteration counts (test_binary_erosion38)
        raise TypeError("iterations must be an integer")
    if mask is not None:
        mask = util.as_tensor(mask, x0.device) != 0

    def masked_step(y):
        new = step(y)
        return torch.where(mask, new, y) if mask is not None else new

    if iterations >= 1:
        y = x0
        for _ in range(int(iterations)):
            y = masked_step(y)
        _iterate_binary_op.steps += int(iterations)
        return y
    prev, y = x0, masked_step(x0)
    steps = 1
    while not torch.equal(prev, y):
        for _ in range(_FIXPOINT_CHECK):
            prev, y = y, masked_step(y)
        steps += _FIXPOINT_CHECK
    _iterate_binary_op.steps += steps
    return y


_iterate_binary_op.steps = 0


def _binary_axes_args(input, structure, origin, axes):
    """scipy ``axes`` for binary morphology: the structure spans
    len(axes) dims and is embedded with singleton dims elsewhere."""
    ndim = input.ndim
    axes = util.check_axes(axes, ndim)
    if len(axes) == ndim:
        return structure, origin
    if structure is None:
        structure = generate_binary_structure(len(axes), 1)
    structure = _axes_embed_array(structure, axes, ndim, "structure")
    origin = util.expand_axes_arg(origin, axes, ndim, "origin", 0, int)
    return structure, origin


def _grey_axes_args(input, size, footprint, structure, origin, axes):
    ndim = input.ndim
    axes = util.check_axes(axes, ndim)
    if len(axes) == ndim:
        return size, footprint, structure, origin
    if structure is not None:
        structure = _axes_embed_array(structure, axes, ndim, "structure")
    if footprint is not None:
        footprint = _axes_embed_array(footprint, axes, ndim, "footprint")
    if structure is None and footprint is None and size is not None:
        size = util.expand_axes_arg(size, axes, ndim, "size", 1, int)
    origin = util.expand_axes_arg(origin, axes, ndim, "origin", 0, int)
    return size, footprint, structure, origin


def _binary_erosion(input, structure, iterations, mask, output, border_value,
                    origin, invert):
    """Shared body of binary erosion and dilation.  ``invert=True`` computes
    dilation: OR over the mirrored structure, with the origins negated
    (shifted by one for an even size), as scipy does."""
    input = util.as_tensor(input) != 0
    structure, origins = _normalize_structure(structure, input, origin)
    border_value = bool(border_value)
    if invert:
        structure = structure[tuple([slice(None, None, -1)] * structure.ndim)]
        origins = [
            -o - 1 if w % 2 == 0 else -o
            for o, w in zip(origins, structure.shape)
        ]
    for o, w in zip(origins, structure.shape):
        util.check_origin(o, w)
    taps, pad_width = stencil.footprint_offsets(structure, origins)
    step = _binary_step(input.shape, input.device, taps, pad_width,
                        border_value, invert)
    result = _iterate_binary_op(input, step, iterations, mask)
    out_dtype = dtypes.resolve_output_dtype(output, np.bool_)
    return result.to(dtypes.to_torch(out_dtype))


def binary_erosion(
    input, structure=None, iterations=1, mask=None, output=None,
    border_value=0, origin=0, brute_force=False, *, axes=None,
):
    """Multidimensional binary erosion (scipy parity).  ``brute_force``
    is accepted for parity; every element is processed."""
    del brute_force
    input = util.as_tensor(input)
    structure, origin = _binary_axes_args(input, structure, origin, axes)
    return _binary_erosion(input, structure, iterations, mask, output,
                           border_value, origin, False)


def binary_dilation(
    input, structure=None, iterations=1, mask=None, output=None,
    border_value=0, origin=0, brute_force=False, *, axes=None,
):
    """Multidimensional binary dilation (scipy parity)."""
    del brute_force
    input = util.as_tensor(input)
    structure, origin = _binary_axes_args(input, structure, origin, axes)
    return _binary_erosion(input, structure, iterations, mask, output,
                           border_value, origin, True)


def binary_opening(
    input, structure=None, iterations=1, output=None, origin=0, mask=None,
    border_value=0, brute_force=False, *, axes=None,
):
    """Binary opening: dilation of the erosion (scipy parity)."""
    input = util.as_tensor(input)
    structure, origin = _binary_axes_args(input, structure, origin, axes)
    tmp = binary_erosion(input, structure, iterations, mask, None,
                         border_value, origin)
    return binary_dilation(tmp, structure, iterations, mask, output,
                           border_value, origin)


def binary_closing(
    input, structure=None, iterations=1, output=None, origin=0, mask=None,
    border_value=0, brute_force=False, *, axes=None,
):
    """Binary closing: erosion of the dilation (scipy parity)."""
    input = util.as_tensor(input)
    structure, origin = _binary_axes_args(input, structure, origin, axes)
    tmp = binary_dilation(input, structure, iterations, mask, None,
                          border_value, origin)
    return binary_erosion(tmp, structure, iterations, mask, output,
                          border_value, origin)


def binary_hit_or_miss(
    input, structure1=None, structure2=None, output=None, origin1=0,
    origin2=None,
):
    """Hit-or-miss transform (scipy parity): ``erosion(x, s1) &
    erosion(~x, s2)``, the complement's border taken as set."""
    input = util.as_tensor(input) != 0
    if structure1 is None:
        structure1 = generate_binary_structure(input.ndim, 1)
    structure1 = np.asarray(structure1) != 0
    if structure2 is None:
        structure2 = np.logical_not(structure1)
    else:
        structure2 = np.asarray(structure2) != 0
    origin1 = util.fix_sequence_arg(origin1, input.ndim, "origin1", int)
    if origin2 is None:
        origin2 = list(origin1)
    else:
        origin2 = util.fix_sequence_arg(origin2, input.ndim, "origin2", int)
    tmp1 = _binary_erosion(input, structure1, 1, None, None, 0, origin1,
                           False)
    tmp2 = _binary_erosion(~input, structure2, 1, None, None, 1, origin2,
                           False)
    out_dtype = dtypes.resolve_output_dtype(output, np.bool_)
    return (tmp1 & tmp2).to(dtypes.to_torch(out_dtype))


def binary_propagation(
    input, structure=None, mask=None, output=None, border_value=0, origin=0,
):
    """Binary propagation of ``input`` inside ``mask``: dilation to the
    fixpoint (scipy parity)."""
    return binary_dilation(input, structure, -1, mask, output, border_value,
                           origin)


def binary_fill_holes(input, structure=None, output=None, origin=0, *,
                      axes=None):
    """Fill holes: propagate the background from the border, then invert
    (scipy parity)."""
    input = util.as_tensor(input)
    structure, origin = _binary_axes_args(input, structure, origin, axes)
    mask = input == 0
    tmp = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    filled = binary_dilation(tmp, structure, -1, mask, None, 1, origin)
    out_dtype = dtypes.resolve_output_dtype(output, np.bool_)
    return (~filled).to(dtypes.to_torch(out_dtype))


# ---------------------------------------------------------------------------
# grey-scale morphology: the min/max filters, and B1's two-stage and pair
# modes where they compute the same values
# ---------------------------------------------------------------------------


def _grey_structure(size, footprint, structure):
    if size is None and footprint is None and structure is None:
        raise ValueError("size, footprint or structure must be specified")
    if structure is not None:
        structure = np.asarray(structure, dtype=np.float64)
    if footprint is not None:
        footprint = np.asarray(footprint) != 0
    return size, footprint, structure


def grey_erosion(
    input, size=None, footprint=None, structure=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Grey-scale erosion (scipy parity incl. ``axes``)."""
    input = util.as_tensor(input)
    size, footprint, structure = _grey_structure(size, footprint, structure)
    size, footprint, structure, origin = _grey_axes_args(
        input, size, footprint, structure, origin, axes
    )
    return _min_or_max_filter(input, size, footprint, structure, output,
                              mode, cval, origin, True)


def grey_dilation(
    input, size=None, footprint=None, structure=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Grey-scale dilation (scipy parity incl. ``axes``).

    scipy mirrors the structure/footprint and negates the origins (with
    the even-size shift) before taking the max; the same is done here,
    since the max filter reduces over the unmirrored window.
    """
    input = util.as_tensor(input)
    size, footprint, structure = _grey_structure(size, footprint, structure)
    size, footprint, structure, origin = _grey_axes_args(
        input, size, footprint, structure, origin, axes
    )
    ndim = input.ndim
    origins = util.fix_sequence_arg(origin, ndim, "origin", int)
    if structure is not None:
        structure = structure[tuple([slice(None, None, -1)] * structure.ndim)]
        shape = structure.shape
    if footprint is not None:
        footprint = footprint[tuple([slice(None, None, -1)] * footprint.ndim)]
        shape = footprint.shape
    if structure is None and footprint is None:
        shape = tuple(util.fix_sequence_arg(size, ndim, "size", int))
    origins = [-o - 1 if w % 2 == 0 else -o for o, w in zip(origins, shape)]
    return _min_or_max_filter(input, size, footprint, structure, output,
                              mode, cval, origins, False)


def _flat_rect_sizes(input, size, footprint, structure, origin, axes):
    """(sizes, origins) per axis when the call describes a flat
    rectangle on a floating input (an all-ones ``footprint``, e.g. a
    skimage square or rectangle, counts), else None."""
    if structure is not None or (size is None and footprint is None):
        return None
    if not input.is_floating_point() or input.numel() == 0:
        return None  # empty inputs take the two calls' early return
    ndim = input.ndim
    size, footprint, structure, origin = _grey_axes_args(
        input, size, footprint, structure, origin, axes
    )
    if structure is not None:
        return None
    origins = util.fix_sequence_arg(origin, ndim, "origin", int)
    if footprint is not None:
        fp = np.asarray(footprint, bool)
        if fp.ndim != ndim or not fp.all():
            return None
        sizes = list(fp.shape)
    else:
        sizes = util.fix_sequence_arg(size, ndim, "size", int)
    # every axis, a size-1 one too: scipy raises there (cupyimg_tpu's gate
    # skips size-1 axes)
    for o, sz in zip(origins, sizes):
        util.check_origin(o, sz)
    return sizes, origins


def _try_fused_open_close(input, size, footprint, structure, mode, cval,
                          origin, axes, opening):
    """One two-stage pass for an opening or closing over a flat
    rectangle, where it equals scipy's two calls: odd windows with origin
    0 under the symmetric modes (reflect, mirror, grid-mirror), any window
    under wrap, and a tile the planner fits.  Returns None when the two
    calls must run."""
    rect = _flat_rect_sizes(input, size, footprint, structure, origin, axes)
    if rect is None:
        return None
    sizes, origins = rect
    modes = util.fix_sequence_arg(mode, input.ndim, "mode", str)
    for sz, o, m in zip(sizes, origins, modes):
        boundary.check_mode(m)
        if sz <= 1 or m in ("wrap", "grid-wrap"):
            continue
        if sz % 2 == 0 or o != 0:
            return None
        if m not in ("reflect", "mirror", "grid-mirror"):
            return None
    if not fused_separable.supports_open_close(input, sizes):
        return None
    # the dilation stage mirrors the (rectangular) footprint and negates
    # the origins with the even-size shift (see grey_dilation); under the
    # non-wrap gate (odd sizes, origin 0) this is the identity
    o_ero = tuple(origins)
    o_dil = tuple(-o - 1 if sz % 2 == 0 else -o
                  for o, sz in zip(origins, sizes))
    o1, o2 = (o_ero, o_dil) if opening else (o_dil, o_ero)
    return fused_separable.fused_separable_open_close(
        input.contiguous(), tuple(sizes), o1, o2, tuple(modes), float(cval),
        opening,
    )


def _try_fused_morph_pair(input, size, footprint, structure, mode, cval,
                          origin, axes, combine):
    """One pair pass for a gradient or laplace over a flat rectangle.
    Both folds read one extension, so this is exact under every mode; the
    gate asks for equal min and max windows (odd sizes, origin 0, where
    grey_dilation's origin negation is the identity).  Returns None when
    a dilation and an erosion must run."""
    rect = _flat_rect_sizes(input, size, footprint, structure, origin, axes)
    if rect is None:
        return None
    sizes, origins = rect
    modes = util.fix_sequence_arg(mode, input.ndim, "mode", str)
    for m in modes:
        boundary.check_mode(m)
    for sz, o in zip(sizes, origins):
        if sz > 1 and (sz % 2 == 0 or o != 0):
            return None
    if not fused_separable.supports_pair(input, sizes):
        return None
    return fused_separable.fused_separable_morph_pair(
        input.contiguous(), tuple(sizes), tuple(origins), tuple(modes),
        float(cval), combine,
    )


def _check_not_bool(input):
    if input.dtype == torch.bool:
        # numpy's boolean subtract raises TypeError in scipy
        raise TypeError("boolean subtract is not supported; use ^ for bool "
                        "input")


def _as_output(y, output, input_dtype):
    out_dtype = dtypes.resolve_output_dtype(output, input_dtype)
    return y.to(dtypes.to_torch(out_dtype))


def grey_opening(
    input, size=None, footprint=None, structure=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Grey opening: dilation of the erosion (scipy parity)."""
    input = util.as_tensor(input)
    fused = _try_fused_open_close(input, size, footprint, structure, mode,
                                  cval, origin, axes, True)
    if fused is not None:
        return _as_output(fused, output, input.dtype)
    tmp = grey_erosion(input, size, footprint, structure, None, mode, cval,
                       origin, axes=axes)
    return grey_dilation(tmp, size, footprint, structure, output, mode, cval,
                         origin, axes=axes)


def grey_closing(
    input, size=None, footprint=None, structure=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Grey closing: erosion of the dilation (scipy parity)."""
    input = util.as_tensor(input)
    fused = _try_fused_open_close(input, size, footprint, structure, mode,
                                  cval, origin, axes, False)
    if fused is not None:
        return _as_output(fused, output, input.dtype)
    tmp = grey_dilation(input, size, footprint, structure, None, mode, cval,
                        origin, axes=axes)
    return grey_erosion(tmp, size, footprint, structure, output, mode, cval,
                        origin, axes=axes)


def morphological_gradient(
    input, size=None, footprint=None, structure=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Dilation minus erosion (scipy parity)."""
    input = util.as_tensor(input)
    _check_not_bool(input)
    fused = _try_fused_morph_pair(input, size, footprint, structure, mode,
                                  cval, origin, axes, "grad")
    if fused is None:
        d = grey_dilation(input, size, footprint, structure, None, mode, cval,
                          origin, axes=axes)
        e = grey_erosion(input, size, footprint, structure, None, mode, cval,
                         origin, axes=axes)
        fused = d - e
    return _as_output(fused, output, input.dtype)


def morphological_laplace(
    input, size=None, footprint=None, structure=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Dilation + erosion - 2 * input (scipy parity, up to the rounding
    of that last step: scipy subtracts the input twice)."""
    input = util.as_tensor(input)
    _check_not_bool(input)
    fused = _try_fused_morph_pair(input, size, footprint, structure, mode,
                                  cval, origin, axes, "laplace")
    if fused is None:
        d = grey_dilation(input, size, footprint, structure, None, mode, cval,
                          origin, axes=axes)
        e = grey_erosion(input, size, footprint, structure, None, mode, cval,
                         origin, axes=axes)
        fused = d + e - 2 * input
    return _as_output(fused, output, input.dtype)


def white_tophat(
    input, size=None, footprint=None, structure=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Input minus its grey opening (scipy parity; XOR for bool input)."""
    input = util.as_tensor(input)
    opened = grey_opening(input, size, footprint, structure, None, mode, cval,
                          origin, axes=axes)
    if input.dtype == torch.bool:
        return _as_output(input ^ opened, output, input.dtype)
    return _as_output(input - opened, output, input.dtype)


def black_tophat(
    input, size=None, footprint=None, structure=None, output=None,
    mode="reflect", cval=0.0, origin=0, *, axes=None,
):
    """Grey closing minus the input (scipy parity; XOR for bool input)."""
    input = util.as_tensor(input)
    closed = grey_closing(input, size, footprint, structure, None, mode, cval,
                          origin, axes=axes)
    if input.dtype == torch.bool:
        return _as_output(closed ^ input, output, input.dtype)
    return _as_output(closed - input, output, input.dtype)
