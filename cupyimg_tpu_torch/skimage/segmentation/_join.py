"""``join_segmentations``, ``relabel_sequential`` and ``clear_border``
(skimage.segmentation._join) on torch tensors: ``torch.unique``, gathers
and ``ndimage.label``, all plain torch.

torch has no sort, unique, minimum or maximum of uint16, uint32 or
uint64, so such labels are read in a signed type that keeps their order
(uint16 and uint32 widen, uint64 flips its sign bit into int64) and the
results are cast back.  ``join_segmentations`` forms its pair labels in
int64, so no pair of labels wraps onto another.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

from ..util._map_array import ArrayMap

__all__ = ["join_segmentations", "relabel_sequential", "clear_border"]

_SIGN_BIT = -2 ** 63
_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def _ordered(x):
    """``(y, back)``: ``x`` in a signed or float type that keeps the
    order of its values, and the map of such values back to ``x``'s
    dtype."""
    if x.dtype == torch.uint64:
        return (x.view(torch.int64) ^ _SIGN_BIT,
                lambda y: (y ^ _SIGN_BIT).view(torch.uint64))
    return dtypes.widen_unsigned(x), lambda y: y.to(x.dtype)


def _output_type(input_type, out_max):
    """The relabelled field's dtype: never narrower than the input's, and
    wide enough for ``out_max``."""
    required_type = np.min_scalar_type(out_max)
    if input_type.itemsize < required_type.itemsize:
        return required_type
    if out_max <= np.iinfo(input_type).max:
        return input_type
    return required_type


def _map_dtype(dtype):
    """A torch dtype that the maps' gathers and scatters take."""
    return dtypes.widen_unsigned(torch.empty(0, dtype=dtypes.to_torch(
        dtype))).dtype


def _relabel(label_field, offset, input_type):
    """``relabel_sequential`` with the output dtype chosen as for labels
    of ``input_type``."""
    if offset <= 0:
        raise ValueError("Offset must be strictly positive.")
    values, back = _ordered(label_field)
    if label_field.dtype not in _UNSIGNED and label_field.numel() and bool(
            values.min() < 0):
        raise ValueError(
            "Cannot relabel array that contains negative values."
        )
    offset = int(offset)
    in_vals, inverse = torch.unique(values, return_inverse=True)
    n = in_vals.shape[0]
    if n > np.iinfo(np.int32).max:
        raise ValueError(
            "Too many unique values in label_field (current "
            "implementation uses 32-bit indexing)."
        )
    if np.dtype(input_type).kind not in "iu":
        raise TypeError("label_field must have an integer dtype")

    # 0 always maps to 0
    zero = _ordered(torch.zeros((), dtype=label_field.dtype))[0]
    z = int(n > 0 and bool(in_vals[0] == zero.to(in_vals.device)))
    out_vals = torch.arange(offset - z, offset + n - z, dtype=torch.int64,
                            device=label_field.device)
    if z:
        out_vals[0] = 0
    out_max = 0 if z and n == 1 else offset + n - z - 1
    output_type = _output_type(np.dtype(input_type), out_max)

    out_array = out_vals[inverse].to(dtypes.to_torch(output_type))
    in_map = back(in_vals).to(_map_dtype(label_field.dtype))
    out_map = out_vals.to(_map_dtype(output_type))
    return out_array, ArrayMap(in_map, out_map), ArrayMap(out_map, in_map)


def relabel_sequential(label_field, offset=1):
    """Relabel non-negative labels to {offset, ..., offset + number of
    labels - 1}, 0 staying 0.

    Returns ``(relabeled, forward_map, inverse_map)``, the maps as
    :class:`~cupyimg_tpu_torch.skimage.util.ArrayMap`.  ``relabeled``
    keeps the input's dtype unless the new labels need a wider one; the
    maps of uint16/32/64 labels hold them in the signed type that does.
    """
    label_field = util.as_tensor(label_field)
    return _relabel(label_field, offset, dtypes.to_numpy(label_field.dtype))


def join_segmentations(s1, s2):
    """The join of two segmentations: two pixels share a segment iff they
    share one in both.  The labels are sequential from 1 (0 where both
    are 0), in the narrowest dtype at least as wide as the relabelled
    inputs' that holds them."""
    s1 = util.as_tensor(s1)
    s2 = util.as_tensor(s2, device=s1.device)
    if s1.shape != s2.shape:
        raise ValueError(
            "Cannot join segmentations of different shape. "
            + "s1.shape: %s, s2.shape: %s" % (s1.shape, s2.shape)
        )
    s1 = relabel_sequential(s1)[0]
    s2 = relabel_sequential(s2)[0]
    input_type = np.promote_types(dtypes.to_numpy(s1.dtype),
                                  dtypes.to_numpy(s2.dtype))
    a, b = _ordered(s1)[0].to(torch.int64), _ordered(s2)[0].to(torch.int64)
    j = (b.max() + 1) * a + b
    return _relabel(j, 1, input_type)[0]


def clear_border(labels, buffer_size=0, bgval=0, mask=None):
    """Clear the objects connected to the border of a label image, or to
    the False region of ``mask``; a 0/1 or bool image is first labelled
    into its connected components.  Cleared objects take ``bgval``."""
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    labels = util.as_tensor(labels)
    if any(buffer_size >= s for s in labels.shape) and mask is None:
        # buffer_size is ignored with a mask
        raise ValueError("buffer size may not be greater than labels size")

    if mask is not None:
        mask = util.as_tensor(mask, device=labels.device)
        if mask.shape != labels.shape:
            raise ValueError(
                "labels and mask should have the same shape but "
                "are {} and {}".format(tuple(labels.shape),
                                       tuple(mask.shape))
            )
        if mask.dtype != torch.bool:
            raise TypeError("mask should be of type bool.")
        borders = ~mask
    else:
        borders = torch.zeros(labels.shape, dtype=torch.bool,
                              device=labels.device)
        ext = buffer_size + 1
        for ax in range(labels.ndim):
            borders.narrow(ax, 0, ext).fill_(True)
            borders.narrow(ax, labels.shape[ax] - ext, ext).fill_(True)

    values, back = _ordered(labels)

    def const(v):  # ``v`` as a value of ``values``
        return _ordered(torch.tensor(v, dtype=labels.dtype))[0].to(
            labels.device)

    if labels.dtype == torch.bool or bool(
            ((values == const(0)) | (values == const(1))).all()):
        ccs, _ = ndi.label(values != const(0))
        zero = 0
    else:
        ccs, zero = values, const(0)
    # the components that reach the border, label 0 never among them
    touching = torch.unique(ccs[borders & (ccs != zero)])
    cleared = torch.isin(ccs, touching)
    if labels.dtype == torch.bool:
        return torch.where(cleared, bool(bgval), labels)
    return back(torch.where(cleared, const(bgval), values))
