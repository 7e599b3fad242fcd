"""``find_boundaries`` and ``mark_boundaries``
(skimage.segmentation.boundaries) on torch tensors.

The thick, inner and outer modes compare a grey dilation with a grey
erosion of the labels (plain torch: the fused min/max kernel takes
float32 only).  The subpixel mode decides every interstitial pixel of
the expanded grid at once: it is a boundary iff its 3^ndim window holds
two distinct labels (the zero padding counting as label 0), which is a
window minimum and a window maximum that differ, the interstitial pixels
left out of both.  Labels of uint16/32/64 are read in a signed type that
keeps their order.  ``mark_boundaries``' subpixel mode zooms each
channel with ``ndimage.zoom``: for a float32 image one launch of the
fused separable kernel (the spline prefilter) and one of the spline
gather's affine entry a channel; a float64 image takes the prefilter's
recursion and the gather.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy import ndimage as ndi

from ..color import gray2rgb
from ..morphology import dilation, erosion, square
from ..util import img_as_float
from ._join import _ordered

__all__ = ["find_boundaries", "mark_boundaries"]


def _find_boundaries_subpixel(labels, zero):
    """The subpixel boundaries of the signed ``labels``; ``zero`` is label
    0 as one of their values."""
    ndim = labels.ndim
    info = torch.iinfo(labels.dtype)
    expanded_shape = tuple(2 * s - 1 for s in labels.shape)
    pixels = (slice(None, None, 2),) * ndim
    # the interstitial pixels take no part: the largest value in the
    # minimum, the smallest in the maximum (every window holds a label)
    lo = torch.full(expanded_shape, info.max, dtype=labels.dtype,
                    device=labels.device)
    lo[pixels] = labels
    hi = torch.full(expanded_shape, info.min, dtype=labels.dtype,
                    device=labels.device)
    hi[pixels] = labels
    vmin = ndi.minimum_filter(lo, size=3, mode="constant", cval=zero)
    vmax = ndi.maximum_filter(hi, size=3, mode="constant", cval=zero)
    edges = torch.ones(expanded_shape, dtype=torch.bool,
                       device=labels.device)
    edges[pixels] = False
    return edges & (vmin != vmax)


def find_boundaries(label_img, connectivity=1, mode="thick", background=0):
    """A bool tensor, True on the boundaries between labelled regions
    (modes 'thick', 'inner', 'outer' and 'subpixel')."""
    label_img = util.as_tensor(label_img)
    if label_img.dtype == torch.bool:
        label_img = label_img.to(torch.uint8)
    dtype = label_img.dtype
    labels, _ = _ordered(label_img)

    def value(v):  # ``v`` as a value of ``labels``
        return _ordered(torch.tensor(v, dtype=dtype))[0].to(labels.device)

    ndim = labels.ndim
    if mode == "subpixel":
        if labels.is_floating_point():
            labels = labels.to(torch.int32)
            return _find_boundaries_subpixel(labels, 0)
        return _find_boundaries_subpixel(labels, int(value(0)))
    selem = ndi.generate_binary_structure(ndim, connectivity)
    boundaries = dilation(labels, selem) != erosion(labels, selem)
    if mode == "inner":
        boundaries = boundaries & (labels != value(background))
    elif mode == "outer":
        max_label = value(np.iinfo(dtypes.to_numpy(dtype)).max)
        background_image = labels == value(background)
        selem = ndi.generate_binary_structure(ndim, ndim)
        inverted_background = torch.where(background_image, max_label,
                                          labels)
        adjacent_objects = (
            dilation(labels, selem) != erosion(inverted_background, selem)
        ) & ~background_image
        boundaries = boundaries & (background_image | adjacent_objects)
    return boundaries


def mark_boundaries(
    image,
    label_img,
    color=(1, 1, 0),
    outline_color=None,
    mode="outer",
    background_label=0,
    *,
    order=3,
):
    """The image as RGB float with the boundaries of the labelled
    regions in ``color`` (and their dilation in ``outline_color``); in
    subpixel mode the image is first zoomed onto the expanded grid."""
    marked = img_as_float(image, force_copy=True)
    if marked.ndim == 2:
        marked = gray2rgb(marked)
    if mode == "subpixel":
        # each channel zooms as an image of its own: the channel axis is
        # sampled at its knots, where the spline returns its samples, so
        # its prefilter is left out and a float32 channel's prefilter is
        # the fused separable kernel's FIR
        factors = [2 - 1 / s for s in marked.shape[:-1]]
        marked = torch.stack([
            ndi.zoom(marked[..., c], factors, mode="reflect", order=order)
            for c in range(marked.shape[-1])], dim=-1)
    boundaries = find_boundaries(label_img, mode=mode,
                                 background=background_label)
    boundaries = boundaries.to(marked.device)
    if outline_color is not None:
        outlines = dilation(boundaries, np.asarray(square(3))).to(torch.bool)
        marked = torch.where(
            outlines[..., None],
            torch.tensor(outline_color, dtype=marked.dtype,
                         device=marked.device),
            marked,
        )
    color = torch.tensor(color, dtype=marked.dtype, device=marked.device)
    return torch.where(boundaries[..., None], color, marked)
