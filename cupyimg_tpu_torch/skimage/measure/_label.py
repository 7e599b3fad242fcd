"""skimage.measure.label on torch tensors: ``scipy.ndimage.label`` in
greyscale mode, where neighbours connect only when their values are
equal."""

from __future__ import annotations

import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi

__all__ = ["label"]


def _get_structure(ndim, connectivity):
    if connectivity is None:
        connectivity = ndim
    if not 1 <= connectivity <= ndim:
        raise ValueError(
            "Connectivity below 1 or above %d is illegal." % ndim
        )
    return ndi.generate_binary_structure(ndim, connectivity)


def label(input, background=None, return_num=False, connectivity=None):
    """Label connected regions of an integer array (skimage parity): two
    pixels connect when they are neighbours and hold the same value;
    ``background`` pixels (0 by default) get label 0."""
    input = util.as_tensor(input)
    structure = _get_structure(input.ndim, connectivity)
    if background is not None and background != 0:
        # shifted so that the background becomes 0, as ndi.label expects
        input = input - background
    if input.is_floating_point() or input.is_complex():
        # skimage copies a non-integer input into an intp array
        input = input.to(torch.int64)
    labels, num = ndi.label(input, structure, greyscale_mode=True)
    if return_num:
        return labels, int(num)
    return labels
