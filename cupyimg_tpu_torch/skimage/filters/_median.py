"""The median filter (skimage.filters.median, ndimage behaviour) on torch
tensors: ``ndi.median_filter`` over the footprint.  On the card an
int32 or float32 2-D/3-D image of a 3-64 tap footprint is one launch of
the rank kernel; other dtypes (uint8 among them) take plain torch."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.utils import warn

__all__ = ["median"]


def median(image, selem=None, out=None, mode="nearest", cval=0.0,
           behavior="ndimage"):
    """Local median over ``selem`` (default a 3^ndim box).  Only the
    'ndimage' behaviour exists; 'rank' warns and runs it."""
    if behavior != "ndimage":
        warn("behavior='rank' is not implemented; using 'ndimage'.",
             UserWarning)
    image = util.as_tensor(image)
    if selem is None:
        selem = np.ones((3,) * image.ndim, dtype=bool)
    elif isinstance(selem, torch.Tensor):
        selem = selem.cpu().numpy()
    if out is not None:
        raise NotImplementedError(
            "preallocated output arrays are not supported")
    return ndi.median_filter(image, footprint=np.asarray(selem) != 0,
                             mode=mode, cval=cval)
