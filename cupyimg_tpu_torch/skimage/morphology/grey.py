"""Grey-scale morphological operations (skimage.morphology.grey) on torch
tensors, on ``scipy.ndimage``'s grey morphology.

An opening or closing with an all-ones selem of odd sides on a float
image goes to ``ndi.grey_opening``/``grey_closing`` with that footprint,
which a CUDA float32 image runs as one two-stage kernel launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage.morphology.misc import default_selem
from cupyimg_tpu_torch.skimage.util import crop

__all__ = [
    "erosion",
    "dilation",
    "opening",
    "closing",
    "white_tophat",
    "black_tophat",
]


def _check_out(out):
    if out is not None:
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: `out` is not supported"
        )


def _host(selem):
    """A selem as a host numpy array."""
    if isinstance(selem, torch.Tensor):
        return selem.cpu().numpy()
    return np.asarray(selem)


def _shift_selem(selem, shift_x, shift_y):
    """Pad an even-sided 2-D selem by one zero row or column, so that its
    centre lands where skimage expects it."""
    if selem.ndim != 2:
        return selem
    m, n = selem.shape
    if m % 2 == 0:
        extra_row = np.zeros((1, n), selem.dtype)
        if shift_x:
            selem = np.vstack((selem, extra_row))
        else:
            selem = np.vstack((extra_row, selem))
        m += 1
    if n % 2 == 0:
        extra_col = np.zeros((m, 1), selem.dtype)
        if shift_y:
            selem = np.hstack((selem, extra_col))
        else:
            selem = np.hstack((extra_col, selem))
    return selem


def _invert_selem(selem):
    """Reverse the selem, cancelling grey_dilation's mirroring."""
    return selem[(slice(None, None, -1),) * selem.ndim]


def pad_for_eccentric_selems(func):
    """Edge-pad the image for an opening or closing with even-sided
    selems, so that the intermediate result is not clipped."""

    @functools.wraps(func)
    def func_out(image, selem, out=None, *args, **kwargs):
        _check_out(out)
        image = util.as_tensor(image)
        pad_widths = []
        padding = False
        for axis_len in np.shape(_host(selem)):
            if axis_len % 2 == 0:
                axis_pad_width = axis_len - 1
                padding = True
            else:
                axis_pad_width = 0
            pad_widths.append((axis_pad_width,) * 2)
        if padding:
            image = boundary.pad(image, pad_widths, "nearest")
        result = func(image, selem, None, *args, **kwargs)
        if padding:
            result = crop(result, pad_widths)
        return result

    return func_out


@default_selem
def erosion(image, selem=None, out=None, shift_x=False, shift_y=False):
    """Grey-scale erosion: the minimum over the selem's neighbourhood."""
    _check_out(out)
    selem = _shift_selem(_host(selem), shift_x, shift_y)
    return ndi.grey_erosion(image, footprint=selem)


@default_selem
def dilation(image, selem=None, out=None, shift_x=False, shift_y=False):
    """Grey-scale dilation: the maximum over the selem's neighbourhood
    (the selem reversed first, cancelling grey_dilation's mirroring)."""
    _check_out(out)
    selem = _invert_selem(_shift_selem(_host(selem), shift_x, shift_y))
    return ndi.grey_dilation(image, footprint=selem)


def _odd_flat_rect(image, selem):
    """Whether the selem is an all-ones rectangle of odd sides over a
    float image: skimage's shift and mirror conventions are the identity
    there, so an opening or closing is ndimage's."""
    return (
        image.is_floating_point()
        and selem.ndim == image.ndim
        and all(s % 2 == 1 for s in selem.shape)
        and bool((selem != 0).all())
    )


@default_selem
@pad_for_eccentric_selems
def opening(image, selem=None, out=None):
    """Grey-scale opening: erosion, then dilation."""
    selem = _host(selem)
    if _odd_flat_rect(image, selem):
        return ndi.grey_opening(image, footprint=selem != 0)
    eroded = erosion(image, selem)
    return dilation(eroded, selem, shift_x=True, shift_y=True)


@default_selem
@pad_for_eccentric_selems
def closing(image, selem=None, out=None):
    """Grey-scale closing: dilation, then erosion."""
    selem = _host(selem)
    if _odd_flat_rect(image, selem):
        return ndi.grey_closing(image, footprint=selem != 0)
    dilated = dilation(image, selem)
    return erosion(dilated, selem, shift_x=True, shift_y=True)


@default_selem
def white_tophat(image, selem=None, out=None):
    """White top hat: the image minus its opening (ndimage's; a bool
    image through uint8)."""
    _check_out(out)
    image = util.as_tensor(image)
    selem = _host(selem)
    if image.dtype == torch.bool:
        result = ndi.white_tophat(image.to(torch.uint8), footprint=selem)
        return result.to(torch.bool)
    return ndi.white_tophat(image, footprint=selem)


@default_selem
def black_tophat(image, selem=None, out=None):
    """Black top hat: the closing minus the image."""
    _check_out(out)
    image = util.as_tensor(image)
    closed = closing(image, selem)
    if image.dtype == torch.bool:
        return closed ^ image
    return closed - image
