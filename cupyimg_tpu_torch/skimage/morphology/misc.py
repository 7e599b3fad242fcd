"""Miscellaneous morphology functions (skimage.morphology.misc): the
``default_selem`` decorator, and ``remove_small_objects`` /
``remove_small_holes`` built on ``scipy.ndimage.label`` and
``torch.bincount``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.utils import warn
from cupyimg_tpu_torch.skimage.morphology.selem import _default_selem

__all__ = ["remove_small_objects", "remove_small_holes", "default_selem"]


def default_selem(func):
    """Decorator giving ``func`` a connectivity-1 default structuring
    element."""

    @functools.wraps(func)
    def func_out(image, selem=None, *args, **kwargs):
        if selem is None:
            selem = _default_selem(np.ndim(image))
        return func(image, selem=selem, *args, **kwargs)

    return func_out


def _check_dtype_supported(ar):
    if ar.is_floating_point() or ar.is_complex():
        raise TypeError(
            "Only bool or integer image types are supported. "
            "Got %s." % ar.dtype
        )


def remove_small_objects(ar, min_size=64, connectivity=1, in_place=False):
    """Remove connected components smaller than ``min_size`` pixels
    (skimage.morphology.remove_small_objects): a bool image is labeled
    first; an integer image is taken as labels."""
    ar = util.as_tensor(ar)
    _check_dtype_supported(ar)
    if in_place:
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: in_place is not supported"
        )
    if min_size == 0:  # shortcut for efficiency
        return ar
    if ar.dtype == torch.bool:
        selem = ndi.generate_binary_structure(ar.ndim, connectivity)
        ccs, _ = ndi.label(ar, selem)
    else:
        ccs = ar
    if bool((ccs < 0).any()):
        raise ValueError(
            "Negative value labels are not supported. Try "
            "relabeling the input with `scipy.ndimage.label` or "
            "`skimage.morphology.label`."
        )
    flat = ccs.reshape(-1).to(torch.int64)
    component_sizes = torch.bincount(flat)
    if component_sizes.numel() == 2 and ar.dtype != torch.bool:
        warn(
            "Only one label was provided to `remove_small_objects`. "
            "Did you mean to use a boolean array?"
        )
    too_small = (component_sizes < min_size)[flat].reshape(ar.shape)
    return torch.where(too_small, torch.zeros((), dtype=ar.dtype,
                                              device=ar.device), ar)


def remove_small_holes(ar, area_threshold=64, connectivity=1, in_place=False):
    """Fill contiguous holes smaller than ``area_threshold`` pixels
    (skimage.morphology.remove_small_holes): the complement's small
    objects removed."""
    ar = util.as_tensor(ar)
    _check_dtype_supported(ar)
    if in_place:
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: in_place is not supported"
        )
    if ar.dtype != torch.bool:
        warn(
            "Any labeled images will be returned as a boolean array. "
            "Did you mean to use a boolean array?",
            UserWarning,
        )
    out = remove_small_objects(torch.logical_not(ar), area_threshold,
                               connectivity)
    return torch.logical_not(out)
