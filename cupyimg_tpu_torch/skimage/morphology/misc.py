"""Miscellaneous morphology helpers (skimage.morphology.misc): so far the
``default_selem`` decorator.  ``remove_small_objects`` and
``remove_small_holes`` wait for ``scipy.ndimage.label``."""

from __future__ import annotations

import functools

import numpy as np

from cupyimg_tpu_torch.skimage.morphology.selem import _default_selem

__all__ = ["default_selem"]


def default_selem(func):
    """Decorator giving ``func`` a connectivity-1 default structuring
    element."""

    @functools.wraps(func)
    def func_out(image, selem=None, *args, **kwargs):
        if selem is None:
            selem = _default_selem(np.ndim(image))
        return func(image, selem=selem, *args, **kwargs)

    return func_out
