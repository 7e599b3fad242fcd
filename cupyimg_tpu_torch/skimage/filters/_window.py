"""N-d windows (skimage.filters.window) on torch tensors: a 1-d
``scipy.signal.get_window`` profile made on the host, sampled at each
point's distance from the centre by ``map_coordinates`` (float64 data,
float32 coordinates: one launch of the spline gather's map entry on the
card)."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.scipy.ndimage import map_coordinates
from cupyimg_tpu_torch.skimage._shared.utils import safe_as_int

__all__ = ["window"]


def window(window_type, shape, warp_kwargs=None, *, device=None):
    """An n-d window of ``shape`` on ``device`` (default
    ``config.device``): the 1-d window of the longest axis rotated about
    the centre.  Each axis' coordinates are ``arange(s) * (max_size / s)``
    about ``max_size / 2 - 0.5``, so anisotropic axes keep matching
    profiles.  ``warp_kwargs`` may set the interpolation's ``order``,
    ``mode``, ``cval`` and ``prefilter``."""
    from scipy.signal import get_window

    if np.isscalar(shape):
        shape = (int(safe_as_int(shape)),)
    else:
        shape = tuple(int(v) for v in np.atleast_1d(safe_as_int(shape)))
    if any(s < 0 for s in shape):
        raise ValueError("invalid shape")
    ndim = len(shape)
    if ndim <= 0:
        raise ValueError("Number of dimensions must be greater than zero")
    if warp_kwargs is None:
        warp_kwargs = {}
    unknown = set(warp_kwargs) - {"order", "mode", "cval", "prefilter"}
    if unknown:
        raise TypeError("window() got unsupported warp_kwargs keys: "
                        + ", ".join(sorted(unknown)))
    device = torch.device(config.device if device is None else device)

    max_size = max(shape)
    w = util.as_tensor(get_window(window_type, max_size, fftbins=False),
                       device=device)
    center = max_size / 2 - 0.5
    dist2 = None
    for axis, s in enumerate(shape):
        g = (torch.arange(s, dtype=torch.float32, device=device)
             * (max_size / s) - center)
        g = g.reshape([-1 if i == axis else 1 for i in range(ndim)])
        d = g * g
        dist2 = d if dist2 is None else dist2 + d
    coords = torch.sqrt(dist2) + center
    return map_coordinates(
        w, coords[None], order=int(warp_kwargs.get("order", 1)),
        mode=warp_kwargs.get("mode", "constant"),
        cval=warp_kwargs.get("cval", 0.0),
        prefilter=warp_kwargs.get("prefilter", True))
