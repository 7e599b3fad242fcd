"""Convex hull of a binary image (skimage.morphology.convex_hull_image).

The hull's facets come from ``scipy.spatial.ConvexHull`` on the host, over
the corners of the foreground pixels (copied with ``.cpu()``); the
half-plane test of every pixel centre against them runs on the image's
device, in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

__all__ = ["convex_hull_image"]


def _offsets_diamond(ndim):
    """+-0.5 offsets along each axis (a pixel's corner extent)."""
    offsets = np.zeros((2 * ndim, ndim))
    for vertex, (axis, offset) in enumerate(
        ((a, o) for a in range(ndim) for o in (-0.5, 0.5))
    ):
        offsets[vertex, axis] = offset
    return offsets


def convex_hull_image(image, offset_coordinates=True, tolerance=1e-10):
    """The smallest convex set holding every foreground pixel, as a bool
    tensor on the image's device (skimage parity)."""
    image = util.as_tensor(image)
    if image.ndim < 2:
        raise ValueError("Input must be at least 2-D")
    fg = image != 0
    coords = torch.nonzero(fg).cpu().numpy()
    if coords.shape[0] == 0:
        return torch.zeros(image.shape, dtype=torch.bool, device=image.device)
    points = coords.astype(float)
    if offset_coordinates:
        points = (points[:, None, :] + _offsets_diamond(image.ndim)).reshape(
            -1, image.ndim)

    from scipy.spatial import ConvexHull, QhullError

    try:
        hull = ConvexHull(points)
    except QhullError:
        # degenerate (all points on one line): the hull is the points
        return fg.clone()
    # facet equations a . x + b <= 0 hold inside
    eq = torch.as_tensor(hull.equations, dtype=torch.float64,
                         device=image.device)
    dots = eq[:, -1].reshape((1,) * image.ndim + (-1,))
    for ax, n in enumerate(image.shape):
        view = [1] * image.ndim + [1]
        view[ax] = n
        coord = torch.arange(n, dtype=torch.float64,
                             device=image.device).reshape(view)
        dots = dots + coord * eq[:, ax]
    return torch.all(dots < tolerance, dim=-1)
