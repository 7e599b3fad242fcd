"""``approximate_polygon`` and ``subdivide_polygon`` (skimage.measure) on
torch tensors.

A polygonal chain is small host data, and Douglas-Peucker is a
sequential recursion: it runs in numpy on the host (skimage drives the
same stack loop).  B-spline subdivision is two 1-D convolutions with the
port's ``scipy.signal.convolve2d``.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import signal

__all__ = ["approximate_polygon", "subdivide_polygon"]


def approximate_polygon(coords, tolerance):
    """Douglas-Peucker approximation of a polygonal chain ``(N, 2)``
    within ``tolerance``: a tensor on the input's device for a tensor,
    else a numpy array; the input itself for ``tolerance <= 0``."""
    coords_in = coords
    if isinstance(coords, torch.Tensor):
        coords = coords.detach().cpu().numpy()
    coords = np.asarray(coords)
    if tolerance <= 0:
        return coords_in

    chain = np.zeros(coords.shape[0], bool)
    dists = np.zeros(coords.shape[0])
    chain[0] = True
    chain[-1] = True
    pos_stack = [(0, chain.shape[0] - 1)]

    while pos_stack:
        start, end = pos_stack.pop()
        r0, c0 = coords[start, :]
        r1, c1 = coords[end, :]
        dr = r1 - r0
        dc = c1 - c0
        segment_angle = -np.arctan2(dr, dc)
        segment_dist = c0 * np.sin(segment_angle) + r0 * np.cos(
            segment_angle
        )

        segment_coords = coords[start + 1 : end, :]
        segment_dists = dists[start + 1 : end]

        dr0 = segment_coords[:, 0] - r0
        dc0 = segment_coords[:, 1] - c0
        dr1 = segment_coords[:, 0] - r1
        dc1 = segment_coords[:, 1] - c1
        projected_lengths0 = dr0 * dr + dc0 * dc
        projected_lengths1 = -dr1 * dr - dc1 * dc
        perp = np.logical_and(
            projected_lengths0 > 0, projected_lengths1 > 0
        )
        eucl = np.logical_not(perp)

        tmp = segment_coords[perp]
        segment_dists[perp] = np.abs(
            tmp[:, 0] * np.cos(segment_angle)
            + tmp[:, 1] * np.sin(segment_angle)
            - segment_dist
        )
        segment_dists[eucl] = np.minimum(
            np.sqrt(dc0[eucl] ** 2 + dr0[eucl] ** 2),
            np.sqrt(dc1[eucl] ** 2 + dr1[eucl] ** 2),
        )

        if np.any(segment_dists > tolerance):
            new_end = start + int(np.argmax(segment_dists)) + 1
            pos_stack.append((new_end, end))
            pos_stack.append((start, new_end))
            chain[new_end] = True

    out = coords[chain, :]
    if isinstance(coords_in, torch.Tensor):
        return torch.as_tensor(out, device=coords_in.device)
    return out


# B-spline subdivision masks from the (degree + 2)th row of Pascal's
# triangle
_SUBDIVISION_MASKS = {
    # degree: (mask_even, mask_odd)
    1: ([1, 1], [1, 1]),
    2: ([3, 1], [1, 3]),
    3: ([1, 6, 1], [0, 4, 4]),
    4: ([5, 10, 1], [1, 10, 5]),
    5: ([1, 15, 15, 1], [0, 6, 20, 6]),
    6: ([7, 35, 21, 1], [1, 21, 35, 7]),
    7: ([1, 28, 70, 28, 1], [0, 8, 56, 56, 8]),
}


def subdivide_polygon(coords, degree=2, preserve_ends=False):
    """B-spline subdivision of a polygonal curve ``(N, 2)`` (float64); a
    closed curve (first point equal to the last) is wrapped."""
    if degree not in _SUBDIVISION_MASKS:
        raise ValueError(
            "Invalid B-Spline degree. Only degree 1 - 7 is supported."
        )
    coords = util.as_tensor(coords).to(torch.float64)

    circular = bool(torch.all(coords[0, :] == coords[-1, :]))

    method = "valid"
    if circular:
        # the last point repeats the first: drop it and wrap
        coords = coords[:-1, :]
        method = "same"

    mask_even, mask_odd = _SUBDIVISION_MASKS[degree]
    mask_even = np.array([mask_even], dtype=np.float64) / (2**degree)
    mask_odd = np.array([mask_odd], dtype=np.float64) / (2**degree)

    even = signal.convolve2d(coords.T, mask_even, mode=method,
                             boundary="wrap")
    odd = signal.convolve2d(coords.T, mask_odd, mode=method,
                            boundary="wrap")

    out = torch.empty((even.shape[1] + odd.shape[1], 2),
                      dtype=torch.float64, device=coords.device)
    out[1::2] = even.T
    out[::2] = odd.T

    if circular:
        out = torch.cat([out, out[0:1, :]])

    if preserve_ends and not circular:
        out = torch.cat([coords[0:1, :], out, coords[-1:, :]])

    return out
