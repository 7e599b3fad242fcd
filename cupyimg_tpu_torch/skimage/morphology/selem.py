"""Structuring-element generators (skimage.morphology.selem).

Selems are tiny host numpy arrays, as skimage returns them: the
morphology functions read footprints on the host.  ``ellipse``,
``octagon`` and ``star`` are built from their half-plane descriptions
(as ``cupyimg_tpu`` builds them), with no skimage ``draw`` or convex
hull.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "square",
    "rectangle",
    "diamond",
    "disk",
    "ellipse",
    "cube",
    "octahedron",
    "ball",
    "octagon",
    "star",
]


def square(width, dtype=np.uint8):
    """Flat, square-shaped structuring element (all ones)."""
    return np.ones((width, width), dtype=dtype)


def rectangle(nrows, ncols, dtype=np.uint8):
    """Flat, rectangular-shaped structuring element (all ones)."""
    return np.ones((nrows, ncols), dtype=dtype)


def diamond(radius, dtype=np.uint8):
    """Flat, diamond-shaped selem: city-block distance <= radius."""
    L = np.arange(0, radius * 2 + 1)
    I, J = np.meshgrid(L, L, sparse=True, indexing="ij")
    return np.asarray(
        np.abs(I - radius) + np.abs(J - radius) <= radius, dtype=dtype
    )


def disk(radius, dtype=np.uint8):
    """Flat, disk-shaped selem: Euclidean distance <= radius."""
    L = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(L, L, sparse=True, indexing="ij")
    return np.asarray((X * X + Y * Y) <= radius * radius, dtype=dtype)


def ellipse(width, height, dtype=np.uint8):
    """Flat, ellipse-shaped selem of shape (2*height+1, 2*width+1): the
    points strictly inside the ellipse centred at (height, width) with
    radii (height+1, width+1), as skimage's ``draw.ellipse`` gives them."""
    r = np.arange(2 * height + 1)[:, None]
    c = np.arange(2 * width + 1)[None, :]
    inside = ((r - height) / (height + 1.0)) ** 2 + (
        (c - width) / (width + 1.0)
    ) ** 2 < 1.0
    return np.asarray(inside, dtype=dtype)


def cube(width, dtype=np.uint8):
    """Cube-shaped (3-D) structuring element (all ones)."""
    return np.ones((width, width, width), dtype=dtype)


def octahedron(radius, dtype=np.uint8):
    """Octahedron-shaped (3-D) selem: city-block distance <= radius."""
    n = 2 * radius + 1
    Z, Y, X = np.ogrid[
        -radius:radius:n * 1j,
        -radius:radius:n * 1j,
        -radius:radius:n * 1j,
    ]
    s = np.abs(X) + np.abs(Y) + np.abs(Z)
    return np.asarray(s <= radius, dtype=dtype)


def ball(radius, dtype=np.uint8):
    """Ball-shaped (3-D) selem: Euclidean distance <= radius."""
    n = 2 * radius + 1
    Z, Y, X = np.ogrid[
        -radius:radius:n * 1j,
        -radius:radius:n * 1j,
        -radius:radius:n * 1j,
    ]
    s = X * X + Y * Y + Z * Z
    return np.asarray(s <= radius * radius, dtype=dtype)


def octagon(m, n, dtype=np.uint8):
    """Octagon-shaped selem: sides of m along the axes, of n at 45
    degrees.  The convex hull of the eight vertices is the square minus
    its four n-deep corner triangles: four half-planes."""
    s = m + 2 * n
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    inside = (
        (i + j >= n)
        & ((s - 1 - i) + j >= n)
        & (i + (s - 1 - j) >= n)
        & ((s - 1 - i) + (s - 1 - j) >= n)
    )
    return np.asarray(inside, dtype=dtype)


def star(a, dtype=np.uint8):
    """Star-shaped selem: a square united with its 45-degree rotation,
    the diamond ``|i - c| + |j - c| <= c`` with ``c = (m + 2n - 1) // 2``."""
    if a == 1:
        return np.ones((3, 3), dtype=dtype)
    m = 2 * a + 1
    n = a // 2
    s = m + 2 * n
    c = (s - 1) // 2
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    axis_square = (i >= n) & (i < m + n) & (j >= n) & (j < m + n)
    diamond_sq = np.abs(i - c) + np.abs(j - c) <= c
    return np.asarray(axis_square | diamond_sq, dtype=dtype)


def _default_selem(ndim):
    """Cross-shaped selem (connectivity 1), the default for morphology."""
    from cupyimg_tpu_torch.scipy.ndimage.morphology import (
        generate_binary_structure,
    )

    return generate_binary_structure(ndim, 1)
