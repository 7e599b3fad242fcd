"""Image moments (skimage.measure) on torch tensors, in float64.

``moments_central`` contracts the image with one Vandermonde matrix per
axis (``calc @ powers_of_delta``, float64: no TF32); the Hu moments are
the closed-form invariants; the inertia tensor and its eigenvalues are
assembled on the host from the small moment table, as skimage does."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

__all__ = [
    "moments",
    "moments_central",
    "moments_coords",
    "moments_coords_central",
    "moments_normalized",
    "moments_hu",
    "centroid",
    "inertia_tensor",
    "inertia_tensor_eigvals",
]

_F64 = torch.float64


def _eye_index(ndim, device):
    """The index tuple that picks the first-order entries ``M[1, 0, ..]``,
    ``M[0, 1, ..]``, ... of a moment table."""
    eye = torch.eye(ndim, dtype=torch.int64, device=device)
    return tuple(eye[i] for i in range(ndim))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def moments_coords(coords, order=3):
    """Raw moments of a point cloud ``(N, D)``, up to ``order``."""
    return moments_coords_central(coords, 0, order=order)


def moments_coords_central(coords, center=None, order=3):
    """Central moments of a point cloud ``(N, D)`` (or a tuple of D
    coordinate arrays), up to ``order``: a float64 table of shape
    ``(order + 1,) * D``."""
    if isinstance(coords, tuple):
        coords = torch.stack([util.as_tensor(c) for c in coords], dim=-1)
    coords = util.as_tensor(coords)
    if coords.ndim != 2:
        raise ValueError("coords must be a (N, D) array of points")
    ndim = coords.shape[1]
    coords = coords.to(_F64)
    if center is None:
        center = coords.mean(dim=0)
    else:
        center = util.as_tensor(center, device=coords.device).to(_F64)
    # (D, order + 1, N): each axis' coordinates raised to 0..order
    powers = torch.arange(order + 1, device=coords.device)
    p = (coords - center).T[:, None, :] ** powers[None, :, None]
    calc = p[0]
    for axis in range(1, ndim):
        calc = calc.unsqueeze(-2) * p[axis]
    return calc.sum(dim=-1)


def moments(image, order=3):
    """Raw image moments up to ``order`` (float64)."""
    image = util.as_tensor(image)
    return moments_central(image, (0,) * image.ndim, order=order)


def moments_central(image, center=None, order=3, **kwargs):
    """Central image moments up to ``order``: the image (float64)
    contracted along each axis with the powers of its distances to
    ``center`` (default: the centroid)."""
    image = util.as_tensor(image)
    if center is None:
        center = centroid(image)
    center = util.as_tensor(center, device=image.device).to(_F64)
    calc = image.to(_F64)
    powers = torch.arange(order + 1, device=image.device)
    for dim, dim_length in enumerate(image.shape):
        delta = torch.arange(dim_length, dtype=_F64,
                             device=image.device) - center[dim]
        powers_of_delta = delta[:, None] ** powers
        calc = torch.movedim(calc, dim, -1)
        calc = torch.matmul(calc, powers_of_delta)
        calc = torch.movedim(calc, -1, dim)
    return calc


def moments_normalized(mu, order=3):
    """Normalized central moments ``nu_ij = mu_ij / mu00^((i + j) / ndim
    + 1)``; NaN below total order 2, 0 outside the ``(order + 1)^ndim``
    hypercube."""
    mu = util.as_tensor(mu)
    if any(s <= order for s in mu.shape):
        raise ValueError("Shape of image moments must be >= `order`")
    mu0 = mu.reshape(-1)[0]
    ndim = mu.ndim
    grids = torch.meshgrid(
        *[torch.arange(s, device=mu.device) for s in mu.shape],
        indexing="ij")
    total = sum(grids)
    in_domain = sum((g <= order).to(torch.int64) for g in grids) == ndim
    nu = mu / mu0 ** (total.to(_F64) / ndim + 1)
    nu = torch.where(total < 2, torch.nan, nu)
    return torch.where(in_domain, nu, 0.0)


def moments_hu(nu):
    """Hu's seven invariant moments of a 2-D normalized moment table
    (the closed-form invariants, Hu 1962)."""
    nu = util.as_tensor(nu)
    if nu.ndim != 2:
        raise ValueError("moments_hu only implemented for 2D images")
    t0 = nu[3, 0] + nu[1, 2]
    t1 = nu[2, 1] + nu[0, 3]
    q0 = t0 * t0
    q1 = t1 * t1
    n4 = 4 * nu[1, 1]
    s = nu[2, 0] + nu[0, 2]
    d = nu[2, 0] - nu[0, 2]
    hu0 = s
    hu1 = d * d + n4 * nu[1, 1]
    hu3 = q0 + q1
    hu5 = d * (q0 - q1) + n4 * t0 * t1
    t0 = t0 * (q0 - 3 * q1)
    t1 = t1 * (3 * q0 - q1)
    q0 = nu[3, 0] - 3 * nu[1, 2]
    q1 = 3 * nu[2, 1] - nu[0, 3]
    hu2 = q0 * q0 + q1 * q1
    hu4 = q0 * t0 + q1 * t1
    hu6 = q1 * t0 - q0 * t1
    return torch.stack([hu0, hu1, hu2, hu3, hu4, hu5, hu6])


def centroid(image):
    """The (intensity-weighted) centroid of an image, float64."""
    image = util.as_tensor(image)
    M = moments_central(image, center=(0,) * image.ndim, order=1)
    return M[_eye_index(image.ndim, M.device)] / M[(0,) * image.ndim]


def inertia_tensor(image, mu=None):
    """The ``ndim x ndim`` inertia tensor of the image, assembled on the
    host from the central moments of order 2."""
    image = util.as_tensor(image)
    if mu is None:
        mu = moments_central(image, order=2)
    device = mu.device if isinstance(mu, torch.Tensor) else image.device
    mu = _host(mu)
    mu0 = mu[(0,) * image.ndim]
    corners2 = tuple(2 * np.eye(image.ndim, dtype=int))
    result = np.diag((np.sum(mu[corners2]) - mu[corners2]) / mu0)
    for dims in itertools.combinations(range(image.ndim), 2):
        mu_index = np.zeros(image.ndim, dtype=int)
        mu_index[list(dims)] = 1
        result[dims] = -mu[tuple(mu_index)] / mu0
        result.T[dims] = -mu[tuple(mu_index)] / mu0
    return torch.as_tensor(result, device=device)


def inertia_tensor_eigvals(image, mu=None, T=None):
    """Eigenvalues of the inertia tensor in descending order, negative
    round-off clipped to 0."""
    if T is None:
        T = inertia_tensor(image, mu)
    device = T.device if isinstance(T, torch.Tensor) else None
    eigvals = np.clip(np.linalg.eigvalsh(_host(T)), 0, None)
    return torch.as_tensor(np.sort(eigvals)[::-1].copy(), dtype=_F64,
                           device=device)
