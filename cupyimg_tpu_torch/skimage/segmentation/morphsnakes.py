"""Morphological snakes (skimage.segmentation.morphsnakes) on torch
tensors: MorphACWE (``morphological_chan_vese``) and MorphGAC
(``morphological_geodesic_active_contour``), the level sets and the
``inverse_gaussian_gradient`` border indicator.

Each iteration is plain torch: region means as two sums on the device
(no read back), ``numpy.gradient``, selects, and the curvature operator's
binary erosions and dilations by line structures.  The operator
alternates SIoIS and ISoSI; every call starts at SIoIS, as
``cupyimg_tpu`` does.  ``inverse_gaussian_gradient`` of a float32 image
is ``gaussian_gradient_magnitude``: one fused separable kernel launch an
axis.  The level sets have no input to follow, so they take a
keyword-only ``device``.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.numpy import gradient, quantile
from cupyimg_tpu_torch.scipy import ndimage as ndi

from .._shared.utils import check_nD

__all__ = [
    "morphological_chan_vese",
    "morphological_geodesic_active_contour",
    "inverse_gaussian_gradient",
    "circle_level_set",
    "disk_level_set",
    "checkerboard_level_set",
]


# the SI and IS structuring lines of 2-D and 3-D level sets
_P2 = [
    np.eye(3),
    np.array([[0, 1, 0]] * 3),
    np.flipud(np.eye(3)),
    np.rot90([[0, 1, 0]] * 3),
]
_P3 = [np.zeros((3, 3, 3)) for i in range(9)]

_P3[0][:, :, 1] = 1
_P3[1][:, 1, :] = 1
_P3[2][1, :, :] = 1
_P3[3][:, [0, 1, 2], [0, 1, 2]] = 1
_P3[4][:, [0, 1, 2], [2, 1, 0]] = 1
_P3[5][[0, 1, 2], :, [0, 1, 2]] = 1
_P3[6][[0, 1, 2], :, [2, 1, 0]] = 1
_P3[7][[0, 1, 2], [0, 1, 2], :] = 1
_P3[8][[0, 1, 2], [2, 1, 0], :] = 1


def _get_P(u):
    if u.ndim == 2:
        return _P2
    if u.ndim == 3:
        return _P3
    raise ValueError(
        "u has an invalid number of dimensions (should be 2 or 3)"
    )


def sup_inf(u):
    """SI operator: the union of the erosions by each line."""
    return functools.reduce(torch.logical_or, [
        ndi.binary_erosion(u, P_i) for P_i in _get_P(u)]).to(torch.int8)


def inf_sup(u):
    """IS operator: the intersection of the dilations by each line."""
    return functools.reduce(torch.logical_and, [
        ndi.binary_dilation(u, P_i) for P_i in _get_P(u)]).to(torch.int8)


def _curvop(u, parity):
    """The curvature operator: SIoIS at even parity, ISoSI at odd."""
    if parity == 0:
        return sup_inf(inf_sup(u))
    return inf_sup(sup_inf(u))


def _smooth(u, smoothing, parity):
    """``smoothing`` curvature steps from ``parity``; the next parity."""
    for _ in range(smoothing):
        u = _curvop(u, parity)
        parity = 1 - parity
    return u, parity


def _check_input(image, init_level_set):
    """The image is 2-D or 3-D and the level set has its rank."""
    check_nD(image, [2, 3])
    if len(image.shape) != len(init_level_set.shape):
        raise ValueError(
            "The dimensions of the initial level set do not "
            "match the dimensions of the image."
        )


def _init_level_set(init_level_set, image_shape, device):
    """A level set from a name, or ``init_level_set`` on ``device``."""
    if isinstance(init_level_set, str):
        if init_level_set == "checkerboard":
            return checkerboard_level_set(image_shape, device=device)
        if init_level_set in ("circle", "disk"):
            return disk_level_set(image_shape, device=device)
        raise ValueError(
            "`init_level_set` not in "
            "['checkerboard', 'circle', 'disk']"
        )
    return util.as_tensor(init_level_set, device=device)


def circle_level_set(image_shape, center=None, radius=None, *, device=None):
    """Deprecated alias of :func:`disk_level_set`."""
    warnings.warn(
        "circle_level_set is deprecated in favor of disk_level_set."
        "circle_level_set will be removed in version 0.19",
        FutureWarning,
        stacklevel=2,
    )
    return disk_level_set(image_shape, center=center, radius=radius,
                          device=device)


def _grid(image_shape, dtype, device):
    return torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=dtype, device=device) for n in image_shape],
        indexing="ij"))


def disk_level_set(image_shape, center=None, radius=None, *, device=None):
    """An int8 disk level set (radius 3/8 of the shortest side about the
    centre by default); the distances in float64."""
    if center is None:
        center = tuple(i // 2 for i in image_shape)
    if radius is None:
        radius = min(image_shape) * 3.0 / 8.0
    device = config.device if device is None else device
    grid = _grid(image_shape, torch.float64, device)
    grid = grid - torch.tensor(center, dtype=torch.float64,
                               device=device).reshape(
        (-1,) + (1,) * len(image_shape))
    phi = radius - torch.sqrt(torch.sum(grid * grid, 0))
    return (phi > 0).to(torch.int8)


def checkerboard_level_set(image_shape, square_size=5, *, device=None):
    """An int8 checkerboard level set of squares of ``square_size``."""
    device = config.device if device is None else device
    grid = (_grid(image_shape, torch.int64, device) // square_size) & 1
    return functools.reduce(torch.bitwise_xor, list(grid)).to(torch.int8)


def inverse_gaussian_gradient(image, alpha=100.0, sigma=5.0):
    """1 / sqrt(1 + alpha * |grad(gaussian(image))|): near 0 on the
    borders, near 1 in flat regions."""
    gradnorm = ndi.gaussian_gradient_magnitude(image, sigma, mode="nearest")
    return 1.0 / torch.sqrt(1.0 + alpha * gradnorm)


def morphological_chan_vese(
    image,
    iterations,
    init_level_set="checkerboard",
    smoothing=1,
    lambda1=1,
    lambda2=1,
    iter_callback=lambda x: None,
):
    """Morphological active contours without edges (MorphACWE): the
    final int8 level set."""
    image = util.as_tensor(image)
    init_level_set = _init_level_set(init_level_set, image.shape,
                                     image.device)
    _check_input(image, init_level_set)

    u = (init_level_set > 0).to(torch.int8)
    iter_callback(u)
    parity = 0
    for _ in range(iterations):
        uf = u.to(image.dtype)
        # the region means, on the device
        c0 = (image * (1 - uf)).sum() / ((1 - uf).sum() + 1e-8)
        c1 = (image * uf).sum() / (uf.sum() + 1e-8)

        # image attachment
        abs_du = torch.stack(gradient(uf)).abs().sum(0)
        aux = abs_du * (lambda1 * (image - c1) ** 2
                        - lambda2 * (image - c0) ** 2)
        u = torch.where(aux < 0, 1, u).to(torch.int8)
        u = torch.where(aux > 0, 0, u).to(torch.int8)

        u, parity = _smooth(u, smoothing, parity)
        iter_callback(u)
    return u


def morphological_geodesic_active_contour(
    gimage,
    iterations,
    init_level_set="circle",
    smoothing=1,
    threshold="auto",
    balloon=0,
    iter_callback=lambda x: None,
):
    """Morphological geodesic active contours (MorphGAC) on a border
    indicator such as :func:`inverse_gaussian_gradient`: the final int8
    level set.  ``threshold='auto'`` is the image's 40th percentile (one
    read back)."""
    image = util.as_tensor(gimage)
    init_level_set = _init_level_set(init_level_set, image.shape,
                                     image.device)
    _check_input(image, init_level_set)

    if threshold == "auto":
        threshold = float(quantile(image, 0.4))

    structure = np.ones((3,) * image.ndim, dtype=np.int8)
    dimage = gradient(image)
    if balloon != 0:
        threshold_mask_balloon = image > threshold / np.abs(balloon)

    u = (init_level_set > 0).to(torch.int8)
    iter_callback(u)
    parity = 0
    for _ in range(iterations):
        # balloon force
        if balloon > 0:
            aux = ndi.binary_dilation(u, structure)
        elif balloon < 0:
            aux = ndi.binary_erosion(u, structure)
        if balloon != 0:
            u = torch.where(threshold_mask_balloon, aux.to(torch.int8), u)

        # image attachment
        du = gradient(u.to(image.dtype))
        aux = sum(el1 * el2 for el1, el2 in zip(dimage, du))
        u = torch.where(aux > 0, 1, u).to(torch.int8)
        u = torch.where(aux < 0, 0, u).to(torch.int8)

        u, parity = _smooth(u, smoothing, parity)
        iter_callback(u)
    return u
