"""``euler_number``, ``perimeter`` and ``perimeter_crofton``
(skimage.measure) on torch tensors.

Each is a histogram of configuration codes: one integer
``ndi.convolve`` of the binary image with a small code stencil, one
``bincount`` of fixed length and a dot product with the configurations'
contributions (Ohser, Nagel and Schladitz's tables).  The convolution
stays in integers (the dense kernel takes float32 only; the codes must
stay exact), so it takes the plain correlation on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy import ndimage as ndi

__all__ = ["euler_number", "perimeter", "perimeter_crofton"]

STREL_4 = np.array(
    [[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=np.uint8
)
STREL_8 = np.ones((3, 3), dtype=np.uint8)

# Ohser/Nagel/Schladitz configuration contributions (skimage's tables)
EULER_COEFS2D_4 = [0, 1, 0, 0, 0, 0, 0, -1, 0, 1, 0, 0, 0, 0, 0, 0]
EULER_COEFS2D_8 = [0, 0, 0, 0, 0, 0, -1, 0, 1, 0, 0, 0, 0, 0, -1, 0]
# fmt: off
EULER_COEFS3D_26 = np.array([0, 1, 1, 0, 1, 0, -2, -1,
                            1, -2, 0, -1, 0, -1, -1, 0,
                            1, 0, -2, -1, -2, -1, -1, -2,
                            -6, -3, -3, -2, -3, -2, 0, -1,
                            1, -2, 0, -1, -6, -3, -3, -2,
                            -2, -1, -1, -2, -3, 0, -2, -1,
                            0, -1, -1, 0, -3, -2, 0, -1,
                            -3, 0, -2, -1, 0, 1, 1, 0,
                            1, -2, -6, -3, 0, -1, -3, -2,
                            -2, -1, -3, 0, -1, -2, -2, -1,
                            0, -1, -3, -2, -1, 0, 0, -1,
                            -3, 0, 0, 1, -2, -1, 1, 0,
                            -2, -1, -3, 0, -3, 0, 0, 1,
                            -1, 4, 0, 3, 0, 3, 1, 2,
                            -1, -2, -2, -1, -2, -1, 1,
                            0, 0, 3, 1, 2, 1, 2, 2, 1,
                            1, -6, -2, -3, -2, -3, -1, 0,
                            0, -3, -1, -2, -1, -2, -2, -1,
                            -2, -3, -1, 0, -1, 0, 4, 3,
                            -3, 0, 0, 1, 0, 1, 3, 2,
                            0, -3, -1, -2, -3, 0, 0, 1,
                            -1, 0, 0, -1, -2, 1, -1, 0,
                            -1, -2, -2, -1, 0, 1, 3, 2,
                            -2, 1, -1, 0, 1, 2, 2, 1,
                            0, -3, -3, 0, -1, -2, 0, 1,
                            -1, 0, -2, 1, 0, -1, -1, 0,
                            -1, -2, 0, 1, -2, -1, 3, 2,
                            -2, 1, 1, 2, -1, 0, 2, 1,
                            -1, 0, -2, 1, -2, 1, 1, 2,
                            -2, 3, -1, 2, -1, 2, 0, 1,
                            0, -1, -1, 0, -1, 0, 2, 1,
                            -1, 2, 0, 1, 0, 1, 1, 0, ])
# fmt: on


def _code_histogram(image, config, bins):
    """The histogram of the configuration codes of ``image`` (int32) under
    the code stencil ``config``."""
    codes = ndi.convolve(image, config, mode="constant", cval=0)
    return torch.bincount(codes.reshape(-1), minlength=bins)


def _dot(coefs, hist):
    """``coefs @ hist`` in float64 on the histogram's device."""
    coefs = torch.as_tensor(np.asarray(coefs, dtype=np.float64),
                            device=hist.device)
    return torch.dot(coefs, hist.to(torch.float64))


def euler_number(image, connectivity=None):
    """Euler characteristic of the set of non-zero pixels of a 2-D or 3-D
    image (an int)."""
    image = util.as_tensor(image)
    image = (dtypes.widen_unsigned(image) > 0).to(torch.int32)
    image = F.pad(image, (1, 1) * image.ndim, mode="constant", value=0)

    if connectivity is None:
        connectivity = image.ndim

    if image.ndim == 2:
        config = np.array([[0, 0, 0], [0, 1, 4], [0, 2, 8]], np.int32)
        if connectivity == 1:
            coefs = EULER_COEFS2D_4
        else:
            coefs = EULER_COEFS2D_8
        bins = 16
    else:
        if connectivity == 2:
            raise NotImplementedError(
                "For 3D images, Euler number is implemented "
                "for connectivities 1 and 3 only"
            )
        config = np.array([[[0, 0, 0], [0, 0, 0], [0, 0, 0]],
                           [[0, 0, 0], [0, 1, 4], [0, 2, 8]],
                           [[0, 0, 0], [0, 16, 64], [0, 32, 128]]],
                          np.int32)
        if connectivity == 1:
            coefs = EULER_COEFS3D_26[::-1]
        else:
            coefs = EULER_COEFS3D_26
        bins = 256

    value = _dot(coefs, _code_histogram(image, config, bins))
    if image.ndim == 2:
        return int(value)
    return int(0.125 * float(value))


def perimeter(image, neighbourhood=4):
    """Total perimeter of all objects in a 2-D binary image (a 0-d
    float64 tensor)."""
    image = util.as_tensor(image)
    if image.ndim != 2:
        raise NotImplementedError("`perimeter` supports 2D images only")

    if neighbourhood == 4:
        strel = STREL_4
    else:
        strel = STREL_8
    image = image.to(torch.uint8)
    eroded_image = ndi.binary_erosion(image, strel, border_value=0)
    border_image = image.to(torch.int32) - eroded_image.to(torch.int32)

    perimeter_weights = np.zeros(50, dtype=np.float64)
    perimeter_weights[[5, 7, 15, 17, 25, 27]] = 1
    perimeter_weights[[21, 33]] = math.sqrt(2)
    perimeter_weights[[13, 23]] = (1 + math.sqrt(2)) / 2

    hist = _code_histogram(
        border_image,
        np.array([[10, 2, 10], [2, 1, 2], [10, 2, 10]], np.int32), 50)
    return _dot(perimeter_weights, hist)


def perimeter_crofton(image, directions=4):
    """Total Crofton perimeter of all objects in a 2-D image (a 0-d
    float64 tensor)."""
    image = util.as_tensor(image)
    if image.ndim != 2:
        raise NotImplementedError(
            "`perimeter_crofton` supports 2D images only"
        )

    image = (dtypes.widen_unsigned(image) > 0).to(torch.int32)
    image = F.pad(image, (1, 1, 1, 1), mode="constant", value=0)
    hist = _code_histogram(
        image, np.array([[0, 0, 0], [0, 1, 4], [0, 2, 8]], np.int32), 16)

    # fmt: off
    if directions == 2:
        coefs = [0, np.pi / 2, 0, 0, 0, np.pi / 2, 0, 0,
                 np.pi / 2, np.pi, 0, 0, np.pi / 2, np.pi, 0, 0]
    else:
        sq2 = math.sqrt(2)
        coefs = [0, np.pi / 4 * (1 + 1 / sq2),
                 np.pi / (4 * sq2),
                 np.pi / (2 * sq2), 0,
                 np.pi / 4 * (1 + 1 / sq2),
                 0, np.pi / (4 * sq2), np.pi / 4, np.pi / 2,
                 np.pi / (4 * sq2), np.pi / (4 * sq2),
                 np.pi / 4, np.pi / 2, 0, 0]
    # fmt: on
    return _dot(coefs, hist)
