"""Gabor filters (skimage.filters.gabor, gabor_kernel) on torch tensors.

The kernel is made on the host and crosses as one complex128 tensor.
The filter is two float64 ``ndi.convolve`` calls (real and imaginary
parts): plain torch on the card, whose dense kernel serves float32 only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi

__all__ = ["gabor_kernel", "gabor"]


def _sigma_prefactor(bandwidth):
    b = bandwidth
    return (1.0 / np.pi * math.sqrt(math.log(2) / 2.0)
            * (2.0 ** b + 1) / (2.0 ** b - 1))


def gabor_kernel(frequency, theta=0, bandwidth=1, sigma_x=None, sigma_y=None,
                 n_stds=3, offset=0, *, device=None):
    """Complex 2-D Gabor kernel (complex128, on ``device``, default
    ``config.device``): a gaussian envelope of ``n_stds`` standard
    deviations times a harmonic of ``frequency`` along ``theta``."""
    if sigma_x is None:
        sigma_x = _sigma_prefactor(bandwidth) / frequency
    if sigma_y is None:
        sigma_y = _sigma_prefactor(bandwidth) / frequency
    x0 = math.ceil(max(abs(n_stds * sigma_x * math.cos(theta)),
                       abs(n_stds * sigma_y * math.sin(theta)), 1))
    y0 = math.ceil(max(abs(n_stds * sigma_y * math.cos(theta)),
                       abs(n_stds * sigma_x * math.sin(theta)), 1))
    y, x = np.mgrid[-y0:y0 + 1, -x0:x0 + 1]
    rotx = x * math.cos(theta) + y * math.sin(theta)
    roty = -x * math.sin(theta) + y * math.cos(theta)
    g = np.exp(-0.5 * (rotx ** 2 / sigma_x ** 2 + roty ** 2 / sigma_y ** 2))
    g /= 2 * np.pi * sigma_x * sigma_y
    phase = 2 * np.pi * frequency * rotx + offset
    kernel = np.empty(g.shape, np.complex128)
    kernel.real = g * np.cos(phase)
    kernel.imag = g * np.sin(phase)
    return util.as_tensor(kernel, device=device)


def gabor(image, frequency, theta=0, bandwidth=1, sigma_x=None, sigma_y=None,
          n_stds=3, offset=0, mode="reflect", cval=0):
    """The real and imaginary responses of the image to
    ``gabor_kernel``, each a float64 convolution."""
    image = util.as_tensor(image)
    g = gabor_kernel(frequency, theta, bandwidth, sigma_x, sigma_y, n_stds,
                     offset, device="cpu").numpy()
    image = image.to(torch.float64)
    filtered_real = ndi.convolve(image, g.real, mode=mode, cval=cval)
    filtered_imag = ndi.convolve(image, g.imag, mode=mode, cval=cval)
    return filtered_real, filtered_imag
