"""Image pyramids (skimage.transform.pyramids) on torch tensors: each
level is ``gaussian_filter`` (the fused separable kernel for CUDA
float32 data) and ``resize`` (``zoom`` on the spline gather)."""

from __future__ import annotations

import math

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.utils import convert_to_float
from cupyimg_tpu_torch.skimage.transform._warps import (
    _to_ndimage_mode,
    resize,
)

__all__ = [
    "pyramid_reduce",
    "pyramid_expand",
    "pyramid_gaussian",
    "pyramid_laplacian",
]


def _smooth(image, sigma, mode, cval, multichannel):
    """Gaussian smoothing of every spatial axis (not the channel axis)."""
    sigmas = [sigma] * image.ndim
    if multichannel:
        sigmas[-1] = 0
    return ndi.gaussian_filter(
        image, sigmas, mode=_to_ndimage_mode(mode), cval=cval
    )


def _check_factor(factor):
    if factor <= 1:
        raise ValueError("scale factor must be greater than 1")


def pyramid_reduce(
    image, downscale=2, sigma=None, order=1, mode="reflect", cval=0,
    multichannel=False, preserve_range=False,
):
    """Smooth, then downsample."""
    _check_factor(downscale)
    image = convert_to_float(util.as_tensor(image), preserve_range)
    out_shape = tuple(
        math.ceil(d / float(downscale)) for d in image.shape
    )
    if multichannel:
        out_shape = out_shape[:-1] + (image.shape[-1],)
    if sigma is None:
        sigma = 2 * downscale / 6.0
    smoothed = _smooth(image, sigma, mode, cval, multichannel)
    return resize(
        smoothed, out_shape, order=order, mode=mode, cval=cval,
        anti_aliasing=False,
    )


def pyramid_expand(
    image, upscale=2, sigma=None, order=1, mode="reflect", cval=0,
    multichannel=False, preserve_range=False,
):
    """Upsample, then smooth."""
    _check_factor(upscale)
    image = convert_to_float(util.as_tensor(image), preserve_range)
    out_shape = tuple(
        math.ceil(upscale * d) for d in image.shape
    )
    if multichannel:
        out_shape = out_shape[:-1] + (image.shape[-1],)
    if sigma is None:
        sigma = 2 * upscale / 6.0
    resized = resize(
        image, out_shape, order=order, mode=mode, cval=cval,
        anti_aliasing=False,
    )
    return _smooth(resized, sigma, mode, cval, multichannel)


def pyramid_gaussian(
    image, max_layer=-1, downscale=2, sigma=None, order=1, mode="reflect",
    cval=0, multichannel=False, preserve_range=False,
):
    """Generator of the gaussian pyramid's layers, the image first."""
    _check_factor(downscale)
    layer = 0
    image = util.as_tensor(image)
    current_shape = tuple(image.shape)
    prev_layer_image = convert_to_float(image, preserve_range)
    yield prev_layer_image
    while layer != max_layer:
        layer += 1
        layer_image = pyramid_reduce(
            prev_layer_image, downscale, sigma, order, mode, cval,
            multichannel,
        )
        prev_shape = current_shape
        prev_layer_image = layer_image
        current_shape = tuple(layer_image.shape)
        if current_shape == prev_shape:
            break
        yield layer_image


def pyramid_laplacian(
    image, max_layer=-1, downscale=2, sigma=None, order=1, mode="reflect",
    cval=0, multichannel=False, preserve_range=False,
):
    """Generator of the laplacian pyramid's layers (differences of each
    level and its smoothed copy)."""
    _check_factor(downscale)
    if sigma is None:
        sigma = 2 * downscale / 6.0
    image = util.as_tensor(image)
    current_shape = tuple(image.shape)
    image = convert_to_float(image, preserve_range)
    smoothed = _smooth(image, sigma, mode, cval, multichannel)
    yield image - smoothed
    layer = 0
    while layer != max_layer:
        layer += 1
        out_shape = tuple(
            math.ceil(d / float(downscale)) for d in current_shape
        )
        if multichannel:
            out_shape = out_shape[:-1] + (current_shape[-1],)
        resized = resize(
            smoothed, out_shape, order=order, mode=mode, cval=cval,
            anti_aliasing=False,
        )
        smoothed = _smooth(resized, sigma, mode, cval, multichannel)
        prev_shape = current_shape
        current_shape = tuple(resized.shape)
        if current_shape == prev_shape:
            break
        yield resized - smoothed
