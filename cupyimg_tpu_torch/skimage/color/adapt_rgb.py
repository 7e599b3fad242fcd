"""The ``adapt_rgb`` decorator (skimage.color.adapt_rgb) on torch tensors:
a grey-scale filter applied to an RGB image per channel or to its HSV
value."""

from __future__ import annotations

import functools

import torch

from cupyimg_tpu_torch.skimage.color import colorconv
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float

__all__ = ["adapt_rgb", "hsv_value", "each_channel"]


def is_rgb_like(image):
    return image.ndim == 3 and image.shape[2] in (3, 4)


def adapt_rgb(apply_to_rgb):
    """Decorator adapting a grey-scale filter to RGB images: an image of
    3 or 4 channels goes through ``apply_to_rgb(filter, image, ...)``."""

    def decorator(image_filter):
        @functools.wraps(image_filter)
        def image_filter_adapted(image, *args, **kwargs):
            if is_rgb_like(image):
                return apply_to_rgb(image_filter, image, *args, **kwargs)
            return image_filter(image, *args, **kwargs)

        return image_filter_adapted

    return decorator


def hsv_value(image_filter, image, *args, **kwargs):
    """Apply the filter to the V channel of HSV."""
    hsv = colorconv.rgb2hsv(image[..., :3])
    filtered = image_filter(hsv[..., 2], *args, **kwargs)
    hsv = hsv.clone()
    hsv[..., 2] = img_as_float(filtered)
    return colorconv.hsv2rgb(hsv)


def each_channel(image_filter, image, *args, **kwargs):
    """Apply the filter to each channel independently."""
    channels = [
        image_filter(image[..., c], *args, **kwargs)
        for c in range(image.shape[-1])
    ]
    return torch.stack(channels, dim=-1)
