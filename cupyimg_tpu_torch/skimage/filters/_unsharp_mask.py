"""Unsharp masking (skimage.filters.unsharp_mask) on torch tensors.

A float32 image stays float32, so on the card its blur is one launch of
the fused separable kernel; ``preserve_range=True`` computes in float64
(plain torch).
"""

from __future__ import annotations

import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.skimage.filters._gaussian import gaussian
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float

__all__ = ["unsharp_mask"]


def _unsharp_mask_single_channel(image, radius, amount):
    blurred = gaussian(image, sigma=radius, mode="nearest",
                       preserve_range=True)
    return image + (image - blurred) * amount


def unsharp_mask(image, radius=1.0, amount=1.0, multichannel=False,
                 preserve_range=False):
    """Sharpen by adding ``amount`` times the difference to the image's
    gaussian blur of sigma ``radius``; clipped to [0, 1] (or [-1, 1] for
    an image with negative values) unless ``preserve_range``."""
    image = util.as_tensor(image)
    fimg = (image.to(torch.float64) if preserve_range
            else img_as_float(image))
    if multichannel:
        out = torch.stack([
            _unsharp_mask_single_channel(fimg[..., c], radius, amount)
            for c in range(image.shape[-1])], dim=-1)
    else:
        out = _unsharp_mask_single_channel(fimg, radius, amount)
    if not preserve_range:
        out = torch.clamp(out, -1.0 if float(fimg.min()) < 0 else 0.0, 1.0)
    return out
