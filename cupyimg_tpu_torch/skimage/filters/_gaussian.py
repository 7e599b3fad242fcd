"""The gaussian and difference-of-gaussians filters (skimage.filters) on
torch tensors.

The image is converted by ``convert_to_float`` (float32 stays float32),
then ``ndi.gaussian_filter``: on the card a float32 2-D/3-D image is one
launch of the fused separable kernel; float64 images take plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.utils import convert_to_float, warn

__all__ = ["gaussian", "difference_of_gaussians"]


def _guess_spatial_dimensions(image):
    """2 for a 2-D image, 3 for a volume or a 4-D RGB stack, None for the
    ambiguous (M, N, 3)."""
    if image.ndim == 2:
        return 2
    if image.ndim == 3 and image.shape[-1] != 3:
        return 3
    if image.ndim == 3 and image.shape[-1] == 3:
        return None
    if image.ndim == 4 and image.shape[-1] == 3:
        return 3
    raise ValueError("Expected 2D, 3D, or 4D array, got %iD." % image.ndim)


def gaussian(image, sigma=1, output=None, mode="nearest", cval=0,
             multichannel=None, preserve_range=False, truncate=4.0):
    """Multi-dimensional gaussian filter of the image converted to float;
    a channel axis (``multichannel``, guessed with a warning for
    (M, N, 3|4)) gets sigma 0.  ``output`` may be a float dtype, not an
    array."""
    image = util.as_tensor(image)
    spatial_dims = image.ndim
    if image.ndim == 3 and image.shape[-1] in (3, 4):
        if multichannel is None:
            warn("Images with dimensions (M, N, 3) are interpreted as 2D+RGB "
                 "by default. Use `multichannel=False` to interpret as "
                 "3D image with last dimension of length 3.")
            multichannel = True
    if multichannel:
        spatial_dims = image.ndim - 1
    if np.isscalar(sigma):
        sigma = [sigma] * spatial_dims
    sigma = list(sigma)
    if len(sigma) != image.ndim:
        sigma = sigma + [0] * (image.ndim - len(sigma))
    if any(s < 0 for s in sigma):
        raise ValueError("Sigma values less than zero are not valid")
    image = convert_to_float(image, preserve_range)
    if output is not None and not isinstance(
            output, (str, np.dtype, type, torch.dtype)):
        if dtypes.to_numpy(getattr(output, "dtype", np.float64)).kind not in (
                "fc"):
            raise ValueError("Provided output data type is not float")
        raise ValueError("preallocated output arrays are not supported "
                         "(pass a dtype instead)")
    return ndi.gaussian_filter(image, sigma, output=output, mode=mode,
                               cval=cval, truncate=truncate)


def difference_of_gaussians(image, low_sigma, high_sigma=None, *,
                            mode="nearest", cval=0, multichannel=False,
                            truncate=4.0):
    """Band-pass filter: the gaussian of ``low_sigma`` less the gaussian
    of ``high_sigma`` (default 1.6 * ``low_sigma``)."""
    image = util.as_tensor(image)
    low_sigma = np.array(low_sigma, dtype="float", ndmin=1)
    if high_sigma is None:
        high_sigma = low_sigma * 1.6
    else:
        high_sigma = np.array(high_sigma, dtype="float", ndmin=1)
    spatial_dims = image.ndim - 1 if multichannel else image.ndim
    if len(low_sigma) != 1 and len(low_sigma) != spatial_dims:
        raise ValueError("low_sigma must have length equal to number of "
                         "spatial dimensions of input")
    if len(high_sigma) != 1 and len(high_sigma) != spatial_dims:
        raise ValueError("high_sigma must have length equal to number of "
                         "spatial dimensions of input")
    low_sigma = low_sigma * np.ones(spatial_dims)
    high_sigma = high_sigma * np.ones(spatial_dims)
    if any(high_sigma < low_sigma):
        raise ValueError("high_sigma must be equal to or larger than "
                         "low_sigma for all axes")
    im1 = gaussian(image, low_sigma, mode=mode, cval=cval,
                   multichannel=multichannel, truncate=truncate,
                   preserve_range=False)
    im2 = gaussian(image, high_sigma, mode=mode, cval=cval,
                   multichannel=multichannel, truncate=truncate,
                   preserve_range=False)
    return im1 - im2
