"""The Canny edge detector (skimage.feature.canny) on torch tensors.

The image's gaussian is ``filters.gaussian`` (a float32 image: one
launch of the fused separable kernel on the card); the mask's, its
quotient and the sobels compute in float64 (the mask is float64, as
skimage's ``mask.astype(float)``) and take plain torch.  The non-maximum
suppression is dense: each of the four direction sectors interpolates
the shifted magnitudes over the whole image and selects, a later sector
overriding an earlier one where they overlap, as skimage's masked
assignments in order do.  Hysteresis labels the low mask and keeps the
components that hold a high pixel (one ``bincount``).
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch import numpy as tnp
from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.utils import check_nD
from cupyimg_tpu_torch.skimage.filters._gaussian import gaussian
from cupyimg_tpu_torch.skimage.util.dtype import dtype_limits, img_as_float

__all__ = ["canny"]

_F64 = torch.float64


def smooth_with_function_and_mask(image, function, mask):
    """``function`` of the masked image, divided by ``function`` of the
    float64 mask (the bleed-over of the zeros outside it)."""
    image = util.as_tensor(image)
    mask = util.as_tensor(mask, device=image.device).to(torch.bool)
    bleed_over = function(mask.to(_F64))
    masked_image = torch.where(mask, image, 0)
    smoothed_image = function(masked_image)
    return smoothed_image / (bleed_over + np.finfo(np.float64).eps)


def _shift(a, di, dj):
    """``a`` shifted so that out[i, j] = a[i + di, j + dj], zero outside."""
    out = torch.zeros_like(a)
    n0, n1 = a.shape
    out[max(-di, 0):n0 - max(di, 0), max(-dj, 0):n1 - max(dj, 0)] = a[
        max(di, 0):n0 - max(-di, 0), max(dj, 0):n1 - max(-dj, 0)]
    return out


def canny(image, sigma=1.0, low_threshold=None, high_threshold=None,
          mask=None, use_quantiles=False):
    """Canny's edges of a 2-D image (a bool tensor): gaussian smoothing
    within the mask, sobel gradients, non-maximum suppression along the
    gradient and hysteresis between ``low_threshold`` (default 0.1) and
    ``high_threshold`` (default 0.2), given in the image's dtype range or,
    with ``use_quantiles``, as quantiles of the gradient magnitude."""
    image = util.as_tensor(image)
    check_nD(image, 2)
    dtype_max = dtype_limits(image, clip_negative=False)[1]

    if low_threshold is None:
        low_threshold = 0.1
    elif use_quantiles:
        if not (0.0 <= low_threshold <= 1.0):
            raise ValueError("Quantile thresholds must be between 0 and 1.")
    else:
        low_threshold = low_threshold / dtype_max
    if high_threshold is None:
        high_threshold = 0.2
    elif use_quantiles:
        if not (0.0 <= high_threshold <= 1.0):
            raise ValueError("Quantile thresholds must be between 0 and 1.")
    else:
        high_threshold = high_threshold / dtype_max

    if mask is None:
        mask = torch.ones(image.shape, dtype=torch.bool, device=image.device)
    else:
        mask = util.as_tensor(mask, device=image.device).to(torch.bool)

    def fsmooth(x):
        return img_as_float(gaussian(x, sigma, mode="constant"))

    smoothed = smooth_with_function_and_mask(image, fsmooth, mask)
    jsobel = ndi.sobel(smoothed, axis=1)
    isobel = ndi.sobel(smoothed, axis=0)
    abs_isobel = torch.abs(isobel)
    abs_jsobel = torch.abs(jsobel)
    magnitude = torch.hypot(isobel, jsobel)

    # erode the mask: border gradients are infected by the unknown
    s = ndi.generate_binary_structure(2, 2)
    eroded_mask = ndi.binary_erosion(mask, s, border_value=0)
    eroded_mask = eroded_mask & (magnitude > 0)

    # the interpolation weights (the denominator is not zero inside the
    # eroded mask, where the magnitude is positive; guarded all the same)
    w_ij = torch.where(abs_isobel == 0, 0.0, abs_jsobel / torch.where(
        abs_isobel == 0, 1.0, abs_isobel))
    w_ji = torch.where(abs_jsobel == 0, 0.0, abs_isobel / torch.where(
        abs_jsobel == 0, 1.0, abs_jsobel))

    def interp_le(c2, c1, w):
        return c2 * w + c1 * (1 - w) <= magnitude

    m = {(di, dj): _shift(magnitude, di, dj)
         for di in (-1, 0, 1) for dj in (-1, 0, 1)}
    same_sign = ((isobel >= 0) & (jsobel >= 0)) | (
        (isobel <= 0) & (jsobel <= 0))
    opp_sign = ((isobel <= 0) & (jsobel >= 0)) | (
        (isobel >= 0) & (jsobel <= 0))

    # the sectors in skimage's order; where they overlap, the last wins
    sectors = [
        # 0-45 degrees: horizontal and diagonal
        (eroded_mask & same_sign & (abs_isobel >= abs_jsobel),
         interp_le(m[(1, 1)], m[(1, 0)], w_ij)
         & interp_le(m[(-1, -1)], m[(-1, 0)], w_ij)),
        # 45-90 degrees: diagonal and vertical
        (eroded_mask & same_sign & (abs_isobel <= abs_jsobel),
         interp_le(m[(1, 1)], m[(0, 1)], w_ji)
         & interp_le(m[(-1, -1)], m[(0, -1)], w_ji)),
        # 90-135 degrees: anti-diagonal and vertical
        (eroded_mask & opp_sign & (abs_isobel <= abs_jsobel),
         interp_le(m[(-1, 1)], m[(0, 1)], w_ji)
         & interp_le(m[(1, -1)], m[(0, -1)], w_ji)),
        # 135-180 degrees: anti-diagonal and anti-horizontal
        (eroded_mask & opp_sign & (abs_isobel >= abs_jsobel),
         interp_le(m[(-1, 1)], m[(-1, 0)], w_ij)
         & interp_le(m[(1, -1)], m[(1, 0)], w_ij)),
    ]
    local_maxima = torch.zeros(image.shape, dtype=torch.bool,
                               device=image.device)
    for pts, val in sectors:
        local_maxima = torch.where(pts, val, local_maxima)

    if use_quantiles:
        # numpy's quantile of all the magnitudes (torch.quantile refuses
        # more than 2^24 elements)
        high_threshold = tnp.quantile(magnitude, high_threshold)
        low_threshold = tnp.quantile(magnitude, low_threshold)

    high_mask = local_maxima & (magnitude >= high_threshold)
    low_mask = local_maxima & (magnitude >= low_threshold)

    # hysteresis: keep the low components that hold a high pixel
    labels, count = ndi.label(low_mask, np.ones((3, 3), bool))
    count = int(count)
    if count == 0:
        return low_mask
    labels = labels.long()
    good_label = torch.bincount(labels[high_mask], minlength=count + 1) > 0
    good_label[0] = False
    return good_label[labels]
