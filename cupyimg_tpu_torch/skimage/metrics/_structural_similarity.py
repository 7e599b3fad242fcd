"""The structural similarity index (skimage.metrics.structural_similarity;
Wang et al. 2004) on torch tensors.  It computes in float64, as skimage
and cupyimg_tpu do: its uniform or gaussian window filters take plain
torch on the card (the fused separable kernel serves float32 only)."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy.ndimage import gaussian_filter, uniform_filter
from cupyimg_tpu_torch.skimage._shared.utils import check_shape_equality, warn
from cupyimg_tpu_torch.skimage.util.arraycrop import crop
from cupyimg_tpu_torch.skimage.util.dtype import dtype_range

__all__ = ["structural_similarity"]


def structural_similarity(
    im1,
    im2,
    *,
    win_size=None,
    gradient=False,
    data_range=None,
    multichannel=False,
    channel_axis=None,
    gaussian_weights=False,
    full=False,
    **kwargs,
):
    """Mean structural similarity of two images (a 0-d float64 tensor);
    with ``gradient`` and/or ``full`` also its gradient with respect to
    ``im2`` and the SSIM image."""
    im1 = util.as_tensor(im1)
    im2 = util.as_tensor(im2, device=im1.device)
    check_shape_equality(im1, im2)

    if channel_axis is not None:
        multichannel = True
    if multichannel:
        # each channel along the last axis on its own
        args = dict(
            win_size=win_size,
            gradient=gradient,
            data_range=data_range,
            multichannel=False,
            gaussian_weights=gaussian_weights,
            full=full,
        )
        args.update(kwargs)
        nch = im1.shape[-1]
        mssim = []
        grads = []
        fulls = []
        for ch in range(nch):
            result = structural_similarity(
                im1[..., ch], im2[..., ch], **args
            )
            if gradient and full:
                mssim.append(result[0])
                grads.append(result[1])
                fulls.append(result[2])
            elif gradient:
                mssim.append(result[0])
                grads.append(result[1])
            elif full:
                mssim.append(result[0])
                fulls.append(result[1])
            else:
                mssim.append(result)
        mssim = torch.mean(torch.stack(mssim))
        out = [mssim]
        if gradient:
            out.append(torch.stack(grads, dim=-1))
        if full:
            out.append(torch.stack(fulls, dim=-1))
        return tuple(out) if len(out) > 1 else out[0]

    K1 = kwargs.pop("K1", 0.01)
    K2 = kwargs.pop("K2", 0.03)
    sigma = kwargs.pop("sigma", 1.5)
    use_sample_covariance = kwargs.pop("use_sample_covariance", True)
    if K1 < 0 or K2 < 0 or sigma < 0:
        raise ValueError("K1, K2 and sigma must all be positive")

    if gaussian_weights:
        truncate = 3.5
    if win_size is None:
        if gaussian_weights:
            r = int(truncate * sigma + 0.5)
            win_size = 2 * r + 1
        else:
            win_size = 7
    if np.any((np.asarray(im1.shape) - win_size) < 0):
        raise ValueError(
            "win_size exceeds image extent. If the input is a "
            "multichannel (color) image, set multichannel=True."
        )
    if not (win_size % 2 == 1):
        raise ValueError("Window size must be odd.")

    if data_range is None:
        if im1.dtype != im2.dtype:
            warn(
                "Inputs have mismatched dtype. Setting data_range based on "
                "im1.dtype.",
                stacklevel=2,
            )
        dmin, dmax = dtype_range[dtypes.to_numpy(im1.dtype).type]
        data_range = dmax - dmin

    ndim = im1.ndim
    if gaussian_weights:
        filter_func = gaussian_filter
        filter_args = {"sigma": sigma, "truncate": truncate}
    else:
        filter_func = uniform_filter
        filter_args = {"size": win_size}

    NP = win_size ** ndim
    cov_norm = NP / (NP - 1) if use_sample_covariance else 1.0

    im1 = im1.to(torch.float64)
    im2 = im2.to(torch.float64)
    ux = filter_func(im1, **filter_args)
    uy = filter_func(im2, **filter_args)
    uxx = filter_func(im1 * im1, **filter_args)
    uyy = filter_func(im2 * im2, **filter_args)
    uxy = filter_func(im1 * im2, **filter_args)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    R = float(data_range)
    C1 = (K1 * R) ** 2
    C2 = (K2 * R) ** 2

    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux ** 2 + uy ** 2 + C1
    B2 = vx + vy + C2
    D = B1 * B2
    S = (A1 * A2) / D

    pad = (win_size - 1) // 2
    mssim = torch.mean(crop(S, pad))

    out = [mssim]
    if gradient:
        # the local gradient of the mean SSIM with respect to im2
        # (Avanaki 2009)
        grad = filter_func(A1 / D, **filter_args) * im1
        grad = grad + filter_func(-S / B2, **filter_args) * im2
        grad = grad + filter_func(
            (ux * (A2 - A1) - uy * (B2 - B1) * S) / D, **filter_args
        )
        grad = grad * (2 / im1.numel())
        out.append(grad)
    if full:
        out.append(S)
    return tuple(out) if len(out) > 1 else mssim
