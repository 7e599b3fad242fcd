"""The mean squared error, normalized root MSE and peak signal-to-noise
ratio (skimage.metrics.simple_metrics) on torch tensors; each a 0-d
tensor on the images' device.  The images are compared in numpy's
promotion of their dtypes with float32."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.skimage._shared.utils import check_shape_equality, warn
from cupyimg_tpu_torch.skimage.util.dtype import dtype_range

__all__ = [
    "mean_squared_error",
    "normalized_root_mse",
    "peak_signal_noise_ratio",
]


def _pair(image0, image1):
    image0 = util.as_tensor(image0)
    image1 = util.as_tensor(image1, device=image0.device)
    check_shape_equality(image0, image1)
    return image0, image1


def _as_floats(image0, image1):
    float_type = dtypes.to_torch(dtypes.promote_types(dtypes.promote_types(
        image0.dtype, image1.dtype), np.float32))
    return image0.to(float_type), image1.to(float_type)


def mean_squared_error(image0, image1):
    """Mean of the squared differences."""
    image0, image1 = _as_floats(*_pair(image0, image1))
    return torch.mean((image0 - image1) ** 2)


def normalized_root_mse(image_true, image_test, normalization="euclidean"):
    """Root of the MSE over a norm of ``image_true``: 'euclidean' (its
    root mean square), 'min-max' (its range) or 'mean'."""
    image_true, image_test = _as_floats(*_pair(image_true, image_test))
    normalization = normalization.lower()
    if normalization == "euclidean":
        denom = torch.sqrt(torch.mean(image_true * image_true))
    elif normalization == "min-max":
        denom = torch.amax(image_true) - torch.amin(image_true)
    elif normalization == "mean":
        denom = torch.mean(image_true)
    else:
        raise ValueError("Unsupported norm_type")
    return torch.sqrt(mean_squared_error(image_true, image_test)) / denom


def peak_signal_noise_ratio(image_true, image_test, data_range=None):
    """Peak signal-to-noise ratio in dB.  Without ``data_range``, the
    range of ``image_true``'s dtype (its maximum where the image has no
    negative values); values outside that range raise ValueError."""
    image_true, image_test = _pair(image_true, image_test)
    if data_range is None:
        if image_true.dtype != image_test.dtype:
            warn(
                "Inputs have mismatched dtype. Setting data_range based on "
                "im_true.",
                stacklevel=2,
            )
        dmin, dmax = dtype_range[dtypes.to_numpy(image_true.dtype).type]
        wide = dtypes.widen_unsigned(image_true)
        true_min = float(torch.amin(wide))
        true_max = float(torch.amax(wide))
        if true_max > dmax or true_min < dmin:
            raise ValueError(
                "im_true has intensity values outside the range expected for "
                "its data type. Please manually specify the data_range"
            )
        if true_min >= 0:
            data_range = dmax
        else:
            data_range = dmax - dmin
    err = mean_squared_error(image_true, image_test)
    return 10 * torch.log10((float(data_range) ** 2) / err)
