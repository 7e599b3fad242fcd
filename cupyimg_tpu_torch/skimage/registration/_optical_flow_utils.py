"""Common tools of the optical flow solvers
(skimage.registration._optical_flow_utils) on torch tensors.

Each pyramid level is ``transform.pyramid_reduce``: a gaussian (the
fused separable kernel for CUDA float32 data) and a ``resize`` (``zoom``
on the spline gather's affine entry).  ``resize_flow`` is one order-0
``zoom`` without prefilter (the gather's affine entry again), and the
inputs are converted with ``util.dtype._convert``.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage.transform import pyramid_reduce
from cupyimg_tpu_torch.skimage.util.dtype import _convert


def get_warp_points(grid, flow):
    """Warp point coordinates: grid + flow."""
    return torch.stack([flow[i] + g for i, g in enumerate(grid)], dim=0)


def resize_flow(flow, shape):
    """Rescale a vector field to ``shape``, scaling the vectors by the
    same factors."""
    scale = [n / o for n, o in zip(shape, flow.shape[1:])]
    scale_factor = torch.tensor(scale, dtype=flow.dtype,
                                device=flow.device).reshape(
        (-1,) + (1,) * len(shape))
    return scale_factor * ndi.zoom(
        flow, [1] + scale, order=0, mode="nearest", prefilter=False
    )


def get_pyramid(I, downscale=2.0, nlevel=10, min_size=16):
    """The coarse-to-fine image pyramid, coarsest level first."""
    pyramid = [I]
    size = min(I.shape)
    count = 1
    while (count < nlevel) and (size > downscale * min_size):
        J = pyramid_reduce(pyramid[-1], downscale, multichannel=False)
        pyramid.append(J)
        size = min(J.shape)
        count += 1
    return pyramid[::-1]


def _flow_dtype(dtype):
    """The torch dtype of a float ``dtype`` (numpy's characters 'efdg' or
    a torch float type); anything else raises ValueError."""
    if isinstance(dtype, torch.dtype):
        ok = dtype in (torch.float16, torch.float32, torch.float64)
    else:
        ok = np.dtype(dtype).char in "efdg"
    if not ok:
        raise ValueError(
            "Only floating point data type are valid for optical flow"
        )
    return dtype if isinstance(dtype, torch.dtype) else dtypes.to_torch(dtype)


def coarse_to_fine(
    I0, I1, solver, downscale=2, nlevel=10, min_size=16,
    dtype=np.float32,
):
    """Run ``solver(J0, J1, flow)`` from the coarsest pyramid level to
    the finest, the flow resized between levels."""
    I0 = util.as_tensor(I0)
    I1 = util.as_tensor(I1, device=I0.device)
    if I0.shape != I1.shape:
        raise ValueError("Input images should have the same shape")
    tdtype = _flow_dtype(dtype)

    pyramid = list(
        zip(
            get_pyramid(_convert(I0, tdtype), downscale, nlevel, min_size),
            get_pyramid(_convert(I1, tdtype), downscale, nlevel, min_size),
        )
    )
    # the flow starts at 0 on the coarsest level
    J0 = pyramid[0][0]
    flow = torch.zeros((J0.ndim,) + tuple(J0.shape), dtype=tdtype,
                       device=J0.device)
    flow = solver(J0, pyramid[0][1], flow)
    for J0, J1 in pyramid[1:]:
        flow = solver(J0, J1, resize_flow(flow, J0.shape))
    return flow
