"""Edge filters (skimage.filters.edges) on torch tensors: sobel, scharr,
prewitt and farid in n-D (one smoothing axis pass per other axis after
the derivative's), roberts' cross and the laplace.

Every filter computes in float64, as skimage's: on the card these are
plain-torch correlations (the fused separable kernel serves float32
only).  A mask is eroded by one pixel (``binary_erosion``, plain torch)
and zeroes the output outside it.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi

__all__ = [
    "sobel", "sobel_h", "sobel_v",
    "scharr", "scharr_h", "scharr_v",
    "prewitt", "prewitt_h", "prewitt_v",
    "roberts", "roberts_pos_diag", "roberts_neg_diag",
    "farid", "farid_h", "farid_v",
    "laplace",
]

# the smoothing weights (normalised) and the derivative, in correlation
# orientation: skimage convolves with [1, 0, -1], i.e. f(x+1) - f(x-1)
HSOBEL_SMOOTH = np.array([1, 2, 1]) / 4.0
HSCHARR_SMOOTH = np.array([3, 10, 3]) / 16.0
HPREWITT_SMOOTH = np.array([1, 1, 1]) / 3.0
EDGE_KERNEL = np.array([-1.0, 0.0, 1.0])

# Farid & Simoncelli's 5-tap optimal kernels (published constants),
# correlation orientation
FARID_SMOOTH = np.array(
    [0.0376593171958126, 0.249153396177344, 0.426374573253687,
     0.249153396177344, 0.0376593171958126])
FARID_EDGE = np.array(
    [-0.109603762960254, -0.276690988455557, 0.0, 0.276690988455557,
     0.109603762960254])

ROBERTS_PD_WEIGHTS = np.array([[1, 0], [0, -1]], dtype=np.float64)
ROBERTS_ND_WEIGHTS = np.array([[0, 1], [-1, 0]], dtype=np.float64)


def _mask_filter_result(result, mask):
    """Zero the filter output where the mask, eroded by one pixel, is
    False."""
    if mask is None:
        return result
    mask = util.as_tensor(mask, device=result.device).to(torch.bool)
    erosion_footprint = np.ones((3,) * result.ndim, dtype=bool)
    mask = ndi.binary_erosion(mask, erosion_footprint, border_value=0)
    return result * mask


def _generic_edge_filter(image, *, smooth_weights, edge_weights=EDGE_KERNEL,
                         axis=None, mode="reflect", cval=0.0):
    """The derivative along each of ``axis`` (default all) smoothed along
    every other axis; over several axes the root mean square over all
    ``ndim`` axes."""
    image = util.as_tensor(image).to(torch.float64)
    ndim = image.ndim
    if axis is None:
        axes = list(range(ndim))
    elif np.isscalar(axis):
        axes = [axis % ndim]
    else:
        axes = [a % ndim for a in axis]
    return_magnitude = len(axes) > 1
    output = None
    for edge_dim in axes:
        ax_out = ndi.correlate1d(image, edge_weights, axis=edge_dim,
                                 mode=mode, cval=cval)
        for smooth_dim in range(ndim):
            if smooth_dim == edge_dim:
                continue
            ax_out = ndi.correlate1d(ax_out, smooth_weights, axis=smooth_dim,
                                     mode=mode, cval=cval)
        if return_magnitude:
            ax_out = ax_out * ax_out
        output = ax_out if output is None else output + ax_out
    if return_magnitude:
        # the mean of the squares over ndim, not over the axes asked for
        output = torch.sqrt(output / ndim)
    return output


def sobel(image, mask=None, *, axis=None, mode="reflect", cval=0.0):
    """Sobel filter: the edge magnitude, or one axis' derivative."""
    out = _generic_edge_filter(image, smooth_weights=HSOBEL_SMOOTH,
                               axis=axis, mode=mode, cval=cval)
    return _mask_filter_result(out, mask)


def sobel_h(image, mask=None):
    """Sobel derivative along the rows (horizontal edges)."""
    return sobel(image, mask, axis=0)


def sobel_v(image, mask=None):
    """Sobel derivative along the columns (vertical edges)."""
    return sobel(image, mask, axis=1)


def scharr(image, mask=None, *, axis=None, mode="reflect", cval=0.0):
    """Scharr filter: the edge magnitude, or one axis' derivative."""
    out = _generic_edge_filter(image, smooth_weights=HSCHARR_SMOOTH,
                               axis=axis, mode=mode, cval=cval)
    return _mask_filter_result(out, mask)


def scharr_h(image, mask=None):
    """Scharr derivative along the rows."""
    return scharr(image, mask, axis=0)


def scharr_v(image, mask=None):
    """Scharr derivative along the columns."""
    return scharr(image, mask, axis=1)


def prewitt(image, mask=None, *, axis=None, mode="reflect", cval=0.0):
    """Prewitt filter: the edge magnitude, or one axis' derivative."""
    out = _generic_edge_filter(image, smooth_weights=HPREWITT_SMOOTH,
                               axis=axis, mode=mode, cval=cval)
    return _mask_filter_result(out, mask)


def prewitt_h(image, mask=None):
    """Prewitt derivative along the rows."""
    return prewitt(image, mask, axis=0)


def prewitt_v(image, mask=None):
    """Prewitt derivative along the columns."""
    return prewitt(image, mask, axis=1)


def farid(image, mask=None, *, axis=None, mode="reflect", cval=0.0):
    """Farid & Simoncelli's 5-tap derivative filter."""
    out = _generic_edge_filter(image, smooth_weights=FARID_SMOOTH,
                               edge_weights=FARID_EDGE, axis=axis, mode=mode,
                               cval=cval)
    return _mask_filter_result(out, mask)


def farid_h(image, mask=None):
    """Farid derivative along the rows."""
    return farid(image, mask, axis=0)


def farid_v(image, mask=None):
    """Farid derivative along the columns."""
    return farid(image, mask, axis=1)


def roberts(image, mask=None):
    """Roberts' cross edge magnitude, divided by sqrt(2) so that [0, 1]
    images stay in [0, 1]."""
    return torch.sqrt(roberts_pos_diag(image, mask) ** 2
                      + roberts_neg_diag(image, mask) ** 2) / np.sqrt(2.0)


def roberts_pos_diag(image, mask=None):
    """Roberts' cross, positive diagonal."""
    image = util.as_tensor(image).to(torch.float64)
    return _mask_filter_result(ndi.convolve(image, ROBERTS_PD_WEIGHTS), mask)


def roberts_neg_diag(image, mask=None):
    """Roberts' cross, negative diagonal."""
    image = util.as_tensor(image).to(torch.float64)
    return _mask_filter_result(ndi.convolve(image, ROBERTS_ND_WEIGHTS), mask)


def laplace(image, ksize=3, mask=None):
    """Laplace edge filter: the correlation with ``uft.laplacian``'s
    impulse response (centre 2 * ndim, axis neighbours -1), the negated
    ndimage laplace."""
    from cupyimg_tpu_torch.skimage.restoration.uft import laplacian

    image = util.as_tensor(image).to(torch.float64)
    _, laplace_op = laplacian(image.ndim, (ksize,) * image.ndim,
                              device=image.device)
    return _mask_filter_result(ndi.correlate(image, laplace_op), mask)
