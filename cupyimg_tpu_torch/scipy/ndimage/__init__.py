"""scipy.ndimage-compatible API on torch tensors: the filters and the
interpolation functions."""

from cupyimg_tpu_torch.scipy.ndimage.filters import (  # noqa: F401
    generic_filter,
    generic_filter1d,
    correlate,
    convolve,
    correlate1d,
    convolve1d,
    uniform_filter,
    uniform_filter1d,
    gaussian_filter,
    gaussian_filter1d,
    prewitt,
    sobel,
    generic_laplace,
    laplace,
    gaussian_laplace,
    generic_gradient_magnitude,
    gaussian_gradient_magnitude,
    minimum_filter,
    maximum_filter,
    minimum_filter1d,
    maximum_filter1d,
    rank_filter,
    median_filter,
    percentile_filter,
)
from cupyimg_tpu_torch.scipy.ndimage.interpolation import (  # noqa: F401
    spline_filter1d,
    spline_filter,
    map_coordinates,
    affine_transform,
    shift,
    zoom,
    rotate,
    geometric_transform,
)
