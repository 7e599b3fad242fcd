"""scipy.ndimage-compatible API on torch tensors: the separable filters."""

from cupyimg_tpu_torch.scipy.ndimage.filters import (  # noqa: F401
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
)
