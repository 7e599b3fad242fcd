"""skimage.filters on torch tensors: the edge filters, gaussian and
difference of gaussians, median, unsharp masking, gabor, windows,
``rank_order``, the LPI filters, the thresholds and the ridge filters.

On the card a float32 image reaches the port's kernels: the gaussians
(``gaussian``, ``difference_of_gaussians``, ``unsharp_mask``, the ridge
filters' Hessian) the fused separable correlation, ``median`` the rank
kernel (int32 and float32), ``window`` the spline gather.  The edge
filters, ``gabor`` and the local thresholds compute in float64 and take
plain torch; the spectra are ``torch.fft``."""

from .edges import (  # noqa: F401
    sobel, sobel_h, sobel_v,
    scharr, scharr_h, scharr_v,
    prewitt, prewitt_h, prewitt_v,
    roberts, roberts_pos_diag, roberts_neg_diag,
    farid, farid_h, farid_v,
    laplace,
)
from ._gaussian import gaussian, difference_of_gaussians  # noqa: F401
from ._median import median  # noqa: F401
from ._unsharp_mask import unsharp_mask  # noqa: F401
from ._gabor import gabor, gabor_kernel  # noqa: F401
from ._window import window  # noqa: F401
from ._rank_order import rank_order  # noqa: F401
from .lpi_filter import (  # noqa: F401
    LPIFilter2D,
    filter_forward,
    forward,
    inverse,
    wiener,
)
from .thresholding import (  # noqa: F401
    try_all_threshold,
    threshold_otsu,
    threshold_yen,
    threshold_isodata,
    threshold_li,
    threshold_local,
    threshold_minimum,
    threshold_mean,
    threshold_niblack,
    threshold_sauvola,
    threshold_triangle,
    threshold_multiotsu,
    apply_hysteresis_threshold,
)
from .ridges import (  # noqa: F401
    meijering,
    sato,
    frangi,
    hessian,
    compute_hessian_eigenvalues,
)

# skimage's name for the median filter of the reference's listing
rank_filter = median
