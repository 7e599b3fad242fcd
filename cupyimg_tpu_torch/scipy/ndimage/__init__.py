"""scipy.ndimage-compatible API on torch tensors: the filters, the
interpolation functions, morphology, the distance transforms, the
Fourier-domain filters and the measurements."""

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
from cupyimg_tpu_torch.scipy.ndimage.morphology import (  # noqa: F401
    generate_binary_structure,
    iterate_structure,
    binary_erosion,
    binary_dilation,
    binary_opening,
    binary_closing,
    binary_hit_or_miss,
    binary_propagation,
    binary_fill_holes,
    grey_erosion,
    grey_dilation,
    grey_opening,
    grey_closing,
    morphological_gradient,
    morphological_laplace,
    white_tophat,
    black_tophat,
)
from cupyimg_tpu_torch.scipy.ndimage._distance_transform import (  # noqa: F401
    distance_transform_edt,
    distance_transform_cdt,
    distance_transform_bf,
)
from cupyimg_tpu_torch.scipy.ndimage.fourier import (  # noqa: F401
    fourier_gaussian,
    fourier_uniform,
    fourier_shift,
    fourier_ellipsoid,
)
from cupyimg_tpu_torch.scipy.ndimage.measurements import (  # noqa: F401
    label,
    sum,
    sum_labels,
    mean,
    variance,
    standard_deviation,
    minimum,
    maximum,
    median,
    minimum_position,
    maximum_position,
    extrema,
    center_of_mass,
    histogram,
    labeled_comprehension,
    find_objects,
    value_indices,
)

# the spline prefilter's internals (poles, gain, and a callable applying
# the prefilter along axis 0)
from cupyimg_tpu_torch.ops.iir import get_poles, get_gain  # noqa: F401,E402


def get_raw_spline1d_kernel(order, mode):
    """A callable applying the order-``order`` spline prefilter along axis
    0 of a float tensor by the recursion, in the boundary family of the
    ndimage ``mode``."""
    from cupyimg_tpu_torch.ops import iir as _iir

    def kernel(x):
        nb = _iir._n_boundary(get_poles(order), _iir._real_np_dtype(x.dtype))
        return _iir._apply_axis0(x, order, _iir.get_spline_mode(mode), nb)

    return kernel
