"""scikit-image-compatible layer on torch tensors: ``skimage.util`` (the
dtype conversions, views, ``invert``, ``random_noise``, ``map_array``,
``crop``), ``skimage.morphology``, ``skimage.measure`` (``label``,
``regionprops``, the moments, perimeters, ``profile_line``, polygons,
``block_reduce``), ``skimage.color`` (the colour spaces, stains,
``label2rgb``, ``deltaE_*``), ``skimage.exposure`` (histograms, their
equalization and matching, the intensity corrections),
``skimage.transform`` (the geometric transforms, the warps, the integral
images, the pyramids), ``skimage.feature`` (``canny``, the corner and
Hessian features, ``peak_local_max``, ``match_template``, ``daisy``, the
registration aliases), ``skimage.filters`` (the edge filters, the
gaussians, median, unsharp masking, gabor, windows, the LPI filters, the
thresholds, the ridge filters), ``skimage.restoration`` (the
deconvolutions, total-variation denoising, denoiser calibration,
``uft``), ``skimage.registration`` (phase cross-correlation, plain and
masked; the TV-L1 and iLK optical flows), ``skimage.segmentation``
(boundaries, label joins and relabelling, border clearing, the
morphological snakes), ``skimage.metrics`` and the shared helpers of
``skimage._shared``.  The ``img_as_*`` conversions and ``dtype_limits``
are re-exported here, as skimage does."""

from .util.dtype import (  # noqa: F401,E402
    img_as_float32,
    img_as_float64,
    img_as_float,
    img_as_int,
    img_as_uint,
    img_as_ubyte,
    img_as_bool,
    dtype_limits,
)
