"""scikit-image-compatible layer on torch tensors: ``skimage.util`` (the
dtype conversions, views, ``invert``, ``random_noise``, ``map_array``,
``crop``), ``skimage.morphology``, ``skimage.measure.label`` and the
shared helpers of ``skimage._shared``.  The ``img_as_*`` conversions and
``dtype_limits`` are re-exported here, as skimage does."""

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
