"""numpy.lib-compatible names: the histograms, ``gradient`` and
``apply_along_axis``."""
from .histograms import histogram, histogram2d, histogramdd  # noqa: F401
from .function_base import gradient  # noqa: F401
from .shape_base import apply_along_axis  # noqa: F401
