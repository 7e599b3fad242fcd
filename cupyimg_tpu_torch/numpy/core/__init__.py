"""numpy.core-compatible names: ``convolve``, ``correlate``,
``ravel_multi_index`` and ``ndim``."""
from .numeric import convolve, correlate  # noqa: F401
from .multiarray import ravel_multi_index  # noqa: F401
from .fromnumeric import ndim  # noqa: F401
