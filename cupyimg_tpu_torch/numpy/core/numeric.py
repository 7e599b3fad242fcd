"""numpy.core.numeric's 1-d ``convolve`` and ``correlate``."""
from cupyimg_tpu_torch.numpy import convolve, correlate  # noqa: F401

__all__ = ["convolve", "correlate"]
