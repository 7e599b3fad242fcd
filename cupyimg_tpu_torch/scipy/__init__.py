"""SciPy-compatible op layer: scipy.ndimage's separable filters."""

from cupyimg_tpu_torch.scipy import ndimage  # noqa: F401
