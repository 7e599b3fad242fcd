"""SciPy-compatible op layer: scipy.ndimage and scipy.signal."""

from cupyimg_tpu_torch.scipy import ndimage, signal  # noqa: F401
