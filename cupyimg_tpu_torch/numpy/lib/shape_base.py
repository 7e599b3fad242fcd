"""numpy.lib.shape_base's ``apply_along_axis``."""
from cupyimg_tpu_torch.numpy import apply_along_axis  # noqa: F401

__all__ = ["apply_along_axis"]
