"""numpy.core.fromnumeric's ``ndim``."""
from cupyimg_tpu_torch.numpy import ndim  # noqa: F401

__all__ = ["ndim"]
