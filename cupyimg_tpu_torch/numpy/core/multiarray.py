"""numpy.core.multiarray's ``ravel_multi_index``."""
from cupyimg_tpu_torch.numpy import ravel_multi_index  # noqa: F401

__all__ = ["ravel_multi_index"]
