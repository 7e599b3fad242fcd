"""skimage.measure on torch tensors: so far ``label``."""

from cupyimg_tpu_torch.skimage.measure._label import label  # noqa: F401

__all__ = ["label"]
