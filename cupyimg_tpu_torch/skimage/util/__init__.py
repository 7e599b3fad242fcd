"""skimage.util on torch tensors: so far ``crop``."""

from cupyimg_tpu_torch.skimage.util.arraycrop import crop  # noqa: F401
