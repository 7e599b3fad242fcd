"""scipy.stats' ``entropy`` on torch tensors."""

from cupyimg_tpu_torch.scipy.stats.distributions import entropy  # noqa: F401
