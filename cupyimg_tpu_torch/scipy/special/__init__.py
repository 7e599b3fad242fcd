"""scipy.special's convex-analysis functions on torch tensors."""

from cupyimg_tpu_torch.scipy.special._convex_analysis import (  # noqa: F401
    entr,
    kl_div,
    rel_entr,
    huber,
    pseudo_huber,
)
