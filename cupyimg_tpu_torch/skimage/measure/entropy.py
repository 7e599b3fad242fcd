"""``shannon_entropy`` (skimage.measure) on torch tensors: the entropy of
the frequencies of an image's distinct values, through the port's
``scipy.stats.entropy``."""

from __future__ import annotations

import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy.stats import entropy as scipy_entropy

__all__ = ["shannon_entropy"]


def shannon_entropy(image, base=2):
    """Shannon entropy of an image, ``-sum(pk * log(pk))`` over the
    frequency ``pk`` of each distinct pixel value; a 0-d float64 tensor
    on the image's device."""
    image = dtypes.widen_unsigned(util.as_tensor(image))
    _, counts = torch.unique(image, return_counts=True)
    return scipy_entropy(counts, base=base)
