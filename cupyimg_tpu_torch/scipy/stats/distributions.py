"""scipy.stats.entropy on torch tensors."""

from __future__ import annotations

import math

import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy.special import entr, rel_entr

__all__ = ["entropy"]


def entropy(pk, qk=None, base=None, axis=0):
    """Shannon entropy of ``pk``, or the relative entropy of ``pk`` to
    ``qk``, along ``axis`` (scipy.stats.entropy): both are normalized to
    sum to 1 first; ``base`` (default e) sets the logarithm's base."""
    pk = util.as_tensor(pk)
    if not (pk.is_floating_point() or pk.is_complex()):
        pk = pk.to(torch.float64)
    pk = pk / torch.sum(pk, dim=axis, keepdim=True)
    if qk is None:
        vec = entr(pk)
    else:
        qk = util.as_tensor(qk, device=pk.device)
        if qk.shape != pk.shape:
            raise ValueError("qk and pk must have same shape.")
        if not (qk.is_floating_point() or qk.is_complex()):
            qk = qk.to(torch.float64)
        qk = qk / torch.sum(qk, dim=axis, keepdim=True)
        vec = rel_entr(pk, qk)
    S = torch.sum(vec, dim=axis)
    if base is not None:
        S = S / math.log(base)
    return S
