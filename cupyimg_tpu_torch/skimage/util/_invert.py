"""skimage.util.invert on torch tensors."""

from __future__ import annotations

import torch

from cupyimg_tpu_torch.core import util

__all__ = ["invert"]

# torch's unsigned types above 8 bits have no bitwise kernels: NOT runs on
# the signed type of the same size, through a view
_SAME_SIZE_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                     torch.uint64: torch.int64}


def invert(image, signed_float=False):
    """Invert an image (skimage.util.invert): logical not for bool,
    ``max + min - x`` for integers (which is bitwise NOT, and stays in
    the dtype), ``1 - x`` for floats, or ``-x`` with ``signed_float``."""
    image = util.as_tensor(image)
    if image.dtype == torch.bool:
        return ~image
    if not (image.is_floating_point() or image.is_complex()):
        signed = _SAME_SIZE_SIGNED.get(image.dtype)
        if signed is None:
            return ~image
        return (~image.view(signed)).view(image.dtype)
    if signed_float:
        return -image
    return 1.0 - image
