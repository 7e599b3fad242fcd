"""skimage.util.crop on torch tensors."""

from __future__ import annotations

from cupyimg_tpu_torch.core import util

__all__ = ["crop"]


def crop(ar, crop_width, copy=False, order="K"):
    """Crop an array by ``crop_width`` along each dimension (skimage
    parity): a view unless ``copy``; ``order`` is accepted for parity."""
    del order
    ar = util.as_tensor(ar)
    if isinstance(crop_width, int):
        crops = [(crop_width, crop_width)] * ar.ndim
    elif isinstance(crop_width[0], int):
        if len(crop_width) == 1:
            crops = [(crop_width[0], crop_width[0])] * ar.ndim
        elif len(crop_width) == 2:
            crops = [tuple(crop_width)] * ar.ndim
        else:
            raise ValueError("crop_width has an invalid length")
    elif len(crop_width) == 1:
        crops = [tuple(crop_width[0])] * ar.ndim
    elif len(crop_width) == ar.ndim:
        crops = [(c, c) if isinstance(c, int) else tuple(c)
                 for c in crop_width]
    else:
        raise ValueError("crop_width has an invalid length")
    cropped = ar[tuple(slice(a, ar.shape[i] - b)
                       for i, (a, b) in enumerate(crops))]
    return cropped.clone() if copy else cropped
