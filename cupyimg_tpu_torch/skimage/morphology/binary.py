"""Binary morphological operations (skimage.morphology.binary) on torch
tensors, on ``scipy.ndimage``'s binary operations."""

from __future__ import annotations

from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage.morphology.misc import default_selem

__all__ = [
    "binary_erosion",
    "binary_dilation",
    "binary_opening",
    "binary_closing",
]


def _check_out(out):
    if out is not None:
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: `out` is not supported"
        )


@default_selem
def binary_erosion(image, selem=None, out=None):
    """Binary erosion (skimage parity): ndimage's, the border taken as
    set."""
    _check_out(out)
    return ndi.binary_erosion(image, structure=selem, border_value=True)


@default_selem
def binary_dilation(image, selem=None, out=None):
    """Binary dilation (skimage parity)."""
    _check_out(out)
    return ndi.binary_dilation(image, structure=selem)


@default_selem
def binary_opening(image, selem=None, out=None):
    """Binary opening: erosion, then dilation (skimage parity)."""
    _check_out(out)
    return binary_dilation(binary_erosion(image, selem), selem)


@default_selem
def binary_closing(image, selem=None, out=None):
    """Binary closing: dilation, then erosion (skimage parity)."""
    _check_out(out)
    return binary_erosion(binary_dilation(image, selem), selem)
