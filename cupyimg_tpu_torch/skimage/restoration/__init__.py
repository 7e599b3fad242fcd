"""skimage.restoration on torch tensors: the Wiener-Hunt deconvolutions
and Richardson-Lucy, total-variation denoising, J-invariant denoiser
calibration, and the unitary Fourier transforms of ``uft``."""

from . import uft  # noqa: F401
from .deconvolution import wiener, unsupervised_wiener, richardson_lucy
from ._denoise import denoise_tv_chambolle
from .j_invariant import calibrate_denoiser

__all__ = [
    "wiener",
    "unsupervised_wiener",
    "richardson_lucy",
    "denoise_tv_chambolle",
    "calibrate_denoiser",
]
