"""Composite image-processing pipelines on torch tensors.

``edge_enhance_pipeline`` runs the separable filters end to end (a
gaussian smooth, the sobel gradient magnitude, an unsharp mix): for a
CUDA float32 volume one fused separable kernel launch for the gaussian
and one for each sobel.  ``richardson_lucy_step`` is one iteration of
Richardson-Lucy deconvolution by FFT convolution (``torch.fft``).
"""

from __future__ import annotations

import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi


def edge_enhance_pipeline(x, sigma=1.5, amount=0.7):
    """Gaussian smooth + sobel gradient magnitude + unsharp mix of a 2-D
    or 3-D image, in the input's floating type."""
    x = util.as_tensor(x)
    sm = ndi.gaussian_filter(x, sigma, dtype_mode="float")
    grad = None
    for ax in range(x.ndim):
        d = ndi.sobel(sm, axis=ax, dtype_mode="float")
        grad = d * d if grad is None else grad + d * d
    grad = torch.sqrt(grad)
    return (1.0 + amount) * x - amount * sm + 0.1 * grad


def richardson_lucy_step(image, estimate, psf_fft, psf_fft_conj):
    """One Richardson-Lucy iteration: ``psf_fft`` is the PSF's real
    spectrum (``rfftn``) in the estimate's shape, ``psf_fft_conj`` its
    conjugate."""
    estimate = util.as_tensor(estimate)
    dev = estimate.device
    image = util.as_tensor(image, device=dev)
    psf_fft = util.as_tensor(psf_fft, device=dev)
    psf_fft_conj = util.as_tensor(psf_fft_conj, device=dev)
    s = tuple(estimate.shape)
    conv = torch.fft.irfftn(torch.fft.rfftn(estimate) * psf_fft, s=s)
    relative = image / (conv + 1e-12)
    update = torch.fft.irfftn(torch.fft.rfftn(relative) * psf_fft_conj, s=s)
    return estimate * update
