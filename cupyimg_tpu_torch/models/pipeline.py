"""Composite image-processing pipelines on torch tensors.

``edge_enhance_pipeline`` runs the separable filters end to end (a
gaussian smooth, the sobel gradient magnitude, an unsharp mix): for a
CUDA float32 volume one fused separable kernel launch for the gaussian
and one for each sobel.  ``sharded_edge_enhance`` runs the same math over
a (batch, spatial) device mesh with halo exchange (``parallel``): on each
rank one fused separable launch for the gaussian and one for each
spatial derivative.  ``richardson_lucy_step`` is one iteration of
Richardson-Lucy deconvolution by FFT convolution (``torch.fft``).  None
of them has parameters: there are no weights to carry across from the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.parallel import halo as _halo
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.scipy.ndimage.filters import _gaussian_kernel1d


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


def sharded_edge_enhance(x, mesh, spec, sigma=1.5, amount=0.7):
    """The edge-enhance pipeline over a device mesh with halo exchange.

    ``x`` is a DTensor sharded per ``spec`` (or the whole array on every
    rank); ``spec`` shards a batch axis (data parallel, axis 0, never
    filtered) and/or spatial axes (spatial parallel).  A gaussian on the
    spatial axes, the Sobel-style derivative of each spatial axis
    smoothed across the others, and ``(1 + amount) * x - amount * sm +
    0.1 * grad``; returns a DTensor sharded as ``x``.
    """
    from torch.distributed.tensor import DTensor

    x = _halo.distribute(x, mesh, spec)
    lw = int(4.0 * sigma + 0.5)
    g = _gaussian_kernel1d(sigma, 0, lw)[::-1]
    ndim = x.ndim
    # batch axis (axis 0) gets no filtering; spatial axes get gaussian
    weights = [None] + [g] * (ndim - 1)
    sm = _halo.sharded_separable(x, weights, mesh, spec)  # in x's dtype

    deriv = np.array([-1.0, 0.0, 1.0])
    smooth = np.array([1.0, 2.0, 1.0])
    grad = None
    for ax in range(1, ndim):
        w = [None] + [
            deriv if a == ax else smooth for a in range(1, ndim)
        ]
        d = _halo.sharded_separable(sm, w, mesh, spec).to_local()
        grad = d * d if grad is None else grad + d * d
    grad = torch.sqrt(grad).to(x.dtype)
    out = (1.0 + amount) * x.to_local() - amount * sm.to_local() + 0.1 * grad
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())
