"""Deconvolution (skimage.restoration.deconvolution) on torch tensors:
``wiener``, ``unsupervised_wiener`` and ``richardson_lucy``.

The Wiener-Hunt pair works on ``uft``'s spectra (``torch.fft``; cuFFT on
the card).  ``unsupervised_wiener`` is a Gibbs sampler whose complex
noise and gamma draws come from a numpy ``RandomState`` on the host, as
skimage's: a seeded generator gives the same chain in every package; each
iteration reads back two quadratic norms and its convergence measure.
``richardson_lucy`` is two ``scipy.signal.convolve`` calls an iteration:
a float32 image stays float32, so on the card each convolution is one
launch of the dense kernel (direct) or the FFT kernel's passes, as
``choose_conv_method`` decides.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy.signal import convolve

from . import uft

__keywords__ = "restoration, image, deconvolution"


def _clip_pm1(x):
    """``x[x > 1] = 1; x[x < -1] = -1``; complex values compare
    lexicographically by (real, imag), and a clipped pixel loses its
    imaginary part, as numpy's masked assignment of a real bound does."""
    if not x.is_complex():
        return torch.clamp(x, -1, 1)
    gt = (x.real > 1) | ((x.real == 1) & (x.imag > 0))
    lt = (x.real < -1) | ((x.real == -1) & (x.imag < 0))
    return torch.where(gt, 1.0, torch.where(lt, -1.0, x))


def _transfer_functions(image, psf, reg, is_real):
    """The regularisation's and the PSF's transfer functions on the
    image's device (a complex ``reg`` or a ``psf`` of ``reg``'s shape is
    one already)."""
    if reg is None:
        reg, _ = uft.laplacian(image.ndim, image.shape, is_real=is_real,
                               device=image.device)
    reg = util.as_tensor(reg, device=image.device)
    if not reg.is_complex():
        reg = uft.ir2tf(reg, image.shape, is_real=is_real)
    if psf.shape != reg.shape:
        trans_fct = uft.ir2tf(psf, image.shape, is_real=is_real)
    else:
        trans_fct = psf
    return reg, trans_fct


def wiener(image, psf, balance, reg=None, is_real=True, clip=True):
    """Wiener-Hunt deconvolution by Fourier diagonalisation.  ``psf`` is
    an impulse response or, in ``reg``'s shape, a transfer function;
    ``reg`` defaults to the Laplacian."""
    image = util.as_tensor(image)
    psf = util.as_tensor(psf, device=image.device)
    reg, trans_func = _transfer_functions(image, psf, reg, is_real)
    atf2 = torch.abs(trans_func) ** 2
    areg2 = torch.abs(reg) ** 2
    wiener_filter = torch.conj(trans_func) / (atf2 + balance * areg2)
    if is_real:
        deconv = uft.uirfft2(wiener_filter * uft.urfft2(image),
                             shape=image.shape)
    else:
        deconv = uft.uifft2(wiener_filter * uft.ufft2(image))
    if clip:
        deconv = _clip_pm1(deconv)
    return deconv


def unsupervised_wiener(image, psf, reg=None, user_params=None, is_real=True,
                        clip=True):
    """Unsupervised Wiener-Hunt deconvolution: a Gibbs sampler over the
    noise and prior precisions.  Returns ``(x_postmean, {"noise": chain,
    "prior": chain})``.  ``user_params`` may set ``threshold``,
    ``max_iter``, ``min_iter``, ``burnin``, ``callback`` (called with each
    sample) and ``rng`` (a numpy ``RandomState``)."""
    params = {"threshold": 1e-4, "max_iter": 200, "min_iter": 30,
              "burnin": 15, "callback": None, "rng": None}
    params.update(user_params or {})
    rng = params["rng"] or np.random.RandomState()

    image = util.as_tensor(image)
    psf = util.as_tensor(psf, device=image.device)
    reg, trans_fct = _transfer_functions(image, psf, reg, is_real)

    x_postmean = torch.zeros(trans_fct.shape, dtype=trans_fct.dtype,
                             device=image.device)
    prev_x_postmean = x_postmean
    delta = np.nan
    gn_chain, gx_chain = [1], [1]
    areg2 = torch.abs(reg) ** 2
    atf2 = torch.abs(trans_fct) ** 2

    image64 = image.to(torch.float64)
    data_spectrum = uft.urfft2(image64) if is_real else uft.ufft2(image64)
    real_dtype = dtypes.to_numpy(data_spectrum.real.dtype)
    size = image.numel()
    iteration = 0
    for iteration in range(params["max_iter"]):
        # weighting (correlation in direct space), Eq. 29
        precision = gn_chain[-1] * atf2 + gx_chain[-1] * areg2
        # the normal excursion, drawn on the host
        noise = torch.complex(
            util.as_tensor(rng.standard_normal(data_spectrum.shape).astype(
                real_dtype), device=image.device),
            util.as_tensor(rng.standard_normal(data_spectrum.shape).astype(
                real_dtype), device=image.device))
        excursion = math.sqrt(0.5) / torch.sqrt(precision) * noise

        # mean Eq. 30
        wiener_filter = gn_chain[-1] * torch.conj(trans_fct) / precision
        x_sample = wiener_filter * data_spectrum + excursion
        if params["callback"]:
            params["callback"](x_sample)

        # sample the hyperparameters, Eq. 31
        gn_chain.append(float(rng.gamma(
            size / 2,
            2 / float(uft.image_quad_norm(data_spectrum
                                          - x_sample * trans_fct)))))
        gx_chain.append(float(rng.gamma(
            (size - 1) / 2, 2 / float(uft.image_quad_norm(x_sample * reg)))))

        # current empirical average
        if iteration > params["burnin"]:
            x_postmean = prev_x_postmean + x_sample
        if iteration > (params["burnin"] + 1):
            current = x_postmean / (iteration - params["burnin"])
            previous = prev_x_postmean / (iteration - params["burnin"] - 1)
            delta = float(torch.sum(torch.abs(current - previous))
                          / torch.sum(torch.abs(x_postmean))
                          / (iteration - params["burnin"]))
        prev_x_postmean = x_postmean
        if (iteration > params["min_iter"]) and (
                delta < params["threshold"]):
            break

    x_postmean = x_postmean / (iteration - params["burnin"])
    if is_real:
        x_postmean = uft.uirfft2(x_postmean, shape=image.shape)
    else:
        x_postmean = uft.uifft2(x_postmean)
    if clip:
        x_postmean = _clip_pm1(x_postmean)
    return (x_postmean, {"noise": gn_chain, "prior": gx_chain})


def richardson_lucy(image, psf, iterations=50, clip=True,
                    filter_epsilon=None):
    """Richardson-Lucy deconvolution: ``iterations`` multiplicative
    updates, each two 'same' convolutions and a ratio (set to 0 where the
    blurred estimate is below ``filter_epsilon``).  The image and PSF are
    computed in their type promoted with float32."""
    image = util.as_tensor(image)
    psf = util.as_tensor(psf, device=image.device)
    float_type = dtypes.to_torch(np.promote_types(
        dtypes.to_numpy(image.dtype), np.float32))
    image = image.to(float_type)
    psf = psf.to(float_type)
    im_deconv = torch.full(image.shape, 0.5, dtype=float_type,
                           device=image.device)
    psf_mirror = torch.flip(psf, tuple(range(psf.ndim)))
    for _ in range(int(iterations)):
        conv = convolve(im_deconv, psf, mode="same")
        if filter_epsilon:
            relative_blur = torch.where(conv < filter_epsilon, 0.0,
                                        image / conv)
        else:
            relative_blur = image / conv
        im_deconv = im_deconv * convolve(relative_blur, psf_mirror,
                                         mode="same")
    if clip:
        im_deconv = _clip_pm1(im_deconv)
    return im_deconv
