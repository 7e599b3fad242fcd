"""Unitary Fourier transforms (skimage.restoration.uft) on torch tensors.

The orthonormal helpers of the Wiener-Hunt deconvolution family:
``torch.fft`` (through ``skimage._shared.fft``) scaled by 1/sqrt(N) over
the transformed axes, the scale a host float.  No hand-written kernel:
these are cuFFT calls on the card, as the reference's are ``jnp.fft``
outside any Pallas kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.skimage._shared.fft import fftmodule as fft

__keywords__ = "fft, Fourier Transform, orthonormal, unitary"


def _unitary_scale(shape, axes):
    """1/sqrt(N) over the transformed axes, a host float."""
    n = 1
    for ax in axes:
        n *= shape[ax]
    return 1.0 / math.sqrt(n)


def _axes(inarray, dim):
    return tuple(range(-(inarray.ndim if dim is None else dim), 0))


def ufftn(inarray, dim=None):
    """N-dimensional unitary Fourier transform of the last ``dim`` axes."""
    inarray = util.as_tensor(inarray)
    axes = _axes(inarray, dim)
    return fft.fftn(inarray, dim=axes) * _unitary_scale(inarray.shape, axes)


def uifftn(inarray, dim=None):
    """N-dimensional unitary inverse Fourier transform."""
    inarray = util.as_tensor(inarray)
    axes = _axes(inarray, dim)
    return fft.ifftn(inarray, dim=axes) / _unitary_scale(inarray.shape, axes)


def urfftn(inarray, dim=None):
    """N-dimensional real unitary Fourier transform (Hermitian half)."""
    inarray = util.as_tensor(inarray)
    axes = _axes(inarray, dim)
    return fft.rfftn(inarray, dim=axes) * _unitary_scale(inarray.shape, axes)


def uirfftn(inarray, dim=None, shape=None):
    """N-dimensional inverse real unitary Fourier transform; ``shape``
    (the transformed axes' sizes) recovers an odd last axis."""
    inarray = util.as_tensor(inarray)
    axes = _axes(inarray, dim)
    s = None if shape is None else tuple(int(n) for n in shape)
    out = fft.irfftn(inarray, s=s, dim=axes)
    return out * (1.0 / _unitary_scale(out.shape, axes))


def ufft2(inarray):
    """2-dimensional unitary Fourier transform (last two axes)."""
    return ufftn(inarray, 2)


def uifft2(inarray):
    """2-dimensional inverse unitary Fourier transform."""
    return uifftn(inarray, 2)


def urfft2(inarray):
    """2-dimensional real unitary Fourier transform."""
    return urfftn(inarray, 2)


def uirfft2(inarray, shape=None):
    """2-dimensional inverse real unitary Fourier transform."""
    return uirfftn(inarray, 2, shape=shape)


def image_quad_norm(inarray):
    """Quadratic norm of images in Fourier space; a Hermitian half (last
    two axes of unequal size) counts its mirrored half twice."""
    inarray = util.as_tensor(inarray)
    abs_sq = torch.abs(inarray)
    abs_sq = abs_sq * abs_sq
    if inarray.shape[-1] != inarray.shape[-2]:
        return 2 * torch.sum(torch.sum(abs_sq, dim=-1), dim=-1) - torch.sum(
            torch.abs(inarray[..., 0]) ** 2, dim=-1)
    return torch.sum(torch.sum(abs_sq, dim=-1), dim=-1)


def ir2tf(imp_resp, shape, dim=None, is_real=True):
    """Transfer function of an impulse response: zero-padded to
    ``shape``, its centre rolled to the origin, transformed over the last
    ``dim`` axes (real: the Hermitian half)."""
    imp_resp = util.as_tensor(imp_resp)
    if not dim:
        dim = imp_resp.ndim
    irpadded = torch.zeros(tuple(shape), dtype=imp_resp.dtype,
                           device=imp_resp.device)
    irpadded[tuple(slice(0, s) for s in imp_resp.shape)] = imp_resp
    for axis, axis_size in enumerate(imp_resp.shape):
        if axis >= imp_resp.ndim - dim:
            irpadded = torch.roll(irpadded, shifts=-math.floor(axis_size / 2),
                                  dims=axis)
    axes = tuple(range(-dim, 0))
    if is_real:
        return fft.rfftn(irpadded, dim=axes)
    return fft.fftn(irpadded, dim=axes)


def laplacian(ndim, shape, is_real=True, *, device=None):
    """Transfer function and impulse response of the Laplacian (centre
    2 * ndim, each axis neighbour -1), float64, on ``device`` (default
    ``config.device``)."""
    impr = np.zeros([3] * ndim)
    for dim in range(ndim):
        idx = tuple([slice(1, 2)] * dim + [slice(None)]
                    + [slice(1, 2)] * (ndim - dim - 1))
        impr[idx] = np.array([-1.0, 0.0, -1.0]).reshape(
            [-1 if i == dim else 1 for i in range(ndim)])
    impr[(slice(1, 2),) * ndim] = 2.0 * ndim
    impr = util.as_tensor(impr, device=device)
    return ir2tf(impr, shape, is_real=is_real), impr
