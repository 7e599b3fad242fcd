"""Subpixel translation registration by phase cross-correlation
(skimage.registration._phase_cross_correlation) on torch tensors.

The spectra and the cross-correlation are ``torch.fft`` (cuFFT on the
card).  The upsampled DFT of the refinement is one matrix product per
axis of ``ceil(1.5 * upsample_factor)`` rows against a whole image axis:
it runs in complex128, which TF32 cannot serve, and is rounded once to
the input's precision.  The peak, the shifts and the error terms stay on
the device; the NaN check is the call's one read back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

from .._shared.fft import fftmodule as fft
from ._masked_phase_cross_correlation import _masked_phase_cross_correlation

__all__ = ["phase_cross_correlation"]


def _region_params(data_ndim, upsampled_region_size, axis_offsets):
    if not hasattr(upsampled_region_size, "__iter__"):
        upsampled_region_size = [upsampled_region_size] * data_ndim
    elif len(upsampled_region_size) != data_ndim:
        raise ValueError(
            "shape of upsampled region sizes must be equal "
            "to input data's number of dimensions."
        )
    if axis_offsets is None:
        axis_offsets = [0] * data_ndim
    elif len(axis_offsets) != data_ndim:
        raise ValueError(
            "number of axis offsets must be equal to input "
            "data's number of dimensions."
        )
    return upsampled_region_size, axis_offsets


def _upsampled_dft(
    data, upsampled_region_size, upsample_factor=1, axis_offsets=None
):
    """The DFT of ``data`` upsampled by ``upsample_factor`` on a region
    of ``upsampled_region_size`` points an axis starting at
    ``axis_offsets``: one complex128 product an axis with the kernel
    exp(-2 pi i (k - offset) f / upsample_factor), rounded once to
    complex64 for single-precision data."""
    data = util.as_tensor(data)
    upsampled_region_size, axis_offsets = _region_params(
        data.ndim, upsampled_region_size, axis_offsets
    )
    single = data.dtype in (torch.float16, torch.bfloat16, torch.float32,
                            torch.complex32, torch.complex64)
    dev = data.device
    f64 = torch.float64
    z = data.to(torch.complex128)
    dims = list(zip(data.shape, upsampled_region_size, axis_offsets))
    for n_items, ups_size, ax_offset in dims[::-1]:
        freqs = torch.fft.fftfreq(n_items, upsample_factor, dtype=f64,
                                  device=dev)
        rows = torch.arange(ups_size, dtype=f64, device=dev) - torch.as_tensor(
            ax_offset, dtype=f64, device=dev)
        theta = 2 * math.pi * rows[:, None] * freqs
        kernel = torch.complex(torch.cos(theta), -torch.sin(theta))
        # contracts the last axis and puts the region's axis first
        z = torch.tensordot(kernel, z, dims=([1], [z.ndim - 1]))
    return z.to(torch.complex64) if single else z


def _compute_phasediff(ccmax):
    """The global phase difference of the two images."""
    return torch.atan2(ccmax.imag, ccmax.real)


def _compute_error(ccmax, src_amp, target_amp):
    """The translation-invariant normalized RMS error."""
    error = 1.0 - (ccmax.real ** 2 + ccmax.imag ** 2) / (
        src_amp * target_amp)
    return torch.sqrt(torch.abs(error))


def _argmax_index(values):
    """The flat index of the first maximum and its coordinates as a
    float64 tensor (no read back)."""
    flat = torch.argmax(values.reshape(-1))
    coords, rest = [], flat
    for n in reversed(values.shape):
        coords.append(rest % n)
        rest = rest // n
    return flat, torch.stack(coords[::-1]).to(torch.float64)


def _spectrum(x):
    """``x``'s n-d FFT; integer and bool data transform as float64,
    half-precision data as float32."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64)
    elif x.dtype in (torch.float16, torch.bfloat16):
        x = x.to(torch.float32)
    return fft.fftn(x)


def _pcc_core(reference_image, moving_image, upsample_factor, return_error,
              fourier_space):
    """Shifts (float64), error, phase difference and a NaN flag, all on
    the images' device."""
    if fourier_space:
        src_freq, target_freq = reference_image, moving_image
    else:
        src_freq = _spectrum(reference_image)
        target_freq = _spectrum(moving_image)
    dev = src_freq.device
    f64 = torch.float64

    # whole-pixel shift: the cross-correlation by an inverse FFT
    shape = tuple(src_freq.shape)
    image_product = src_freq * target_freq.conj()
    cross_correlation = fft.ifftn(image_product)

    flat, shifts = _argmax_index(torch.abs(cross_correlation))
    midpoints = torch.tensor([np.fix(s / 2) for s in shape], dtype=f64,
                             device=dev)
    shape_t = torch.tensor(shape, dtype=f64, device=dev)
    shifts = torch.where(shifts > midpoints, shifts - shape_t, shifts)

    src_amp = target_amp = ccmax = None
    if upsample_factor == 1:
        if return_error:
            src_amp = torch.sum(torch.abs(src_freq) ** 2) / src_freq.numel()
            target_amp = (torch.sum(torch.abs(target_freq) ** 2)
                          / target_freq.numel())
            ccmax = cross_correlation.reshape(-1)[flat]
    else:
        # refine the estimate by the upsampled DFT around it
        shifts = torch.round(shifts * upsample_factor) / upsample_factor
        upsampled_region_size = math.ceil(upsample_factor * 1.5)
        dftshift = float(np.fix(upsampled_region_size / 2.0))
        upsample_factor = float(upsample_factor)
        sample_region_offset = dftshift - shifts * upsample_factor
        cross_correlation = _upsampled_dft(
            image_product.conj(), upsampled_region_size, upsample_factor,
            sample_region_offset,
        ).conj()
        power = (cross_correlation.real * cross_correlation.real
                 + cross_correlation.imag * cross_correlation.imag)
        flat, maxima = _argmax_index(power)
        ccmax = cross_correlation.reshape(-1)[flat]
        shifts = shifts + (maxima - dftshift) / upsample_factor
        if return_error:
            src_amp = torch.sum(torch.abs(src_freq) ** 2)
            target_amp = torch.sum(torch.abs(target_freq) ** 2)

    # a singleton dimension admits no shift
    singleton = [s == 1 for s in shape]
    if any(singleton):
        shifts = torch.where(torch.tensor(singleton, device=dev), 0.0,
                             shifts)

    if not return_error:
        return shifts, None, None, None
    nan_found = (torch.isnan(ccmax.real) | torch.isnan(ccmax.imag)
                 | torch.isnan(src_amp) | torch.isnan(target_amp))
    return (shifts, _compute_error(ccmax, src_amp, target_amp),
            _compute_phasediff(ccmax), nan_found)


def phase_cross_correlation(
    reference_image,
    moving_image,
    *,
    upsample_factor=1,
    space="real",
    return_error=True,
    reference_mask=None,
    moving_mask=None,
    overlap_ratio=0.3,
):
    """Subpixel image translation registration by cross-correlation.

    Returns ``shifts`` (float64), and ``error`` and ``phasediff`` when
    ``return_error``; with a mask, the masked normalized
    cross-correlation's shifts.
    """
    if (reference_mask is not None) or (moving_mask is not None):
        return _masked_phase_cross_correlation(
            reference_image,
            moving_image,
            reference_mask,
            moving_mask,
            overlap_ratio,
        )

    reference_image = util.as_tensor(reference_image)
    moving_image = util.as_tensor(moving_image,
                                  device=reference_image.device)
    if reference_image.shape != moving_image.shape:
        raise ValueError("images must be same shape")
    if space.lower() not in ("real", "fourier"):
        raise ValueError('space argument must be "real" of "fourier"')

    shifts, error, phasediff, nan_found = _pcc_core(
        reference_image,
        moving_image,
        int(upsample_factor),
        bool(return_error),
        space.lower() == "fourier",
    )
    if not return_error:
        return shifts
    if bool(nan_found):
        raise ValueError(
            "NaN values found, please remove NaNs from your "
            "input data or use the `reference_mask`/`moving_mask` "
            "keywords, eg: "
            "phase_cross_correlation(reference_image, moving_image, "
            "reference_mask=~np.isnan(reference_image), "
            "moving_mask=~np.isnan(moving_image))"
        )
    return shifts, error, phasediff
