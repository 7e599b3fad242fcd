"""Masked normalized cross-correlation (Padfield; skimage.registration.
_masked_phase_cross_correlation) on torch tensors.

Six forward and five inverse FFTs and elementwise normalisation, in
float64 (complex128 spectra on ``torch.fft``: cuFFT on the card),
whatever the inputs' dtype.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

from .._shared.fft import fftmodule, next_fast_len

__all__ = ["cross_correlate_masked"]


def _masked_phase_cross_correlation(
    reference_image,
    moving_image,
    reference_mask,
    moving_mask=None,
    overlap_ratio=0.3,
):
    """Translation registration by masked normalized cross-correlation:
    the shifts as a float64 tensor; exactly equal maxima are averaged."""
    reference_image = util.as_tensor(reference_image)
    dev = reference_image.device
    moving_image = util.as_tensor(moving_image, device=dev)
    reference_mask = util.as_tensor(reference_mask, device=dev)
    if moving_mask is None:
        if reference_image.shape != moving_image.shape:
            raise ValueError(
                "Input images have different shapes, moving_mask must "
                "be explicitely set."
            )
        moving_mask = reference_mask.to(torch.bool)
    moving_mask = util.as_tensor(moving_mask, device=dev)

    for im, mask in [
        (reference_image, reference_mask),
        (moving_image, moving_mask),
    ]:
        if im.shape != mask.shape:
            raise ValueError(
                "Image sizes must match their respective mask sizes."
            )

    xcorr = cross_correlate_masked(
        moving_image,
        reference_image,
        moving_mask,
        reference_mask,
        axes=tuple(range(moving_image.ndim)),
        mode="full",
        overlap_ratio=overlap_ratio,
    )

    # the average of several equal maxima
    maxima = torch.nonzero(xcorr == xcorr.max())
    center = maxima.to(torch.float64).mean(0)
    shifts = center - torch.tensor(reference_image.shape,
                                   dtype=torch.float64, device=dev) + 1
    size_mismatch = torch.tensor(
        [t - s for t, s in zip(moving_image.shape, reference_image.shape)],
        dtype=torch.float64, device=dev)
    return -shifts + size_mismatch / 2


def cross_correlate_masked(
    arr1, arr2, m1, m2, mode="full", axes=(-2, -1), overlap_ratio=0.3
):
    """Masked normalized cross-correlation of ``arr1`` and ``arr2`` over
    ``axes``, in float64, clipped to [-1, 1]; where fewer than
    ``overlap_ratio`` of the most overlapping pixels overlap, 0."""
    if mode not in {"full", "same"}:
        raise ValueError("Correlation mode {} is not valid.".format(mode))

    arr1 = util.as_tensor(arr1)
    dev = arr1.device
    arr2 = util.as_tensor(arr2, device=dev)
    if arr1.is_complex() or arr2.is_complex():
        raise ValueError("complex-valued arr1, arr2 are not supported")

    f64 = torch.float64
    fixed_image = arr1.to(f64)
    fixed_mask = util.as_tensor(m1, device=dev).to(torch.bool)
    moving_image = arr2.to(f64)
    moving_mask = util.as_tensor(m2, device=dev).to(torch.bool)
    eps = float(np.finfo(np.float64).eps)

    # the other axes must have equal lengths
    all_axes = set(range(fixed_image.ndim))
    axes = tuple(ax % fixed_image.ndim for ax in axes)
    for axis in all_axes - set(axes):
        if fixed_image.shape[axis] != moving_image.shape[axis]:
            raise ValueError(
                "Array shapes along non-transformation axes should be "
                "equal, but dimensions along axis {a} are not".format(
                    a=axis
                )
            )

    final_shape = list(arr1.shape)
    for axis in axes:
        final_shape[axis] = (
            fixed_image.shape[axis] + moving_image.shape[axis] - 1
        )
    final_slice = tuple(slice(0, int(sz)) for sz in final_shape)
    fast_shape = tuple(next_fast_len(final_shape[ax]) for ax in axes)

    fft = partial(fftmodule.fftn, s=fast_shape, dim=axes)
    ifft = partial(fftmodule.ifftn, s=fast_shape, dim=axes)

    fixed_image = torch.where(fixed_mask, fixed_image, 0.0)
    moving_image = torch.where(moving_mask, moving_image, 0.0)

    # the n-d analogue of a rotation by 180 degrees
    rotated_moving_image = torch.flip(moving_image, axes)
    rotated_moving_mask = torch.flip(moving_mask, axes)

    fixed_fft = fft(fixed_image)
    rotated_moving_fft = fft(rotated_moving_image)
    fixed_mask_fft = fft(fixed_mask.to(f64))
    rotated_moving_mask_fft = fft(rotated_moving_mask.to(f64))

    number_overlap_masked_px = torch.round(
        ifft(rotated_moving_mask_fft * fixed_mask_fft).real)
    number_overlap_masked_px = _fmax(number_overlap_masked_px, eps)
    masked_correlated_fixed_fft = ifft(rotated_moving_mask_fft * fixed_fft)
    masked_correlated_rotated_moving_fft = ifft(
        fixed_mask_fft * rotated_moving_fft)

    numerator = ifft(rotated_moving_fft * fixed_fft)
    numerator = numerator - (
        masked_correlated_fixed_fft
        * masked_correlated_rotated_moving_fft
        / number_overlap_masked_px
    )

    fixed_squared_fft = fft(fixed_image * fixed_image)
    fixed_denom = ifft(rotated_moving_mask_fft * fixed_squared_fft)
    fixed_denom = fixed_denom - (
        masked_correlated_fixed_fft * masked_correlated_fixed_fft
        / number_overlap_masked_px
    )
    fixed_denom = _fmax(fixed_denom.real, 0.0)

    rotated_moving_squared_fft = fft(
        rotated_moving_image * rotated_moving_image)
    moving_denom = ifft(fixed_mask_fft * rotated_moving_squared_fft)
    moving_denom = moving_denom - (
        masked_correlated_rotated_moving_fft
        * masked_correlated_rotated_moving_fft
        / number_overlap_masked_px
    )
    moving_denom = _fmax(moving_denom.real, 0.0)

    denom = torch.sqrt(fixed_denom * moving_denom)

    numerator = numerator[final_slice]
    denom = denom[final_slice]
    number_overlap_masked_px = number_overlap_masked_px[final_slice]

    if mode == "same":
        _centering = partial(_centered, newshape=fixed_image.shape,
                             axes=axes)
        denom = _centering(denom)
        numerator = _centering(numerator)
        number_overlap_masked_px = _centering(number_overlap_masked_px)

    # zero where the denominator is numerically negligible
    tol = 1e3 * eps * torch.amax(denom.abs(), dim=axes, keepdim=True)
    nonzero_indices = denom > tol
    out = torch.where(
        nonzero_indices,
        numerator.real / torch.where(nonzero_indices, denom, 1.0), 0.0)
    out = torch.clamp(out, -1, 1)

    # the overlap ratio threshold
    number_px_threshold = overlap_ratio * torch.amax(
        number_overlap_masked_px, dim=axes, keepdim=True)
    return torch.where(number_overlap_masked_px < number_px_threshold,
                       0.0, out)


def _fmax(x, v):
    """numpy's ``fmax(x, v)``: NaN gives ``v``."""
    return torch.fmax(x, torch.tensor(v, dtype=x.dtype, device=x.device))


def _centered(arr, newshape, axes):
    """The centre ``newshape`` portion of ``arr`` along ``axes``."""
    currshape = arr.shape
    slices = [slice(None, None)] * arr.ndim
    for ax in axes:
        startind = (currshape[ax] - newshape[ax]) // 2
        endind = startind + newshape[ax]
        slices[ax] = slice(startind, endind)
    return arr[tuple(slices)]
