"""``peak_local_max`` (skimage.feature) on torch tensors.

The candidate mask is ``maximum_filter`` with an all-ones footprint (on
a CUDA float32 image one launch of the fused separable kernel's max
op), compared with the image on the device.  The host sees the
trivial-plateau test (one bool), the mask's ``nonzero`` (one transfer)
and ``ensure_spacing``'s blocks; the coordinates are sorted by intensity
on the device.  With ``labels``, the boxes come from the port's
``find_objects`` and each label repeats those steps on its box.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.coord import ensure_spacing

__all__ = ["peak_local_max"]


def _get_excluded_border_width(image, min_distance, exclude_border):
    if isinstance(exclude_border, bool):
        return (min_distance if exclude_border else 0,) * image.ndim
    if isinstance(exclude_border, int):
        if exclude_border < 0:
            raise ValueError("`exclude_border` cannot be a negative value")
        return (exclude_border,) * image.ndim
    if isinstance(exclude_border, tuple):
        if len(exclude_border) != image.ndim:
            raise ValueError(
                "`exclude_border` should have the same length as the "
                "dimensionality of the image."
            )
        for ex in exclude_border:
            if not isinstance(ex, int) or ex < 0:
                raise ValueError(
                    "`exclude_border`, when expressed as a tuple, must only "
                    "contain ints."
                )
        return exclude_border
    raise TypeError(
        "`exclude_border` must be bool, int, or tuple with the same "
        "length as the dimensionality of the image."
    )


def _exclude_border(mask, border_width):
    """``mask`` with ``border_width`` samples at both ends of each axis
    set to zero (a copy)."""
    mask = mask.clone()
    for i, width in enumerate(border_width):
        if width == 0:
            continue
        mask[(slice(None),) * i + (slice(None, width),)] = 0
        mask[(slice(None),) * i + (slice(-width, None),)] = 0
    return mask


def _to_mask(coordinates, shape, device):
    peaks = torch.zeros(shape, dtype=torch.bool, device=device)
    if coordinates.shape[0]:
        peaks[tuple(coordinates.T)] = True
    return peaks


def peak_local_max(
    image,
    min_distance=1,
    threshold_abs=None,
    threshold_rel=None,
    exclude_border=True,
    indices=True,
    num_peaks=np.inf,
    footprint=None,
    labels=None,
    num_peaks_per_label=np.inf,
    p_norm=np.inf,
):
    """Coordinates of the local maxima, (N, ndim) int64 on the image's
    device, highest first; with ``indices=False`` a bool mask."""
    image = util.as_tensor(image)
    if indices is False:
        warnings.warn(
            "indices argument is deprecated and will be removed in "
            "version 0.20. To avoid this warning, please do not use the "
            "indices argument. Please see peak_local_max documentation "
            "for more details.",
            FutureWarning,
            stacklevel=2,
        )
    if (
        footprint is None or np.asarray(footprint).size == 1
    ) and min_distance < 1:
        warnings.warn(
            "When min_distance < 1, peak_local_max acts as finding "
            "image > max(threshold_abs, threshold_rel * max(image)).",
            RuntimeWarning,
            stacklevel=2,
        )
    border_width = _get_excluded_border_width(
        image, min_distance, exclude_border
    )
    work = dtypes.widen_unsigned(image)
    # the threshold stays on the device, a float64 scalar as cupyimg_tpu's
    # Python float: a floating image compares in its own dtype, an integer
    # one in float64
    f64 = torch.float64
    threshold = torch.amin(work).to(f64) if threshold_abs is None else (
        torch.tensor(threshold_abs, dtype=f64, device=image.device))
    if threshold_rel is not None:
        threshold = torch.maximum(
            threshold, threshold_rel * torch.amax(work).to(f64))

    if footprint is None:
        size = 2 * min_distance + 1
        footprint = np.ones((size,) * image.ndim, dtype=bool)
    else:
        if isinstance(footprint, torch.Tensor):
            footprint = footprint.cpu().numpy()
        footprint = np.asarray(footprint, dtype=bool)

    if labels is None:
        mask = _get_peak_mask(work, footprint, threshold)
        mask = _exclude_border(mask, border_width)
        coordinates = _get_high_intensity_peaks(
            work, mask, num_peaks, min_distance, p_norm
        )
    else:
        # each object's box on its own: a peak competes only with pixels
        # of its own label
        labels = util.as_tensor(labels, device=image.device)
        labels = dtypes.widen_unsigned(labels).to(torch.int64)
        _labels = _exclude_border(labels, border_width)
        if image.is_floating_point():
            bg_val = float(torch.finfo(image.dtype).min)
        else:
            bg_val = int(torch.iinfo(work.dtype).min) if (
                work.dtype == image.dtype) else 0
        objects = ndi.find_objects(_labels)
        labels_peak_coord = []
        for label_idx, roi in enumerate(objects):
            if roi is None:
                continue
            label_mask = labels[roi] == label_idx + 1
            img_object = torch.where(
                label_mask, work[roi],
                torch.tensor(bg_val, dtype=work.dtype, device=work.device))
            mask = _get_peak_mask(img_object, footprint, threshold,
                                  label_mask)
            coordinates = _get_high_intensity_peaks(
                img_object, mask, num_peaks_per_label, min_distance, p_norm,
            )
            if coordinates.shape[0]:
                starts = torch.tensor([s.start for s in roi],
                                      device=image.device)
                coordinates = coordinates + starts
            labels_peak_coord.append(coordinates.reshape(-1, image.ndim))
        if labels_peak_coord:
            coordinates = torch.cat(labels_peak_coord)
        else:
            coordinates = torch.empty((0, image.ndim), dtype=torch.int64,
                                      device=image.device)

        if coordinates.shape[0] > num_peaks:
            out = _to_mask(coordinates, image.shape, image.device)
            coordinates = _get_high_intensity_peaks(
                work, out, num_peaks, min_distance, p_norm
            )

    coordinates = coordinates.reshape(-1, image.ndim)
    if indices:
        return coordinates
    return _to_mask(coordinates, image.shape, image.device)


def _get_peak_mask(image, footprint, threshold, mask=None):
    """The candidate peaks: equal to the footprint's maximum, not on a
    plateau that covers the whole image (or label), above
    ``threshold``."""
    if footprint.size == 1 or image.numel() == 1:
        return image > threshold
    image_max = ndi.maximum_filter(image, footprint=footprint,
                                   mode="constant")
    out = image == image_max
    image_is_trivial = bool(torch.all(out)) if mask is None else bool(
        torch.all(out[mask]))
    if image_is_trivial:
        out = torch.zeros_like(out)
        if mask is not None:
            # isolated pixels of the masked area still count as peaks
            isolated_px = torch.logical_xor(mask, ndi.binary_opening(mask))
            out = out | isolated_px
    return out & (image > threshold)


def _get_high_intensity_peaks(image, mask, num_peaks, min_distance,
                              p_norm):
    """The mask's coordinates, highest intensity first (ties in raster
    order), thinned to ``min_distance``."""
    coord = torch.nonzero(mask)
    if coord.shape[0]:
        intensities = image[tuple(coord.T)]
        order = torch.argsort(intensities, descending=True, stable=True)
        coord = coord[order]
    coord = ensure_spacing(coord, spacing=min_distance,
                           p_norm=p_norm).reshape(-1, mask.ndim)
    if coord.shape[0] > num_peaks:
        coord = coord[: int(num_peaks)]
    return coord


def _prominent_peaks(
    image, min_xdistance=1, min_ydistance=1, threshold=None,
    num_peaks=np.inf,
):
    """Peaks with axis-wise non-maximum suppression (for Hough-style
    accumulators).  The two 1-d maximum filters and the candidate mask
    run on the device; the sequential suppression runs on the host over
    the candidates, the columns wrapping around."""
    from cupyimg_tpu_torch.skimage import measure

    img = util.as_tensor(image)
    rows, cols = img.shape

    if threshold is None:
        threshold = 0.5 * float(torch.amax(img))

    ycoords_size = 2 * min_ydistance + 1
    xcoords_size = 2 * min_xdistance + 1
    img_max = ndi.maximum_filter1d(
        img, size=ycoords_size, axis=0, mode="constant", cval=0
    )
    img_max = ndi.maximum_filter1d(
        img_max, size=xcoords_size, axis=1, mode="constant", cval=0
    )
    mask = img == img_max
    img = img * mask
    img_t = img > threshold

    label_img = measure.label(img_t)
    props = measure.regionprops(label_img, img_max)
    # by intensity, not position: a strong peak must not be suppressed
    # by a weaker neighbour
    props = sorted(props, key=lambda x: float(x.max_intensity))[::-1]
    coords = np.asarray(
        [np.round(np.asarray(p.centroid, dtype=float)) for p in props],
        dtype=int,
    ).reshape(-1, 2)

    img_max_np = img_max.cpu().numpy().copy()
    img_peaks = []
    ycoords_peaks = []
    xcoords_peaks = []

    ycoords_ext, xcoords_ext = np.mgrid[
        -min_ydistance: min_ydistance + 1,
        -min_xdistance: min_xdistance + 1,
    ]
    for ycoords_idx, xcoords_idx in coords:
        accum = img_max_np[ycoords_idx, xcoords_idx]
        if accum > threshold:
            ycoords_nh = ycoords_idx + ycoords_ext
            xcoords_nh = xcoords_idx + xcoords_ext

            # no reflection for the row neighbourhood
            ycoords_in = np.logical_and(ycoords_nh > 0, ycoords_nh < rows)
            ycoords_nh = ycoords_nh[ycoords_in]
            xcoords_nh = xcoords_nh[ycoords_in]

            # the columns wrap (continuous axes, such as Hough angles)
            xcoords_low = xcoords_nh < 0
            ycoords_nh[xcoords_low] = rows - ycoords_nh[xcoords_low]
            xcoords_nh[xcoords_low] += cols
            xcoords_high = xcoords_nh >= cols
            ycoords_nh[xcoords_high] = rows - ycoords_nh[xcoords_high]
            xcoords_nh[xcoords_high] -= cols

            img_max_np[ycoords_nh, xcoords_nh] = 0
            img_peaks.append(accum)
            ycoords_peaks.append(ycoords_idx)
            xcoords_peaks.append(xcoords_idx)

    img_peaks = np.asarray(img_peaks)
    ycoords_peaks = np.asarray(ycoords_peaks)
    xcoords_peaks = np.asarray(xcoords_peaks)

    if num_peaks < len(img_peaks):
        idx_maxsort = np.argsort(img_peaks)[::-1][: int(num_peaks)]
        img_peaks = img_peaks[idx_maxsort]
        ycoords_peaks = ycoords_peaks[idx_maxsort]
        xcoords_peaks = xcoords_peaks[idx_maxsort]

    device = img.device
    return (
        torch.as_tensor(img_peaks, device=device),
        torch.as_tensor(xcoords_peaks, device=device),
        torch.as_tensor(ycoords_peaks, device=device),
    )
