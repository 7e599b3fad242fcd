"""Image warping (skimage.transform) on torch tensors.

The geometry becomes an ndimage call:

- a 2-D image under a homography of affine form goes to
  ``ndi.affine_transform`` (on a CUDA float32 image one launch of the
  spline gather's affine entry);
- every other map is a dense float64 coordinate array
  (:func:`warp_coords`) that goes to ``ndi.map_coordinates`` (the
  gather's map entry);
- ``resize``, ``rescale`` and the pyramids smooth with ``gaussian_filter``
  (the fused separable kernel for CUDA float32 data) and resample with
  ``zoom(grid_mode=True)`` (the gather's affine entry).

Orders above 1 prefilter first (one fused separable launch per pole on a
CUDA float32 image).  Coordinates are formed by multiply-adds in float64,
never by ``torch.matmul``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.utils import (
    NUMPY_PAD_TO_NDIMAGE,
    _validate_interpolation_order,
    convert_to_float,
    safe_as_int,
)
from cupyimg_tpu_torch.skimage.measure.block import block_reduce
from cupyimg_tpu_torch.skimage.transform._geometric import (
    AffineTransform,
    ProjectiveTransform,
    SimilarityTransform,
)

__all__ = [
    "warp",
    "warp_coords",
    "warp_polar",
    "resize",
    "rescale",
    "rotate",
    "swirl",
    "downscale_local_mean",
]

HOMOGRAPHY_TRANSFORMS = (
    SimilarityTransform,
    AffineTransform,
    ProjectiveTransform,
)

_NDIMAGE_MODES = ("constant", "nearest", "reflect", "mirror", "wrap",
                  "grid-constant", "grid-mirror", "grid-wrap")


def _to_ndimage_mode(mode):
    """A skimage (numpy.pad) mode name as the ndimage mode; an ndimage
    name passes through.  Any other name raises ValueError, as skimage's
    does, before any filter runs."""
    if mode in NUMPY_PAD_TO_NDIMAGE:
        return NUMPY_PAD_TO_NDIMAGE[mode]
    if mode in _NDIMAGE_MODES:
        return mode
    raise ValueError(
        f"Unknown mode: '{mode}', or cannot translate mode. The mode "
        f"should be one of 'constant', 'edge', 'symmetric', 'reflect', or "
        f"'wrap'. See the documentation of numpy.pad for more info.")


def _clip_warp_output(input_image, output_image, mode, cval, clip):
    """Clip the output to the input's intensity range (and ``cval`` in
    mode 'constant'); the bounds stay tensors, no host sync."""
    if not clip or output_image.is_complex():
        return output_image
    min_val = torch.amin(input_image).to(output_image.dtype)
    max_val = torch.amax(input_image).to(output_image.dtype)
    if mode == "constant":
        c = torch.tensor(float(cval), dtype=output_image.dtype,
                         device=output_image.device)
        min_val = torch.minimum(min_val, c)
        max_val = torch.maximum(max_val, c)
    return torch.clamp(output_image, min_val, max_val)


def warp_coords(coord_map, shape, dtype=np.float64, *, device=None):
    """The coordinate array for warping: ``coord_map`` maps output
    (col, row) points, an (N, 2) tensor, to input (col, row) points.
    Built on ``device`` (default ``config.device``)."""
    shape = tuple(shape)
    rows, cols = shape[0], shape[1]
    if device is None:
        device = util.as_tensor(0).device
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    kw = dict(dtype=tdt, device=device)
    cc, rr = torch.meshgrid(torch.arange(cols, **kw),
                            torch.arange(rows, **kw), indexing="xy")
    tf_coords = torch.stack([cc, rr], dim=-1).reshape(-1, 2)
    del cc, rr
    mapped = util.as_tensor(coord_map(tf_coords), device=device).to(tdt)
    # (x, y) -> rows = y, cols = x
    map_rows = mapped[:, 1].reshape(rows, cols)
    map_cols = mapped[:, 0].reshape(rows, cols)
    if len(shape) == 2:
        return torch.stack([map_rows, map_cols], dim=0)
    # several channels: the identity map over the last axis
    nch = shape[2]
    full = (rows, cols, nch)
    return torch.stack(
        [
            map_rows[..., None].expand(full),
            map_cols[..., None].expand(full),
            torch.arange(nch, **kw).expand(full),
        ],
        dim=0,
    )


def warp(
    image,
    inverse_map,
    map_args=None,
    output_shape=None,
    order=None,
    mode="constant",
    cval=0.0,
    clip=True,
    preserve_range=False,
):
    """Warp an image by an inverse coordinate map: a transform, a
    callable, a 3x3 matrix or a dense coordinate array."""
    if map_args is None:
        map_args = {}
    image = util.as_tensor(image)
    if image.numel() == 0:
        raise ValueError("Cannot warp empty image with dimensions")
    order = _validate_interpolation_order(image.dtype, order)
    if not image.is_complex():
        # always float (bool and integers too), scaled unless
        # preserve_range
        image = convert_to_float(image, preserve_range)
    input_shape = tuple(image.shape)
    if output_shape is None:
        output_shape = input_shape
    else:
        output_shape = tuple(int(s) for s in safe_as_int(output_shape))
    ndi_mode = _to_ndimage_mode(mode)

    if isinstance(inverse_map, torch.Tensor) and tuple(
            inverse_map.shape) == (3, 3):
        inverse_map = inverse_map.detach().cpu().numpy()
    if isinstance(inverse_map, np.ndarray) and inverse_map.shape == (3, 3):
        inverse_map = ProjectiveTransform(matrix=inverse_map)

    # an affine-form homography of a 2-D image: ndi.affine_transform, the
    # gather's affine entry; skimage's (x, y) becomes ndimage's (row, col)
    if (
        isinstance(inverse_map, HOMOGRAPHY_TRANSFORMS)
        and image.ndim == 2
        and len(output_shape) == 2
    ):
        H = np.asarray(inverse_map.params)
        if H.shape == (3, 3) and np.allclose(H[2], [0, 0, 1]):
            mat_rc = np.array(
                [[H[1, 1], H[1, 0]], [H[0, 1], H[0, 0]]]
            )
            off_rc = np.array([H[1, 2], H[0, 2]])
            warped = ndi.affine_transform(
                image,
                mat_rc,
                offset=off_rc,
                output_shape=output_shape,
                order=order,
                mode=ndi_mode,
                cval=cval,
                prefilter=order > 1,
                allow_float32=image.dtype != torch.float64,
            )
            return _clip_warp_output(image, warped, mode, cval, clip)

    if isinstance(inverse_map, (np.ndarray, torch.Tensor)) and (
        inverse_map.ndim >= 2 and inverse_map.shape[0] == image.ndim
    ):
        # a dense coordinate array in (row, col, ...) order
        coords = util.as_tensor(inverse_map, device=image.device)
    elif callable(inverse_map) or isinstance(
        inverse_map, HOMOGRAPHY_TRANSFORMS
    ):
        if image.ndim < 2 or image.ndim > 3:
            raise ValueError(
                "Only 2-D images (grayscale or color) are supported, "
                "when providing a callable `inverse_map`."
            )
        if isinstance(inverse_map, HOMOGRAPHY_TRANSFORMS):
            def coord_map(c):
                return inverse_map(c)
        else:
            def coord_map(c):
                return inverse_map(c, **map_args)

        if len(input_shape) == 3 and len(output_shape) == 2:
            output_shape = tuple(output_shape) + (input_shape[2],)
        coords = warp_coords(coord_map, output_shape, device=image.device)
    else:
        raise ValueError("Invalid `inverse_map` argument")

    warped = ndi.map_coordinates(
        image, coords, prefilter=order > 1, mode=ndi_mode, order=order,
        cval=cval,
    )
    return _clip_warp_output(image, warped, mode, cval, clip)


def resize(
    image,
    output_shape,
    order=None,
    mode="reflect",
    cval=0,
    clip=True,
    preserve_range=False,
    anti_aliasing=None,
    anti_aliasing_sigma=None,
):
    """Resize an image: a gaussian anti-aliasing filter when it shrinks,
    then ``zoom(grid_mode=True)``."""
    image = util.as_tensor(image)
    output_shape = tuple(int(s) for s in safe_as_int(output_shape))
    input_shape = tuple(image.shape)
    if len(output_shape) > image.ndim:
        # append channel axes
        input_shape = input_shape + (1,) * (len(output_shape) - image.ndim)
        image = image.reshape(input_shape)
    elif len(output_shape) == image.ndim - 1:
        # several channels: keep the last axis
        output_shape = output_shape + (input_shape[-1],)
    elif len(output_shape) < image.ndim - 1:
        raise ValueError(
            "len(output_shape) cannot be smaller than the image dimensions"
        )

    factors = np.asarray(input_shape, dtype=float) / np.asarray(
        output_shape, dtype=float
    )
    order = _validate_interpolation_order(image.dtype, order)
    ndi_mode = _to_ndimage_mode(mode)

    is_bool = image.dtype == torch.bool
    if anti_aliasing is None:
        anti_aliasing = not is_bool and any(
            x < y for x, y in zip(output_shape, input_shape))
    if is_bool and anti_aliasing:
        warnings.warn(
            "Input image dtype is bool. Gaussian convolution is not "
            "defined with bool data type. Please set anti_aliasing to "
            "False or explicitly cast input image to another data type. "
            "Starting from version 0.19 a ValueError will be raised "
            "instead of this warning.",
            FutureWarning,
            stacklevel=2,
        )
    # every non-complex input becomes float (img_as_float's scaling
    # unless preserve_range), for order 0 too
    if not image.is_complex():
        image = convert_to_float(image, preserve_range)

    if anti_aliasing:
        if anti_aliasing_sigma is None:
            anti_aliasing_sigma = np.maximum(0, (factors - 1) / 2)
        else:
            anti_aliasing_sigma = np.atleast_1d(
                np.asarray(anti_aliasing_sigma, dtype=float)
            ) * np.ones_like(factors)
            if np.any(anti_aliasing_sigma < 0):
                raise ValueError(
                    "Anti-aliasing standard deviation must be "
                    "greater than or equal to zero"
                )
            elif np.any((anti_aliasing_sigma > 0) & (factors <= 1)):
                warnings.warn(
                    "Anti-aliasing standard deviation greater than zero "
                    "but not down-sampling along all axes"
                )
        image = ndi.gaussian_filter(
            image, [float(s) for s in anti_aliasing_sigma], cval=cval,
            mode=ndi_mode,
        )

    zoom_factors = [1 / f for f in factors]
    out = ndi.zoom(
        image, zoom_factors, order=order, mode=ndi_mode, cval=cval,
        grid_mode=True,
    )
    if tuple(out.shape) != tuple(output_shape):
        # a rounding mismatch of the zoom's shape
        out = out[tuple(slice(0, s) for s in output_shape)]
    return _clip_warp_output(image, out, mode, cval, clip)


def rescale(
    image,
    scale,
    order=None,
    mode="reflect",
    cval=0,
    clip=True,
    preserve_range=False,
    multichannel=False,
    anti_aliasing=None,
    anti_aliasing_sigma=None,
):
    """Rescale an image by a factor (one, or one per spatial axis)."""
    image = util.as_tensor(image)
    scale = np.atleast_1d(np.asarray(scale, dtype=float))
    if len(scale) > 1:
        if (not multichannel and len(scale) != image.ndim) or (
            multichannel and len(scale) != image.ndim - 1
        ):
            raise ValueError(
                "Supply a single scale, or one value per spatial axis"
            )
        if multichannel:
            scale = np.concatenate((scale, [1]))
    orig_shape = np.asarray(image.shape)
    output_shape = np.round(scale * orig_shape[: len(scale)])
    if scale.size == 1:
        output_shape = np.round(scale * orig_shape)
        if multichannel:
            output_shape[-1] = orig_shape[-1]
    return resize(
        image, tuple(int(s) for s in output_shape), order=order, mode=mode,
        cval=cval, clip=clip, preserve_range=preserve_range,
        anti_aliasing=anti_aliasing,
        anti_aliasing_sigma=anti_aliasing_sigma,
    )


def _corners_inverse(tform, rows, cols):
    """The image corners under ``tform.inverse``, on the host from its
    float64 params (no device work)."""
    corners = np.array(
        [[0, 0], [0, rows - 1], [cols - 1, rows - 1], [cols - 1, 0]],
        dtype=np.float64,
    )
    m = np.linalg.inv(tform.params)
    h = corners @ m[:2, :2].T + m[:2, 2]
    w = corners @ m[2, :2] + m[2, 2]
    w = np.where(w == 0, np.finfo(np.float64).eps, w)
    return h / w[:, None]


def rotate(
    image, angle, resize=False, center=None, order=None, mode="constant",
    cval=0, clip=True, preserve_range=False,
):
    """Rotate a 2-D image (or each channel) by ``angle`` degrees about
    its centre, counter-clockwise."""
    image = util.as_tensor(image)
    rows, cols = image.shape[0], image.shape[1]
    if center is None:
        center = np.array((cols, rows)) / 2.0 - 0.5
    else:
        center = np.asarray(center, dtype=float)
    tform1 = SimilarityTransform(translation=center)
    tform2 = SimilarityTransform(rotation=np.deg2rad(angle))
    tform3 = SimilarityTransform(translation=-center)
    tform = tform3 + tform2 + tform1

    output_shape = None
    if resize:
        corners = _corners_inverse(tform, rows, cols)
        minc = corners[:, 0].min()
        minr = corners[:, 1].min()
        maxc = corners[:, 0].max()
        maxr = corners[:, 1].max()
        out_rows = maxr - minr + 1
        out_cols = maxc - minc + 1
        output_shape = np.around((out_rows, out_cols))
        # fit the output image in the new shape
        translation = (minc, minr)
        tform4 = SimilarityTransform(translation=translation)
        tform = tform4 + tform
    tform.params[2] = (0, 0, 1)
    return warp(
        image, tform, output_shape=output_shape, order=order, mode=mode,
        cval=cval, clip=clip, preserve_range=preserve_range,
    )


def swirl(
    image, center=None, strength=1, radius=100, rotation=0,
    output_shape=None, order=None, mode="reflect", cval=0, clip=True,
    preserve_range=False,
):
    """Swirl distortion."""
    image = util.as_tensor(image)
    if center is None:
        center = np.array(image.shape)[:2][::-1] / 2
    # the swirl decays to ~1/1000 at `radius`
    radius = radius / 5 * math.log(2)
    x0, y0 = (float(v) for v in center)

    def _swirl_mapping(xy):
        x, y = xy[:, 0], xy[:, 1]
        rho = torch.sqrt((x - x0) ** 2 + (y - y0) ** 2)
        theta = rotation + strength * torch.exp(-rho / radius) + \
            torch.atan2(y - y0, x - x0)
        xr = x0 + rho * torch.cos(theta)
        yr = y0 + rho * torch.sin(theta)
        return torch.stack([xr, yr], dim=-1)

    return warp(
        image, _swirl_mapping, output_shape=output_shape, order=order,
        mode=mode, cval=cval, clip=clip, preserve_range=preserve_range,
    )


def warp_polar(
    image, center=None, *, radius=None, output_shape=None,
    scaling="linear", multichannel=False, **kwargs,
):
    """Polar (or log-polar) warp: output rows are angles, columns radii."""
    image = util.as_tensor(image)
    if image.ndim != 2 and not multichannel:
        raise ValueError(
            "Input array must be 2 dimensions when `multichannel=False`, "
            f"got {image.ndim}"
        )
    if image.ndim != 3 and multichannel:
        raise ValueError(
            "Input array must be 3 dimensions when `multichannel=True`, "
            f"got {image.ndim}"
        )
    if center is None:
        center = (np.array(image.shape)[:2] / 2) - 0.5
    if radius is None:
        w, h = np.array(image.shape)[:2] / 2
        radius = np.sqrt(w ** 2 + h ** 2)
    if output_shape is None:
        height = 360
        width = int(np.ceil(radius))
        output_shape = (height, width)
    else:
        output_shape = safe_as_int(output_shape)
        height = output_shape[0]
        width = output_shape[1]
    if scaling == "linear":
        k_radius = width / radius
        map_func = _linear_polar_mapping
    elif scaling == "log":
        k_radius = width / math.log(radius)
        map_func = _log_polar_mapping
    else:
        raise ValueError("Scaling value must be in {'linear', 'log'}")
    k_angle = height / (2 * np.pi)
    center_xy = tuple(float(v) for v in np.asarray(center)[::-1])

    def coord_map(xy):
        return map_func(xy, k_angle, k_radius, center_xy)

    return warp(image, coord_map,
                output_shape=tuple(int(s) for s in output_shape), **kwargs)


def _linear_polar_mapping(output_coords, k_angle, k_radius, center):
    angle = output_coords[:, 1] / k_angle
    rr = output_coords[:, 0] / k_radius
    coord_x = rr * torch.cos(angle) + center[0]
    coord_y = rr * torch.sin(angle) + center[1]
    return torch.stack([coord_x, coord_y], dim=-1)


def _log_polar_mapping(output_coords, k_angle, k_radius, center):
    angle = output_coords[:, 1] / k_angle
    rr = torch.exp(output_coords[:, 0] / k_radius)
    coord_x = rr * torch.cos(angle) + center[0]
    coord_y = rr * torch.sin(angle) + center[1]
    return torch.stack([coord_x, coord_y], dim=-1)


def _mean(blocks, axis):
    """The block mean; integer and bool blocks in float64, as numpy's."""
    if not (blocks.is_floating_point() or blocks.is_complex()):
        blocks = blocks.to(torch.float64)
    return torch.mean(blocks, dim=axis)


def downscale_local_mean(image, factors, cval=0, clip=True):
    """Downsample by the mean of local blocks (``block_reduce``)."""
    return block_reduce(image, factors, _mean, cval)
