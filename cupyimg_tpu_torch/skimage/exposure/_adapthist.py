"""Contrast Limited Adaptive Histogram Equalization (CLAHE,
skimage.exposure.equalize_adapthist) on torch tensors.

Pad, bin, per-tile histograms, clip and redistribute, per-tile mapping
tables, and a multilinear blend between neighbouring tiles, all on the
device: the tiles' histograms are one ``bincount`` over ``tile * nbins +
bin``.  The excess above the clip limit is redistributed in four
fractional passes rather than skimage's data-dependent integer loop, so
the mapping departs from skimage's by at most one grey level of 2^14.  A
colour image equalizes the value channel of its HSV form.
"""

from __future__ import annotations

import itertools
import math
import numbers

import numpy as np
import torch

from cupyimg_tpu_torch.core import boundary, util
from cupyimg_tpu_torch.skimage.exposure.exposure import rescale_intensity
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float, img_as_uint

NR_OF_GRAY = 2 ** 14

__all__ = ["equalize_adapthist"]


def equalize_adapthist(image, kernel_size=None, clip_limit=0.01, nbins=256):
    """CLAHE: float64 in [0, 1]; an RGB(A) image equalizes the HSV value
    channel and returns RGB."""
    image = util.as_tensor(image)
    if image.ndim == 3 and image.shape[-1] in (3, 4):
        from cupyimg_tpu_torch.skimage.color.colorconv import (
            hsv2rgb,
            rgb2hsv,
            rgba2rgb,
        )

        if image.shape[-1] == 4:
            image = rgba2rgb(image)
        hsv = rgb2hsv(image)
        v_eq = equalize_adapthist(hsv[..., 2], kernel_size, clip_limit, nbins)
        hsv = hsv.clone()
        hsv[..., 2] = v_eq
        return hsv2rgb(hsv)

    image = img_as_uint(image)
    image = torch.round(
        rescale_intensity(image.to(torch.float64),
                          out_range=(0, NR_OF_GRAY - 1))
    ).to(torch.int32)

    if kernel_size is None:
        kernel_size = tuple(image.shape[dim] // 8 for dim in range(image.ndim))
    elif isinstance(kernel_size, numbers.Number):
        kernel_size = (int(kernel_size),) * image.ndim
    elif len(kernel_size) != image.ndim:
        raise ValueError(f"Incorrect value of `kernel_size`: {kernel_size}")
    kernel_size = [max(int(k), 1) for k in kernel_size]

    out = _clahe(image, kernel_size, clip_limit, nbins)
    out = img_as_float(out.to(torch.uint16))
    return rescale_intensity(out)


def _interleave(ns, ks):
    """The shape ``(n0, k0, n1, k1, ...)`` of tiles of ``k`` pixels."""
    shape = []
    for n, k in zip(ns, ks):
        shape += [n, k]
    return shape


def _clahe(image, kernel_size, clip_limit, nbins):
    ndim = image.ndim
    device = image.device

    pad_start = [k // 2 for k in kernel_size]
    pad_end = [
        (k - s % k) % k + math.ceil(k / 2.0)
        for k, s in zip(kernel_size, image.shape)
    ]
    # numpy's 'reflect' is ndimage's 'mirror'
    image = boundary.pad(image, list(zip(pad_start, pad_end)), "mirror")

    bin_size = 1 + NR_OF_GRAY // nbins
    binned = (image // bin_size).to(torch.int64)  # values in [0, nbins)

    # ---- one histogram per interior tile, one bincount for all
    ns_hist = [s // k - 1 for s, k in zip(image.shape, kernel_size)]
    hist_slices = tuple(
        slice(k // 2, k // 2 + n * k) for k, n in zip(kernel_size, ns_hist)
    )
    order = tuple(range(0, 2 * ndim, 2)) + tuple(range(1, 2 * ndim, 2))
    tiles = binned[hist_slices].reshape(
        _interleave(ns_hist, kernel_size)).permute(order)
    n_tiles = int(np.prod(ns_hist))
    tile_pixels = int(np.prod(kernel_size))
    flat_tiles = tiles.reshape(n_tiles, tile_pixels)
    offsets = torch.arange(n_tiles, device=device)[:, None] * nbins
    hist = torch.bincount((flat_tiles + offsets).reshape(-1),
                          minlength=n_tiles * nbins)
    hist = hist.reshape(n_tiles, nbins).to(torch.float32)

    # ---- clip, and redistribute the excess in four fractional passes
    if clip_limit > 0.0:
        clim = float(max(clip_limit * tile_pixels, 1))
        for _ in range(4):
            excess = torch.sum(torch.clamp(hist - clim, min=0), dim=-1,
                               keepdim=True)
            hist = torch.clamp(hist, max=clim)
            hist = hist + excess / nbins
        hist = torch.clamp(hist, max=clim)

    # ---- per-tile mapping: the scaled cumulative histogram
    lut = torch.cumsum(hist, dim=-1) * ((NR_OF_GRAY - 1) / tile_pixels)
    lut = torch.clamp(lut, max=NR_OF_GRAY - 1).to(torch.int32)
    lut = lut.reshape(tuple(ns_hist) + (nbins,))
    # the edge tiles' mappings repeated, so that every tile has 2^ndim
    # neighbours
    lut = boundary.pad(lut, [(1, 1)] * ndim + [(0, 0)], "nearest")

    # ---- multilinear blend over the processing tiles (float64)
    ns_proc = [s // k for s, k in zip(image.shape, kernel_size)]
    blocks = binned.reshape(_interleave(ns_proc, kernel_size)).permute(order)
    blocks_shape = blocks.shape
    n_proc = int(np.prod(ns_proc))
    blocks_flat = blocks.reshape(n_proc, -1)

    # the interpolation coefficient within a tile along each axis
    coeff_1d = [torch.arange(k, dtype=torch.float64, device=device) / k
                for k in kernel_size]
    coeff_flat = [c.reshape(-1)
                  for c in torch.meshgrid(*coeff_1d, indexing="ij")]

    result = torch.zeros(blocks_flat.shape, dtype=torch.float64,
                         device=device)
    for edge in itertools.product(*((0, 1),) * ndim):
        edge_maps = lut[
            tuple(slice(e, e + n) for e, n in zip(edge, ns_proc))
        ].reshape(n_proc, nbins)
        mapped = torch.gather(edge_maps, 1, blocks_flat)
        w = None
        for d, e in enumerate(edge):
            f = coeff_flat[d] if e else 1.0 - coeff_flat[d]
            w = f if w is None else w * f
        result = result + mapped.to(torch.float32) * w[None, :]

    result = result.reshape(blocks_shape)
    # undo the (tile, within-tile) interleave
    inv_order = []
    for d in range(ndim):
        inv_order += [d, ndim + d]
    result = result.permute(inv_order).reshape(image.shape)
    unpad = tuple(
        slice(a, s - b) for a, b, s in zip(pad_start, pad_end, image.shape)
    )
    return result[unpad]


def clip_histogram(hist, clip_limit):
    """Clip a histogram (float64; last axis the bins) at ``clip_limit``
    and redistribute the excess over the bins below the limit: first an
    even increment, then one count a bin per round to the first bins
    below the limit, until no excess or no room is left.  Mass is
    conserved and no bin exceeds the limit.  Each round's exit test reads
    one flag on the host."""
    hist = util.as_tensor(hist).to(torch.float64)
    size = hist.shape[-1]
    excess = torch.sum(torch.clamp(hist - clip_limit, min=0), dim=-1,
                       keepdim=True)
    clipped = torch.clamp(hist, max=clip_limit)

    # the even increment
    bin_incr = torch.floor(excess / size)
    upper = clip_limit - bin_incr
    mid = (clipped >= upper) & (clipped < clip_limit)
    used = torch.sum(torch.where(mid, clip_limit - clipped, 0.0), dim=-1,
                     keepdim=True) + torch.sum(
        torch.where(clipped < upper, bin_incr, 0.0), dim=-1, keepdim=True)
    clipped = torch.where(mid, clip_limit, clipped)
    clipped = torch.where(clipped < upper, clipped + bin_incr, clipped)
    excess = torch.clamp(excess - used, min=0)

    # the rest one count at a time
    while True:
        under = clipped < clip_limit
        if not bool(torch.any((excess >= 1)
                              & torch.any(under, dim=-1, keepdim=True))):
            break
        k = torch.minimum(torch.floor(excess),
                          under.sum(dim=-1, keepdim=True).to(torch.float64))
        take = under & (torch.cumsum(under.to(torch.int64), dim=-1) <= k)
        inc = torch.clamp(clip_limit - clipped, max=1.0)
        clipped = torch.where(take, clipped + inc, clipped)
        excess = excess - torch.sum(torch.where(take, inc, 0.0), dim=-1,
                                    keepdim=True)
    return clipped


def map_histogram(hist, min_val, max_val, n_pixels):
    """The equalizing lookup table of a (clipped) histogram: its
    cumulative sum scaled to ``[min_val, max_val]``, int64."""
    hist = util.as_tensor(hist)
    out = torch.cumsum(hist, dim=-1).to(torch.float64)
    out = out * (max_val - min_val) / n_pixels
    out = out + min_val
    out = torch.clamp(out, max=max_val)
    return out.to(torch.int64)
