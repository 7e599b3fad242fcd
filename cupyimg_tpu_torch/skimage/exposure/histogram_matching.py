"""``match_histograms`` (skimage.exposure) on torch tensors."""

from __future__ import annotations

import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.skimage.exposure.exposure import _interp

__all__ = ["match_histograms"]


def _match_cumulative_cdf(source, template):
    """``source``'s values mapped so that their CDF matches
    ``template``'s (float64): each value's quantile among the source's
    values, read off the template's sorted values."""
    src = dtypes.widen_unsigned(source).reshape(-1).contiguous()
    tmpl = dtypes.widen_unsigned(template).reshape(-1)
    src_sorted = torch.sort(src).values
    # the rank of each pixel's value: the count of values <= it
    src_rank = torch.searchsorted(src_sorted, src, right=True)
    src_quantiles = src_rank.to(torch.float64) / src.shape[0]
    tmpl_sorted = torch.sort(tmpl).values.to(torch.float64)
    tmpl_quantiles = (torch.arange(tmpl.shape[0], dtype=torch.float64,
                                   device=tmpl.device) + 1) / tmpl.shape[0]
    interp = _interp(src_quantiles, tmpl_quantiles, tmpl_sorted)
    return interp.reshape(source.shape)


def match_histograms(image, reference, multichannel=False,
                     channel_axis=None):
    """Adjust ``image`` so that its histogram matches ``reference``'s
    (per channel, on the last axis, with ``multichannel`` or
    ``channel_axis``); float64."""
    image = util.as_tensor(image)
    reference = util.as_tensor(reference, device=image.device)
    if channel_axis is not None:
        multichannel = True
    if image.ndim != reference.ndim:
        raise ValueError(
            "Image and reference must have the same number of channels."
        )
    if multichannel:
        if image.shape[-1] != reference.shape[-1]:
            raise ValueError(
                "Number of channels in the input image and reference image "
                "must match!"
            )
        matched = [
            _match_cumulative_cdf(image[..., c], reference[..., c])
            for c in range(image.shape[-1])
        ]
        return torch.stack(matched, dim=-1)
    return _match_cumulative_cdf(image, reference)
