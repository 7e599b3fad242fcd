"""rank_order (skimage.filters) on torch tensors."""

from __future__ import annotations

import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = ["rank_order"]


def rank_order(image):
    """Each pixel's rank among the image's distinct values, and those
    values sorted: ``(labels, original_values)``.  The ranks are counted
    in int64 and cast to uint32 at the end, and unsigned images are
    sorted in a signed type that holds them (torch has few kernels of the
    wide unsigned types); the unique values' count is one read back."""
    image = util.as_tensor(image)
    flat = dtypes.widen_unsigned(image.reshape(-1))
    sorted_vals, sort_order = torch.sort(flat, stable=True)
    is_new = torch.ones(flat.shape, dtype=torch.bool, device=flat.device)
    is_new[1:] = sorted_vals[1:] != sorted_vals[:-1]
    ranks_sorted = torch.cumsum(is_new[1:].to(torch.int64), 0)
    labels = torch.zeros(flat.shape, dtype=torch.int64, device=flat.device)
    labels[sort_order[1:]] = ranks_sorted
    original_values = sorted_vals[is_new]
    if image.dtype == torch.uint64:
        original_values = original_values.view(torch.uint64)
    else:
        original_values = original_values.to(image.dtype)
    return labels.reshape(image.shape).to(torch.uint32), original_values
