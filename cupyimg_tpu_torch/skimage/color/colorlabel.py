"""``label2rgb`` and ``color_dict`` (skimage.color.colorlabel) on torch
tensors.

The label image stays on the device: one ``torch.unique`` gives the
sorted labels and each pixel's rank among them; only the sorted labels
come to the host, to build the colour table, which is then gathered on
the device.  The 'avg' kind takes every label's mean colour from one
``index_add_`` and one ``bincount`` in float64.
"""

from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.skimage._shared.utils import change_default_value
from cupyimg_tpu_torch.skimage.color import rgb_colors
from cupyimg_tpu_torch.skimage.color.colorconv import gray2rgb, rgb2gray
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float

__all__ = ["color_dict", "label2rgb", "DEFAULT_COLORS"]

DEFAULT_COLORS = (
    "red", "blue", "yellow", "magenta", "green", "indigo", "darkorange",
    "cyan", "pink", "yellowgreen",
)

color_dict = {
    k: v for k, v in rgb_colors.__dict__.items() if isinstance(v, tuple)
}


def _rgb_vector(color):
    if isinstance(color, str):
        color = color_dict[color]
    return np.asarray(color[:3], dtype=np.float64)


def _ranks(label):
    """The sorted distinct labels (on the host) and each pixel's index
    among them (on the device)."""
    if label.dtype == torch.bool:
        label = label.to(torch.uint8)
    uniq, inv = torch.unique(dtypes.widen_unsigned(label), sorted=True,
                             return_inverse=True)
    return uniq.cpu().numpy(), inv


@change_default_value("bg_label", new_value=0, changed_version="0.19")
def label2rgb(
    label, image=None, colors=None, alpha=0.3, bg_label=-1, bg_color=(0, 0, 0),
    image_alpha=1, kind="overlay",
):
    """An RGB image (float64) where each label has a colour, overlaid on
    ``image`` ('overlay': colours cycle over the labels in sorted order)
    or each label's mean colour of ``image`` ('avg')."""
    label = util.as_tensor(label)
    if kind == "overlay":
        return _label2rgb_overlay(
            label, image, colors, alpha, bg_label, bg_color, image_alpha
        )
    elif kind == "avg":
        return _label2rgb_avg(label, image, bg_label, bg_color)
    raise ValueError("`kind` must be either 'overlay' or 'avg'.")


def _label2rgb_overlay(
    label, image=None, colors=None, alpha=0.3, bg_label=-1, bg_color=None,
    image_alpha=1,
):
    if colors is None:
        colors = DEFAULT_COLORS
    colors = np.stack([_rgb_vector(c) for c in colors])

    if image is None:
        image = torch.zeros(label.shape + (3,), dtype=torch.float64,
                            device=label.device)
        alpha = 1.0
    else:
        image = util.as_tensor(image, device=label.device)
        if (image.shape[: label.ndim] != label.shape
                or image.ndim > label.ndim + 1):
            raise ValueError("`image` and `label` must be the same shape")
        if float(dtypes.widen_unsigned(image).min()) < 0:
            warnings.warn(
                "Negative intensities in `image` are not supported"
            )
        if image.ndim == label.ndim + 1 and image.shape[-1] != 3:
            raise ValueError("`image` must be RGB")
        if image.ndim == label.ndim:
            image = gray2rgb(image)
        image = img_as_float(rgb2gray(image))
        image = gray2rgb(image) * image_alpha + (1 - image_alpha)

    uniq, inv = _ranks(label)
    is_fg = uniq != bg_label
    lut = np.zeros((uniq.size, 3), dtype=np.float64)
    color_cycle = itertools.cycle(range(len(colors)))
    for k, color_idx in zip(np.flatnonzero(is_fg), color_cycle):
        lut[k] = colors[color_idx]

    device = label.device
    mapped = torch.as_tensor(lut, device=device)[inv]
    result = mapped * alpha + image * (1 - alpha)
    if bg_color is None:
        fg_mask = torch.as_tensor(is_fg, device=device)[inv][..., None]
        return torch.where(fg_mask, result, image)
    bg_mask = torch.as_tensor(~is_fg, device=device)[inv][..., None]
    bg = torch.as_tensor(_rgb_vector(bg_color), device=device)
    return torch.where(bg_mask, bg * alpha + image * (1 - alpha), result)


def _label2rgb_avg(label_field, image, bg_label=0, bg_color=(0, 0, 0)):
    """Colour each region with its mean colour of ``image``."""
    image = util.as_tensor(image, device=label_field.device)
    img = image if image.ndim == label_field.ndim + 1 else gray2rgb(image)
    img = img_as_float(img)
    uniq, inv = _ranks(label_field)
    flat_inv = inv.reshape(-1)
    n = uniq.size
    sums = torch.zeros((n, img.shape[-1]), dtype=torch.float64,
                       device=img.device)
    sums.index_add_(0, flat_inv,
                    img.reshape(-1, img.shape[-1]).to(torch.float64))
    counts = torch.bincount(flat_inv, minlength=n).clamp(min=1)
    table = sums / counts[:, None]
    hit = np.flatnonzero(uniq == bg_label)
    if hit.size:
        table[int(hit[0])] = torch.as_tensor(_rgb_vector(bg_color),
                                             device=table.device)
    return table[inv]
