"""skimage.util.random_noise on torch tensors.

The noise is drawn from a ``torch.Generator`` on the image's device,
seeded with ``seed`` (0 when None, as ``cupyimg_tpu``'s key): the same
seed gives the same output on one device.  The draws differ from
skimage's and ``cupyimg_tpu``'s streams; their distributions are the
same.
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float

__all__ = ["random_noise"]


def random_noise(image, mode="gaussian", seed=None, clip=True, **kwargs):
    """Add random noise to an image (skimage.util.random_noise): modes
    'gaussian' and 'speckle' (``mean``, ``var``), 'localvar'
    (``local_vars``, each > 0), 'poisson', 'salt', 'pepper' and 's&p'
    (``amount``, ``salt_vs_pepper``).  The image goes through
    ``img_as_float``; the low clip is -1 for an image with negative
    values, else 0; ``clip`` clips to [low clip, 1].  An unknown mode
    raises KeyError."""
    image = img_as_float(util.as_tensor(image))
    mode = mode.lower()
    gen = torch.Generator(device=image.device)
    gen.manual_seed(0 if seed is None else int(seed))
    low_clip = -1.0 if bool(image.min() < 0) else 0.0

    def normal():
        return torch.randn(image.shape, generator=gen, dtype=image.dtype,
                           device=image.device)

    def uniform():
        return torch.rand(image.shape, generator=gen, dtype=image.dtype,
                          device=image.device)

    if mode in ("gaussian", "speckle"):
        mean = kwargs.get("mean", 0.0)
        var = kwargs.get("var", 0.01)
        noise = mean + var ** 0.5 * normal()
        out = image + noise if mode == "gaussian" else image + image * noise
    elif mode == "localvar":
        local_vars = util.as_tensor(kwargs["local_vars"], device=image.device)
        if bool((local_vars <= 0).any()):
            raise ValueError("All values of `local_vars` must be > 0.")
        out = image + torch.sqrt(local_vars) * normal()
    elif mode == "poisson":
        vals = torch.unique(image).numel()
        vals = float(2 ** np.ceil(np.log2(vals)))
        if low_clip == -1.0:
            old_max = image.max()
            image = (image + 1.0) / (old_max + 1.0)
        out = torch.poisson(image * vals, generator=gen) / vals
        if low_clip == -1.0:
            out = out * (old_max + 1.0) - 1.0
    elif mode in ("salt", "pepper", "s&p"):
        amount = kwargs.get("amount", 0.05)
        salt_vs_pepper = kwargs.get("salt_vs_pepper", 0.5)
        flipped = uniform() < amount
        if mode == "salt":
            out = torch.where(flipped, 1.0, image)
        elif mode == "pepper":
            out = torch.where(flipped, low_clip, image)
        else:
            salted = uniform() < salt_vs_pepper
            out = torch.where(flipped & salted, 1.0, image)
            out = torch.where(flipped & ~salted, low_clip, out)
    else:
        # skimage raises KeyError (its allowed-types dict lookup)
        raise KeyError(f"unknown noise mode: {mode}")

    if clip:
        out = torch.clamp(out, low_clip, 1.0)
    return out
