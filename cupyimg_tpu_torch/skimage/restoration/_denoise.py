"""Total-variation denoising (skimage.restoration.denoise_tv_chambolle)
on torch tensors: Chambolle's dual projection, plain elementwise torch.

Each iteration's divergence and gradient are shifted slices; the energy
that decides convergence is read back once an iteration, as skimage's.
"""

from __future__ import annotations

import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.skimage.util import img_as_float

__all__ = ["denoise_tv_chambolle"]


def _forward_diff(x, axis):
    """``diff`` along ``axis`` with a zero appended at its end."""
    out = torch.zeros_like(x)
    n = x.shape[axis]
    out.narrow(axis, 0, n - 1).copy_(
        x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1))
    return out


def _shift_down(x, axis):
    """``x`` moved one step up ``axis``, a zero entering at its start."""
    out = torch.zeros_like(x)
    n = x.shape[axis]
    out.narrow(axis, 1, n - 1).copy_(x.narrow(axis, 0, n - 1))
    return out


def _denoise_tv_chambolle_nd(image, weight=0.1, eps=2.0e-4, n_iter_max=200):
    """Rudin-Osher-Fatemi denoising of an n-D image by Chambolle's
    algorithm."""
    ndim = image.ndim
    p = torch.zeros((ndim,) + tuple(image.shape), dtype=image.dtype,
                    device=image.device)
    tau = 1.0 / (2.0 * ndim)
    out = image
    E_init = E_previous = None
    for i in range(n_iter_max):
        if i > 0:
            # d = (negative) divergence of p
            d = sum(_shift_down(p[ax], ax) - p[ax] for ax in range(ndim))
            out = image + d
            E = float((d * d).sum())
        else:
            out = image
            E = 0.0
        g = torch.stack([_forward_diff(out, ax) for ax in range(ndim)])
        norm = torch.sqrt((g * g).sum(dim=0, keepdim=True))
        E += weight * float(norm.sum())
        norm = norm * (tau / weight) + 1.0
        p = (p - tau * g) / norm
        E /= float(image.numel())
        if i == 0:
            E_init = E
            E_previous = E
        else:
            if abs(E_previous - E) < eps * E_init:
                break
            E_previous = E
    return out


def denoise_tv_chambolle(image, weight=0.1, eps=2.0e-4, n_iter_max=200,
                         multichannel=False):
    """Total-variation denoising of an n-D image (each channel apart with
    ``multichannel``); integer images are converted by ``img_as_float``."""
    image = util.as_tensor(image)
    if not image.is_floating_point():
        image = img_as_float(image)
    if multichannel:
        return torch.stack([
            _denoise_tv_chambolle_nd(image[..., c], weight, eps, n_iter_max)
            for c in range(image.shape[-1])], dim=-1)
    return _denoise_tv_chambolle_nd(image, weight, eps, n_iter_max)
