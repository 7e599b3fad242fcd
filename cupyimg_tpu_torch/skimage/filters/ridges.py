"""Ridge filters (skimage.filters.ridges) on torch tensors: Meijering's
neuriteness, Sato's tubeness, Frangi's vesselness and the hybrid Hessian
filter, from the scale-normalised Hessian eigenvalues.

The Hessian is ``feature.hessian_matrix`` (a float32 image: one launch
of the fused separable kernel for its gaussian on the card) and its
eigenvalues the closed forms of ``feature.hessian_matrix_eigvals`` (no
matrix product).  The sigma^2 scaling computes in float64, as skimage's
host float does, so the responses are float64.
"""

from __future__ import annotations

import warnings
from functools import reduce

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.skimage.feature.corner import (
    hessian_matrix,
    hessian_matrix_eigvals,
)
from cupyimg_tpu_torch.skimage.util._invert import invert
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float

__all__ = [
    "compute_hessian_eigenvalues",
    "meijering",
    "sato",
    "frangi",
    "hessian",
]


def _divide_nonzero(array1, array2, cval=1e-10):
    return array1 / torch.where(torch.abs(array2) > cval, array2, cval)


def _sort_rows(array, key):
    """``array`` sorted along dim 0 by ``key`` of its rows, stably, NaN
    last, by an odd-even transposition network of elementwise
    compare-exchanges (torch.sort along a short leading dim runs a
    generic radix sort: 23 ms for 2 x 2048^2 float64 on an H100)."""
    rows = list(array.unbind(0))
    n = len(rows)
    for r in range(n):
        for i in range(r % 2, n - 1, 2):
            ki, kj = key(rows[i]), key(rows[i + 1])
            swap = (ki > kj) | (torch.isnan(ki) & ~torch.isnan(kj))
            rows[i], rows[i + 1] = (torch.where(swap, rows[i + 1], rows[i]),
                                    torch.where(swap, rows[i], rows[i + 1]))
    return torch.stack(rows)


def _check_sigmas(sigmas):
    sigmas = np.asarray(sigmas, dtype=float)
    if np.any(sigmas < 0.0):
        raise ValueError("Sigma values less than zero are not valid")
    return sigmas


def compute_hessian_eigenvalues(image, sigma, sorting="none",
                                mode="constant", cval=0):
    """The Hessian's eigenvalues at scale ``sigma``, each element scaled
    by sigma^2, stacked on axis 0 and sorted by 'abs', by 'val' or not."""
    image = img_as_float(util.as_tensor(image))
    elems = hessian_matrix(image, sigma=sigma, order="rc", mode=mode,
                           cval=cval)
    scale = float(sigma) ** 2
    elems = [scale * e.to(torch.float64) for e in elems]
    eigvals = hessian_matrix_eigvals(elems)
    if sorting == "abs":
        eigvals = _sort_rows(eigvals, torch.abs)
    elif sorting == "val":
        eigvals = _sort_rows(eigvals, lambda r: r)
    return eigvals


def meijering(image, sigmas=range(1, 10, 2), alpha=None, black_ridges=True,
              mode="reflect", cval=0):
    """Meijering's neuriteness: the largest modified eigenvalue, scaled
    by its minimum over the image, the maximum over ``sigmas``."""
    image = util.as_tensor(image)
    sigmas = _check_sigmas(sigmas)
    ndim = image.ndim
    if alpha is None:
        alpha = 1.0 / ndim
    if black_ridges:
        image = invert(image)
    outputs = []
    for sigma in sigmas:
        eigenvalues = compute_hessian_eigenvalues(image, sigma,
                                                  sorting="abs", mode=mode,
                                                  cval=cval)
        # aux_i = lambda_i + alpha * sum_{j != i} lambda_j, of the largest
        total = eigenvalues[0]
        for k in range(1, ndim):
            total = total + eigenvalues[k]
        aux = (1 - alpha) * eigenvalues[ndim - 1] + alpha * total
        filtered = _divide_nonzero(aux, torch.min(aux))
        outputs.append(torch.where(aux < 0, filtered, 0.0))
    return torch.max(torch.stack(outputs), dim=0).values


def _warn_implicit_mode(name):
    """A mode of None warns and resolves to 'reflect'."""
    warnings.warn(
        f"Previously, {name} implicitly used 'constant' as the "
        "border mode when dealing with the edge of the array. The new "
        "behavior is 'reflect'. To recover the old behavior, use "
        "mode='constant'. To avoid this warning, please explicitly "
        "set the mode.",
        category=FutureWarning,
        stacklevel=3,
    )
    return "reflect"


def _resolve_scale_range(sigmas, scale_range, scale_step):
    """The deprecated ``scale_range``/``scale_step`` pair, if given."""
    if scale_range is not None and scale_step is not None:
        warnings.warn(
            "Use keyword parameter `sigmas` instead of `scale_range` and "
            "`scale_range` which will be removed in version 0.17.",
            stacklevel=3,
        )
        sigmas = np.arange(scale_range[0], scale_range[1], scale_step)
    return sigmas


def sato(image, sigmas=range(1, 10, 2), black_ridges=True, mode=None,
         cval=0):
    """Sato's tubeness: the geometric mean of all but the smallest
    eigenvalue where the largest is positive, the maximum over
    ``sigmas``."""
    image = util.as_tensor(image)
    if mode is None:
        mode = _warn_implicit_mode("sato")
    sigmas = _check_sigmas(sigmas)
    if not black_ridges:
        image = invert(image)
    outputs = []
    for sigma in sigmas:
        eig = compute_hessian_eigenvalues(image, sigma, sorting="val",
                                          mode=mode, cval=cval)
        lambdas = [eig[i] for i in range(1, eig.shape[0])]
        filtered = torch.abs(reduce(torch.mul, lambdas)) ** (
            1 / len(lambdas))
        outputs.append(torch.where(lambdas[-1] > 0, filtered, 0.0))
    return torch.max(torch.stack(outputs), dim=0).values


def frangi(image, sigmas=range(1, 10, 2), scale_range=None, scale_step=None,
           alpha=0.5, beta=0.5, gamma=15, black_ridges=True, mode="reflect",
           cval=0):
    """Frangi's vesselness: the plate, blob and structure measures of the
    eigenvalues, zero where a ridge's eigenvalue has the wrong sign, the
    maximum over ``sigmas``."""
    image = util.as_tensor(image)
    sigmas = _resolve_scale_range(sigmas, scale_range, scale_step)
    sigmas = _check_sigmas(sigmas)
    ndim = image.ndim
    alpha_sq = 2 * alpha ** 2
    beta_sq = 2 * beta ** 2
    gamma_sq = 2 * gamma ** 2
    if black_ridges:
        image = invert(image)
    outputs = []
    lambdas_max = []
    for sigma in sigmas:
        eig = compute_hessian_eigenvalues(image, sigma, sorting="abs",
                                          mode=mode, cval=cval)
        lambda1 = eig[0]
        lambdas = [eig[i] for i in range(1, eig.shape[0])]
        if ndim == 2:
            r_a = torch.full_like(lambda1, np.inf)
        else:
            r_a = _divide_nonzero(lambdas[0], lambdas[1]) ** 2
        filtered_raw = torch.abs(reduce(torch.mul, lambdas)) ** (
            1 / len(lambdas))
        r_b = _divide_nonzero(lambda1, filtered_raw) ** 2
        r_g = lambda1 ** 2
        for lam in lambdas:
            r_g = r_g + lam ** 2
        outputs.append((1 - torch.exp(-r_a / alpha_sq))
                       * torch.exp(-r_b / beta_sq)
                       * (1 - torch.exp(-r_g / gamma_sq)))
        lambdas_max.append(torch.max(torch.stack(lambdas), dim=0).values)
    filtered_array = torch.stack(outputs)
    lambdas_array = torch.stack(lambdas_max)
    filtered_array = torch.where(lambdas_array > 0, 0.0, filtered_array)
    return torch.max(filtered_array, dim=0).values


def hessian(image, sigmas=range(1, 10, 2), scale_range=None, scale_step=None,
            alpha=0.5, beta=0.5, gamma=15, black_ridges=True, mode=None,
            cval=0):
    """The hybrid Hessian filter (Ng et al.): Frangi's response with the
    background (responses <= 0) set to 1."""
    if mode is None:
        mode = _warn_implicit_mode("hessian")
    filtered = frangi(image, sigmas=sigmas, scale_range=scale_range,
                      scale_step=scale_step, alpha=alpha, beta=beta,
                      gamma=gamma, black_ridges=black_ridges, mode=mode,
                      cval=cval)
    return torch.where(filtered <= 0, 1.0, filtered)
