"""Corner and second-derivative features (skimage.feature.corner) on
torch tensors: the structure tensor, the Hessian, their eigenvalues in
closed form (2x2 and 3x3; ``torch.linalg.eigvalsh`` in float64 beyond),
and the corner responses.

The derivatives are ``ndi.sobel`` and ``ndi.gaussian_filter`` (one launch
of the fused separable kernel each for CUDA float32 data; float64 data
takes plain torch) and ``numpy.gradient``'s port; the SURF-style
``hessian_matrix_det`` reads the port's ``integral_image``.
"""

from __future__ import annotations

import itertools
import math
from warnings import warn

import numpy as np
import torch

from cupyimg_tpu_torch import numpy as tnp
from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.utils import _supported_float_type
from cupyimg_tpu_torch.skimage.util.dtype import img_as_float

__all__ = [
    "structure_tensor",
    "structure_tensor_eigvals",
    "structure_tensor_eigenvalues",
    "hessian_matrix",
    "hessian_matrix_det",
    "hessian_matrix_eigvals",
    "shape_index",
    "corner_kitchen_rosenfeld",
    "corner_harris",
    "corner_shi_tomasi",
    "corner_foerstner",
    "corner_peaks",
]


def _compute_derivatives(image, mode="constant", cval=0):
    """The sobel derivative along every axis."""
    return [
        ndi.sobel(image, axis=i, mode=mode, cval=cval)
        for i in range(image.ndim)
    ]


def _prepare_grayscale_input_nD(image):
    image = util.as_tensor(image)
    return img_as_float(image).to(
        dtypes.to_torch(_supported_float_type(image.dtype)))


def structure_tensor(image, sigma=1, mode="constant", cval=0, order=None):
    """The structure tensor's unique elements: gaussian-smoothed products
    of the sobel gradients.  A 2-D image without ``order`` warns and
    takes skimage's deprecated 'xy' order."""
    image = util.as_tensor(image)
    if order == "xy" and image.ndim > 2:
        raise ValueError('Only "rc" order is supported for dim > 2.')
    if order is None:
        if image.ndim == 2:
            warn(
                "deprecation warning: the default order of the structure "
                'tensor values will be "row-column" instead of "xy" '
                'starting in skimage version 0.20. Use order="rc" or '
                'order="xy" to set this explicitly.  (Specify order="xy" '
                "to maintain the old behavior.)",
                category=FutureWarning,
                stacklevel=2,
            )
            order = "xy"
        else:
            order = "rc"
    image = _prepare_grayscale_input_nD(image)
    derivatives = _compute_derivatives(image, mode=mode, cval=cval)
    if order == "xy":
        derivatives = derivatives[::-1]
    elif order != "rc":
        raise ValueError(f"unknown order: {order}")
    return [
        ndi.gaussian_filter(der0 * der1, sigma, mode=mode, cval=cval)
        for der0, der1 in itertools.combinations_with_replacement(
            derivatives, 2
        )
    ]


def hessian_matrix(image, sigma=1, mode="constant", cval=0, order="rc"):
    """The Hessian's upper-triangular elements, row-major: gradients of
    the gaussian-smoothed image.  As skimage, 'rc' reverses the axes, so
    the first element is the second derivative along the last axis."""
    image = _prepare_grayscale_input_nD(image)
    gaussian_filtered = ndi.gaussian_filter(
        image, sigma=sigma, mode=mode, cval=cval
    )
    gradients = tnp.gradient(gaussian_filtered)
    if image.ndim == 1:
        gradients = [gradients]
    axes = range(image.ndim)
    if order == "rc":
        axes = reversed(list(axes))
    elif order != "xy":
        raise ValueError(f"unknown order: {order}")
    return [
        tnp.gradient(gradients[ax0], axis=ax1)
        for ax0, ax1 in itertools.combinations_with_replacement(
            list(axes), 2)
    ]


def _symmetric_eigvals_2x2(a, b, d):
    """Eigenvalues of [[a, b], [b, d]], descending."""
    tr_half = (a + d) / 2
    det_part = torch.sqrt(((a - d) / 2) ** 2 + b * b)
    return [tr_half + det_part, tr_half - det_part]


def _symmetric_eigvals_3x3(a, b, c, d, e, f):
    """Eigenvalues of [[a, b, c], [b, d, e], [c, e, f]], descending (the
    trigonometric closed form for a symmetric 3x3 matrix; Smith 1961)."""
    p1 = b * b + c * c + e * e
    q = (a + d + f) / 3.0
    p2 = (a - q) ** 2 + (d - q) ** 2 + (f - q) ** 2 + 2 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    # B = (A - q I) / p
    b11 = (a - q) / p
    b22 = (d - q) / p
    b33 = (f - q) / p
    b12 = b / p
    b13 = c / p
    b23 = e / p
    detB = (
        b11 * (b22 * b33 - b23 * b23)
        - b12 * (b12 * b33 - b23 * b13)
        + b13 * (b12 * b23 - b22 * b13)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    eig1 = q + 2 * p * torch.cos(phi)
    eig3 = q + 2 * p * torch.cos(phi + (2 * math.pi / 3.0))
    eig2 = 3 * q - eig1 - eig3
    is_diag = p2 <= 1e-30
    eig1 = torch.where(is_diag, a, eig1)
    eig2 = torch.where(is_diag, d, eig2)
    eig3 = torch.where(is_diag, f, eig3)
    # sort descending, element by element
    lo = torch.minimum(torch.minimum(eig1, eig2), eig3)
    hi = torch.maximum(torch.maximum(eig1, eig2), eig3)
    mid = eig1 + eig2 + eig3 - lo - hi
    return [hi, mid, lo]


def _stack_symmetric(S_elems):
    """The (..., n, n) float64 matrices of the upper-triangular
    elements."""
    n = len(S_elems)
    ndim = int((math.sqrt(8 * n + 1) - 1) / 2)
    shape = tuple(S_elems[0].shape)
    M = torch.empty(shape + (ndim, ndim), dtype=torch.float64,
                    device=S_elems[0].device)
    k = 0
    for i in range(ndim):
        for j in range(i, ndim):
            M[..., i, j] = S_elems[k]
            M[..., j, i] = S_elems[k]
            k += 1
    return M, ndim


def _symmetric_eigvals(S_elems):
    n = len(S_elems)
    if n == 3:  # 2x2
        return _symmetric_eigvals_2x2(S_elems[0], S_elems[1], S_elems[2])
    if n == 6:  # 3x3
        return _symmetric_eigvals_3x3(*S_elems)
    # larger matrices: eigvalsh in float64
    M, ndim = _stack_symmetric(S_elems)
    vals = torch.linalg.eigvalsh(M).to(S_elems[0].dtype)
    return [vals[..., ndim - 1 - i] for i in range(ndim)]


def structure_tensor_eigenvalues(A_elems):
    """Eigenvalues of the structure tensor, descending, stacked."""
    return torch.stack(_symmetric_eigvals(A_elems), dim=0)


def structure_tensor_eigvals(Axx, Axy, Ayy):
    """Eigenvalues of a 2-D structure tensor (skimage's legacy API)."""
    warn(
        "deprecation warning: use structure_tensor_eigenvalues instead "
        "of structure_tensor_eigvals which will be removed in version "
        "0.20.",
        category=FutureWarning,
        stacklevel=2,
    )
    return tuple(_symmetric_eigvals_2x2(Axx, Axy, Ayy))


def hessian_matrix_eigvals(H_elems):
    """Eigenvalues of the Hessian, descending, stacked."""
    return torch.stack(_symmetric_eigvals(H_elems), dim=0)


def hessian_matrix_det(image, sigma=1, approximate=True):
    """Determinant of the Hessian: SURF's box-filter approximation on the
    integral image for a 2-D image (Bay et al.), else the gaussian
    Hessian's exact determinant."""
    image = _prepare_grayscale_input_nD(image)
    if image.ndim == 2 and approximate:
        from cupyimg_tpu_torch.skimage.transform.integral import (
            integral_image,
        )

        return _hessian_matrix_det_approx(integral_image(image), sigma)
    H = hessian_matrix(image, sigma)
    if image.ndim == 2:
        return H[0] * H[2] - H[1] ** 2
    M, _ = _stack_symmetric(H)
    return torch.linalg.det(M).to(H[0].dtype)


def _integ(ii, r, c, rl, cl):
    """Box sums over ``[y + r, y + r + rl) x [x + c, x + c + cl)`` for
    every pixel (y, x), from the integral image; a corner before the
    first row or column reads 0, one past the last reads the last."""
    rows, cols = ii.shape
    # one leading zero row and column: index 0 reads the zero
    P = torch.nn.functional.pad(ii, (1, 0, 1, 0))

    def idx(n, off):
        i = torch.arange(n, device=ii.device) + off
        return torch.clamp(i, -1, n - 1) + 1

    r0, r1 = idx(rows, r - 1), idx(rows, r + rl - 1)
    c0, c1 = idx(cols, c - 1), idx(cols, c + cl - 1)

    def at(ri, ci):
        return P.index_select(0, ri).index_select(1, ci)

    return at(r1, c1) - at(r1, c0) - at(r0, c1) + at(r0, c0)


def _hessian_matrix_det_approx(ii, sigma):
    """SURF's approximate Hessian determinant from an integral image."""
    size = int(3 * sigma)
    if size % 2 == 0:
        size += 1
    s2 = (size - 1) // 2
    s3 = size // 3
    w = size
    scale = 1.0 / (w * w)

    # D_xx: three horizontal bands (left, centre, right)
    mid_c = -(s3 - 1) // 2
    tl = _integ(ii, -s3 + 1, -s2, 2 * s3 - 1, s3)
    tm = _integ(ii, -s3 + 1, mid_c, 2 * s3 - 1, s3)
    tr = _integ(ii, -s3 + 1, s2 - s3 + 1, 2 * s3 - 1, s3)
    dxx = tl - 2 * tm + tr

    # D_yy: the same, transposed
    tl = _integ(ii, -s2, -s3 + 1, s3, 2 * s3 - 1)
    tm = _integ(ii, mid_c, -s3 + 1, s3, 2 * s3 - 1)
    tr = _integ(ii, s2 - s3 + 1, -s3 + 1, s3, 2 * s3 - 1)
    dyy = tl - 2 * tm + tr

    # D_xy: four quadrants
    d1 = _integ(ii, -s3, -s3, s3, s3)
    d2 = _integ(ii, -s3, 1, s3, s3)
    d3 = _integ(ii, 1, -s3, s3, s3)
    d4 = _integ(ii, 1, 1, s3, s3)
    dxy = d1 - d2 - d3 + d4

    dxx = dxx * scale
    dyy = dyy * scale
    dxy = dxy * scale
    return dxx * dyy - 0.81 * dxy * dxy


def shape_index(image, sigma=1, mode="constant", cval=0):
    """Koenderink and van Doorn's shape index."""
    H = hessian_matrix(image, sigma=sigma, mode=mode, cval=cval, order="rc")
    l1, l2 = hessian_matrix_eigvals(H)
    # IEEE on purpose, as skimage: equal eigenvalues give +-inf and so
    # +-1 (a spherical cap); only a flat point (0/0) is NaN
    return (2.0 / math.pi) * torch.arctan((l2 + l1) / (l2 - l1))


def corner_kitchen_rosenfeld(image, mode="constant", cval=0):
    """Kitchen and Rosenfeld's curvature corner response."""
    image = _prepare_grayscale_input_nD(image)
    imy, imx = _compute_derivatives(image, mode=mode, cval=cval)
    imxy, imxx = [
        ndi.sobel(imx, axis=i, mode=mode, cval=cval) for i in (0, 1)
    ]
    imyy, imyx = [
        ndi.sobel(imy, axis=i, mode=mode, cval=cval) for i in (0, 1)
    ]
    numerator = imxx * imy ** 2 + imyy * imx ** 2 - 2 * imxy * imx * imy
    denominator = imx ** 2 + imy ** 2
    zero = denominator == 0
    safe = torch.where(zero, torch.ones_like(denominator), denominator)
    return torch.where(zero, torch.zeros_like(numerator), numerator / safe)


def corner_harris(image, method="k", k=0.05, eps=1e-6, sigma=1):
    """Harris' corner response."""
    Arr, Arc, Acc = structure_tensor(image, sigma, order="rc")
    detA = Arr * Acc - Arc ** 2
    traceA = Arr + Acc
    if method == "k":
        return detA - k * traceA ** 2
    return 2 * detA / (traceA + eps)


def corner_shi_tomasi(image, sigma=1):
    """Shi and Tomasi's response: the smaller eigenvalue."""
    Arr, Arc, Acc = structure_tensor(image, sigma, order="rc")
    return (
        Arr + Acc - torch.sqrt((Arr - Acc) ** 2 + 4 * Arc ** 2)
    ) / 2


def corner_foerstner(image, sigma=1):
    """Foerstner's (w, q) corner measures."""
    Arr, Arc, Acc = structure_tensor(image, sigma, order="rc")
    detA = Arr * Acc - Arc ** 2
    traceA = Arr + Acc
    zero = traceA == 0
    one = torch.ones_like(traceA)
    w = torch.where(zero, torch.zeros_like(detA),
                    detA / torch.where(zero, one, traceA))
    q = torch.where(zero, torch.zeros_like(detA),
                    4 * detA / torch.where(zero, one, traceA ** 2))
    return w, q


def corner_peaks(
    image,
    min_distance=1,
    threshold_abs=None,
    threshold_rel=None,
    exclude_border=True,
    indices=True,
    num_peaks=np.inf,
    footprint=None,
    labels=None,
    *,
    num_peaks_per_label=np.inf,
    p_norm=np.inf,
):
    """The corners among ``peak_local_max``'s peaks, thinned once more
    with an inclusive distance (points exactly ``min_distance`` apart
    conflict, so plateau peaks collapse to one)."""
    from cupyimg_tpu_torch.skimage._shared.coord import ensure_spacing
    from cupyimg_tpu_torch.skimage.feature.peak import peak_local_max

    if indices is False:
        warn(
            "indices argument is deprecated and will be removed in "
            "version 0.20. To avoid this warning, please do not use the "
            "indices argument. Please see corner_peaks documentation for "
            "more details.",
            FutureWarning,
            stacklevel=2,
        )
    image = util.as_tensor(image)
    coords = peak_local_max(
        image,
        min_distance=min_distance,
        threshold_abs=threshold_abs,
        threshold_rel=threshold_rel,
        exclude_border=exclude_border,
        num_peaks=np.inf,
        footprint=footprint,
        labels=labels,
        num_peaks_per_label=num_peaks_per_label,
    )
    if coords.shape[0]:
        coords = ensure_spacing(
            coords, spacing=min_distance, p_norm=p_norm, strict=False
        )
    if coords.shape[0] > num_peaks:
        coords = coords[: int(num_peaks)]
    if indices:
        return coords.to(torch.int64)
    peaks = torch.zeros(image.shape, dtype=torch.bool, device=image.device)
    if coords.shape[0]:
        peaks[tuple(coords.T)] = True
    return peaks
