"""TV-L1 and iterative Lucas-Kanade optical flow
(skimage.registration._optical_flow) on torch tensors.

Each warp iteration of either solver warps the moving image by the flow
with ``transform.warp`` and a coordinate array: one launch of the spline
gather's map entry for CUDA float32 or float64 images.  With
``prefilter=True`` the flow's 1x3x3 median first takes the rank kernel
(float32).  iLK's window sums are ``uniform_filter`` or
``gaussian_filter`` (the fused separable kernel for float32) and its
per-pixel systems are solved in closed form for 1-3 axes
(determinant and Cramer's rule as multiply-adds in the flow's dtype: no
matrix product).  TV-L1's data term and Chambolle projections are plain
elementwise torch, several hundred small launches a warp; its stopping
test reads one number back a warp.
"""

from __future__ import annotations

from functools import partial
from itertools import combinations_with_replacement

import numpy as np
import torch

from cupyimg_tpu_torch.numpy import gradient
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage.transform import warp

from ._optical_flow_utils import coarse_to_fine, get_warp_points

__all__ = ["optical_flow_tvl1", "optical_flow_ilk"]


def _forward_diff(x, axis):
    """Forward difference along ``axis`` with a trailing zero."""
    out = torch.zeros_like(x)
    out.narrow(axis, 0, x.shape[axis] - 1).copy_(torch.diff(x, dim=axis))
    return out


def _shift_down(x, axis):
    """``x`` shifted by +1 along ``axis`` with a leading zero."""
    out = torch.zeros_like(x)
    n = x.shape[axis] - 1
    out.narrow(axis, 1, n).copy_(x.narrow(axis, 0, n))
    return out


def _grid(shape, dtype, device):
    """The (ndim, *shape) tensor of each pixel's coordinates."""
    return torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=dtype, device=device) for n in shape],
        indexing="ij"))


def _tvl1_warp_step(reference_image, moving_image, grid, flow_in, proj, f0,
                    f1, dt, num_iter, prefilter):
    """One warp iteration of the TV-L1 solver: the new flow and its
    squared change; ``proj`` (the dual variables) is updated in place."""
    ndim = reference_image.ndim
    flow = flow_in
    if prefilter:
        flow = ndi.median_filter(flow, [1] + ndim * [3])

    image1_warp = warp(moving_image, grid + flow, mode="edge")
    grad = torch.stack(gradient(image1_warp))
    NI = (grad * grad).sum(0)
    NI = torch.where(NI == 0, 1.0, NI)
    rho_0 = image1_warp - reference_image - (grad * flow).sum(0)

    for _ in range(num_iter):
        # data term: a thresholded gradient step
        rho = rho_0 + (grad * flow).sum(0)
        step = torch.where(torch.abs(rho) <= f0 * NI, rho / NI,
                           f0 * torch.sign(rho))
        flow_auxiliary = flow - step[None] * grad

        # regularisation: Chambolle's dual projection per component; each
        # component reads only its own auxiliary component, so the new
        # flow is written over the auxiliary one
        flow = flow_auxiliary
        for idx in range(ndim):
            p = proj[idx]
            comp = flow_auxiliary[idx]
            for _ in range(2):
                g = torch.stack([_forward_diff(comp, ax)
                                 for ax in range(ndim)])
                norm = torch.sqrt((g * g).sum(0, keepdim=True)) * f1 + 1.0
                p = (p - dt * g) / norm
                # the (negative) divergence of p
                d = sum(_shift_down(p[ax], ax) - p[ax] for ax in range(ndim))
                comp = flow_auxiliary[idx] + d
            proj[idx] = p
            flow[idx] = comp

    delta = flow_in - flow
    return flow, (delta * delta).sum()


def _tvl1(reference_image, moving_image, flow0, attachment, tightness,
          num_warp, num_iter, tol, prefilter):
    """The TV-L1 solver on one pyramid level."""
    dtype = reference_image.dtype
    ndim = reference_image.ndim
    grid = _grid(reference_image.shape, dtype, reference_image.device)

    dt = 0.5 / ndim
    f0 = attachment * tightness
    f1 = dt / tightness
    tol = tol * reference_image.numel()

    flow = flow0
    proj = torch.zeros((ndim, ndim) + tuple(reference_image.shape),
                       dtype=dtype, device=reference_image.device)
    for _ in range(num_warp):
        flow, delta = _tvl1_warp_step(reference_image, moving_image, grid,
                                      flow, proj, f0, f1, dt, num_iter,
                                      prefilter)
        if float(delta) < tol:
            break
    return flow


def optical_flow_tvl1(
    reference_image,
    moving_image,
    *,
    attachment=15,
    tightness=0.3,
    num_warp=5,
    num_iter=10,
    tol=1e-4,
    prefilter=False,
    dtype=np.float32,
):
    """Coarse-to-fine TV-L1 optical flow: the flow, one component per
    axis, shape ``(image0.ndim, M, N[, ...])``, in ``dtype`` (numpy's or
    torch's float types)."""
    solver = partial(
        _tvl1,
        attachment=attachment,
        tightness=tightness,
        num_warp=num_warp,
        num_iter=num_iter,
        tol=tol,
        prefilter=prefilter,
    )
    return coarse_to_fine(reference_image, moving_image, solver, dtype=dtype)


def _cramer(A, b):
    """The determinant of every pixel's symmetric system (``A`` by its
    upper triangle ``{(i, j): window}``) and the solution of ``A x = b``
    by Cramer's rule, for 1 to 3 axes: multiply-adds in ``A``'s dtype."""
    n = len(b)
    if n == 1:
        det = A[(0, 0)]
        return det, b / det
    if n == 2:
        a, c, e = A[(0, 0)], A[(0, 1)], A[(1, 1)]
        det = a * e - c * c
        return det, torch.stack([(b[0] * e - c * b[1]) / det,
                                 (a * b[1] - c * b[0]) / det])
    a00, a01, a02 = A[(0, 0)], A[(0, 1)], A[(0, 2)]
    a11, a12, a22 = A[(1, 1)], A[(1, 2)], A[(2, 2)]
    # the adjugate, symmetric as A
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a11 * a02
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    return det, torch.stack([
        (c00 * b[0] + c01 * b[1] + c02 * b[2]) / det,
        (c01 * b[0] + c11 * b[1] + c12 * b[2]) / det,
        (c02 * b[0] + c12 * b[1] + c22 * b[2]) / det,
    ])


def _solve(A, b, dtype):
    """The solution of every pixel's system ``A x = b`` (``b`` stacked
    on axis 0) in ``dtype``; a system with |det| < 1e-14 gives 0, as the
    identity would."""
    ndim = len(b)
    if ndim <= 3:
        # float16 sums underflow in the products: they solve in float32
        work = torch.promote_types(dtype, torch.float32)
        det, x = _cramer({k: v.to(work) for k, v in A.items()}, b.to(work))
        return torch.where(torch.abs(det) < 1e-14, 0.0, x).to(dtype)
    # more axes: a batched LU in float64, rounded once
    full = torch.stack([torch.stack([A[min(i, j), max(i, j)]
                                     for j in range(ndim)], -1)
                        for i in range(ndim)], -2).to(torch.float64)
    rhs = torch.movedim(b, 0, -1).to(torch.float64)
    bad = torch.abs(torch.linalg.det(full)) < 1e-14
    eye = torch.eye(ndim, dtype=torch.float64, device=full.device)
    full = torch.where(bad[..., None, None], eye, full)
    rhs = torch.where(bad[..., None], 0.0, rhs)
    sol = torch.linalg.solve(full, rhs[..., None])[..., 0]
    return torch.movedim(sol, -1, 0).to(dtype)


def _ilk_warp_step(reference_image, moving_image, grid, flow, radius,
                   gaussian, prefilter):
    """One warp iteration of the iLK solver: warp, windowed normal
    equations, a solve a pixel."""
    dtype = reference_image.dtype
    ndim = reference_image.ndim
    size = 2 * radius + 1
    if gaussian:
        filter_func = partial(ndi.gaussian_filter, sigma=ndim * (size / 4,),
                              mode="mirror")
    else:
        filter_func = partial(ndi.uniform_filter, size=ndim * (size,),
                              mode="mirror")

    if prefilter:
        flow = ndi.median_filter(flow, (1,) + ndim * (3,))

    moving_image_warp = warp(moving_image, get_warp_points(grid, flow),
                             mode="edge")
    grad = torch.stack(gradient(moving_image_warp))
    error_image = (grad * flow).sum(0) + reference_image - moving_image_warp

    # the local ndim x ndim systems A x = b at every pixel
    A = {(i, j): filter_func(grad[i] * grad[j]).to(dtype)
         for i, j in combinations_with_replacement(range(ndim), 2)}
    b = torch.stack([filter_func(grad[i] * error_image).to(dtype)
                     for i in range(ndim)])
    return _solve(A, b, dtype)


def _ilk(reference_image, moving_image, flow0, radius, num_warp, gaussian,
         prefilter):
    """The iterative Lucas-Kanade solver on one pyramid level."""
    grid = _grid(reference_image.shape, reference_image.dtype,
                 reference_image.device)
    flow = flow0
    for _ in range(num_warp):
        flow = _ilk_warp_step(reference_image, moving_image, grid, flow,
                              radius, gaussian, prefilter)
    return flow


def optical_flow_ilk(
    reference_image,
    moving_image,
    *,
    radius=7,
    num_warp=10,
    gaussian=False,
    prefilter=False,
    dtype=np.float32,
):
    """Coarse-to-fine iterative Lucas-Kanade optical flow: the flow, one
    component per axis, in ``dtype`` (numpy's or torch's float types)."""
    solver = partial(
        _ilk,
        radius=radius,
        num_warp=num_warp,
        gaussian=gaussian,
        prefilter=prefilter,
    )
    return coarse_to_fine(reference_image, moving_image, solver, dtype=dtype)
