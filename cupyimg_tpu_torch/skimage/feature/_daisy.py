"""DAISY dense descriptors (skimage.feature.daisy) on torch tensors.

The orientation maps are one (orientations, H, W) tensor, each map
smoothed by ``gaussian_filter`` once per ring (on a CUDA float32 image one
launch of the fused separable kernel each); the descriptors are shifted
windows of the smoothed maps.  ``visualize=True`` also draws the sampling
geometry on the host (numpy), as cupyimg_tpu does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy.ndimage import gaussian_filter
from ..util.dtype import img_as_float
from .._shared.utils import check_nD

__all__ = ["daisy"]


def daisy(
    image,
    step=4,
    radius=15,
    rings=3,
    histograms=8,
    orientations=8,
    normalization="l1",
    sigmas=None,
    ring_radii=None,
    visualize=False,
):
    """DAISY descriptors of a 2-D image on a grid of ``step`` pixels,
    (P, Q, (rings * histograms + 1) * orientations)."""
    image = util.as_tensor(image)
    check_nD(image, 2, "img")
    image = img_as_float(image)

    if (
        sigmas is not None
        and ring_radii is not None
        and len(sigmas) - 1 != len(ring_radii)
    ):
        raise ValueError("`len(sigmas)-1 != len(ring_radii)`")
    if ring_radii is not None:
        rings = len(ring_radii)
        radius = ring_radii[-1]
    if sigmas is not None:
        rings = len(sigmas) - 1
    if sigmas is None:
        sigmas = [
            radius * (i + 1) / float(2 * rings) for i in range(rings)
        ]
    if ring_radii is None:
        ring_radii = [
            radius * (i + 1) / float(rings) for i in range(rings)
        ]
    if normalization not in ["l1", "l2", "daisy", "off"]:
        raise ValueError("Invalid normalization method.")

    # forward differences, zero at the far edge
    dx = torch.nn.functional.pad(torch.diff(image, n=1, dim=1), (0, 1))
    dy = torch.nn.functional.pad(torch.diff(image, n=1, dim=0), (0, 0, 0, 1))

    # each orientation's share of the gradient magnitude
    grad_mag = torch.sqrt(dx * dx + dy * dy)
    grad_ori = torch.atan2(dy, dx)
    pi = math.pi
    orientation_kappa = orientations / pi
    orientation_angles = [
        2 * o * pi / orientations - pi for o in range(orientations)
    ]
    hist = torch.stack(
        [
            torch.exp(orientation_kappa * torch.cos(grad_ori - o))
            * grad_mag
            for o in orientation_angles
        ],
        dim=0,
    )

    # the centre and every ring smoothed
    sigmas = [sigmas[0]] + list(sigmas)
    hist_smooth = [
        torch.stack(
            [gaussian_filter(hist[j], sigma=sigmas[i])
             for j in range(orientations)],
            dim=0,
        )
        for i in range(rings + 1)
    ]

    # the descriptor grid
    theta = [2 * pi * j / histograms for j in range(histograms)]
    desc_dims = (rings * histograms + 1) * orientations
    out_shape = (
        image.shape[0] - 2 * radius,
        image.shape[1] - 2 * radius,
    )
    blocks = [hist_smooth[0][:, radius:-radius, radius:-radius]]
    for i in range(rings):
        for j in range(histograms):
            y_min = radius + int(
                round(ring_radii[i] * math.sin(theta[j]))
            )
            y_max = out_shape[0] + y_min
            x_min = radius + int(
                round(ring_radii[i] * math.cos(theta[j]))
            )
            x_max = out_shape[1] + x_min
            blocks.append(
                hist_smooth[i + 1][:, y_min:y_max, x_min:x_max]
            )
    descs = torch.cat([b[:, ::step, ::step] for b in blocks], dim=0)
    descs = torch.movedim(descs, 0, -1)

    if normalization != "off":
        descs = descs + 1e-10
        if normalization == "l1":
            descs = descs / torch.sum(descs, dim=2)[:, :, None]
        elif normalization == "l2":
            descs = descs / torch.sqrt(
                torch.sum(descs * descs, dim=2)
            )[:, :, None]
        elif normalization == "daisy":
            chunks = []
            for i in range(0, desc_dims, orientations):
                dtmp = descs[:, :, i: i + orientations]
                norms = torch.sqrt(torch.sum(dtmp * dtmp, dim=2))
                chunks.append(dtmp / norms[:, :, None])
            descs = torch.cat(chunks, dim=2)

    if visualize:
        descs_img = _render_descriptors(
            image.cpu().numpy(), descs.cpu().numpy(), step, radius, sigmas,
            ring_radii, orientation_angles, theta, rings, histograms,
            orientations,
        )
        return descs, torch.as_tensor(descs_img, device=image.device)
    return descs


def _blend(img, ys, xs, alpha, color):
    """Alpha-blend ``color`` into ``img`` at integer pixels, dropping
    samples outside."""
    h, w = img.shape[:2]
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w) & (alpha > 0)
    ys, xs, alpha = ys[keep], xs[keep], alpha[keep][:, None]
    img[ys, xs] = (1.0 - alpha) * img[ys, xs] + alpha * np.asarray(color)


def _draw_circle_aa(img, cy, cx, r, color):
    """Anti-aliased circle perimeter by a radial distance ramp."""
    r = max(int(r), 1)
    yy, xx = np.mgrid[-r - 1: r + 2, -r - 1: r + 2]
    d = np.hypot(yy, xx)
    alpha = np.clip(1.0 - np.abs(d - r), 0.0, 1.0)
    ys, xs = np.nonzero(alpha)
    _blend(img, ys + cy - r - 1, xs + cx - r - 1, alpha[ys, xs], color)


def _draw_line_aa(img, y0, x0, y1, x1, color):
    """Anti-aliased segment by its perpendicular-distance coverage."""
    ymin, ymax = sorted((y0, y1))
    xmin, xmax = sorted((x0, x1))
    yy, xx = np.mgrid[ymin - 1: ymax + 2, xmin - 1: xmax + 2]
    dy, dx = y1 - y0, x1 - x0
    L2 = float(dy * dy + dx * dx)
    if L2 == 0:
        d = np.hypot(yy - y0, xx - x0)
    else:
        t = np.clip(((yy - y0) * dy + (xx - x0) * dx) / L2, 0.0, 1.0)
        d = np.hypot(yy - (y0 + t * dy), xx - (x0 + t * dx))
    alpha = np.clip(1.0 - d, 0.0, 1.0)
    ys, xs = np.nonzero(alpha)
    _blend(img, ys + ymin - 1, xs + xmin - 1, alpha[ys, xs], color)


def _render_descriptors(image, descs, step, radius, sigmas, ring_radii,
                        orientation_angles, theta, rings, histograms,
                        orientations):
    """The sampling geometry drawn over the image: red centre circles and
    bins, ring histograms in a green-blue ramp, each bin's line scaled by
    its share of the descriptor's largest bin."""
    descs_img = np.repeat(image[:, :, None], 3, axis=2).astype(float)
    for i in range(descs.shape[0]):
        for j in range(descs.shape[1]):
            color = [1, 0, 0]
            desc_y = i * step + radius
            desc_x = j * step + radius
            _draw_circle_aa(
                descs_img, desc_y, desc_x, int(sigmas[0]), color
            )
            max_bin = float(np.max(descs[i, j, :]))
            if max_bin == 0:
                max_bin = 1.0
            for o_num, o in enumerate(orientation_angles):
                bin_size = float(descs[i, j, o_num]) / max_bin
                dy = sigmas[0] * bin_size * math.sin(o)
                dx = sigmas[0] * bin_size * math.cos(o)
                _draw_line_aa(
                    descs_img, desc_y, desc_x,
                    int(desc_y + dy), int(desc_x + dx), color,
                )
            for r_num, r in enumerate(ring_radii):
                color_offset = float(1 + r_num) / rings
                color = (1 - color_offset, 1, color_offset)
                for t_num, t in enumerate(theta):
                    hist_y = desc_y + int(round(r * math.sin(t)))
                    hist_x = desc_x + int(round(r * math.cos(t)))
                    _draw_circle_aa(
                        descs_img, hist_y, hist_x,
                        int(sigmas[r_num + 1]), color,
                    )
                    for o_num, o in enumerate(orientation_angles):
                        bin_size = float(
                            descs[
                                i, j,
                                orientations
                                + r_num * histograms * orientations
                                + t_num * orientations
                                + o_num,
                            ]
                        ) / max_bin
                        dy = sigmas[r_num + 1] * bin_size * math.sin(o)
                        dx = sigmas[r_num + 1] * bin_size * math.cos(o)
                        _draw_line_aa(
                            descs_img, hist_y, hist_x,
                            int(hist_y + dy), int(hist_x + dx), color,
                        )
    return descs_img
