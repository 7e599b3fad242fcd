"""Colour differences in CIELAB (skimage.color.delta_e) on torch tensors:
the published CIE76, CIE94, CIEDE2000 and CMC l:c formulas, in
float64."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.skimage.color.colorconv import lab2lch

__all__ = [
    "deltaE_cie76",
    "deltaE_ciede94",
    "deltaE_ciede2000",
    "deltaE_cmc",
]


def _unpack_lab(lab):
    lab = util.as_tensor(lab).to(torch.float64)
    return lab[..., 0], lab[..., 1], lab[..., 2]


def deltaE_cie76(lab1, lab2):
    """Euclidean distance in CIELAB (CIE76)."""
    L1, a1, b1 = _unpack_lab(lab1)
    L2, a2, b2 = _unpack_lab(lab2)
    return torch.sqrt((L2 - L1) ** 2 + (a2 - a1) ** 2 + (b2 - b1) ** 2)


def deltaE_ciede94(lab1, lab2, kH=1, kC=1, kL=1, k1=0.045, k2=0.015):
    """CIE94 colour difference (not symmetric: ``lab1`` is the
    reference)."""
    L1, C1 = _unpack_lab(lab2lch(lab1))[:2]
    L2, C2 = _unpack_lab(lab2lch(lab2))[:2]
    dL = L1 - L2
    dC = C1 - C2
    dE2 = deltaE_cie76(lab1, lab2) ** 2
    dH2 = torch.clamp(dE2 - dL ** 2 - dC ** 2, min=0)
    SL = 1.0
    SC = 1 + k1 * C1
    SH = 1 + k2 * C1
    dE2 = (dL / (kL * SL)) ** 2
    dE2 = dE2 + (dC / (kC * SC)) ** 2
    dE2 = dE2 + dH2 / (kH * SH) ** 2
    return torch.sqrt(torch.clamp(dE2, min=0))


def _cart2polar_2pi(x, y):
    return torch.hypot(x, y), torch.atan2(y, x) % (2 * np.pi)


def deltaE_ciede2000(lab1, lab2, kL=1, kC=1, kH=1):
    """CIEDE2000 colour difference (Sharma, Wu and Dalal's
    formulation)."""
    L1, a1, b1 = _unpack_lab(lab1)
    L2, a2, b2 = _unpack_lab(lab2)

    # distort a* by the mean chroma
    Cbar = 0.5 * (torch.hypot(a1, b1) + torch.hypot(a2, b2))
    c7 = Cbar ** 7
    G = 0.5 * (1 - torch.sqrt(c7 / (c7 + 25.0 ** 7)))
    scale = 1 + G
    C1, h1 = _cart2polar_2pi(a1 * scale, b1)
    C2, h2 = _cart2polar_2pi(a2 * scale, b2)

    # lightness term
    Lbar = 0.5 * (L1 + L2)
    tmp = (Lbar - 50) ** 2
    SL = 1 + 0.015 * tmp / torch.sqrt(20 + tmp)
    L_term = (L2 - L1) / (kL * SL)

    # chroma term
    Cbar = 0.5 * (C1 + C2)
    SC = 1 + 0.045 * Cbar
    C_term = (C2 - C1) / (kC * SC)

    # hue term, the difference wrapped into (-pi, pi]
    h_diff = h2 - h1
    h_sum = h1 + h2
    CC = C1 * C2
    dH = torch.where(h_diff > np.pi, h_diff - 2 * np.pi, h_diff)
    dH = torch.where(h_diff < -np.pi, h_diff + 2 * np.pi, dH)
    dH = torch.where(CC == 0.0, 0.0, dH)
    dH_term = 2 * torch.sqrt(CC) * torch.sin(dH / 2)

    mask = (CC != 0.0) & (torch.abs(h_diff) > np.pi)
    Hbar = torch.where(mask & (h_sum < 2 * np.pi), h_sum + 2 * np.pi, h_sum)
    Hbar = torch.where(mask & (h_sum >= 2 * np.pi), h_sum - 2 * np.pi,
                       Hbar)
    Hbar = torch.where(CC == 0.0, Hbar * 2, Hbar)
    Hbar = Hbar * 0.5

    T = (
        1
        - 0.17 * torch.cos(Hbar - np.deg2rad(30))
        + 0.24 * torch.cos(2 * Hbar)
        + 0.32 * torch.cos(3 * Hbar + np.deg2rad(6))
        - 0.20 * torch.cos(4 * Hbar - np.deg2rad(63))
    )
    SH = 1 + 0.015 * Cbar * T
    H_term = dH_term / (kH * SH)

    # hue rotation
    c7 = Cbar ** 7
    Rc = 2 * torch.sqrt(c7 / (c7 + 25.0 ** 7))
    dtheta = np.deg2rad(30) * torch.exp(
        -(((torch.rad2deg(Hbar) - 275) / 25) ** 2)
    )
    R_term = -torch.sin(2 * dtheta) * Rc * C_term * H_term

    dE2 = L_term ** 2 + C_term ** 2 + H_term ** 2 + R_term
    return torch.sqrt(torch.clamp(dE2, min=0))


def deltaE_cmc(lab1, lab2, kL=1, kC=1):
    """CMC l:c colour difference (not symmetric: ``lab1`` is the
    reference)."""
    L1, C1, h1 = _unpack_lab(lab2lch(lab1))
    L2, C2, h2 = _unpack_lab(lab2lch(lab2))

    dC = C1 - C2
    dL = L1 - L2
    dE2 = deltaE_cie76(lab1, lab2) ** 2
    dH2 = torch.clamp(dE2 - dL ** 2 - dC ** 2, min=0)

    h1_deg = torch.rad2deg(h1)
    T = torch.where(
        (h1_deg >= 164) & (h1_deg <= 345),
        0.56 + 0.2 * torch.abs(torch.cos(h1 + np.deg2rad(168))),
        0.36 + 0.4 * torch.abs(torch.cos(h1 + np.deg2rad(35))),
    )
    c1_4 = C1 ** 4
    F = torch.sqrt(c1_4 / (c1_4 + 1900))

    SL = torch.where(L1 < 16, 0.511, 0.040975 * L1 / (1.0 + 0.01765 * L1))
    SC = 0.638 + 0.0638 * C1 / (1.0 + 0.0131 * C1)
    SH = SC * (F * T + 1 - F)

    dE2 = (dL / (kL * SL)) ** 2
    dE2 = dE2 + (dC / (kC * SC)) ** 2
    dE2 = dE2 + dH2 / (SH ** 2)
    return torch.sqrt(torch.clamp(dE2, min=0))


def get_dH2(lab1, lab2):
    """The squared hue difference of ``deltaE_cmc``/``deltaE_ciede94`` in
    the round-off-stable form ``2 * (|ab1| |ab2| - ab1 . ab2)``."""
    lab1 = util.as_tensor(lab1)
    lab2 = util.as_tensor(lab2, device=lab1.device)
    a1, b1 = lab1[..., 1], lab1[..., 2]
    a2, b2 = lab2[..., 1], lab2[..., 2]
    C1 = torch.hypot(a1, b1)
    C2 = torch.hypot(a2, b2)
    term = (C1 * C2) - (a1 * a2 + b1 * b2)
    return 2 * term
