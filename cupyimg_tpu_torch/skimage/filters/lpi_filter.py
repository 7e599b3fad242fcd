"""Linear position-invariant filtering (skimage.filters.lpi_filter) on
torch tensors: the filter's and the data's spectra by ``torch.fft`` on
the zero-padded (2n - 1) grid; ``LPIFilter2D`` caches the filter's."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

__all__ = ["LPIFilter2D", "inverse", "wiener", "filter_forward", "forward"]

eps = np.finfo(float).eps


def _min_limit(x, val=eps):
    """Values of magnitude below ``val`` moved out to it (0 to ``val``)."""
    return torch.where(torch.abs(x) < val,
                       torch.sgn(x) * val + (x == 0) * val, x)


def _center(x, oshape):
    """The centre ``oshape`` portion of ``x``."""
    start = (np.array(x.shape) - np.array(oshape)) // 2 + 1
    return x[tuple(slice(int(s), int(s) + o) for s, o in zip(start, oshape))]


def _pad(data, shape):
    """``data`` zero-padded to ``shape`` (anchored at the origin)."""
    out = data.new_zeros(tuple(shape))
    out[tuple(slice(0, s) for s in data.shape)] = data
    return out


class LPIFilter2D:
    """Linear position-invariant filter given by an impulse-response
    function of (row, column) offsets from the centre; it receives and
    returns torch tensors."""

    def __init__(self, impulse_response, **filter_params):
        if impulse_response is None:
            raise ValueError("Impulse response must be a callable.")
        self.impulse_response = impulse_response
        self.filter_params = filter_params
        self._cache = None

    def _prepare(self, data):
        dshape = np.array(data.shape)
        dshape += dshape % 2 == 0  # odd
        oshape = tuple(int(v) for v in np.array(data.shape) * 2 - 1)
        if self._cache is None or tuple(self._cache.shape) != oshape:
            coords = np.mgrid[[slice(0, float(n)) for n in dshape]]
            for k, coord in enumerate(coords):
                coord -= (dshape[k] - 1) / 2.0
            coords = coords.reshape(2, -1).T  # (row, col)
            f = util.as_tensor(self.impulse_response(
                util.as_tensor(coords[:, 0], device=data.device),
                util.as_tensor(coords[:, 1], device=data.device),
                **self.filter_params), device=data.device).reshape(
                    tuple(int(v) for v in dshape))
            F = torch.fft.fftn(_pad(f, oshape))
            self._cache = F
        else:
            F = self._cache
        G = torch.fft.fftn(_pad(data, oshape))
        return F, G

    def __call__(self, data):
        data = util.as_tensor(data)
        F, G = self._prepare(data)
        return _center(torch.fft.ifftn(F * G).real, data.shape)


def filter_forward(data, impulse_response=None, filter_params=None,
                   predefined_filter=None):
    """Apply a linear position-invariant filter."""
    if filter_params is None:
        filter_params = {}
    if predefined_filter is None:
        predefined_filter = LPIFilter2D(impulse_response, **filter_params)
    return predefined_filter(data)


# the reference's name for filter_forward
forward = filter_forward


def inverse(data, impulse_response=None, filter_params=None, max_gain=2,
            predefined_filter=None):
    """Inverse filtering, the gain limited to ``max_gain``."""
    if filter_params is None:
        filter_params = {}
    filt = (LPIFilter2D(impulse_response, **filter_params)
            if predefined_filter is None else predefined_filter)
    data = util.as_tensor(data)
    F, G = filt._prepare(data)
    F = _min_limit(F)
    F = torch.conj(F) / (torch.abs(F) ** 2)
    mask = torch.abs(F) > max_gain
    F = torch.where(mask, torch.sgn(F) * max_gain, F)
    return _center(torch.fft.ifftn(G * F).real, data.shape)


def wiener(data, impulse_response=None, filter_params=None, K=0.25,
           predefined_filter=None):
    """Minimum mean-square-error (Wiener) inverse filtering with the
    noise-to-signal ratio ``K``."""
    if filter_params is None:
        filter_params = {}
    if not isinstance(K, float):
        raise ValueError("K must be a float")
    filt = (LPIFilter2D(impulse_response, **filter_params)
            if predefined_filter is None else predefined_filter)
    data = util.as_tensor(data)
    F, G = filt._prepare(data)
    F = _min_limit(F)
    H_mag_sqr = torch.abs(F) ** 2
    F = 1 / F * H_mag_sqr / (H_mag_sqr + K)
    return _center(torch.fft.ifftn(G * F).real, data.shape)


def constrained_least_squares(data, lam, impulse_response=None,
                              filter_params=None):
    raise NotImplementedError
