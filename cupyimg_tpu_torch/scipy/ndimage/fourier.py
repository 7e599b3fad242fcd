"""scipy.ndimage's Fourier-domain filters on torch tensors: multiply an
FFT-domain tensor by a separable (or radial) frequency response, in plain
PyTorch.

The port of ``cupyimg_tpu/scipy/ndimage/fourier.py``.  The response is
formed in float64 on the input's device and multiplied in; one cast at the
end keeps single precision single.  ``output`` may be None (scipy's
default dtype) or a dtype; an output array is not supported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = [
    "fourier_gaussian",
    "fourier_uniform",
    "fourier_shift",
    "fourier_ellipsoid",
]


def _get_fft_axes(x, n, axis):
    """Per-axis frequency grids, broadcastable against ``x``: if n > 0,
    the ``axis`` dimension holds a real FFT of a length-n signal."""
    ndim = x.ndim
    axis = util.check_axis(axis, ndim)
    freqs = []
    for ax in range(ndim):
        size = x.shape[ax]
        if ax == axis and n > 0:
            f = torch.arange(size, dtype=torch.float64, device=x.device) / n
        else:
            f = torch.fft.fftfreq(size, dtype=torch.float64, device=x.device)
        shape = [1] * ndim
        shape[ax] = size
        freqs.append(f.reshape(shape))
    return freqs


def _output_dtype(x, output):
    """scipy's output dtype: complex64 and float32 are kept, other
    complex input gives complex128 and everything else float64."""
    if output is not None:
        if isinstance(output, torch.dtype):
            return output
        try:
            return dtypes.to_torch(np.dtype(output))
        except TypeError:
            raise NotImplementedError(
                "output must be None or a dtype; an output array is not "
                "supported") from None
    if x.dtype in (torch.complex64, torch.float32):
        return x.dtype
    return torch.complex128 if x.is_complex() else torch.float64


# Cephes' j1 (double precision): J1(x) = x (x^2 - Z1)(x^2 - Z2) RP(x^2) /
# RQ(x^2) for x <= 5, else the Hankel form with P(25/x^2) and Q(25/x^2).
# RQ and QQ have an implicit leading coefficient 1.
_J1_RP = (-8.99971225705559398224e+08, 4.52228297998194034323e+11,
          -7.27494245221818276015e+13, 3.68295732863852883286e+15)
_J1_RQ = (1.0, 6.20836478118054335476e+02, 2.56987256757748830383e+05,
          8.35146791431949253037e+07, 2.21511595479792499675e+10,
          4.74914122079991414898e+12, 7.84369607876235854894e+14,
          8.95222336184627338078e+16, 5.32278620332680085395e+18)
_J1_PP = (7.62125616208173112003e-04, 7.31397056940917570436e-02,
          1.12719608129684925192e+00, 5.11207951146807644818e+00,
          8.42404590141772420927e+00, 5.21451598682361504063e+00,
          1.00000000000000000254e+00)
_J1_PQ = (5.71323128072548699714e-04, 6.88455908754495404082e-02,
          1.10514232634061696926e+00, 5.07386386128601488557e+00,
          8.39985554327604159757e+00, 5.20982848682361821619e+00,
          9.99999999999999997461e-01)
_J1_QP = (5.10862594750176621635e-02, 4.98213872951233449420e+00,
          7.58238284132545283818e+01, 3.66779609360150777800e+02,
          7.10856304998926107277e+02, 5.97489612400613639965e+02,
          2.11688757100572135698e+02, 2.52070205858023719784e+01)
_J1_QQ = (1.0, 7.42373277035675149943e+01, 1.05644886038262816351e+03,
          4.98641058337653607651e+03, 9.56231892404756170795e+03,
          7.99704160447350683650e+03, 2.82619278517639096600e+03,
          3.36093607810698293419e+02)


def _polevl(x, coefs):
    out = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        out = out * x + c
    return out


def _bessel_j1(x):
    """J1 of a float64 tensor of x >= 0, to double precision (Cephes).
    ``torch.special.bessel_j1`` leaves out the leading coefficient of two
    of these denominators (errors up to 5e-7 for x in 5..10)."""
    z = x * x
    small = (x * (z - 1.46819706421238932572e+01)
             * (z - 4.92184563216946036703e+01)
             * _polevl(z, _J1_RP) / _polevl(z, _J1_RQ))
    xl = torch.clamp(x, min=5.0)
    w = 5.0 / xl
    w2 = w * w
    p = _polevl(w2, _J1_PP) / _polevl(w2, _J1_PQ)
    q = _polevl(w2, _J1_QP) / _polevl(w2, _J1_QQ)
    xn = xl - 2.356194490192344928846982537459627163
    large = ((p * torch.cos(xn) - w * q * torch.sin(xn))
             * 0.797884560802865355879892119868763737 / torch.sqrt(xl))
    return torch.where(x <= 5.0, small, large)


def fourier_gaussian(input, sigma, n=-1, axis=-1, output=None):
    """Multiply by a Gaussian's frequency response
    (scipy.ndimage.fourier_gaussian)."""
    x = util.as_tensor(input)
    sigmas = util.fix_sequence_arg(sigma, x.ndim, "sigma", float)
    dt = _output_dtype(x, output)
    out = x
    for f, s in zip(_get_fft_axes(x, n, axis), sigmas):
        out = out * torch.exp(-2.0 * (math.pi * s) ** 2 * f * f)
    return out.to(dt)


def fourier_uniform(input, size, n=-1, axis=-1, output=None):
    """Multiply by a box filter's frequency response
    (scipy.ndimage.fourier_uniform)."""
    x = util.as_tensor(input)
    sizes = util.fix_sequence_arg(size, x.ndim, "size", float)
    dt = _output_dtype(x, output)
    out = x
    for f, s in zip(_get_fft_axes(x, n, axis), sizes):
        out = out * torch.sinc(f * s)
    return out.to(dt)


def fourier_shift(input, shift, n=-1, axis=-1, output=None):
    """Multiply by a shift's phase ramp (scipy.ndimage.fourier_shift):
    complex64 input stays complex64, everything else becomes
    complex128."""
    x = util.as_tensor(input)
    shifts = util.fix_sequence_arg(shift, x.ndim, "shift", float)
    if output is None:
        dt = (torch.complex64 if x.dtype == torch.complex64
              else torch.complex128)
    else:
        dt = _output_dtype(x, output)
    out = x
    for f, s in zip(_get_fft_axes(x, n, axis), shifts):
        out = out * torch.exp(-2j * math.pi * s * f)
    return out.to(dt)


def fourier_ellipsoid(input, size, n=-1, axis=-1, output=None):
    """Multiply by an ellipsoid's frequency response
    (scipy.ndimage.fourier_ellipsoid; 1 to 3 axes): the sinc in 1-D, the
    jinc 2 J1(z)/z in 2-D (J1 by Cephes' rational forms), and
    3 (sin z - z cos z)/z^3 in 3-D, of the scaled radial frequency."""
    x = util.as_tensor(input)
    if x.ndim > 3:
        raise NotImplementedError("only 1-3 dimensions are supported")
    dt = _output_dtype(x, output)
    if x.numel() == 0:
        return x.to(dt)
    sizes = util.fix_sequence_arg(size, x.ndim, "size", float)
    r2 = None
    for f, s in zip(_get_fft_axes(x, n, axis), sizes):
        term = (f * s) ** 2
        r2 = term if r2 is None else r2 + term
    r = torch.sqrt(r2) * math.pi
    if x.ndim == 1:
        resp = torch.sinc(r / math.pi)
    else:
        zero = r == 0
        z = torch.where(zero, 1e-20, r)
        if x.ndim == 2:
            resp = 2.0 * _bessel_j1(z) / z
        else:
            resp = 3.0 * (torch.sin(z) - z * torch.cos(z)) / z ** 3
        resp = torch.where(zero, 1.0, resp)
    return (x * resp).to(dt)
