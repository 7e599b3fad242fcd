"""Polyphase upsample-FIR-downsample (scipy.signal.upfirdn) on torch
tensors.

The up -> filter -> down cascade runs as a static polyphase
decomposition: each of the ``up / gcd(up, down)`` output phases is one
strided 1-D correlation of the input with that phase's taps (one
``conv1d`` call, TF32 off).  The nine signal-extension modes are explicit
pre-extensions with an alignment shift so that the decimation grid
matches scipy's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = ["upfirdn", "upfirdn_out_len", "upfirdn_modes"]

upfirdn_modes = [
    "constant",
    "wrap",
    "edge",
    "smooth",
    "symmetric",
    "reflect",
    "antisymmetric",
    "antireflect",
    "line",
]


def upfirdn_out_len(len_h: int, in_len: int, up: int, down: int) -> int:
    """Output length of upfirdn (scipy's _output_len)."""
    return (((in_len - 1) * up + len_h) - 1) // down + 1


def _sym_idx(idx, n):
    period = 2 * n
    im = idx % period
    return np.where(im < n, im, period - 1 - im)


def _refl_idx(idx, n):
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    im = idx % period
    return np.where(im < n, im, period - im)


def _ramp(k, x):
    """``k`` (host numbers) as a float64 tensor broadcasting along the
    last axis of ``x``."""
    return torch.as_tensor(np.asarray(k, np.float64), device=x.device)


def _pad_antireflect(x, npre: int, npost: int):
    """numpy's ``pad(mode='reflect', reflect_type='odd')`` along the last
    axis: odd reflections about the edge values, each chunk reflected
    about the current edge (numpy's ``_set_reflect_both`` loop)."""
    n = x.shape[-1]
    out = x.new_zeros(x.shape[:-1] + (npre + n + npost,))
    out[..., npre:npre + n] = x
    left, right = npre, npost
    while left > 0 or right > 0:
        old = out.shape[-1] - left - right
        old = (old - 1) // (n - 1) * (n - 1) + 1 - 1 if n > 1 else 0
        if old == 0:  # a single sample reflects onto itself
            out[..., :left] = out[..., left:left + 1]
            out[..., out.shape[-1] - right:] = out[
                ..., out.shape[-1] - right - 1:out.shape[-1] - right]
            break
        if left > 0:
            c = min(old, left)
            chunk = torch.flip(out[..., left + 1:left + 1 + c], (-1,))
            out[..., left - c:left] = 2 * out[..., left:left + 1] - chunk
            left -= c
        if right > 0:
            c = min(old, right)
            end = out.shape[-1] - right
            chunk = torch.flip(out[..., end - 1 - c:end - 1], (-1,))
            out[..., end:end + c] = 2 * out[..., end - 1:end] - chunk
            right -= c
    return out


def _pad_1d_mode(x, npre: int, npost: int, mode: str, cval):
    """Extend ``x`` along its last axis with one of the 9 upfirdn modes."""
    if npre == 0 and npost == 0:
        return x
    n = x.shape[-1]
    pre_idx = np.arange(-npre, 0)
    post_idx = np.arange(n, n + npost)

    def take(idx):
        return x[..., torch.as_tensor(idx, dtype=torch.long,
                                      device=x.device)]

    if mode == "constant":
        out = x.new_full(x.shape[:-1] + (npre + n + npost,), cval)
        out[..., npre:npre + n] = x
        return out
    if mode == "antireflect":
        return _pad_antireflect(x, npre, npost)
    if mode == "edge":
        pre, post = take(np.zeros(npre, int)), take(np.full(npost, n - 1))
    elif mode == "wrap":
        pre, post = take(pre_idx % n), take(post_idx % n)
    elif mode == "symmetric":
        pre, post = take(_sym_idx(pre_idx, n)), take(_sym_idx(post_idx, n))
    elif mode == "reflect":
        pre, post = take(_refl_idx(pre_idx, n)), take(_refl_idx(post_idx, n))
    elif mode == "antisymmetric":
        # mirror with a sign flip per reflection:
        # value(i) = (-1)^floor(i/n) * x[sym(i)]
        def anti(idx):
            sign = np.where(np.floor_divide(idx, n) % 2 == 0, 1.0, -1.0)
            return take(_sym_idx(idx, n)) * _ramp(sign, x).to(x.dtype)

        pre, post = anti(pre_idx), anti(post_idx)
    elif mode in ("smooth", "line"):
        if n < 2:
            raise ValueError(f"{mode} mode requires at least 2 samples")
        first, last = x[..., :1], x[..., n - 1:]
        if mode == "smooth":  # continue the slope of the outer two samples
            slope0 = x[..., 1:2] - first
            slope1 = last - x[..., n - 2:n - 1]
        else:
            slope0 = slope1 = (last - first) / max(n - 1, 1)
        pre = first - _ramp(np.arange(npre, 0, -1), x) * slope0
        post = last + _ramp(np.arange(1, npost + 1), x) * slope1
    else:
        raise ValueError(f"unknown upfirdn mode: {mode}")
    return torch.cat([pre.to(x.dtype), x, post.to(x.dtype)], dim=-1)


def _strided_corr(xin, w, stride: int, length: int):
    """``out[..., s] = sum_j w[j] * xin[..., s * stride + j]`` for
    ``s < length``: one ``conv1d`` over the flattened leading axes, TF32
    off (``xin`` and ``w`` share one dtype, real or complex)."""
    from cupyimg_tpu_torch.scipy.signal.signaltools import _no_tf32

    lead = xin.shape[:-1]
    flat = xin.reshape((-1, 1, xin.shape[-1]))
    need = (length - 1) * stride + w.shape[0]
    with _no_tf32():
        y = torch.nn.functional.conv1d(flat[..., :need], w.reshape(1, 1, -1),
                                       stride=stride)
    return y.reshape(lead + (length,))


def _upfirdn_zero(h, x, up: int, down: int, out_len: int):
    """Zero-extension upfirdn along the LAST axis.

    Output index ``m = p + P*s`` with ``P = up / gcd(up, down)`` phases.
    ``out[m] = sum_j h[j] * xup[m*down - j]`` with ``xup[l] = x[l/up]``
    when ``up | l``; substituting ``j = r + up*t`` with
    ``r = (m*down) % up`` gives ``out[m] = sum_t h[r + up*t] *
    x[(m*down)//up - t]``: phase ``p`` reads ``x`` from ``q0 = p*down //
    up`` with stride ``D = down / gcd``, a correlation with its taps
    reversed."""
    len_h = h.shape[0]
    n = x.shape[-1]
    g = math.gcd(up, down)
    P, D = up // g, down // g
    T = (len_h + up - 1) // up  # the most taps of one phase
    L = -(-out_len // P)  # outputs per phase (padded)
    q_max = ((P - 1) * down) // up + D * (L - 1)
    lead = x.shape[:-1]
    xp = x.new_zeros(lead + (T + max(n, q_max + 1) + T,))
    xp[..., T:T + n] = x
    phases = []
    for p in range(P):
        r = (p * down) % up
        q0 = (p * down) // up
        taps = h[r::up]
        if taps.shape[0] == 0:
            phases.append(x.new_zeros(lead + (L,)))
            continue
        tp = taps.shape[0]
        start = q0 - (tp - 1) + T
        phases.append(_strided_corr(xp[..., start:], torch.flip(taps, (0,)),
                                    D, L))
    out = torch.stack(phases, dim=-1).reshape(lead + (L * P,))
    return out[..., :out_len]


def upfirdn(
    h,
    x,
    up=1,
    down=1,
    axis=-1,
    mode="constant",
    cval=0,
    *,
    prepadded=False,
    out=None,
    offset=0,
    crop=False,
    take=None,
):
    """Upsample by ``up``, FIR filter with ``h``, downsample by ``down``
    (scipy.signal.upfirdn, with all 9 extension modes).

    ``crop=True`` trims the output to the input's extent
    (``ceil(n_in * up / down)`` samples), ``offset`` drops that many
    leading samples first, and ``take`` limits the output length;
    ``prepadded``/``out`` are not supported and must stay at their
    defaults.  ``mode="zero"`` and ``"periodic"`` are aliases of
    ``"constant"`` (with ``cval=0``) and ``"wrap"``.
    """
    if prepadded or out is not None:
        raise NotImplementedError(
            "prepadded/out are not supported (functional framework)"
        )
    if mode == "zero":
        mode, cval = "constant", 0
    elif mode == "periodic":
        mode = "wrap"
    x = util.as_tensor(x)
    h = util.as_tensor(h, device=x.device)
    if h.ndim != 1 or h.shape[0] == 0:
        raise ValueError("h must be 1-D with non-zero length")
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("Both up and down must be >= 1")
    axis = util.check_axis(axis, x.ndim)

    dtype = np.promote_types(
        np.promote_types(dtypes.to_numpy(h.dtype), dtypes.to_numpy(x.dtype)),
        np.float32,
    )
    tdtype = dtypes.to_torch(dtype)
    h = h.to(tdtype)
    xm = torch.movedim(x.to(tdtype), axis, -1)
    n_in = xm.shape[-1]
    len_h = h.shape[0]
    out_len = upfirdn_out_len(len_h, n_in, up, down)

    if mode == "constant" and complex(cval) == 0:
        y = _upfirdn_zero(h, xm, up, down, out_len)
    else:
        # pre-extend so that taps never read outside, the left extension a
        # multiple of down/gcd(up, down) so that the decimation grid
        # realigns
        reach = -(-(len_h - 1) // up) + 1
        step = down // math.gcd(up, down)
        npre = -(-reach // step) * step
        xe = _pad_1d_mode(xm, npre, reach, mode, cval)
        poff = npre * up // down
        ext_out_len = upfirdn_out_len(len_h, xe.shape[-1], up, down)
        y = _upfirdn_zero(h, xe, up, down, ext_out_len)[
            ..., poff:poff + out_len]

    if offset:
        y = y[..., int(offset):]
    if crop:
        n_keep = -(-n_in * up // down)
        y = y[..., :n_keep]
    if take is not None:
        y = y[..., :int(take)]
    return torch.movedim(y, -1, axis)
