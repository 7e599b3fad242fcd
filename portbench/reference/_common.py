"""Plain PyTorch building blocks of the references: scipy.ndimage's
boundary extension and 1-D passes along one axis, from their
definitions.  Nothing here comes from cupyimg_tpu_torch.
"""

import torch


def fold_index(i, n, mode):
    """The sample of an axis of ``n`` that index ``i`` (any integers)
    reads under scipy.ndimage's ``mode``."""
    if mode == "reflect":        # d c b a | a b c d | d c b a
        j = torch.remainder(i, 2 * n)
        return torch.where(j >= n, 2 * n - 1 - j, j)
    if mode == "mirror":         # d c b | a b c d | c b a
        if n == 1:
            return torch.zeros_like(i)
        j = torch.remainder(i, 2 * n - 2)
        return torch.where(j >= n, 2 * n - 2 - j, j)
    if mode == "nearest":        # a a a | a b c d | d d d
        return i.clamp(0, n - 1)
    if mode in ("wrap", "grid-wrap"):
        return torch.remainder(i, n)
    raise ValueError(f"mode {mode!r} has no reference here")


def extend_index(n, lo, hi, mode, device):
    """Source index of each sample of an axis of ``n`` extended by ``lo``
    before and ``hi`` after."""
    return fold_index(torch.arange(-lo, n + hi, device=device), n, mode)


def _extended(x, axis, lo, hi, mode):
    idx = extend_index(x.shape[axis], lo, hi, mode, x.device)
    return torch.index_select(x, axis, idx)


def correlate1d(x, weights, axis, mode="reflect"):
    """scipy.ndimage.correlate1d with origin 0 and an odd number of taps,
    in ``x``'s dtype: out[i] = sum_j w[j] x[i + j - r]."""
    weights = [float(w) for w in weights]
    if len(weights) % 2 != 1:
        raise ValueError("odd tap counts only")
    r = len(weights) // 2
    n = x.shape[axis]
    xe = _extended(x, axis, r, r, mode)
    out = None
    for j, w in enumerate(weights):
        if w == 0.0:
            continue
        term = xe.narrow(axis, j, n) * torch.tensor(w, dtype=x.dtype,
                                                    device=x.device)
        out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(x)


def minmax1d(x, size, axis, op, mode="reflect"):
    """scipy.ndimage.minimum_filter1d / maximum_filter1d with origin 0 and
    an odd ``size``: the ``op`` (torch.minimum or torch.maximum) of the
    window of ``size`` centred on each sample."""
    if size % 2 != 1:
        raise ValueError("odd sizes only")
    r = size // 2
    n = x.shape[axis]
    xe = _extended(x, axis, r, r, mode)
    out = xe.narrow(axis, 0, n)
    for j in range(1, size):
        out = op(out, xe.narrow(axis, j, n))
    return out


def gaussian_weights(sigma, truncate=4.0):
    """scipy's order-0 gaussian taps: exp(-x^2 / (2 sigma^2)) over
    |x| <= int(truncate * sigma + 0.5), normalised to sum 1, in float64."""
    r = int(truncate * float(sigma) + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float64)
    phi = torch.exp(-0.5 * x * x / (float(sigma) ** 2))
    return (phi / phi.sum()).tolist()
