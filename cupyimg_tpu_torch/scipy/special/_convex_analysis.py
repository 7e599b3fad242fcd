"""scipy.special's convex-analysis functions (``entr``, ``kl_div``,
``rel_entr``, ``huber``, ``pseudo_huber``) on torch tensors, with scipy's
``inf``/``nan`` cases: elementwise torch expressions.

Integer and bool inputs give float64 and float16 gives float32 (scipy's
ufuncs have float32 and float64 loops only); two arguments promote as
numpy promotes them.  As scipy's float32 loops do, every function computes
in float64 and rounds once to the result type.  The arguments go to the
device of the first tensor among them (``config.device`` when none is a
tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util

__all__ = ["entr", "kl_div", "rel_entr", "huber", "pseudo_huber"]


def _as_float(*args):
    """The arguments as broadcast float64 tensors on one device, and the
    result dtype."""
    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
    dev = None if first is None else first.device
    ts = [util.as_tensor(a, device=dev) for a in args]
    kinds = []
    for t in ts:
        dt = dtypes.to_numpy(t.dtype)
        if dt.kind != "f":
            dt = np.dtype(np.float64)
        elif dt == np.float16:
            dt = np.dtype(np.float32)
        kinds.append(dt)
    out = torch.broadcast_tensors(*[t.to(torch.float64) for t in ts])
    return out, dtypes.to_torch(np.result_type(*kinds))


def entr(x):
    """``-x log(x)`` for x > 0, 0 at x = 0, -inf for x < 0 (NaN stays
    NaN)."""
    (x,), res = _as_float(x)
    safe = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, -safe * torch.log(safe),
                       torch.where(x == 0, 0.0,
                                   torch.where(x < 0, -torch.inf, x))
                       ).to(res)


def kl_div(x, y):
    """``x log(x / y) - x + y`` for x, y > 0; ``y`` where x = 0 and
    y >= 0; inf elsewhere (NaN stays NaN)."""
    (x, y), res = _as_float(x, y)
    safe_x = torch.where(x > 0, x, 1.0)
    safe_y = torch.where(y > 0, y, 1.0)
    main = safe_x * torch.log(safe_x / safe_y) - x + y
    out = torch.where((x > 0) & (y > 0), main,
                      torch.where((x == 0) & (y >= 0), y, torch.inf))
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out).to(res)


def rel_entr(x, y):
    """``x log(x / y)`` for x, y > 0; 0 where x = 0 and y >= 0; inf
    elsewhere (NaN stays NaN)."""
    (x, y), res = _as_float(x, y)
    safe_x = torch.where(x > 0, x, 1.0)
    safe_y = torch.where(y > 0, y, 1.0)
    t = safe_x / safe_y
    # scipy's branches: log1p near t = 1, the difference of the logs
    # where x / y over- or underflows
    main = torch.where(
        (t > 0.5) & (t < 2),
        safe_x * torch.log1p((safe_x - safe_y) / safe_y),
        torch.where((t == 0) | torch.isinf(t),
                    safe_x * (torch.log(safe_x) - torch.log(safe_y)),
                    safe_x * torch.log(t)))
    out = torch.where((x > 0) & (y > 0), main,
                      torch.where((x == 0) & (y >= 0), 0.0, torch.inf))
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out).to(res)


def huber(delta, r):
    """Huber loss: ``r^2 / 2`` where |r| <= delta, else
    ``delta (|r| - delta / 2)``; inf for delta < 0."""
    (delta, r), res = _as_float(delta, r)
    abs_r = torch.abs(r)
    quad = 0.5 * r * r
    lin = delta * (abs_r - 0.5 * delta)
    return torch.where(delta < 0, torch.inf,
                       torch.where(abs_r <= delta, quad, lin)).to(res)


def pseudo_huber(delta, r):
    """Pseudo-Huber loss ``delta^2 (sqrt(1 + (r / delta)^2) - 1)``; 0 for
    delta = 0 or r = 0, inf for delta < 0."""
    (delta, r), res = _as_float(delta, r)
    safe_delta = torch.where(delta != 0, delta, 1.0)
    rd = r / safe_delta
    # scipy's form, exact for small r / delta: sqrt(1 + v^2) - 1 as
    # expm1(log1p(v^2) / 2)
    val = delta * delta * torch.expm1(0.5 * torch.log1p(rd * rd))
    return torch.where(delta < 0, torch.inf,
                       torch.where((delta == 0) | (r == 0), 0.0, val)
                       ).to(res)
