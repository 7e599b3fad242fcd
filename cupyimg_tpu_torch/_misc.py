"""Miscellaneous utilities: ``convolve_separable`` (an n-d convolution
by one ``convolve1d`` per axis: for CUDA float32 data under
``dtype_mode="float"`` one fused separable kernel launch an axis),
``cache_source`` (a profile of what a call ran, written to text files)
and ``PerformanceWarning``.
"""

from __future__ import annotations

import contextlib
import os

__all__ = [
    "convolve_separable",
    "cache_source",
    "PerformanceWarning",
]


class PerformanceWarning(UserWarning):
    """Warns that a code path is known to be slow on the device."""


def convolve_separable(x, w, axes=None, **kwargs):
    """n-dimensional convolution by separable 1-d filters.

    Parameters
    ----------
    x : tensor or array
        The input.
    w : 1-d array or sequence of 1-d arrays
        One filter applied along each axis in ``axes``, or one filter per
        axis.
    axes : sequence of int, optional
        The axes to filter (all by default).
    **kwargs
        Passed to ``scipy.ndimage.convolve1d`` (``mode``, ``cval``,
        ``dtype_mode``, ...).
    """
    import numpy as np

    from cupyimg_tpu_torch.core import util
    from cupyimg_tpu_torch.scipy.ndimage import convolve1d

    x = util.as_tensor(x)
    axes = list(range(x.ndim) if axes is None else axes)
    if isinstance(w, (list, tuple)):
        filters = list(w)
        if len(filters) != len(axes):
            raise ValueError("must have one filter per axis")
    else:
        if np.ndim(w) != 1:
            raise ValueError("w must be 1-d or a sequence of 1-d")
        filters = [w] * len(axes)
    for ax, f in zip(axes, filters):
        x = convolve1d(x, f, axis=ax, **kwargs)
    return x


@contextlib.contextmanager
def cache_source(out_dir=None):
    """A context manager that yields ``dump(name, fn, *args, **kwargs)``:
    it calls ``fn(*args, **kwargs)`` under torch's kineto profiler (the
    engine of ``torch.profiler``; CUDA kernels too where there is a card)
    and writes the table of the operators and kernels it ran into
    ``<out_dir>/<name>.profile.txt`` (``out_dir`` defaults to
    ``./torch_profile_cache``).  ``dump`` returns ``<out_dir>/<name>``."""
    import torch

    out_dir = out_dir or os.path.join(os.getcwd(), "torch_profile_cache")
    os.makedirs(out_dir, exist_ok=True)

    def dump(name, fn, *args, **kwargs):
        cuda = torch.cuda.is_available()
        with torch.autograd.profiler.profile(
                use_kineto=True, use_device="cuda" if cuda else None) as prof:
            fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
        table = prof.key_averages().table(
            sort_by="device_time_total" if cuda else "cpu_time_total",
            row_limit=-1)
        path = os.path.join(out_dir, name)
        with open(path + ".profile.txt", "w") as f:
            f.write(table)
        return path

    yield dump
