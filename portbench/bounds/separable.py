"""The least time of a separable call, from its shapes and arguments.

Bytes: one read of the input and one write of the output, whatever the
kernels read again.  Work: 2 flops per tap per output sample per
filtered axis of each correlation, one flop per elementwise operation
per sample, and (size - 1) min or max operations per sample per axis of
each min/max pass (``_peaks.PEAK_MINMAX``, an assumed rate).  A
composite call is bounded as a whole: ``edge_enhance_pipeline`` reads
its input once and writes its output once, and its work is the sum of
its filters' taps and its elementwise operations, so that fusing its
elementwise work is credited.
"""

import math

from portbench.bounds._peaks import least_s


def _sizes(size, ndim):
    return list(size) if isinstance(size, (list, tuple)) else [size] * ndim


def gaussian_taps(sigma, truncate=4.0):
    """Taps of scipy's gaussian on one axis: 2 * int(truncate * sigma +
    0.5) + 1."""
    return 2 * int(truncate * float(sigma) + 0.5) + 1


def work(fn, ndim, args):
    """(flops, minmax) per output sample of one call."""
    if fn == "uniform_filter":
        return 2.0 * sum(_sizes(args.get("size", 3), ndim)), 0.0
    if fn == "edge_enhance_pipeline":
        gauss = 2.0 * gaussian_taps(args.get("sigma", 1.5)) * ndim
        sobels = ndim * 2.0 * 3 * ndim  # a 3-tap pass on every axis each
        # d*d per axis, the sum's adds, sqrt, (1+a)*x, a*sm, -, 0.1*g, +
        elementwise = ndim + (ndim - 1) + 6
        return gauss + sobels + elementwise, 0.0
    if fn == "grey_opening":
        sizes = _sizes(args["size"], ndim)
        return 0.0, 2.0 * sum(s - 1 for s in sizes)
    raise KeyError(f"no separable bound for {fn}")


def bound_s(fn, shape, itemsize, args, operands):
    """Seconds: the least time of ``fn`` on an input of ``shape``."""
    n = math.prod(shape)
    flops, minmax = work(fn, len(shape), args)
    return least_s(2.0 * itemsize * n, n * flops, n * minmax)
