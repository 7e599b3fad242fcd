"""The least time of a spline gather (``affine_transform``), from its
shapes and arguments.

Bytes: one read of the input and one write of the output.  Work: 2
flops per tap of the product of the axes' (order + 1) taps per output
sample.  Nothing else: the coordinates and the spline weights are the
implementation's work, not the call's, so another way of computing them
leaves this bound where it is.
"""

import math

from portbench.bounds._peaks import least_s


def bound_s(fn, shape, itemsize, args, operands):
    """Seconds: the least time of ``fn`` on an input of ``shape``."""
    if fn != "affine_transform":
        raise KeyError(f"no gather bound for {fn}")
    n_in = math.prod(shape)
    n_out = math.prod(args.get("output_shape") or shape)
    taps = (int(args.get("order", 3)) + 1) ** len(shape)
    return least_s(itemsize * (n_in + n_out), 2.0 * taps * n_out)
