"""The least time of ``fftconvolve``, from its shapes and arguments.

Bytes: one read of each operand and one write of the output.  Work:
three transforms (two forward, one inverse) over the linear
convolution's full shape n = s1 + s2 - 1 on each convolved axis.  Both
operands are real, so each is a real transform: 2.5 N log2(n) flops per
axis, N the points of the full shape (half a complex transform's
5 N log2(n): a real transform of N points is a complex one of N / 2, as
the reference's ``rfftn`` computes it), whatever the algorithm and
whatever padded length the implementation picks.
"""

import math

from portbench.bounds._peaks import least_s


def out_numel(s1, s2, mode):
    if mode == "full":
        return math.prod(a + b - 1 for a, b in zip(s1, s2))
    if mode == "same":
        return math.prod(s1)
    return math.prod(max(a - b + 1, 0) for a, b in zip(s1, s2))


def bound_s(fn, shape, itemsize, args, operands):
    """Seconds: the least time of ``fn`` on a real input of ``shape``."""
    if fn != "fftconvolve":
        raise KeyError(f"no fft bound for {fn}")
    other = operands[args["in2"]]
    if other.is_complex():
        raise KeyError("the fft bound counts real operands only")
    s2 = tuple(other.shape)
    full = [a + b - 1 for a, b in zip(shape, s2)]
    points = math.prod(full)
    flops = 3 * sum(2.5 * points * math.log2(n) for n in full)
    nbytes = itemsize * (math.prod(shape) + other.numel()
                         + out_numel(shape, s2, args.get("mode", "full")))
    return least_s(nbytes, flops)
