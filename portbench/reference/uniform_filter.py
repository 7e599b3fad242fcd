"""scipy.ndimage.uniform_filter in plain PyTorch: a box of ``size``
samples on every axis, 1/size each, scipy's boundary ``mode``."""

from portbench.reference._common import correlate1d


def reference(x, args, operands, dtype):
    x = x.to(dtype)
    size = args.get("size", 3)
    mode = args.get("mode", "reflect")
    for axis in range(x.ndim):
        s = size[axis] if isinstance(size, (list, tuple)) else size
        if s > 1:
            x = correlate1d(x, [1.0 / s] * s, axis, mode)
    return x
