"""scipy.ndimage.grey_opening over a flat box of ``size`` in plain
PyTorch: the maximum filter of the minimum filter, each separable over
the axes, scipy's boundary ``mode``."""

import torch

from portbench.reference._common import minmax1d


def reference(x, args, operands, dtype):
    x = x.to(dtype)
    size = args["size"]
    mode = args.get("mode", "reflect")
    sizes = list(size) if isinstance(size, (list, tuple)) else [size] * x.ndim
    for op in (torch.minimum, torch.maximum):
        for axis in range(x.ndim):
            if sizes[axis] > 1:
                x = minmax1d(x, sizes[axis], axis, op, mode)
    return x
