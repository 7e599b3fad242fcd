"""scipy.ndimage.affine_transform of order 1 without prefilter, in plain
PyTorch: each output sample o reads the input at c = matrix @ o + offset
(coordinates in float64), linear weights (1 - f, f) of the fraction f on
each axis, the 2^ndim neighbours folded into the input by scipy's
``mode``.  Computed in blocks of output planes along axis 0."""

import math

import torch

from portbench.reference._common import fold_index

BLOCK_POINTS = 1 << 21


def reference(x, args, operands, dtype):
    if int(args.get("order", 3)) != 1 or args.get("prefilter", True):
        raise ValueError("the reference covers order 1 without prefilter")
    mode = args.get("mode", "constant")
    dev = x.device
    shape = tuple(x.shape)
    nd = len(shape)
    out_shape = tuple(args.get("output_shape") or shape)
    matrix = torch.tensor(args["matrix"], dtype=torch.float64, device=dev)
    offset = torch.as_tensor(args.get("offset", 0.0), dtype=torch.float64,
                             device=dev).expand(nd)
    flat = x.to(dtype).reshape(-1)
    strides = [math.prod(shape[k + 1:]) for k in range(nd)]
    rest = math.prod(out_shape[1:])
    block = max(1, BLOCK_POINTS // rest)
    out = torch.empty(out_shape, dtype=dtype, device=dev)
    for start in range(0, out_shape[0], block):
        stop = min(out_shape[0], start + block)
        axes = [torch.arange(start, stop, dtype=torch.float64, device=dev)]
        axes += [torch.arange(n, dtype=torch.float64, device=dev)
                 for n in out_shape[1:]]
        grid = torch.meshgrid(*axes, indexing="ij")
        lo, frac = [], []
        for k in range(nd):
            c = offset[k] + sum(matrix[k, j] * grid[j] for j in range(nd))
            f = torch.floor(c)
            lo.append(f.to(torch.int64))
            frac.append((c - f).to(dtype))
        acc = torch.zeros(grid[0].shape, dtype=dtype, device=dev)
        for corner in range(1 << nd):
            index = torch.zeros(grid[0].shape, dtype=torch.int64, device=dev)
            weight = None
            for k in range(nd):
                up = (corner >> k) & 1
                i = fold_index(lo[k] + up, shape[k], mode)
                index += i * strides[k]
                w = frac[k] if up else 1 - frac[k]
                weight = w if weight is None else weight * w
            acc += weight * flat[index]
        out[start:stop] = acc
    return out
