"""cupyimg_tpu_torch.models.edge_enhance_pipeline from its definition,
in plain PyTorch: sm = gaussian_filter(x, sigma) (scipy's taps, truncate
4, mode reflect); grad = sqrt(sum over axes of sobel(sm, axis)^2), each
sobel the derivative [-1, 0, 1] on its axis and the smoothing [1, 2, 1]
on the others; out = (1 + amount) x - amount sm + 0.1 grad."""

import torch

from portbench.reference._common import correlate1d, gaussian_weights


def reference(x, args, operands, dtype):
    x = x.to(dtype)
    sigma = args.get("sigma", 1.5)
    amount = args.get("amount", 0.7)
    g = gaussian_weights(sigma)
    sm = x
    for axis in range(x.ndim):
        sm = correlate1d(sm, g, axis)
    grad = None
    for axis in range(x.ndim):
        d = correlate1d(sm, [-1.0, 0.0, 1.0], axis)
        for other in range(x.ndim):
            if other != axis:
                d = correlate1d(d, [1.0, 2.0, 1.0], other)
        grad = d * d if grad is None else grad + d * d
    grad = torch.sqrt(grad)
    return (1.0 + amount) * x - amount * sm + 0.1 * grad
