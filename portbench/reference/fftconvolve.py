"""scipy.signal.fftconvolve in plain PyTorch: the linear convolution of
the input with operand ``in2`` over every axis, by real transforms at the
full shape s1 + s2 - 1 (no padding beyond it), cropped as scipy's
``mode`` crops ("same": centred on the input).  torch.fft has no
bfloat16, so a bfloat16 run rounds the operands and the result to
bfloat16 and transforms in float32."""

import torch


def reference(x, args, operands, dtype):
    k = operands[args["in2"]]
    work = dtype
    if dtype == torch.bfloat16:
        x, k, work = x.to(dtype), k.to(dtype), torch.float32
    x, k = x.to(work), k.to(work)
    s1, s2 = tuple(x.shape), tuple(k.shape)
    full = [a + b - 1 for a, b in zip(s1, s2)]
    dims = tuple(range(x.ndim))
    spec = torch.fft.rfftn(x, full, dim=dims) * torch.fft.rfftn(k, full,
                                                               dim=dims)
    y = torch.fft.irfftn(spec, full, dim=dims)
    mode = args.get("mode", "full")
    if mode == "same":
        for d, (n, m) in enumerate(zip(full, s1)):
            y = y.narrow(d, (n - m) // 2, m)
    elif mode == "valid":
        for d, (a, b) in enumerate(zip(s1, s2)):
            y = y.narrow(d, min(a, b) - 1, abs(a - b) + 1)
    return y.to(dtype)
