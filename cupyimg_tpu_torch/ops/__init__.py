"""Device engines: the per-axis stencil path and the fused separable
CUDA kernel with its plain PyTorch version."""
