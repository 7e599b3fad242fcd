"""Global configuration for cupyimg_tpu_torch.

Three knobs: the default ``dtype_mode`` of the ndimage filters, the
precision of interpolation coordinates, and the device that non-tensor
inputs are moved to.  Tensor inputs always keep their own device.
"""

import os


class _Config:
    """Mutable global knobs."""

    def __init__(self):
        # 'ndimage' accumulates in float64 (SciPy parity); 'float' in the
        # input's own floating type, at least float32.
        self.default_dtype_mode = os.environ.get(
            "CUPYIMG_TPU_DTYPE_MODE", "ndimage"
        )
        # Precision of the coordinates that affine_transform, rotate,
        # shift and zoom form: 'auto' | 'f32' | 'f64' (anything else
        # raises ValueError at the call).  SciPy and the reference cupyimg
        # compute them in C double whatever the image dtype, which decides
        # knife-edge cases (a coordinate exactly on a domain edge or a
        # half-integer) as SciPy does.  f64 is native on the GPU, so
        # 'auto' means f64; 'f32' (with allow_float32) exists for parity
        # with cupyimg_tpu.
        self.coord_precision = "auto"
        # Where numpy arrays and lists go.  The library never moves a
        # call to the CPU on its own: with no CUDA device, a non-tensor
        # input raises unless this is set to "cpu".
        self.device = "cuda"


config = _Config()
