"""Global configuration for cupyimg_tpu_torch.

Two knobs only: the default ``dtype_mode`` of the ndimage filters and the
device that non-tensor inputs are moved to.  Tensor inputs always keep
their own device.
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
        # Where numpy arrays and lists go.  The library never moves a
        # call to the CPU on its own: with no CUDA device, a non-tensor
        # input raises unless this is set to "cpu".
        self.device = "cuda"


config = _Config()
