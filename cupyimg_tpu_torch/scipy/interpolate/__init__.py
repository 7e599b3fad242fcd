"""scipy.interpolate's regular-grid interpolation on torch tensors."""

from cupyimg_tpu_torch.scipy.interpolate.interpolate import (  # noqa: F401
    RegularGridInterpolator,
    interpn,
)
