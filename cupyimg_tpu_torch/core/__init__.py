"""Core semantics shared by every op: boundary modes, dtype policy,
utilities and the input conversion ``util.as_tensor``."""

from cupyimg_tpu_torch.core.boundary import (  # noqa: F401
    BOUNDARY_MODES,
    check_mode,
    map_indices,
    pad,
)
from cupyimg_tpu_torch.core.dtypes import promote_weights_dtype  # noqa: F401
from cupyimg_tpu_torch.core import util  # noqa: F401
