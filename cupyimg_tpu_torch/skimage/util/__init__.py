"""skimage.util on torch tensors: the dtype conversions, block and
window views, ``crop``, ``invert``, ``random_noise`` and ``map_array``."""

from cupyimg_tpu_torch.skimage.util.dtype import (  # noqa: F401
    img_as_float32,
    img_as_float64,
    img_as_float,
    img_as_int,
    img_as_uint,
    img_as_ubyte,
    img_as_bool,
    dtype_limits,
)
from cupyimg_tpu_torch.skimage.util.shape import (  # noqa: F401
    view_as_blocks,
    view_as_windows,
)
from cupyimg_tpu_torch.skimage.util.arraycrop import crop  # noqa: F401
from cupyimg_tpu_torch.skimage.util._invert import invert  # noqa: F401
from cupyimg_tpu_torch.skimage.util.noise import random_noise  # noqa: F401
from cupyimg_tpu_torch.skimage.util._map_array import (  # noqa: F401
    map_array,
    ArrayMap,
)
