"""skimage.morphology on torch tensors: the binary and grey operations
and the structuring elements.  ``reconstruction``, ``convex_hull_image``
and ``remove_small_objects``/``remove_small_holes`` are not ported yet."""

from cupyimg_tpu_torch.skimage.morphology.binary import (  # noqa: F401
    binary_erosion,
    binary_dilation,
    binary_opening,
    binary_closing,
)
from cupyimg_tpu_torch.skimage.morphology.grey import (  # noqa: F401
    erosion,
    dilation,
    opening,
    closing,
    white_tophat,
    black_tophat,
)
from cupyimg_tpu_torch.skimage.morphology.selem import (  # noqa: F401
    square,
    rectangle,
    diamond,
    disk,
    ellipse,
    cube,
    octahedron,
    ball,
    octagon,
    star,
)

__all__ = [
    "binary_erosion",
    "binary_dilation",
    "binary_opening",
    "binary_closing",
    "erosion",
    "dilation",
    "opening",
    "closing",
    "white_tophat",
    "black_tophat",
    "square",
    "rectangle",
    "diamond",
    "disk",
    "ellipse",
    "cube",
    "octahedron",
    "ball",
    "octagon",
    "star",
]
