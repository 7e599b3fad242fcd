"""skimage.morphology on torch tensors: the binary and grey operations,
the structuring elements, ``reconstruction``, ``convex_hull_image`` and
``remove_small_objects``/``remove_small_holes``."""

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
from cupyimg_tpu_torch.skimage.morphology.greyreconstruct import (  # noqa: F401
    reconstruction,
)
from cupyimg_tpu_torch.skimage.morphology.convex_hull import (  # noqa: F401
    convex_hull_image,
)
from cupyimg_tpu_torch.skimage.morphology.misc import (  # noqa: F401
    remove_small_objects,
    remove_small_holes,
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
    "reconstruction",
    "convex_hull_image",
    "remove_small_objects",
    "remove_small_holes",
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
