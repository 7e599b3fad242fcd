"""skimage.measure on torch tensors: ``label``, ``regionprops`` and
``regionprops_table`` with their ~45 properties, the perimeters and the
Euler number, the image and point-cloud moments, ``profile_line``,
``approximate_polygon``/``subdivide_polygon``, ``block_reduce`` and
``shannon_entropy``."""

from ._regionprops import (  # noqa: F401
    regionprops,
    regionprops_table,
    perimeter,
    perimeter_crofton,
    euler_number,
)
from ._polygon import approximate_polygon, subdivide_polygon  # noqa: F401
from ._moments import (  # noqa: F401
    moments,
    moments_central,
    moments_coords,
    moments_coords_central,
    moments_normalized,
    centroid,
    moments_hu,
    inertia_tensor,
    inertia_tensor_eigvals,
)
from .profile import profile_line  # noqa: F401
from .block import block_reduce  # noqa: F401
from ._label import label  # noqa: F401
from .entropy import shannon_entropy  # noqa: F401

__all__ = [
    "regionprops",
    "regionprops_table",
    "perimeter",
    "perimeter_crofton",
    "euler_number",
    "approximate_polygon",
    "subdivide_polygon",
    "block_reduce",
    "centroid",
    "moments",
    "moments_central",
    "moments_coords",
    "moments_coords_central",
    "moments_normalized",
    "moments_hu",
    "inertia_tensor",
    "inertia_tensor_eigvals",
    "profile_line",
    "label",
    "shannon_entropy",
]
