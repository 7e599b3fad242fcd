"""skimage.segmentation on torch tensors: the boundaries
(``find_boundaries``, ``mark_boundaries``), the label operations
(``join_segmentations``, ``relabel_sequential``, ``clear_border``) and
the morphological snakes with their level sets and
``inverse_gaussian_gradient``.  Plain torch but for the gaussian
gradient of float32 images and ``mark_boundaries``' subpixel zoom, which
take the fused separable kernel and the spline gather."""

from .boundaries import find_boundaries, mark_boundaries
from ._join import join_segmentations, relabel_sequential, clear_border
from .morphsnakes import (
    morphological_geodesic_active_contour,
    morphological_chan_vese,
    inverse_gaussian_gradient,
    circle_level_set,
    disk_level_set,
    checkerboard_level_set,
)

__all__ = [
    "find_boundaries",
    "mark_boundaries",
    "clear_border",
    "join_segmentations",
    "relabel_sequential",
    "morphological_geodesic_active_contour",
    "morphological_chan_vese",
    "inverse_gaussian_gradient",
    "circle_level_set",
    "disk_level_set",
    "checkerboard_level_set",
]
