"""skimage.feature on torch tensors: ``canny``, the corner and Hessian
features, ``peak_local_max``, ``match_template`` and ``daisy``.  The
registration aliases (``register_translation``,
``masked_register_translation``) come with ``skimage.registration``."""

from ._canny import canny
from ._daisy import daisy
from .peak import peak_local_max
from .corner import (
    corner_kitchen_rosenfeld,
    corner_harris,
    corner_shi_tomasi,
    corner_foerstner,
    corner_peaks,
    structure_tensor,
    structure_tensor_eigenvalues,
    structure_tensor_eigvals,
    hessian_matrix,
    hessian_matrix_eigvals,
    hessian_matrix_det,
    shape_index,
)
from .template import match_template

__all__ = [
    "canny",
    "daisy",
    "peak_local_max",
    "structure_tensor",
    "structure_tensor_eigenvalues",
    "structure_tensor_eigvals",
    "hessian_matrix",
    "hessian_matrix_det",
    "hessian_matrix_eigvals",
    "shape_index",
    "corner_kitchen_rosenfeld",
    "corner_harris",
    "corner_shi_tomasi",
    "corner_foerstner",
    "corner_peaks",
    "match_template",
]
