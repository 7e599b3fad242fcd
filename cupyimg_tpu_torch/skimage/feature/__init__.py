"""skimage.feature on torch tensors: ``canny``, the corner and Hessian
features, ``peak_local_max``, ``match_template``, ``daisy`` and the
deprecated registration aliases ``register_translation`` and
``masked_register_translation`` (``registration.phase_cross_correlation``)."""

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


def masked_register_translation(
    src_image, target_image, src_mask, target_mask=None,
    overlap_ratio=0.3,
):
    """Deprecated alias of registration.phase_cross_correlation."""
    from ..registration import phase_cross_correlation

    return phase_cross_correlation(
        src_image,
        target_image,
        reference_mask=src_mask,
        moving_mask=target_mask,
        overlap_ratio=overlap_ratio,
    )


def register_translation(
    src_image, target_image, upsample_factor=1, space="real",
    return_error=True,
):
    """Deprecated alias of registration.phase_cross_correlation."""
    from ..registration import phase_cross_correlation

    return phase_cross_correlation(
        src_image,
        target_image,
        upsample_factor=upsample_factor,
        space=space,
        return_error=return_error,
    )


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
    "register_translation",
    "masked_register_translation",
]
