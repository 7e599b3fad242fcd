"""skimage.registration on torch tensors: ``phase_cross_correlation``
(plain and masked; torch.fft, the upsampled DFT in complex128),
``optical_flow_tvl1`` and ``optical_flow_ilk`` (the warps on the spline
gather, iLK's window sums on the fused separable kernel, the flow's
median prefilter on the rank kernel)."""

from ._optical_flow import optical_flow_tvl1, optical_flow_ilk  # noqa
from ._phase_cross_correlation import phase_cross_correlation  # noqa

__all__ = [
    "optical_flow_ilk",
    "optical_flow_tvl1",
    "phase_cross_correlation",
]
