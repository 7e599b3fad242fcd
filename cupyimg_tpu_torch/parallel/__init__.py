"""Multi-device execution: sharded volumes with halo exchange.

The counterpart of ``cupyimg_tpu.parallel`` on ``torch.distributed``: one
process per device (``run_world`` starts them), arrays as ``DTensor``s on
a ``DeviceMesh``, stencil operators on halo-extended blocks (the
neighbours' boundary slabs moved by ``batch_isend_irecv``), the
distributed FFT retiled by ``all_to_all_single`` and the distributed
label's rounds ended by an ``all_reduce``.  Each rank's local compute is
the port's single-device call, so on the card it runs the same kernels.
"""

from cupyimg_tpu_torch.parallel._world import (  # noqa: F401
    World,
    run_world,
    transport,
)
from cupyimg_tpu_torch.parallel.halo import (  # noqa: F401
    halo_exchange,
    sharded_correlate1d,
    sharded_uniform_filter,
    sharded_gaussian_filter,
    sharded_min_max_filter,
    sharded_minimum_filter,
    sharded_maximum_filter,
    sharded_median_filter,
    sharded_fftconvolve,
    sharded_label,
)
from cupyimg_tpu_torch.parallel.halo import (  # noqa: F401
    sharded_map_overlap,
    sharded_correlate,
    sharded_convolve,
    sharded_binary_erosion,
    sharded_binary_dilation,
    sharded_shift,
    sharded_map_coordinates,
    sharded_affine_transform,
    sharded_fft2,
    sharded_fftconvolve2d_spatial,
    distribute,
    full_tensor,
    traffic,
)
