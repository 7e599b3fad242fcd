"""cupyimg_tpu_torch: the PyTorch and CUDA port of cupyimg_tpu.

The same module paths and public names as ``cupyimg_tpu``, on
``torch.Tensor``s.  Hot ops run as hand-written CUDA kernels for Hopper
(``csrc/``, built with nvcc at first use; the build directory is the
only cache); everything else is plain PyTorch.  A tensor argument keeps
its device; a numpy array or list goes to ``config.device`` (``"cuda"``
unless set)::

    import cupyimg_tpu_torch.scipy.ndimage as ndi
    y = ndi.uniform_filter(x, size=5)   # x: a CUDA float32 tensor
"""

from cupyimg_tpu_torch.version import __version__  # noqa: F401
from cupyimg_tpu_torch.core.config import config  # noqa: F401

from cupyimg_tpu_torch._misc import convolve_separable  # noqa: F401,E402
