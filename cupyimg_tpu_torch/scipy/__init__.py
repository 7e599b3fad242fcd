"""SciPy-compatible op layer: scipy.ndimage, scipy.signal and the
gap-fillers of scipy.special, scipy.stats and scipy.interpolate."""

from cupyimg_tpu_torch.scipy import ndimage, signal  # noqa: F401
from cupyimg_tpu_torch.scipy import special, stats, interpolate  # noqa: F401
