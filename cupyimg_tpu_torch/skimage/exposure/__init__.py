"""skimage.exposure on torch tensors: histograms and their equalization
(``histogram``, ``cumulative_distribution``, ``equalize_hist``,
``equalize_adapthist``, ``match_histograms``), intensity rescaling and the
gamma, log and sigmoid corrections."""

from cupyimg_tpu_torch.skimage.exposure.exposure import (  # noqa: F401
    histogram,
    equalize_hist,
    rescale_intensity,
    cumulative_distribution,
    adjust_gamma,
    adjust_log,
    adjust_sigmoid,
    is_low_contrast,
    intensity_range,
)
from cupyimg_tpu_torch.skimage.exposure._adapthist import (  # noqa: F401
    equalize_adapthist,
)
from cupyimg_tpu_torch.skimage.exposure.histogram_matching import (  # noqa: F401
    match_histograms,
)
