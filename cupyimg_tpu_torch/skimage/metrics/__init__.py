"""skimage.metrics on torch tensors: the mean squared error, the
normalized root MSE, the peak signal-to-noise ratio and the structural
similarity."""

from .simple_metrics import (  # noqa: F401
    mean_squared_error,
    normalized_root_mse,
    peak_signal_noise_ratio,
)
from ._structural_similarity import structural_similarity  # noqa: F401
