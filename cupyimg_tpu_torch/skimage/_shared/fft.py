"""The FFT module of the skimage layer (skimage._shared.fft): ``torch.fft``
and ``next_fast_len``."""

import torch

from cupyimg_tpu_torch.scipy.signal.signaltools import next_fast_len  # noqa: F401

fftmodule = torch.fft
