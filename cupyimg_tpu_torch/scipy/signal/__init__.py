"""scipy.signal-compatible API on torch tensors: the FFT-domain
convolution family, the analytic signal and Fourier resampling."""

from cupyimg_tpu_torch.scipy.signal.signaltools import (  # noqa: F401
    choose_conv_method,
    convolve,
    correlate,
    fftconvolve,
    oaconvolve,
    hilbert,
    hilbert2,
    resample,
    next_fast_len,
)
