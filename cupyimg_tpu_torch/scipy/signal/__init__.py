"""scipy.signal-compatible API on torch tensors: the FFT-domain
convolution family, the direct 2-D convolution with boundaries, the
Wiener filter, the analytic signal, Fourier and polyphase resampling and
``upfirdn``."""

from cupyimg_tpu_torch.scipy.signal._upfirdn import (  # noqa: F401
    upfirdn,
    upfirdn_out_len,
)
from cupyimg_tpu_torch.scipy.signal.signaltools import (  # noqa: F401
    choose_conv_method,
    convolve,
    correlate,
    convolve2d,
    correlate2d,
    fftconvolve,
    oaconvolve,
    wiener,
    hilbert,
    hilbert2,
    resample,
    resample_poly,
    next_fast_len,
)
