"""Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet,
dense rates) and the least time a call could take at them.

``PEAK_BYTES`` is HBM3's 3.35 TB/s and ``PEAK_FP32`` the 67 TFLOP/s of
float32 outside the tensor cores (a fused multiply-add counted as 2).
``PEAK_MINMAX`` is an assumed rate, not a published one: a min or a max is
one non-FMA float32 instruction, taken at half the FMA rate, 33.5 T/s.
"""

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_MINMAX = 33.5e12


def least_s(nbytes, flops=0.0, minmax=0.0):
    """Seconds: the larger of ``nbytes`` at PEAK_BYTES and the work
    (``flops`` at PEAK_FP32 plus ``minmax`` min/max operations at
    PEAK_MINMAX)."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FP32 + minmax / PEAK_MINMAX)
