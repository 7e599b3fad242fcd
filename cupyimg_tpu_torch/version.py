"""The version of cupyimg_tpu_torch."""

__version__ = "0.1.0"
