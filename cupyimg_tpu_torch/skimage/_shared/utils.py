"""Shared helpers of the skimage layer (skimage/_shared/utils.py): so far
``warn``."""

from __future__ import annotations

import warnings

__all__ = ["warn"]


def warn(message, category=UserWarning, stacklevel=2):
    """``warnings.warn`` with skimage's defaults."""
    warnings.warn(message, category=category, stacklevel=stacklevel)
