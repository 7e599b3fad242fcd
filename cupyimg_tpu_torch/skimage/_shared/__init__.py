"""Helpers shared by the port's skimage subpackages."""

from ._warnings import all_warnings, expected_warnings, warn  # noqa: F401
