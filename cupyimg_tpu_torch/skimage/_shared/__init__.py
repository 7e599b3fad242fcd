"""Helpers shared by the port's skimage subpackages."""
