"""scikit-image-compatible layer on torch tensors: so far
``skimage.morphology`` (binary and grey operations, the structuring
elements) and ``skimage.util.crop``."""
