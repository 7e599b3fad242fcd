"""scikit-image-compatible layer on torch tensors: so far
``skimage.morphology`` (binary and grey operations, the structuring
elements, reconstruction, the convex hull and the small-object filters),
``skimage.measure.label`` and ``skimage.util.crop``."""
