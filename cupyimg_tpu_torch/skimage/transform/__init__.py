"""skimage.transform on torch tensors: the geometric transforms and their
estimation, the warps (``warp``, ``resize``, ``rescale``, ``rotate``,
``swirl``, ``warp_polar``, ``downscale_local_mean``) on the spline
gather, the integral images and the gaussian and laplacian pyramids."""

from ._geometric import (  # noqa: F401
    estimate_transform,
    matrix_transform,
    EuclideanTransform,
    SimilarityTransform,
    AffineTransform,
    ProjectiveTransform,
    FundamentalMatrixTransform,
    EssentialMatrixTransform,
    PolynomialTransform,
    PiecewiseAffineTransform,
)
from ._warps import (  # noqa: F401
    warp,
    warp_coords,
    warp_polar,
    resize,
    rescale,
    rotate,
    swirl,
    downscale_local_mean,
)
from .integral import (  # noqa: F401
    integral_image,
    integrate,
)
from .pyramids import (  # noqa: F401
    pyramid_reduce,
    pyramid_expand,
    pyramid_gaussian,
    pyramid_laplacian,
)
