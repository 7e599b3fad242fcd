"""Geometric transforms and their estimation (skimage.transform) on torch
tensors.

The estimation is small-matrix linear algebra and runs on the host in
float64 numpy (SVD, least squares); ``params`` is a float64 numpy array,
as in skimage.  Applying a transform to coordinates runs in float64 on
the coordinates' device (a numpy or list input goes to
``config.device``): the homogeneous products are written out as
multiply-adds, never ``torch.matmul``, so no TF32 can reach them.
``PiecewiseAffineTransform`` locates its points in the Delaunay mesh on
the host (``scipy.spatial``) and returns a tensor on the input's device.
"""

from __future__ import annotations

import math
import textwrap

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.skimage._shared.utils import safe_as_int

__all__ = [
    "estimate_transform",
    "matrix_transform",
    "EuclideanTransform",
    "SimilarityTransform",
    "AffineTransform",
    "ProjectiveTransform",
    "FundamentalMatrixTransform",
    "EssentialMatrixTransform",
    "PolynomialTransform",
]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _coords(coords):
    """(N, d) float64 tensor of ``coords`` on their device."""
    c = util.as_tensor(coords)
    if c.ndim < 2:
        c = c.reshape(1, -1)
    return c.to(torch.float64)


def _rows(src, matrix):
    """Each row of ``matrix`` (a host (m, d + 1) float64 array) applied to
    the homogeneous points ``[src, 1]``: one (N,) tensor per row, the
    terms summed in order and the last column added last."""
    d = src.shape[1]
    out = []
    for row in np.asarray(matrix, dtype=np.float64):
        acc = src[:, 0] * float(row[0])
        for k in range(1, d):
            acc = acc + src[:, k] * float(row[k])
        out.append(acc + float(row[d]))
    return out


def _center_and_normalize_points(points):
    """Hartley normalization: centroid 0, mean distance sqrt(2)."""
    points = np.asarray(points, dtype=np.float64)
    n, d = points.shape
    centroid = points.mean(axis=0)
    centered = points - centroid
    rms = math.sqrt(np.sum(centered ** 2) / n)
    if rms == 0:
        return np.full((d + 1, d + 1), np.nan), points
    norm_factor = math.sqrt(d) / rms
    matrix = np.concatenate(
        (
            norm_factor * np.concatenate(
                (np.eye(d), -centroid[:, None]), axis=1
            ),
            [[0] * d + [1]],
        ),
        axis=0,
    )
    pointsh = np.vstack([points.T, np.ones(n)])
    new_pointsh = (matrix @ pointsh).T
    new_points = new_pointsh[:, :d] / new_pointsh[:, d:]
    return matrix, new_points


def _umeyama(src, dst, estimate_scale):
    """Least-squares similarity transform between point sets
    (Umeyama 1991, IEEE PAMI 13(4):376-380)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    num = src.shape[0]
    dim = src.shape[1]

    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_demean = src - src_mean
    dst_demean = dst - dst_mean

    A = dst_demean.T @ src_demean / num
    d = np.ones((dim,), dtype=np.float64)
    if np.linalg.det(A) < 0:
        d[dim - 1] = -1
    T = np.eye(dim + 1, dtype=np.float64)
    U, S, V = np.linalg.svd(A)

    rank = np.linalg.matrix_rank(A)
    if rank == 0:
        return T * np.nan
    elif rank == dim - 1:
        if np.linalg.det(U) * np.linalg.det(V) > 0:
            T[:dim, :dim] = U @ V
        else:
            s = d[dim - 1]
            d[dim - 1] = -1
            T[:dim, :dim] = U @ np.diag(d) @ V
            d[dim - 1] = s
    else:
        T[:dim, :dim] = U @ np.diag(d) @ V

    if estimate_scale:
        scale = 1.0 / src_demean.var(axis=0).sum() * (S @ d)
    else:
        scale = 1.0
    T[:dim, dim] = dst_mean - scale * (T[:dim, :dim] @ src_mean.T)
    T[:dim, :dim] *= scale
    return T


class GeometricTransform:
    """Base class of the geometric transforms."""

    def __call__(self, coords):
        raise NotImplementedError()

    def inverse(self, coords):
        raise NotImplementedError()

    def __add__(self, other):
        raise NotImplementedError()

    def residuals(self, src, dst):
        """Per-point distance between transformed src and dst (a host
        float64 array)."""
        src_t = _host(self(src))
        return np.sqrt(np.sum((src_t - _host(dst)) ** 2, axis=1))

    def _nice(self):
        """Parameter string shared by __str__ and __repr__ (skimage's
        format)."""
        if hasattr(self, "params"):
            npstring = np.array2string(
                np.asarray(self.params), separator=", "
            )
            return "matrix=\n" + textwrap.indent(npstring, "    ")
        return ""

    def __repr__(self):
        return "<{}({}) at {}>".format(
            self.__class__.__name__, self._nice(), hex(id(self))
        )

    def __str__(self):
        return "<{}({})>".format(self.__class__.__name__, self._nice())


class ProjectiveTransform(GeometricTransform):
    """Projective (homography) transform in homogeneous coordinates.

    Coordinates are (x, y) = (col, row), skimage's convention.
    """

    def __init__(self, matrix=None, *, dimensionality=2):
        if matrix is None:
            matrix = np.eye(dimensionality + 1)
        matrix = np.asarray(_host(matrix), dtype=np.float64)
        if matrix.shape[0] != matrix.shape[1]:
            raise ValueError("invalid shape of transformation matrix")
        self.params = matrix

    @property
    def _inv_matrix(self):
        return np.linalg.inv(self.params)

    def _apply_mat(self, coords, matrix):
        src = _coords(coords)
        ndim = matrix.shape[0] - 1
        rows = _rows(src, matrix)
        dst, w = torch.stack(rows[:ndim], dim=-1), rows[ndim]
        w = torch.where(w == 0, np.finfo(np.float64).eps, w)
        return dst / w[..., None]

    def __call__(self, coords):
        return self._apply_mat(coords, self.params)

    def inverse(self, coords):
        return self._apply_mat(coords, self._inv_matrix)

    def estimate(self, src, dst):
        """Direct linear transform with Hartley normalization."""
        src = np.asarray(_host(src), dtype=np.float64)
        dst = np.asarray(_host(dst), dtype=np.float64)
        n, d = src.shape

        src_matrix, src_n = _center_and_normalize_points(src)
        dst_matrix, dst_n = _center_and_normalize_points(dst)
        if np.isnan(src_matrix).any() or np.isnan(dst_matrix).any():
            self.params = np.full((d + 1, d + 1), np.nan)
            return False

        A = np.zeros((n * d, (d + 1) ** 2))
        for ddim in range(d):
            A[ddim * n: (ddim + 1) * n, ddim * (d + 1): ddim * (d + 1) + d] \
                = src_n
            A[ddim * n: (ddim + 1) * n, ddim * (d + 1) + d] = 1
            A[ddim * n: (ddim + 1) * n, -d - 1: -1] = src_n
            A[ddim * n: (ddim + 1) * n, -1] = -1
            A[ddim * n: (ddim + 1) * n, -d - 1:] *= -dst_n[:, ddim: ddim + 1]

        # the solution is the null vector of A
        _, _, V = np.linalg.svd(A)
        # a degenerate configuration (collinear points) makes the
        # homogeneous scale vanish
        if np.isclose(V[-1, -1], 0):
            return False
        H = np.zeros((d + 1, d + 1))
        H.flat[list(self._coeffs) + [-1]] = -V[-1, :-1] / V[-1, -1]
        H[d, d] = 1
        self.params = np.linalg.inv(dst_matrix) @ H @ src_matrix
        self.params /= self.params[-1, -1]
        return True

    @property
    def _coeffs(self):
        d = self.params.shape[0] - 1
        return range((d + 1) ** 2 - 1)

    def __add__(self, other):
        if isinstance(other, ProjectiveTransform):
            if type(self) == type(other):
                tform = self.__class__
            else:
                tform = ProjectiveTransform
            return tform(matrix=other.params @ self.params)
        if (
            hasattr(other, "__name__")
            and other.__name__ == "inverse"
            and isinstance(getattr(other, "__self__", None),
                           ProjectiveTransform)
        ):
            # tform1 + tform2.inverse composes with the inverse matrix
            return ProjectiveTransform(
                matrix=other.__self__._inv_matrix @ self.params
            )
        raise TypeError("Cannot combine transformations of differing types.")

    @property
    def dimensionality(self):
        return self.params.shape[0] - 1


def _square_matrix(matrix):
    matrix = np.asarray(_host(matrix), dtype=np.float64)
    if matrix.ndim != 2 or matrix.shape[0] != matrix.shape[1]:
        raise ValueError("Invalid shape of transformation matrix.")
    return matrix


class AffineTransform(ProjectiveTransform):
    """Affine transform: scale, rotation, shear, translation."""

    def __init__(self, matrix=None, scale=None, rotation=None, shear=None,
                 translation=None, *, dimensionality=2):
        params = any(
            p is not None for p in (scale, rotation, shear, translation)
        )
        if params and matrix is not None:
            raise ValueError(
                "You cannot specify the transformation matrix and the "
                "implicit parameters at the same time."
            )
        if params and dimensionality != 2:
            raise ValueError(
                "Parameter input is only supported in 2D."
            )
        if matrix is not None:
            self.params = _square_matrix(matrix)
        elif params:
            if scale is None:
                scale = (1, 1)
            if rotation is None:
                rotation = 0
            if shear is None:
                shear = 0
            if translation is None:
                translation = (0, 0)
            if np.isscalar(scale):
                sx = sy = scale
            else:
                sx, sy = scale
            self.params = np.array(
                [
                    [sx * math.cos(rotation),
                     -sy * math.sin(rotation + shear),
                     translation[0]],
                    [sx * math.sin(rotation),
                     sy * math.cos(rotation + shear),
                     translation[1]],
                    [0, 0, 1],
                ]
            )
        else:
            self.params = np.eye(dimensionality + 1)

    def estimate(self, src, dst):
        """Least-squares affine estimation."""
        src = np.asarray(_host(src), dtype=np.float64)
        dst = np.asarray(_host(dst), dtype=np.float64)
        n, d = src.shape
        # no spread in the points: all-NaN params, as the normalized
        # DLT fails
        src_matrix, _ = _center_and_normalize_points(src)
        dst_matrix, _ = _center_and_normalize_points(dst)
        if np.isnan(src_matrix).any() or np.isnan(dst_matrix).any():
            self.params = np.full((d + 1, d + 1), np.nan)
            return False
        # [x' y']^T = A [x y 1]^T: each output axis by least squares
        X = np.hstack([src, np.ones((n, 1))])
        coeffs, *_ = np.linalg.lstsq(X, dst, rcond=None)
        self.params = np.eye(d + 1)
        self.params[:d, :d] = coeffs[:d].T
        self.params[:d, d] = coeffs[d]
        return True

    @property
    def scale(self):
        return np.sqrt(np.sum(self.params[:2, :2] ** 2, axis=0))

    @property
    def rotation(self):
        return math.atan2(self.params[1, 0], self.params[0, 0])

    @property
    def shear(self):
        beta = math.atan2(-self.params[0, 1], self.params[1, 1])
        return beta - self.rotation

    @property
    def translation(self):
        return self.params[0:2, 2]


class EuclideanTransform(ProjectiveTransform):
    """Rigid transform: rotation and translation."""

    def __init__(self, matrix=None, rotation=None, translation=None, *,
                 dimensionality=2):
        params_given = rotation is not None or translation is not None
        if params_given and matrix is not None:
            raise ValueError(
                "You cannot specify the transformation matrix and the "
                "implicit parameters at the same time."
            )
        if matrix is not None:
            self.params = _square_matrix(matrix)
        elif params_given:
            if rotation is None:
                rotation = 0
            if translation is None:
                translation = (0,) * dimensionality
            if dimensionality == 2:
                self.params = np.array(
                    [
                        [math.cos(rotation), -math.sin(rotation), 0],
                        [math.sin(rotation), math.cos(rotation), 0],
                        [0, 0, 1],
                    ]
                )
            else:
                raise NotImplementedError(
                    "Parameter input only supported in 2D."
                )
            self.params[0:2, 2] = translation
        else:
            self.params = np.eye(dimensionality + 1)

    def estimate(self, src, dst):
        self.params = _umeyama(_host(src), _host(dst), False)
        return not np.any(np.isnan(self.params))

    @property
    def rotation(self):
        return math.atan2(self.params[1, 0], self.params[1, 1])

    @property
    def translation(self):
        return self.params[0:2, 2]


class SimilarityTransform(EuclideanTransform):
    """Similarity transform: scale, rotation and translation."""

    def __init__(self, matrix=None, scale=None, rotation=None,
                 translation=None, *, dimensionality=2):
        params_given = any(
            p is not None for p in (scale, rotation, translation)
        )
        if params_given and matrix is not None:
            raise ValueError(
                "You cannot specify the transformation matrix and the "
                "implicit parameters at the same time."
            )
        if matrix is not None:
            self.params = _square_matrix(matrix)
        elif params_given:
            if scale is None:
                scale = 1
            if rotation is None:
                rotation = 0
            if translation is None:
                translation = (0, 0)
            self.params = np.array(
                [
                    [math.cos(rotation), -math.sin(rotation), 0],
                    [math.sin(rotation), math.cos(rotation), 0],
                    [0, 0, 1],
                ]
            )
            self.params[0:2, 0:2] *= scale
            self.params[0:2, 2] = translation
        else:
            self.params = np.eye(dimensionality + 1)

    def estimate(self, src, dst):
        self.params = _umeyama(_host(src), _host(dst), True)
        return not np.any(np.isnan(self.params))

    @property
    def scale(self):
        return math.sqrt(np.mean(np.sum(self.params[:2, :2] ** 2, axis=0)))


class FundamentalMatrixTransform(GeometricTransform):
    """Fundamental matrix (epipolar geometry; the 8-point algorithm)."""

    def __init__(self, matrix=None, *, dimensionality=2):
        if matrix is None:
            matrix = np.eye(3)
        matrix = np.asarray(_host(matrix), dtype=np.float64)
        if matrix.shape != (3, 3):
            raise ValueError("Invalid shape of transformation matrix")
        self.params = matrix

    def __call__(self, coords):
        """Epipolar lines in image 2 of points in image 1."""
        return torch.stack(_rows(_coords(coords), self.params), dim=-1)

    def inverse(self, coords):
        return torch.stack(_rows(_coords(coords), self.params.T), dim=-1)

    def _setup_constraint_matrix(self, src, dst):
        src = np.asarray(_host(src), dtype=np.float64)
        dst = np.asarray(_host(dst), dtype=np.float64)
        if src.shape != dst.shape:
            raise ValueError("src and dst shapes must be identical.")
        if src.shape[0] < 8:
            raise ValueError("src.shape[0] must be equal or larger than 8.")
        src_matrix, src_n = _center_and_normalize_points(src)
        dst_matrix, dst_n = _center_and_normalize_points(dst)
        A = np.ones((src.shape[0], 9))
        A[:, :2] = src_n
        A[:, :3] *= dst_n[:, 0:1]
        A[:, 3:5] = src_n
        A[:, 3:6] *= dst_n[:, 1:2]
        A[:, 6:8] = src_n
        return A, src_matrix, dst_matrix

    def estimate(self, src, dst):
        A, src_matrix, dst_matrix = self._setup_constraint_matrix(src, dst)
        _, _, V = np.linalg.svd(A)
        F_normalized = V[-1].reshape(3, 3)
        # enforce rank 2
        U, S, Vh = np.linalg.svd(F_normalized)
        S[2] = 0
        F = U @ np.diag(S) @ Vh
        self.params = dst_matrix.T @ F @ src_matrix
        return True

    def residuals(self, src, dst):
        """Sampson distance (a host float64 array)."""
        src = np.asarray(_host(src), dtype=np.float64)
        dst = np.asarray(_host(dst), dtype=np.float64)
        src_h = np.hstack([src, np.ones((src.shape[0], 1))])
        dst_h = np.hstack([dst, np.ones((dst.shape[0], 1))])
        F_src = self.params @ src_h.T
        Ft_dst = self.params.T @ dst_h.T
        dst_F_src = np.sum(dst_h * F_src.T, axis=1)
        return np.abs(dst_F_src) / np.sqrt(
            F_src[0] ** 2 + F_src[1] ** 2 + Ft_dst[0] ** 2 + Ft_dst[1] ** 2
        )


class EssentialMatrixTransform(FundamentalMatrixTransform):
    """Essential matrix (calibrated epipolar geometry)."""

    def __init__(self, rotation=None, translation=None, matrix=None, *,
                 dimensionality=2):
        if rotation is not None:
            if translation is None:
                raise ValueError(
                    "Both rotation and translation required"
                )
            rotation = np.asarray(_host(rotation), dtype=np.float64)
            translation = np.asarray(_host(translation), dtype=np.float64)
            if rotation.shape != (3, 3):
                raise ValueError("Invalid shape of rotation matrix")
            if abs(np.linalg.det(rotation) - 1) > 1e-6:
                raise ValueError("Rotation matrix must have unit determinant")
            if translation.size != 3:
                raise ValueError("Invalid shape of translation vector")
            if abs(np.linalg.norm(translation) - 1) > 1e-6:
                raise ValueError("Translation vector must have unit length")
            t = translation
            t_x = np.array(
                [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]
            )
            matrix = t_x @ rotation
        elif matrix is None:
            matrix = np.eye(3)
        else:
            matrix = np.asarray(_host(matrix), dtype=np.float64)
            if matrix.shape != (3, 3):
                raise ValueError("Invalid shape of transformation matrix")
        self.params = matrix

    def estimate(self, src, dst):
        A, src_matrix, dst_matrix = self._setup_constraint_matrix(src, dst)
        _, _, V = np.linalg.svd(A)
        E_normalized = V[-1].reshape(3, 3)
        U, S, Vh = np.linalg.svd(E_normalized)
        S[0] = (S[0] + S[1]) / 2
        S[1] = S[0]
        S[2] = 0
        E = U @ np.diag(S) @ Vh
        self.params = dst_matrix.T @ E @ src_matrix
        return True


class PolynomialTransform(GeometricTransform):
    """2-D polynomial transform."""

    def __init__(self, params=None, *, dimensionality=2):
        if params is None:
            params = np.array([[0, 1, 0], [0, 0, 1]], dtype=np.float64)
        params = np.asarray(_host(params), dtype=np.float64)
        if params.shape[0] != 2:
            raise ValueError("invalid shape of transformation parameters")
        self.params = params

    def estimate(self, src, dst, order=2):
        src = np.asarray(_host(src), dtype=np.float64)
        dst = np.asarray(_host(dst), dtype=np.float64)
        xs, ys = src[:, 0], src[:, 1]
        rows = src.shape[0]
        order = safe_as_int(order)
        u = (order + 1) * (order + 2)
        A = np.zeros((rows * 2, u + 1))
        pidx = 0
        for j in range(order + 1):
            for i in range(j + 1):
                A[:rows, pidx] = xs ** (j - i) * ys ** i
                A[rows:, pidx + u // 2] = xs ** (j - i) * ys ** i
                pidx += 1
        A[:rows, -1] = dst[:, 0]
        A[rows:, -1] = dst[:, 1]
        _, _, V = np.linalg.svd(A)
        params = -V[-1, :-1] / V[-1, -1]
        self.params = params.reshape(2, u // 2)
        return True

    def __call__(self, coords):
        coords = _coords(coords)
        x = coords[:, 0]
        y = coords[:, 1]
        u = len(self.params.ravel())
        order = int((-3 + math.sqrt(9 - 4 * (2 - u))) / 2)
        dst_x = torch.zeros_like(x)
        dst_y = torch.zeros_like(y)
        pidx = 0
        for j in range(order + 1):
            for i in range(j + 1):
                term = x ** (j - i) * y ** i
                dst_x = dst_x + float(self.params[0, pidx]) * term
                dst_y = dst_y + float(self.params[1, pidx]) * term
                pidx += 1
        return torch.stack([dst_x, dst_y], dim=-1)

    def inverse(self, coords):
        raise Exception(
            "There is no explicit way to do the inverse polynomial "
            "transformation. Instead, estimate the inverse transformation "
            "parameters by exchanging source and destination coordinates,"
            "then apply the forward transformation."
        )


class PiecewiseAffineTransform(GeometricTransform):
    """Piecewise affine transformation over a Delaunay mesh of control
    points.

    The mesh (triangulation, an affine fit per triangle, point location)
    is host work through ``scipy.spatial``; the points' affine maps are
    applied in float64 numpy and the result goes back to the points'
    device.
    """

    def __init__(self, *, dimensionality=2):
        self._tesselation = None
        self._inverse_tesselation = None
        self.affines = None
        self.inverse_affines = None

    def estimate(self, src, dst):
        """Estimate the transformation from corresponding points."""
        from scipy import spatial

        src = np.asarray(_host(src), dtype=float)
        dst = np.asarray(_host(dst), dtype=float)
        ndim = src.shape[1]

        self._tesselation = spatial.Delaunay(src)
        self.affines = []
        for tri in self._tesselation.simplices:
            affine = AffineTransform(dimensionality=ndim)
            affine.estimate(src[tri, :], dst[tri, :])
            self.affines.append(affine)

        self._inverse_tesselation = spatial.Delaunay(dst)
        self.inverse_affines = []
        for tri in self._inverse_tesselation.simplices:
            affine = AffineTransform(dimensionality=ndim)
            affine.estimate(dst[tri, :], src[tri, :])
            self.inverse_affines.append(affine)

        return True

    def _apply(self, coords, tesselation, affines):
        device = (coords.device if isinstance(coords, torch.Tensor)
                  else None)
        coords = np.atleast_2d(np.asarray(_host(coords), dtype=float))
        simplex = tesselation.find_simplex(coords)
        # each point's simplex's homogeneous matrix
        mats = np.stack([a.params for a in affines], axis=0)
        d = coords.shape[1]
        homo = np.concatenate([coords, np.ones((coords.shape[0], 1))],
                              axis=1)
        sel = np.clip(simplex, 0, mats.shape[0] - 1)
        out = np.einsum("nij,nj->ni", mats[sel], homo)[:, :d]
        out[simplex == -1, :] = -1
        return util.as_tensor(out, device=device)

    def __call__(self, coords):
        """Forward transformation; points outside the mesh map to -1."""
        return self._apply(coords, self._tesselation, self.affines)

    def inverse(self, coords):
        """Inverse transformation; points outside the mesh map to -1."""
        return self._apply(
            coords, self._inverse_tesselation, self.inverse_affines
        )


TRANSFORMS = {
    "piecewise-affine": PiecewiseAffineTransform,
    "euclidean": EuclideanTransform,
    "similarity": SimilarityTransform,
    "affine": AffineTransform,
    "projective": ProjectiveTransform,
    "fundamental": FundamentalMatrixTransform,
    "essential": EssentialMatrixTransform,
    "polynomial": PolynomialTransform,
}


def estimate_transform(ttype, src, dst, **kwargs):
    """Estimate a geometric transform from point correspondences; the
    fit runs on the host in float64."""
    ttype = ttype.lower()
    if ttype not in TRANSFORMS:
        raise ValueError(
            f"the transformation type '{ttype}' is not implemented"
        )
    tform = TRANSFORMS[ttype](dimensionality=np.shape(_host(src))[1])
    tform.estimate(src, dst, **kwargs)
    return tform


def matrix_transform(coords, matrix):
    """Apply a homogeneous transformation matrix to 2-D coordinates."""
    return ProjectiveTransform(matrix)(coords)
