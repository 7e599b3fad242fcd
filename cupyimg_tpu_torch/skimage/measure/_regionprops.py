"""``regionprops`` and ``regionprops_table`` (skimage.measure) on torch
tensors.

Each measurement is a plain function registered in a module table
(:data:`_REGION_PROPS`) under its public name; the lazy
``RegionProperties`` object resolves attribute access through that table,
memoizing where a measurement is reused, and ``regionprops_table``'s
column schema (``PROPS``, ``COL_DTYPES``) comes from the same registry.
The MATLAB-style aliases are generated from the snake_case names by the
camel-case rule plus a table of irregular pairs.

Bounding slices come from the port's ``ndi.find_objects`` (reduced on the
device); a region's crop of the label and intensity images stays on the
device.  Scalars (``area``, ``perimeter``, ...) and the small tables that
skimage also reads on the host (moments, the inertia tensor) come back to
the host once per region; ``convex_image`` is the port's
``convex_hull_image`` and ``filled_image`` its ``binary_fill_holes``.
``regionprops_table`` returns host numpy columns.
"""

from __future__ import annotations

import inspect
from math import atan2, pi as PI, sqrt
from warnings import warn

import numpy as np
import torch

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from . import _moments
from ._regionprops_utils import euler_number, perimeter, perimeter_crofton

__all__ = [
    "regionprops",
    "regionprops_table",
    "euler_number",
    "perimeter",
    "perimeter_crofton",
]


# name -> (func(region) -> value, memoize?, 2-D only?)
_REGION_PROPS = {}

# measurements that need an intensity image (left out of iteration when
# none was given)
_NEEDS_INTENSITY = frozenset(
    {
        "intensity_image",
        "max_intensity",
        "mean_intensity",
        "min_intensity",
        "weighted_moments",
        "weighted_moments_central",
        "weighted_centroid",
        "weighted_local_centroid",
        "weighted_moments_hu",
        "weighted_moments_normalized",
    }
)


def _measurement(cache=False, two_d_only=False):
    """Register a per-region measurement function under its own name."""

    def register(fn):
        _REGION_PROPS[fn.__name__] = (fn, cache, two_d_only)
        return fn

    return register


def _host(value):
    """A measurement's value on the host: a tensor as a numpy array (a
    0-d tensor as its Python number), tuples element by element."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return value.item() if value.ndim == 0 else value.numpy()
    if isinstance(value, tuple):
        return tuple(_host(v) for v in value)
    return value


# public name schema (the values of skimage's tables, generated)

_SNAKE_NAMES = (
    "area", "bbox", "bbox_area", "moments_central", "centroid",
    "convex_area", "convex_image", "coords", "eccentricity",
    "equivalent_diameter", "euler_number", "extent",
    "feret_diameter_max", "filled_area", "filled_image", "moments_hu",
    "image", "inertia_tensor", "inertia_tensor_eigvals",
    "intensity_image", "label", "local_centroid", "major_axis_length",
    "max_intensity", "mean_intensity", "min_intensity",
    "minor_axis_length", "moments", "moments_normalized", "orientation",
    "perimeter", "perimeter_crofton", "slice", "solidity",
    "weighted_moments_central", "weighted_centroid",
    "weighted_moments_hu", "weighted_local_centroid",
    "weighted_moments", "weighted_moments_normalized",
)

# legacy aliases that do NOT follow the snake->Camel rule
_IRREGULAR_ALIASES = {
    "BoundingBox": "bbox",
    "BoundingBoxArea": "bbox_area",
    "CentralMoments": "moments_central",
    "Coordinates": "coords",
    "CroftonPerimeter": "perimeter_crofton",
    "EquivDiameter": "equivalent_diameter",
    "HuMoments": "moments_hu",
    "NormalizedMoments": "moments_normalized",
    "WeightedCentralMoments": "weighted_moments_central",
    "WeightedHuMoments": "weighted_moments_hu",
    "WeightedNormalizedMoments": "weighted_moments_normalized",
}


def _snake_to_camel(name):
    return "".join(part.capitalize() for part in name.split("_"))


PROPS = {
    _snake_to_camel(name): name
    for name in _SNAKE_NAMES
    if name not in set(_IRREGULAR_ALIASES.values())
}
PROPS.update(_IRREGULAR_ALIASES)

OBJECT_COLUMNS = {
    "image", "coords", "convex_image", "slice",
    "filled_image", "intensity_image",
}

_INT_COLUMNS = (
    "area", "bbox", "bbox_area", "convex_area", "euler_number",
    "filled_area", "label", "max_intensity", "min_intensity",
)

COL_DTYPES = {name: int for name in _INT_COLUMNS}
COL_DTYPES.update({name: object for name in OBJECT_COLUMNS})
COL_DTYPES.update(
    {name: float for name in _SNAKE_NAMES if name not in COL_DTYPES}
)

PROP_VALS = set(PROPS.values())


# --------------------------------------------------------------------------
# the measurements
# --------------------------------------------------------------------------


@_measurement(cache=True)
def area(r):
    return int(torch.sum(r.image))


@_measurement()
def bbox(r):
    starts = [r.slice[i].start for i in range(r._ndim)]
    stops = [r.slice[i].stop for i in range(r._ndim)]
    return tuple(starts + stops)


@_measurement()
def bbox_area(r):
    return r.image.numel()


@_measurement()
def centroid(r):
    return tuple(r.coords.to(torch.float64).mean(dim=0).tolist())


@_measurement(cache=True)
def convex_area(r):
    return int(torch.sum(r.convex_image))


@_measurement(cache=True)
def convex_image(r):
    from ..morphology.convex_hull import convex_hull_image

    return convex_hull_image(r.image)


@_measurement()
def coords(r):
    starts = torch.tensor([s.start for s in r.slice], dtype=torch.int64,
                          device=r.image.device)
    return torch.nonzero(r.image) + starts


@_measurement(two_d_only=True)
def eccentricity(r):
    l1, l2 = r.inertia_tensor_eigvals.tolist()
    return 0 if l1 == 0 else sqrt(1 - l2 / l1)


@_measurement()
def equivalent_diameter(r):
    if r._ndim == 2:
        return sqrt(4 * r.area / PI)
    return (2 * r._ndim * r.area / PI) ** (1 / r._ndim)


# registered as euler_number below: the module's euler_number stays the
# function of the whole image
@_measurement()
def _region_euler_number(r):
    if r._ndim not in (2, 3):
        raise NotImplementedError(
            "Euler number is implemented for 2D or 3D images only"
        )
    return euler_number(r.image, r._ndim)


_REGION_PROPS["euler_number"] = _REGION_PROPS.pop("_region_euler_number")


@_measurement()
def extent(r):
    return r.area / r.image.numel()


@_measurement()
def feret_diameter_max(r):
    hull = torch.nn.functional.pad(r.convex_image, (2, 2) * r._ndim)
    pts = _surface_midpoints(hull)
    if pts.shape[0] < 2:
        return 0.0
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    return sqrt(float(torch.max(d2)))


@_measurement()
def filled_area(r):
    return int(torch.sum(r.filled_image))


@_measurement(cache=True)
def filled_image(r):
    return ndi.binary_fill_holes(r.image, np.ones((3,) * r._ndim))


@_measurement(cache=True)
def image(r):
    return r._label_image[r.slice] == r.label


@_measurement(cache=True)
def inertia_tensor(r):
    return _moments.inertia_tensor(r.image, r.moments_central)


@_measurement(cache=True)
def inertia_tensor_eigvals(r):
    return _moments.inertia_tensor_eigvals(r.image, T=r.inertia_tensor)


@_measurement(cache=True)
def intensity_image(r):
    if r._intensity_image is None:
        raise AttributeError("No intensity image specified.")
    mask = r.image
    if r._multichannel:
        mask = mask.unsqueeze(r._ndim)
    crop = r._intensity_image[r.slice]
    return crop * mask.to(crop.dtype)


@_measurement()
def local_centroid(r):
    M = r.moments
    return tuple((M[_moments._eye_index(r._ndim, M.device)]
                  / M[(0,) * r._ndim]).tolist())


@_measurement()
def major_axis_length(r):
    return 4 * sqrt(float(r.inertia_tensor_eigvals[0]))


def _region_values(r):
    return r.intensity_image[r.image]


def _extremum(r, fn):
    """``fn`` (amax or amin) of the region's values over its pixels, in
    the signed type that holds unsigned data (torch has no max of
    uint16/32), cast back."""
    values = _region_values(r)
    return fn(dtypes.widen_unsigned(values), dim=0).to(values.dtype)


@_measurement()
def max_intensity(r):
    return _extremum(r, torch.amax)


@_measurement()
def mean_intensity(r):
    values = _region_values(r)
    if not (values.is_floating_point() or values.is_complex()):
        values = values.to(torch.float64)
    return torch.mean(values, dim=0)


@_measurement()
def min_intensity(r):
    return _extremum(r, torch.amin)


@_measurement()
def minor_axis_length(r):
    return 4 * sqrt(float(r.inertia_tensor_eigvals[-1]))


@_measurement(cache=True)
def moments(r):
    return _moments.moments(r.image.to(torch.uint8), 3)


@_measurement(cache=True)
def moments_central(r):
    return _moments.moments_central(
        r.image.to(torch.uint8), r.local_centroid, order=3
    )


@_measurement(two_d_only=True)
def moments_hu(r):
    return _moments.moments_hu(r.moments_normalized)


@_measurement(cache=True)
def moments_normalized(r):
    return _moments.moments_normalized(r.moments_central, 3)


@_measurement(two_d_only=True)
def orientation(r):
    a, b, _, c = r.inertia_tensor.reshape(-1).tolist()
    if a - c == 0:
        return -PI / 4.0 if b < 0 else PI / 4.0
    return 0.5 * atan2(-2 * b, c - a)


@_measurement(two_d_only=True)
def _region_perimeter(r):
    return float(perimeter(r.image, 4))


_REGION_PROPS["perimeter"] = _REGION_PROPS.pop("_region_perimeter")


@_measurement(two_d_only=True)
def _region_perimeter_crofton(r):
    return float(perimeter_crofton(r.image, 4))


_REGION_PROPS["perimeter_crofton"] = _REGION_PROPS.pop(
    "_region_perimeter_crofton"
)


@_measurement()
def solidity(r):
    return r.area / r.convex_area


@_measurement()
def weighted_centroid(r):
    local = r.weighted_local_centroid.cpu().numpy()
    return tuple(c + s.start for c, s in zip(local, r.slice))


@_measurement()
def weighted_local_centroid(r):
    M = r.weighted_moments
    return M[_moments._eye_index(r._ndim, M.device)] / M[(0,) * r._ndim]


def _per_channel(r, fn):
    """``fn(plane)`` of each intensity channel stacked on the last axis,
    or ``fn`` of the single-channel intensity image."""
    img = r.intensity_image.to(torch.float64)
    if not r._multichannel:
        return fn(img)
    return torch.stack(
        [fn(img[..., ch]) for ch in range(img.shape[-1])], dim=-1)


@_measurement(cache=True)
def weighted_moments(r):
    return _per_channel(r, lambda im: _moments.moments(im, order=3))


@_measurement(cache=True)
def weighted_moments_central(r):
    ctr = r.weighted_local_centroid
    img = r.intensity_image.to(torch.float64)
    if not r._multichannel:
        return _moments.moments_central(img, ctr, order=3)
    return torch.stack(
        [
            _moments.moments_central(
                img[..., ch], center=ctr[..., ch], order=3
            )
            for ch in range(img.shape[-1])
        ],
        dim=-1,
    )


@_measurement(two_d_only=True)
def weighted_moments_hu(r):
    nu = r.weighted_moments_normalized
    if not r._multichannel:
        return _moments.moments_hu(nu)
    return torch.stack(
        [
            _moments.moments_hu(nu[..., ch])
            for ch in range(r._intensity_image.shape[-1])
        ],
        dim=-1,
    )


@_measurement(cache=True)
def weighted_moments_normalized(r):
    mu = r.weighted_moments_central
    if not r._multichannel:
        return _moments.moments_normalized(mu, order=3)
    return torch.stack(
        [
            _moments.moments_normalized(mu[..., ch], order=3)
            for ch in range(r._intensity_image.shape[-1])
        ],
        dim=-1,
    )


def _surface_midpoints(mask):
    """Vertices of the 0.5-level surface of a binary mask: the midpoints
    between axis-adjacent pixels that differ (for binary data, the
    vertices marching squares/cubes give), float64 ``(N, ndim)``."""
    mask = mask.to(torch.bool)
    pts = []
    for ax in range(mask.ndim):
        n = mask.shape[ax]
        diff = mask.narrow(ax, 0, n - 1) != mask.narrow(ax, 1, n - 1)
        edge = torch.nonzero(diff).to(torch.float64)
        edge[:, ax] += 0.5
        pts.append(edge)
    return torch.cat(pts, dim=0)


# --------------------------------------------------------------------------
# the lazy per-region object
# --------------------------------------------------------------------------


def _arg_count(func):
    """Number of required positional arguments of ``func``."""
    spec = inspect.getfullargspec(func)
    return len(spec.args) - len(spec.defaults or ())


class RegionProperties:
    """Please refer to ``regionprops`` for details on available properties."""

    def __init__(
        self,
        slice,
        label,
        label_image,
        intensity_image,
        cache_active,
        *,
        extra_properties=None,
    ):
        multichannel = False
        if intensity_image is not None:
            ndim = label_image.ndim
            shapes_ok = (
                intensity_image.shape[:ndim] == label_image.shape
                and intensity_image.ndim in (ndim, ndim + 1)
            )
            if not shapes_ok:
                raise ValueError(
                    "Label and intensity image shapes must match,"
                    " except for channel (last) axis."
                )
            multichannel = label_image.shape < intensity_image.shape

        self.label = label
        self.slice = slice
        self._slice = slice
        self._label_image = label_image
        self._intensity_image = intensity_image
        self._cache_active = cache_active
        self._cache = {}
        self._ndim = label_image.ndim
        self._multichannel = multichannel
        self._spatial_axes = tuple(range(self._ndim))

        self._extra_properties = {}
        for func in extra_properties or ():
            name = func.__name__
            if name in _REGION_PROPS:
                warn(
                    f"Extra property '{name}' is shadowed by existing "
                    "property and will be inaccessible. Consider "
                    "renaming it."
                )
            self._extra_properties[name] = func

    def _compute_extra(self, name):
        func = self._extra_properties[name]
        n_args = _arg_count(func)
        if n_args == 1:
            return func(self.image)
        if n_args == 2:
            if self._intensity_image is None:
                raise AttributeError(
                    f"intensity image required to calculate {name}"
                )
            return func(self.image, self.intensity_image)
        raise AttributeError(
            "Custom regionprop function's number of arguments must be 1 "
            f"or 2 but {name} takes {n_args} arguments."
        )

    def __getattr__(self, attr):
        # registered measurements win over extra properties, as skimage's
        # class properties win over its __getattr__
        entry = _REGION_PROPS.get(attr)
        if entry is not None:
            fn, memo, two_d_only = entry
            if two_d_only and self._ndim > 2:
                raise NotImplementedError(
                    f"Property {attr} is not implemented for 3D images"
                )
            if memo and self._cache_active:
                if attr not in self._cache:
                    self._cache[attr] = fn(self)
                return self._cache[attr]
            return fn(self)
        if attr in self.__dict__.get("_extra_properties", {}):
            return self._compute_extra(attr)
        raise AttributeError(
            f"'{type(self)}' object has no attribute '{attr}'"
        )

    def __dir__(self):
        # the measurements behind __getattr__ still show in dir(), as
        # skimage's class properties do
        return sorted(set(PROPS.values()) | {"label", "slice"})

    def __getitem__(self, key):
        value = getattr(self, key, None)
        if value is not None:
            return value
        return getattr(self, PROPS[key])  # legacy alias

    def __iter__(self):
        names = PROP_VALS
        if self._intensity_image is None:
            names = names - _NEEDS_INTENSITY
        return iter(sorted(names))

    def __eq__(self, other):
        if not isinstance(other, RegionProperties):
            return False
        for name in PROP_VALS:
            mine = _host(getattr(self, name, None))
            theirs = _host(getattr(other, name, None))
            try:
                if isinstance(mine, tuple):
                    np.testing.assert_equal(mine, theirs)
                else:
                    np.testing.assert_array_equal(
                        np.asarray(mine), np.asarray(theirs)
                    )
            except AssertionError:
                return False
        return True


_RegionProperties = RegionProperties


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------


def regionprops(
    label_image,
    intensity_image=None,
    cache=True,
    coordinates=None,
    *,
    extra_properties=None,
):
    """Measure properties of labeled image regions (skimage parity: the
    same properties and aliases).

    One ``RegionProperties`` per label present, in label order; bounding
    slices come from ``ndi.find_objects``.  The intensity image, if
    given, moves to the label image's device.
    """
    label_image = util.as_tensor(label_image)

    if label_image.ndim not in (2, 3):
        raise TypeError("Only 2-D and 3-D images supported.")

    if label_image.dtype == torch.bool:
        raise TypeError(
            "Non-integer image types are ambiguous: "
            "use skimage.measure.label to label the connected "
            "components of label_image, "
            "or label_image.astype(np.uint8) to interpret "
            "the True values as a single label."
        )
    if label_image.is_floating_point() or label_image.is_complex():
        raise TypeError("Non-integer label_image types are ambiguous")

    _check_coordinates_kwarg(coordinates)
    if intensity_image is not None:
        intensity_image = util.as_tensor(intensity_image,
                                         device=label_image.device)

    return [
        RegionProperties(
            bounds,
            lab,
            label_image,
            intensity_image,
            cache,
            extra_properties=extra_properties,
        )
        for lab, bounds in enumerate(ndi.find_objects(label_image), 1)
        if bounds is not None
    ]


def _check_coordinates_kwarg(coordinates):
    """Reject or deprecate the pre-0.16 ``coordinates`` argument, as
    skimage does."""
    if coordinates is None:
        return
    if coordinates == "rc":
        warn(
            "The coordinates keyword argument to "
            "skimage.measure.regionprops is deprecated. "
            "All features are now computed in rc (row-column) "
            "coordinates. Please remove `coordinates=\"rc\"` from "
            "all calls to regionprops before updating scikit-image.",
            stacklevel=3,
            category=FutureWarning,
        )
    else:
        raise ValueError(
            'Values other than "rc" for the "coordinates" argument '
            "to skimage.measure.regionprops are no longer "
            "supported. You should update your code to use \"rc\" "
            "coordinates and stop using the \"coordinates\" "
            "argument, or use skimage version 0.15.x or earlier."
        )


def _infer_regionprop_dtype(func, *, intensity, ndim, device):
    """The column dtype of an extra property, from its values on two
    small synthetic regions: their dtype where both are scalars or of one
    shape, else object."""
    sample = np.zeros((3,) * ndim, dtype=np.intp)
    sample[(0,) * ndim] = 1
    sample[(slice(1, None),) * ndim] = 2
    masks = (torch.as_tensor(sample == 1, device=device),
             torch.as_tensor(sample == 2, device=device))
    if intensity and _arg_count(func) == 2:
        rng = np.random.RandomState(0)

        def probe(mask):
            return func(mask, torch.as_tensor(
                rng.random_sample(sample.shape), device=device))

    else:
        probe = func
    first, second = (_host(probe(m)) for m in masks)
    scalars = np.isscalar(first) and np.isscalar(second)
    if scalars or np.asarray(first).shape == np.asarray(second).shape:
        return np.asarray(first).dtype.type
    return np.object_


def _column_dtype(sample_region, prop):
    if prop in COL_DTYPES:
        return COL_DTYPES[prop]
    return _infer_regionprop_dtype(
        sample_region._extra_properties[prop],
        intensity=sample_region._intensity_image is not None,
        ndim=sample_region.image.ndim,
        device=sample_region.image.device,
    )


def _props_to_dict(regions, properties=("label", "bbox"), separator="-"):
    """A regionprops list as a dict of host numpy columns (pandas-ready);
    object columns hold the properties' tensors."""
    out = {}
    n = len(regions)
    for prop in properties:
        dtype = _column_dtype(regions[0], prop)
        sample = getattr(regions[0], prop)
        scalar_like = (
            np.isscalar(sample)
            or getattr(sample, "ndim", None) == 0
            or prop in OBJECT_COLUMNS
            or dtype is np.object_
        )
        if scalar_like:
            column = np.empty(n, dtype=dtype)
            for k, region in enumerate(regions):
                value = region[prop]
                column[k] = value if dtype is object else _host(value)
            out[prop] = column
            continue
        # a property of fixed shape: one column per element
        shape = tuple(sample.shape) if hasattr(sample, "shape") else (
            len(sample),)
        values = [np.asarray(_host(region[prop])) for region in regions]
        for ind in np.ndindex(shape):
            loc = ind if len(ind) > 1 else ind[0]
            column = np.empty(n, dtype=dtype)
            for k in range(n):
                column[k] = values[k][loc]
            out[separator.join(map(str, (prop,) + ind))] = column
    return out


def regionprops_table(
    label_image,
    intensity_image=None,
    properties=("label", "bbox"),
    *,
    cache=True,
    separator="-",
    extra_properties=None,
):
    """Image properties as a pandas-compatible dict of host numpy
    columns (skimage parity); an image without labels gives 0-row
    columns."""
    label_image = util.as_tensor(label_image)
    regions = regionprops(
        label_image,
        intensity_image=intensity_image,
        cache=cache,
        extra_properties=extra_properties,
    )
    if extra_properties is not None:
        properties = list(properties) + [
            fn.__name__ for fn in extra_properties
        ]
    if regions:
        return _props_to_dict(
            regions, properties=properties, separator=separator
        )
    # no region: the schema of a single-pixel dummy region, 0 rows
    ndim = label_image.ndim
    dummy = np.zeros((3,) * ndim, dtype=np.int64)
    dummy[(1,) * ndim] = 1
    if intensity_image is not None:
        intensity_image = util.as_tensor(intensity_image,
                                         device=label_image.device)
        intensity_image = torch.zeros(
            dummy.shape + tuple(intensity_image.shape[ndim:]),
            dtype=intensity_image.dtype, device=label_image.device)
    regions = regionprops(
        torch.as_tensor(dummy, device=label_image.device),
        intensity_image=intensity_image,
        cache=cache,
        extra_properties=extra_properties,
    )
    table = _props_to_dict(
        regions, properties=properties, separator=separator
    )
    return {name: column[:0] for name, column in table.items()}
