"""Colour-space conversions (skimage.color) on torch tensors.

The matrices and constants are the published standards (ITU-R BT.601/709
luma weights, the sRGB and CIE primaries, the CIE standard illuminants,
Ruifrok and Johnston's and G. Landini's stain vectors).  A conversion is
a 3x3 matrix applied to every pixel plus per-channel nonlinearities.  The
matrix is applied as nine explicit multiply-adds on the channel planes in
the image's float type, never ``torch.matmul``: a float32 product on the
card may run in TF32 (when a caller allows it), which costs about three
digits on the Lab round trip.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch
from numpy import linalg

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.skimage.util.dtype import dtype_limits, img_as_float

__all__ = [
    "convert_colorspace",
    "rgba2rgb",
    "rgb2hsv",
    "hsv2rgb",
    "rgb2xyz",
    "xyz2rgb",
    "rgb2rgbcie",
    "rgbcie2rgb",
    "rgb2gray",
    "rgb2grey",
    "gray2rgb",
    "grey2rgb",
    "gray2rgba",
    "xyz2lab",
    "lab2xyz",
    "lab2rgb",
    "rgb2lab",
    "xyz2luv",
    "luv2xyz",
    "luv2rgb",
    "rgb2luv",
    "rgb2hed",
    "hed2rgb",
    "lab2lch",
    "lch2lab",
    "rgb2yuv",
    "yuv2rgb",
    "rgb2yiq",
    "yiq2rgb",
    "rgb2ypbpr",
    "ypbpr2rgb",
    "rgb2ycbcr",
    "ycbcr2rgb",
    "rgb2ydbdr",
    "ydbdr2rgb",
    "separate_stains",
    "combine_stains",
    "get_xyz_coords",
]


def _prepare_colorarray(arr, channel_count=3):
    """``arr`` as a float tensor (``img_as_float``), checked to have
    ``channel_count`` channels on its last axis."""
    arr = util.as_tensor(arr)
    if arr.shape[-1] != channel_count:
        raise ValueError(
            f"the input array must have size {channel_count} along its last "
            f"dimension, got {tuple(arr.shape)}"
        )
    return img_as_float(arr)


def _host_matrix(matrix):
    if isinstance(matrix, torch.Tensor):
        matrix = matrix.detach().cpu().numpy()
    return np.asarray(matrix, dtype=np.float64)


def _mix(arr, matrix):
    """``arr @ matrix.T`` over the last axis as explicit multiply-adds:
    output channel ``i`` is ``sum_j matrix[i][j] * arr[..., j]``, the
    entries rounded to ``arr``'s dtype (no matmul, so no TF32)."""
    m = _host_matrix(matrix)
    m = np.atleast_2d(m.astype(dtypes.to_numpy(arr.dtype))).tolist()
    planes = [arr[..., j] for j in range(arr.shape[-1])]
    out = []
    for row in m:
        acc = planes[0] * row[0]
        for plane, w in zip(planes[1:], row[1:]):
            acc = acc + plane * w
        out.append(acc)
    return torch.stack(out, dim=-1)


def _convert(matrix, arr):
    return _mix(_prepare_colorarray(arr), matrix)


# --- conversion matrices (published standards) ------------------------------

xyz_from_rgb = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
rgb_from_xyz = linalg.inv(xyz_from_rgb)

# CIE RGB primaries expressed in XYZ (used by skimage's rgbcie space)
xyz_from_rgbcie = np.array(
    [
        [0.49, 0.31, 0.20],
        [0.17697, 0.81240, 0.01063],
        [0.00, 0.01, 0.99],
    ]
) / 0.17697
rgbcie_from_xyz = linalg.inv(xyz_from_rgbcie)
rgbcie_from_rgb = rgbcie_from_xyz @ xyz_from_rgb
rgb_from_rgbcie = rgb_from_xyz @ xyz_from_rgbcie

gray_from_rgb = np.array([[0.2125, 0.7154, 0.0721]])

yuv_from_rgb = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.14714119, -0.28886916, 0.43601035],
        [0.61497538, -0.51496512, -0.10001026],
    ]
)
rgb_from_yuv = linalg.inv(yuv_from_rgb)

yiq_from_rgb = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.59590059, -0.27455667, -0.32134392],
        [0.21153661, -0.52273617, 0.31119955],
    ]
)
rgb_from_yiq = linalg.inv(yiq_from_rgb)

ypbpr_from_rgb = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ]
)
rgb_from_ypbpr = linalg.inv(ypbpr_from_rgb)

ycbcr_from_rgb = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ]
)
rgb_from_ycbcr = linalg.inv(ycbcr_from_rgb)

ydbdr_from_rgb = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.45, -0.883, 1.333],
        [-1.333, 1.116, 0.217],
    ]
)
rgb_from_ydbdr = linalg.inv(ydbdr_from_rgb)

# CIE standard illuminant XYZ coordinates (X = x*Y/y etc., Y = 1), by
# (illuminant, observer aperture)
illuminants = {
    "A": {
        "2": (1.098466069456375, 1, 0.3558228003436005),
        "10": (1.111420406956693, 1, 0.3519978321919493),
    },
    "D50": {
        "2": (0.9642119944211994, 1, 0.8251882845188288),
        "10": (0.9672062750333777, 1, 0.8142801513128616),
    },
    "D55": {
        "2": (0.956797052643698, 1, 0.9214805860173273),
        "10": (0.9579665682254781, 1, 0.9092525159847462),
    },
    "D65": {
        "2": (0.95047, 1.0, 1.08883),
        "10": (0.94809667673716, 1, 1.0730513595166162),
    },
    "D75": {
        "2": (0.9497220898840717, 1, 1.226393520724154),
        "10": (0.9441713925645873, 1, 1.2064272211720228),
    },
    "E": {"2": (1.0, 1.0, 1.0), "10": (1.0, 1.0, 1.0)},
}


def get_xyz_coords(illuminant, observer, dtype=float):
    """XYZ coordinates of a CIE standard illuminant/observer pair (a host
    numpy array)."""
    illuminant = illuminant.upper()
    try:
        return np.asarray(illuminants[illuminant][observer], dtype=dtype)
    except KeyError:
        raise ValueError(
            f"Unknown illuminant/observer combination "
            f"('{illuminant}', '{observer}')"
        )


def _stain_matrix(rows):
    m = np.array(rows, dtype=np.float64)
    if np.all(m[2] == 0):
        m[2] = np.cross(m[0], m[1])
    return m


# stain-deconvolution vectors (Ruifrok & Johnston 2001; G. Landini)
rgb_from_hed = _stain_matrix(
    [[0.65, 0.70, 0.29], [0.07, 0.99, 0.11], [0.27, 0.57, 0.78]]
)
hed_from_rgb = linalg.inv(rgb_from_hed)
rgb_from_hdx = _stain_matrix(
    [[0.650, 0.704, 0.286], [0.268, 0.570, 0.776], [0, 0, 0]]
)
hdx_from_rgb = linalg.inv(rgb_from_hdx)
rgb_from_fgx = _stain_matrix(
    [
        [0.46420921, 0.83008335, 0.30827187],
        [0.94705542, 0.25373821, 0.19650764],
        [0, 0, 0],
    ]
)
fgx_from_rgb = linalg.inv(rgb_from_fgx)
rgb_from_bex = _stain_matrix(
    [
        [0.834750233, 0.513556283, 0.196330403],
        [0.092789, 0.954111, 0.283111],
        [0, 0, 0],
    ]
)
bex_from_rgb = linalg.inv(rgb_from_bex)
rgb_from_rbd = _stain_matrix(
    [
        [0.21393921, 0.85112669, 0.47794022],
        [0.74890292, 0.60624161, 0.26731082],
        [0.268, 0.570, 0.776],
    ]
)
rbd_from_rgb = linalg.inv(rgb_from_rbd)
rgb_from_gdx = _stain_matrix(
    [[0.98003, 0.144316, 0.133146], [0.268, 0.570, 0.776], [0, 0, 0]]
)
gdx_from_rgb = linalg.inv(rgb_from_gdx)
rgb_from_hax = _stain_matrix(
    [[0.650, 0.704, 0.286], [0.2743, 0.6796, 0.6803], [0, 0, 0]]
)
hax_from_rgb = linalg.inv(rgb_from_hax)
rgb_from_bro = _stain_matrix(
    [
        [0.853033, 0.508733, 0.112656],
        [0.09289875, 0.8662008, 0.49098468],
        [0.10732849, 0.36765403, 0.9237484],
    ]
)
bro_from_rgb = linalg.inv(rgb_from_bro)
rgb_from_bpx = _stain_matrix(
    [
        [0.7995107, 0.5913521, 0.10528667],
        [0.09997159, 0.73738605, 0.6680326],
        [0, 0, 0],
    ]
)
bpx_from_rgb = linalg.inv(rgb_from_bpx)
rgb_from_ahx = _stain_matrix(
    [[0.874622, 0.457711, 0.158256], [0.552556, 0.7544, 0.353744], [0, 0, 0]]
)
ahx_from_rgb = linalg.inv(rgb_from_ahx)
rgb_from_hpx = _stain_matrix(
    [[0.644211, 0.716556, 0.266844], [0.175411, 0.972178, 0.154589],
     [0, 0, 0]]
)
hpx_from_rgb = linalg.inv(rgb_from_hpx)


# --- conversions -------------------------------------------------------------


def convert_colorspace(arr, fromspace, tospace):
    """Convert between colour spaces by name (skimage parity)."""
    fromdict = {
        "rgb": lambda im: im,
        "hsv": hsv2rgb,
        "rgb cie": rgbcie2rgb,
        "xyz": xyz2rgb,
        "yuv": yuv2rgb,
        "yiq": yiq2rgb,
        "ypbpr": ypbpr2rgb,
        "ycbcr": ycbcr2rgb,
        "ydbdr": ydbdr2rgb,
    }
    todict = {
        "rgb": lambda im: im,
        "hsv": rgb2hsv,
        "rgb cie": rgb2rgbcie,
        "xyz": rgb2xyz,
        "yuv": rgb2yuv,
        "yiq": rgb2yiq,
        "ypbpr": rgb2ypbpr,
        "ycbcr": rgb2ycbcr,
        "ydbdr": rgb2ydbdr,
    }
    fromspace = fromspace.lower()
    tospace = tospace.lower()
    if fromspace not in fromdict:
        raise ValueError(f"`fromspace` has to be one of {list(fromdict)}")
    if tospace not in todict:
        raise ValueError(f"`tospace` has to be one of {list(todict)}")
    return todict[tospace](fromdict[fromspace](util.as_tensor(arr)))


def rgba2rgb(rgba, background=(1, 1, 1)):
    """Alpha-blend an RGBA image over a background colour."""
    arr = _prepare_colorarray(rgba, channel_count=4)
    background = torch.as_tensor(np.asarray(background), dtype=arr.dtype,
                                 device=arr.device)
    if background.shape != (3,):
        raise ValueError(
            "the background must be a single RGB color"
        )
    alpha = arr[..., 3:4]
    channels = arr[..., :3]
    return torch.clamp(channels * alpha + background * (1 - alpha), 0, 1)


def rgb2hsv(rgb):
    """RGB -> HSV; a grey pixel has hue 0 and a black one saturation 0."""
    arr = _prepare_colorarray(rgb)
    v = arr.amax(-1)
    minv = arr.amin(-1)
    delta = v - minv
    safe_delta = torch.where(delta == 0, 1.0, delta)
    s = torch.where(v == 0, 0.0, delta / torch.where(v == 0, 1.0, v))
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    hr = ((g - b) / safe_delta) % 6.0
    hg = (b - r) / safe_delta + 2.0
    hb = (r - g) / safe_delta + 4.0
    h = torch.where(v == r, hr, torch.where(v == g, hg, hb))
    h = torch.where(delta == 0, 0.0, h / 6.0)
    return torch.stack([h, s, v], dim=-1)


def hsv2rgb(hsv):
    """HSV -> RGB."""
    arr = _prepare_colorarray(hsv)
    hi = torch.floor(arr[..., 0] * 6)
    f = arr[..., 0] * 6 - hi
    p = arr[..., 2] * (1 - arr[..., 1])
    q = arr[..., 2] * (1 - f * arr[..., 1])
    t = arr[..., 2] * (1 - (1 - f) * arr[..., 1])
    v = arr[..., 2]
    # the sextant, through uint8 as skimage takes it
    hi6 = hi.to(torch.uint8).to(torch.int64) % 6
    choices = torch.stack(
        [
            torch.stack([v, t, p], dim=-1),
            torch.stack([q, v, p], dim=-1),
            torch.stack([p, v, t], dim=-1),
            torch.stack([p, q, v], dim=-1),
            torch.stack([t, p, v], dim=-1),
            torch.stack([v, p, q], dim=-1),
        ],
        dim=0,
    )
    index = hi6[None, ..., None].expand((1,) + tuple(choices.shape[1:]))
    return torch.gather(choices, 0, index)[0]


def rgb2xyz(rgb):
    """sRGB -> CIE XYZ: linearize, then the matrix."""
    arr = _prepare_colorarray(rgb)
    lin = torch.where(
        arr > 0.04045, ((arr + 0.055) / 1.055) ** 2.4, arr / 12.92
    )
    return _mix(lin, xyz_from_rgb)


def xyz2rgb(xyz):
    """CIE XYZ -> sRGB: the matrix, then gamma encoding, clipped to
    [0, 1]."""
    arr = _convert(rgb_from_xyz, xyz)
    mask = arr > 0.0031308
    arr = torch.where(
        mask, 1.055 * torch.pow(torch.clamp(arr, min=1e-30), 1 / 2.4)
        - 0.055, arr * 12.92,
    )
    return torch.clamp(arr, 0, 1)


def rgb2rgbcie(rgb):
    """sRGB -> CIE RGB."""
    return _convert(rgbcie_from_rgb, rgb)


def rgbcie2rgb(rgbcie):
    """CIE RGB -> sRGB."""
    return _convert(rgb_from_rgbcie, rgbcie)


def rgb2gray(rgb):
    """RGB -> luminance with the Y709 weights; a 2-D image passes through
    and channels past the third are dropped, each with skimage's
    FutureWarning."""
    rgb = util.as_tensor(rgb)
    if rgb.ndim == 2:
        warn(
            "The behavior of rgb2gray will change in scikit-image 0.19. "
            "Currently, rgb2gray allows 2D grayscale image to be passed "
            "as inputs and leaves them unmodified as outputs. "
            "Starting from version 0.19, 2D arrays will "
            "be treated as 1D images with 3 channels.",
            FutureWarning,
            stacklevel=2,
        )
        return rgb
    if rgb.shape[-1] > 3:
        warn(
            "Non RGB image conversion is now deprecated. For RGBA images, "
            "please use rgb2gray(rgba2rgb(rgb)) instead. In version 0.19, "
            "a ValueError will be raised if input image last dimension "
            "length is not 3.",
            FutureWarning,
            stacklevel=2,
        )
        rgb = rgb[..., :3]
    rgb = _prepare_colorarray(rgb)
    return _mix(rgb, gray_from_rgb)[..., 0]


rgb2grey = rgb2gray


def _alpha_layer(image, shape):
    return torch.full(shape, dtype_limits(image, clip_negative=False)[1],
                      dtype=image.dtype, device=image.device)


def gray2rgb(image, alpha=None):
    """Stack a grey image into three RGB channels; ``alpha`` and the
    pass-through of 3- and 4-channel inputs keep skimage's deprecated
    behaviour and its FutureWarnings."""
    image = util.as_tensor(image)
    if alpha is not None:
        warn(
            "alpha argument is deprecated and will be removed in "
            "version 0.19. Please use the gray2rgba function instead "
            "to obtain an RGBA image.",
            FutureWarning,
            stacklevel=2,
        )
    squeezed_ndim = image.ndim - sum(1 for s in image.shape if s == 1)
    is_rgb = is_alpha = False
    if squeezed_ndim == 3 and image.ndim >= 3:
        if image.shape[-1] == 3:
            is_rgb = True
        elif image.shape[-1] == 4:
            is_rgb = is_alpha = True
    if is_rgb:
        warn(
            "Pass-through of possibly RGB images in gray2rgb is "
            "deprecated. In version 0.19, input arrays will always be "
            "considered grayscale, even if the last dimension has length "
            "3 or 4. To prevent this warning and ensure compatibility "
            "with future versions, detect RGB images outside of this "
            "function.",
            FutureWarning,
            stacklevel=2,
        )
        if alpha is False:
            return image[..., :3]
        if alpha is True and not is_alpha:
            return torch.cat(
                (image, _alpha_layer(image, image.shape[:-1] + (1,))),
                dim=-1)
        return image
    rgb = torch.stack(3 * (image,), dim=-1)
    if alpha:
        rgb = torch.cat((rgb, _alpha_layer(image, image.shape + (1,))),
                        dim=-1)
    return rgb


grey2rgb = gray2rgb


def gray2rgba(image, alpha=None):
    """Grey -> RGBA; the alpha channel is ``alpha`` or the dtype's
    maximum (1 for floats)."""
    image = util.as_tensor(image)
    if alpha is None:
        if image.is_floating_point():
            alpha = torch.ones_like(image)
        else:
            alpha = _alpha_layer(image, image.shape)
    else:
        alpha = torch.broadcast_to(
            torch.as_tensor(alpha, dtype=image.dtype, device=image.device),
            image.shape)
    return torch.stack([image, image, image, alpha], dim=-1)


def _white(illuminant, observer, arr):
    """The illuminant's reference white as Python floats rounded to
    ``arr``'s dtype."""
    white = get_xyz_coords(illuminant, observer)
    return white.astype(dtypes.to_numpy(arr.dtype)).tolist()


def _cbrt(x):
    """The real cube root of positive ``x`` (torch has no cbrt)."""
    return torch.pow(x, 1.0 / 3.0)


def xyz2lab(xyz, illuminant="D65", observer="2"):
    """XYZ -> CIE-LAB under the given illuminant and observer."""
    arr = _prepare_colorarray(xyz)
    wx, wy, wz = _white(illuminant, observer, arr)
    x, y, z = arr[..., 0] / wx, arr[..., 1] / wy, arr[..., 2] / wz
    arr = torch.stack([x, y, z], dim=-1)
    arr = torch.where(
        arr > 0.008856, _cbrt(torch.clamp(arr, min=1e-30)),
        7.787 * arr + 16.0 / 116.0,
    )
    x, y, z = arr[..., 0], arr[..., 1], arr[..., 2]
    L = (116.0 * y) - 16.0
    a = 500.0 * (x - y)
    b = 200.0 * (y - z)
    return torch.stack([L, a, b], dim=-1)


def lab2xyz(lab, illuminant="D65", observer="2"):
    """CIE-LAB -> XYZ; a negative Z is clipped to 0 with skimage's
    warning."""
    arr = _prepare_colorarray(lab)
    L, a, b = arr[..., 0], arr[..., 1], arr[..., 2]
    y = (L + 16.0) / 116.0
    x = (a / 500.0) + y
    z = y - (b / 200.0)
    n_invalid = int(torch.count_nonzero(z < 0))
    if n_invalid != 0:
        warn(
            "Color data out of range: Z < 0 in %s pixels" % n_invalid,
            stacklevel=2,
        )
    z = torch.clamp(z, min=0)
    out = torch.stack([x, y, z], dim=-1)
    out = torch.where(out > 0.2068966, out ** 3,
                      (out - 16.0 / 116.0) / 7.787)
    wx, wy, wz = _white(illuminant, observer, out)
    return torch.stack([out[..., 0] * wx, out[..., 1] * wy,
                        out[..., 2] * wz], dim=-1)


def rgb2lab(rgb, illuminant="D65", observer="2"):
    """RGB -> CIE-LAB."""
    return xyz2lab(rgb2xyz(rgb), illuminant, observer)


def lab2rgb(lab, illuminant="D65", observer="2"):
    """CIE-LAB -> RGB."""
    return xyz2rgb(lab2xyz(lab, illuminant, observer))


def _uv0(illuminant, observer):
    white = np.asarray(get_xyz_coords(illuminant, observer))
    denom = np.dot([1, 15, 3], white)
    return white, float(4 * white[0] / denom), float(9 * white[1] / denom)


def xyz2luv(xyz, illuminant="D65", observer="2"):
    """XYZ -> CIE-LUV."""
    arr = _prepare_colorarray(xyz)
    x, y, z = arr[..., 0], arr[..., 1], arr[..., 2]
    eps = float(np.finfo(np.float64).eps)
    _, u0, v0 = _uv0(illuminant, observer)
    L = torch.where(
        y > 0.008856, 116.0 * _cbrt(torch.clamp(y, min=1e-30)) - 16.0,
        903.3 * y,
    )
    denom = x + 15 * y + 3 * z
    safe = torch.where(denom == 0, eps, denom)
    u = 13 * L * (4 * x / safe - u0)
    v = 13 * L * (9 * y / safe - v0)
    return torch.stack([L, u, v], dim=-1)


def luv2xyz(luv, illuminant="D65", observer="2"):
    """CIE-LUV -> XYZ."""
    arr = _prepare_colorarray(luv)
    L, u, v = arr[..., 0], arr[..., 1], arr[..., 2]
    eps = float(np.finfo(np.float64).eps)
    white, u0, v0 = _uv0(illuminant, observer)
    y = torch.where(
        L > 7.999625, ((L + 16.0) / 116.0) ** 3, L / 903.3
    ) * float(white[1])
    safe_L = torch.where(L == 0, eps, 13 * L)
    a = u0 + u / safe_L
    d = v0 + v / safe_L
    c = 3 * y * (5 * d - 3)
    safe_d = torch.where(d == 0, eps, d)
    z = ((a - 4) * c - 15 * a * d * y) / (12 * safe_d)
    x = -(c / safe_d + 3.0 * z)
    return torch.stack([x, y, z], dim=-1)


def rgb2luv(rgb, illuminant="D65", observer="2"):
    """RGB -> CIE-LUV."""
    return xyz2luv(rgb2xyz(rgb), illuminant, observer)


def luv2rgb(luv, illuminant="D65", observer="2"):
    """CIE-LUV -> RGB."""
    return xyz2rgb(luv2xyz(luv, illuminant, observer))


def lab2lch(lab):
    """CIE-LAB -> CIE-LCh (hue in [0, 2 pi)); channels past the third
    pass through."""
    lab = util.as_tensor(lab)
    if lab.shape[-1] < 3:
        raise ValueError("Input array has less than 3 color channels")
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    c = torch.hypot(a, b)
    h = torch.atan2(b, a) % (2 * np.pi)
    out = torch.stack([L, c, h], dim=-1)
    if lab.shape[-1] > 3:
        out = torch.cat([out, lab[..., 3:]], dim=-1)
    return out


def lch2lab(lch):
    """CIE-LCh -> CIE-LAB; channels past the third pass through."""
    lch = util.as_tensor(lch)
    if lch.shape[-1] < 3:
        raise ValueError("Input array has less than 3 color channels")
    L, c, h = lch[..., 0], lch[..., 1], lch[..., 2]
    a = c * torch.cos(h)
    b = c * torch.sin(h)
    out = torch.stack([L, a, b], dim=-1)
    if lch.shape[-1] > 3:
        out = torch.cat([out, lch[..., 3:]], dim=-1)
    return out


def _stain_product(conv_matrix, dtype):
    """``conv_matrix`` as the stain functions apply it (``x @ M``, the
    transpose for ``_mix``), its entries rounded to the image's float
    type; the product itself is float64, as skimage's."""
    m = _host_matrix(conv_matrix).astype(dtypes.to_numpy(dtype))
    return m.astype(np.float64).T


def separate_stains(rgb, conv_matrix):
    """RGB -> stain concentrations (float64) by colour deconvolution: the
    optical density ``log(rgb) / log(1e-6)`` times ``conv_matrix``.
    Negative concentrations are kept, so ``combine_stains`` inverts it
    exactly for in-gamut input."""
    rgb = _prepare_colorarray(rgb)
    rgb = torch.clamp(rgb, min=1e-6)  # avoid log(0)
    od = torch.log(rgb).to(torch.float64) / np.log(1e-6)
    return _mix(od, _stain_product(conv_matrix, rgb.dtype))


def combine_stains(stains, conv_matrix):
    """Stain concentrations -> RGB (float64), clipped to [0, 1]."""
    stains = _prepare_colorarray(stains)
    od = stains.to(torch.float64) * np.log(1e-6)
    log_rgb = _mix(od, _stain_product(conv_matrix, stains.dtype))
    return torch.clamp(torch.exp(log_rgb), 0, 1)


def rgb2hed(rgb):
    """RGB -> Haematoxylin-Eosin-DAB."""
    return separate_stains(rgb, hed_from_rgb)


def hed2rgb(hed):
    """HED -> RGB."""
    return combine_stains(hed, rgb_from_hed)


def rgb2yuv(rgb):
    """RGB -> YUV."""
    return _convert(yuv_from_rgb, rgb)


def yuv2rgb(yuv):
    """YUV -> RGB."""
    return _convert(rgb_from_yuv, yuv)


def rgb2yiq(rgb):
    """RGB -> YIQ."""
    return _convert(yiq_from_rgb, rgb)


def yiq2rgb(yiq):
    """YIQ -> RGB."""
    return _convert(rgb_from_yiq, yiq)


def rgb2ypbpr(rgb):
    """RGB -> YPbPr."""
    return _convert(ypbpr_from_rgb, rgb)


def ypbpr2rgb(ypbpr):
    """YPbPr -> RGB."""
    return _convert(rgb_from_ypbpr, ypbpr)


_YCBCR_OFFSETS = (16.0, 128.0, 128.0)


def rgb2ycbcr(rgb):
    """RGB -> Y'CbCr (BT.601 digital)."""
    arr = _convert(ycbcr_from_rgb, rgb)
    return arr + torch.tensor(_YCBCR_OFFSETS, dtype=arr.dtype,
                              device=arr.device)


def ycbcr2rgb(ycbcr):
    """Y'CbCr -> RGB (in float64, as skimage)."""
    arr = util.as_tensor(ycbcr).to(torch.float64)
    arr = arr - torch.tensor(_YCBCR_OFFSETS, dtype=arr.dtype,
                             device=arr.device)
    return _convert(rgb_from_ycbcr, arr)


def rgb2ydbdr(rgb):
    """RGB -> YDbDr (SECAM)."""
    return _convert(ydbdr_from_rgb, rgb)


def ydbdr2rgb(ydbdr):
    """YDbDr -> RGB."""
    return _convert(rgb_from_ydbdr, ydbdr)
