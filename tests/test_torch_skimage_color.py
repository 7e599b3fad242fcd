"""``skimage.color`` of the torch port on CPU tensors: the conversions
against skimage's golden arrays (``tests/data/color``'s Lab and Luv
arrays for every illuminant and observer, the easyrgb and Bruce Lindbloom
values and the colour bars of ``test_skimage_colorconv_suite``),
``colorsys`` and numpy transcriptions, round trips and dtypes; the
colour differences against Sharma's CIEDE2000 table
(``tests/data/color/ciede2000_test_data.txt``) and numpy transcriptions;
``label2rgb`` against ``test_skimage_colorlabel_suite``'s cases and a
numpy definition; ``adapt_rgb``; and a named list against
``cupyimg_tpu``: the traceable conversions and differences as one jit
program per float type, ``lab2rgb`` and ``label2rgb`` eager.  A colour
conversion never calls ``torch.matmul`` (a float32 product may take TF32
on the card): a test makes the matmul entry points raise.

Tolerances: golden arrays to the suite's decimals; float64 against
``cupyimg_tpu`` within 1e-12 of max|ref| (Lab/Luv: 1e-11, a cube root by
``pow``), float32 within 1e-5 (2e-5 for Lab/Luv, whose 116 * cbrt
amplifies one float32 rounding); float32 round trips within 2e-5
(``cupyimg_tpu``'s own Luv round trip errs by 1.4e-5 on the test image);
CIEDE2000 to Sharma's four decimals.
"""

import colorsys
import importlib
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.skimage.color as jc
from cupyimg_tpu_torch.skimage import color as tc
from cupyimg_tpu_torch.skimage.color import colorconv as tcc
from cupyimg_tpu_torch.skimage.color.delta_e import get_dH2

DATA = os.path.join(os.path.dirname(__file__), "data", "color")


def T(x):
    return torch.from_numpy(np.array(x))


def H(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol):
    got = np.asarray(H(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _img_rgb():
    return (np.random.default_rng(0).uniform(size=(64, 48, 3)) * 255).astype(
        np.uint8)


COLBARS = np.swapaxes(np.array(
    [[1, 1, 0, 0, 1, 1, 0, 0], [1, 1, 1, 1, 0, 0, 0, 0],
     [1, 0, 1, 0, 1, 0, 1, 0]], np.float64).reshape(3, 4, 2), 0, 2)
XYZ = np.array([[[0.4124, 0.21260, 0.01930]], [[0, 0, 0]],
                [[0.9505, 1.0, 1.089]], [[0.1805, 0.0722, 0.9505]],
                [[0.07719, 0.15438, 0.02573]]])
LAB = np.array([[[53.233, 80.109, 67.220]], [[0.0, 0.0, 0.0]],
                [[100.0, 0.005, -0.010]], [[32.303, 79.197, -107.864]],
                [[46.229, -51.7, 49.898]]])
LUV = np.array([[[53.233, 175.053, 37.751]], [[0.0, 0.0, 0.0]],
                [[100.0, 0.001, -0.017]], [[32.303, -9.400, -130.358]],
                [[46.228, -43.774, 56.589]]])
ILLUMINANTS = [(i, o) for i in ("d50", "d55", "d65", "d75")
               for o in ("2", "10")] + [("a", "2"), ("e", "2")]


# ---------------------------------------------------------------------------
# golden arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("illuminant, observer", ILLUMINANTS)
def test_lab_luv_golden_arrays(illuminant, observer):
    """skimage's arrays of XYZ_ARRAY in Lab and Luv under every
    illuminant and observer, both ways."""
    for space, fwd, back in (("lab", tc.xyz2lab, tc.lab2xyz),
                             ("luv", tc.xyz2luv, tc.luv2xyz)):
        golden = np.load(os.path.join(
            DATA, f"{space}_array_{illuminant}_{observer}.npy"))
        np.testing.assert_array_almost_equal(
            H(fwd(T(XYZ), illuminant, observer)), golden, decimal=2)
        np.testing.assert_array_almost_equal(
            H(back(T(golden), illuminant, observer)), XYZ, decimal=3)


def test_suite_golden_values():
    np.testing.assert_array_almost_equal(H(tc.xyz2lab(T(XYZ))), LAB, 3)
    np.testing.assert_array_almost_equal(H(tc.lab2xyz(T(LAB))), XYZ, 3)
    np.testing.assert_array_almost_equal(H(tc.xyz2luv(T(XYZ))), LUV, 3)
    np.testing.assert_array_almost_equal(H(tc.luv2xyz(T(LUV))), XYZ, 3)
    gt = np.array([[[0.950456, 1.0, 1.088754], [0.538003, 0.787329, 1.06942],
                    [0.592876, 0.28484, 0.969561],
                    [0.180423, 0.072169, 0.950227]],
                   [[0.770033, 0.927831, 0.138527],
                    [0.35758, 0.71516, 0.119193],
                    [0.412453, 0.212671, 0.019334], [0.0, 0.0, 0.0]]])
    np.testing.assert_array_almost_equal(H(tc.rgb2xyz(T(COLBARS))), gt)
    gt = np.array([[[0.1488856, 0.18288098, 0.19277574],
                    [0.01163224, 0.16649536, 0.18948516],
                    [0.12259182, 0.03308008, 0.17298223],
                    [-0.01466154, 0.01669446, 0.16969164]],
                   [[0.16354714, 0.16618652, 0.0230841],
                    [0.02629378, 0.1498009, 0.01979351],
                    [0.13725336, 0.01638562, 0.00329059], [0.0, 0.0, 0.0]]])
    np.testing.assert_array_almost_equal(H(tc.rgb2rgbcie(T(COLBARS))), gt)
    lab = np.array([[100, 0, 0], [97.1393, -21.5537, 94.4780],
                    [91.1132, -48.0875, -14.1312], [87.7347, -86.1827, 83.1793],
                    [60.3242, 98.2343, -60.8249], [53.2408, 80.0925, 67.2032],
                    [32.2970, 79.1875, -107.8602], [0, 0, 0]]).T
    np.testing.assert_array_almost_equal(
        H(tc.rgb2lab(T(COLBARS))),
        np.swapaxes(lab.reshape(3, 4, 2), 0, 2), decimal=2)
    luv = np.array([[100, 0, 0], [97.1393, 7.7056, 106.7866],
                    [91.1132, -70.4773, -15.2042], [87.7347, -83.0776, 107.3985],
                    [60.3242, 84.0714, -108.6834], [53.2408, 175.0151, 37.7564],
                    [32.2970, -9.4054, -130.3423], [0, 0, 0]]).T
    np.testing.assert_array_almost_equal(
        H(tc.rgb2luv(T(COLBARS))),
        np.swapaxes(luv.reshape(3, 4, 2), 0, 2), decimal=2)
    outliers = np.array([[[50, -12, 85]], [[50, 12, -85]], [[90, -4, -47]]],
                        np.float64)
    np.testing.assert_array_almost_equal(
        H(tc.lab2rgb(T(outliers))),
        [[[0.501, 0.481, 0]], [[0, 0.482, 1.0]], [[0.578, 0.914, 1.0]]], 3)
    rgba = np.array([[[0, 0.5, 1, 0], [0, 0.5, 1, 1], [0, 0.5, 1, 0.5]]])
    np.testing.assert_array_almost_equal(
        H(tc.rgba2rgb(T(rgba))), [[[1, 1, 1], [0, 0.5, 1], [0.5, 0.75, 1]]])


def test_hsv_against_colorsys():
    rgb = _img_rgb()[::16, ::16].astype(np.float64) / 255
    gt = np.array([colorsys.rgb_to_hsv(*p) for p in rgb.reshape(-1, 3)])
    np.testing.assert_array_almost_equal(H(tc.rgb2hsv(T(rgb))).reshape(-1, 3),
                                         gt)
    np.testing.assert_array_almost_equal(H(tc.hsv2rgb(T(gt.reshape(
        rgb.shape)))), rgb)
    grey = np.array([[[0.3, 0.3, 0.3], [0, 0, 0]]])
    np.testing.assert_array_equal(H(tc.rgb2hsv(T(grey))),
                                  [[[0, 0, 0.3], [0, 0, 0]]])


# numpy transcriptions of the linear spaces (skimage's matrices)
LINEAR = [("yuv", tc.rgb2yuv, tc.yuv2rgb), ("yiq", tc.rgb2yiq, tc.yiq2rgb),
          ("ypbpr", tc.rgb2ypbpr, tc.ypbpr2rgb),
          ("ydbdr", tc.rgb2ydbdr, tc.ydbdr2rgb)]


@pytest.mark.parametrize("name, fwd, back", LINEAR)
def test_linear_spaces_match_numpy(name, fwd, back):
    rgb = _img_rgb().astype(np.float64) / 255
    m = getattr(tcc, f"{name}_from_rgb")
    close(fwd(T(rgb)), rgb @ m.T, 1e-15)
    close(back(fwd(T(rgb))), rgb, 1e-14)
    assert fwd(T(rgb.astype(np.float32))).dtype == torch.float32


def test_ycbcr_gray_and_stains_match_numpy():
    rgb = _img_rgb().astype(np.float64) / 255
    close(tc.rgb2ycbcr(T(rgb)),
          rgb @ tcc.ycbcr_from_rgb.T + [16, 128, 128], 1e-14)
    close(tc.ycbcr2rgb(tc.rgb2ycbcr(T(rgb))), rgb, 1e-13)
    close(tc.rgb2gray(T(rgb)), rgb @ [0.2125, 0.7154, 0.0721], 1e-15)
    od = np.log(np.maximum(rgb, 1e-6)) / np.log(1e-6)
    for fwd, back in (("hed_from_rgb", "rgb_from_hed"),
                      ("hdx_from_rgb", "rgb_from_hdx"),
                      ("bro_from_rgb", "rgb_from_bro")):
        stains = tc.separate_stains(T(rgb), getattr(tcc, fwd))
        close(stains, od @ getattr(tcc, fwd), 1e-14)
        close(tc.combine_stains(stains, getattr(tcc, back)),
              np.clip(rgb, 1e-6, 1), 1e-12)
    img = _img_rgb()
    close(tc.hed2rgb(tc.rgb2hed(T(img))), img / 255.0, 1e-2)


def test_round_trips_and_dtypes():
    rgb = _img_rgb().astype(np.float64) / 255
    for fwd, back in ((tc.rgb2lab, tc.lab2rgb), (tc.rgb2luv, tc.luv2rgb),
                      (tc.rgb2xyz, tc.xyz2rgb), (tc.rgb2hsv, tc.hsv2rgb),
                      (tc.rgb2rgbcie, tc.rgbcie2rgb)):
        close(back(fwd(T(rgb))), rgb, 1e-12)
        for dt in (torch.float32, torch.float64):
            x = T(rgb).to(dt)
            assert fwd(x).dtype == dt and back(fwd(x)).dtype == dt
        close(back(fwd(T(rgb).float())), rgb, 2e-5)
    lab = tc.rgb2lab(T(rgb))
    close(tc.lch2lab(tc.lab2lch(lab)), H(lab), 1e-13)
    close(tc.lab2lch(lab[0, 0]), H(tc.lab2lch(lab[None, None, 0, 0])[0, 0]),
          0)
    lab4 = torch.cat([lab, lab[..., :1]], -1)
    close(tc.lab2lch(lab4)[..., 3], H(lab[..., 0]), 0)
    with pytest.raises(ValueError):
        tc.lab2lch(lab[..., :2])
    assert tc.rgb2lab(T(_img_rgb())).dtype == torch.float64


def test_gray_conversions_and_warnings():
    x = torch.ones((1, 1, 3))
    g = tc.rgb2gray(x)
    assert g.shape == (1, 1) and abs(float(g) - 1) < 1e-7
    assert tc.rgb2gray(x.double()).dtype == torch.float64
    with pytest.warns(FutureWarning, match="Non RGB image conversion"):
        assert tc.rgb2gray(torch.rand(10, 10, 4)).ndim == 2
    with pytest.warns(FutureWarning, match="The behavior of rgb2gray"):
        tc.rgb2gray(torch.rand(5, 5))
    grey = T(_img_rgb()[..., 0])
    rgb = tc.gray2rgb(grey)
    assert rgb.shape == grey.shape + (3,) and rgb.dtype == torch.uint8
    assert torch.equal(rgb[..., 1], grey)
    rgba = tc.gray2rgba(grey)
    assert rgba.shape == grey.shape + (4,) and int(rgba[..., 3].min()) == 255
    assert float(tc.gray2rgba(grey.double() / 255)[..., 3].min()) == 1.0
    np.testing.assert_array_equal(H(tc.gray2rgba(grey, alpha=7)[..., 3]), 7)
    with pytest.warns(FutureWarning):
        assert tc.gray2rgb(rgb, alpha=True).shape == grey.shape + (4,)
    with pytest.warns(FutureWarning):
        assert tc.gray2rgb(rgb).shape == rgb.shape
    for bad in (tc.rgba2rgb, tc.rgb2hsv, tc.hsv2rgb, tc.rgb2xyz):
        with pytest.raises(ValueError):
            bad(grey)
    with pytest.raises(ValueError):
        tc.rgba2rgb(T(_img_rgb()))
    with pytest.raises(ValueError):
        tc.lab2xyz(T(LAB), "NaI", "2")
    with pytest.raises(ValueError):
        tc.lab2xyz(T(LAB), "d50", "42")
    a, b = np.meshgrid(np.arange(-100, 100), np.arange(-100, 100))
    lab = np.dstack((np.full(a.shape, 10.0), a, b))
    with pytest.warns(UserWarning, match="Color data out of range"):
        tc.lab2xyz(T(lab))


def test_convert_colorspace():
    rgb = T(COLBARS)
    close(tc.convert_colorspace(rgb, "RGB", "RGB"), COLBARS, 0)
    for space, to, frm in (("HSV", tc.rgb2hsv, tc.hsv2rgb),
                           ("RGB CIE", tc.rgb2rgbcie, tc.rgbcie2rgb),
                           ("XYZ", tc.rgb2xyz, tc.xyz2rgb),
                           ("YUV", tc.rgb2yuv, tc.yuv2rgb),
                           ("YIQ", tc.rgb2yiq, tc.yiq2rgb),
                           ("YPbPr", tc.rgb2ypbpr, tc.ypbpr2rgb),
                           ("YCbCr", tc.rgb2ycbcr, tc.ycbcr2rgb),
                           ("YDbDr", tc.rgb2ydbdr, tc.ydbdr2rgb)):
        close(tc.convert_colorspace(rgb, "RGB", space), H(to(rgb)), 0)
        close(tc.convert_colorspace(rgb, space, "RGB"), H(frm(rgb)), 0)
    with pytest.raises(ValueError):
        tc.convert_colorspace(rgb, "nokey", "XYZ")
    with pytest.raises(ValueError):
        tc.convert_colorspace(rgb, "RGB", "nokey")


def test_no_matmul_in_colour_conversions(monkeypatch):
    """Every conversion runs with torch's matmul entry points made to
    raise: none is reached, so TF32 cannot leak into them."""
    def refuse(*args, **kwargs):
        raise AssertionError("matmul in a colour conversion")

    rgb = T(_img_rgb()).float() / 255
    for name in ("matmul", "mm", "bmm", "einsum", "tensordot", "inner"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    monkeypatch.setattr(torch.Tensor, "matmul", refuse)
    lab = tc.rgb2lab(rgb)
    outs = [tc.lab2rgb(lab), tc.rgb2luv(rgb), tc.luv2rgb(tc.rgb2luv(rgb)),
            tc.rgb2hsv(rgb), tc.hsv2rgb(tc.rgb2hsv(rgb)), tc.rgb2gray(rgb),
            tc.rgb2hed(rgb), tc.hed2rgb(tc.rgb2hed(rgb)),
            tc.separate_stains(rgb, tcc.bex_from_rgb), tc.rgb2ycbcr(rgb),
            tc.deltaE_ciede2000(lab, lab.flip(0)),
            tc.deltaE_cmc(lab, lab.flip(1)), tc.rgb2rgbcie(rgb)]
    outs += [f(rgb) for f in (tc.rgb2yuv, tc.rgb2yiq, tc.rgb2ypbpr,
                              tc.rgb2ydbdr, tc.rgb2xyz)]
    assert all(torch.isfinite(o).all() for o in outs)


# ---------------------------------------------------------------------------
# colour differences
# ---------------------------------------------------------------------------


def _sharma():
    names = ["pair", "1", "L1", "a1", "b1", "a1_prime", "C1_prime",
             "h1_prime", "hbar_prime", "G", "T", "SL", "SC", "SH", "RT",
             "dE", "2", "L2", "a2", "b2", "a2_prime", "C2_prime",
             "h2_prime"]
    data = np.loadtxt(os.path.join(DATA, "ciede2000_test_data.txt"),
                      dtype=[(n, int if n in ("pair", "1", "2") else float)
                             for n in names])
    lab1 = np.stack([data["L1"], data["a1"], data["b1"]], -1)
    lab2 = np.stack([data["L2"], data["a2"], data["b2"]], -1)
    return data, lab1, lab2


def test_ciede2000_against_sharma():
    data, lab1, lab2 = _sharma()
    got = tc.deltaE_ciede2000(T(lab1), T(lab2))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(H(got), data["dE"], rtol=1e-4)
    np.testing.assert_allclose(H(tc.deltaE_ciede2000(T(lab2), T(lab1))),
                               data["dE"], rtol=1e-4)


def _np_lch(lab):
    return np.hypot(lab[..., 1], lab[..., 2]), np.arctan2(
        lab[..., 2], lab[..., 1]) % (2 * np.pi)


def test_cie76_94_cmc_match_numpy():
    """The published formulas written out in numpy on Sharma's pairs."""
    _, lab1, lab2 = _sharma()
    d76 = np.sqrt(((lab1 - lab2) ** 2).sum(-1))
    close(tc.deltaE_cie76(T(lab1), T(lab2)), d76, 1e-14)
    (C1, h1), (C2, _) = _np_lch(lab1), _np_lch(lab2)
    dL, dC = lab1[:, 0] - lab2[:, 0], C1 - C2
    dH2 = np.maximum(d76 ** 2 - dL ** 2 - dC ** 2, 0)
    d94 = np.sqrt(dL ** 2 + (dC / (1 + 0.045 * C1)) ** 2
                  + dH2 / (1 + 0.015 * C1) ** 2)
    close(tc.deltaE_ciede94(T(lab1), T(lab2)), d94, 1e-13)
    hd = np.rad2deg(h1)
    Tt = np.where((hd >= 164) & (hd <= 345),
                  0.56 + 0.2 * np.abs(np.cos(h1 + np.deg2rad(168))),
                  0.36 + 0.4 * np.abs(np.cos(h1 + np.deg2rad(35))))
    F = np.sqrt(C1 ** 4 / (C1 ** 4 + 1900))
    SL = np.where(lab1[:, 0] < 16, 0.511,
                  0.040975 * lab1[:, 0] / (1 + 0.01765 * lab1[:, 0]))
    SC = 0.638 + 0.0638 * C1 / (1 + 0.0131 * C1)
    SH = SC * (F * Tt + 1 - F)
    dcmc = np.sqrt((dL / SL) ** 2 + (dC / SC) ** 2 + dH2 / SH ** 2)
    close(tc.deltaE_cmc(T(lab1), T(lab2)), dcmc, 1e-13)
    close(get_dH2(T(lab1), T(lab2)), 2 * (
        C1 * C2 - (lab1[:, 1] * lab2[:, 1] + lab1[:, 2] * lab2[:, 2])),
        1e-13)
    same = tc.deltaE_ciede2000(T(lab1), T(lab1))
    assert float(same.abs().max()) == 0


# ---------------------------------------------------------------------------
# label2rgb and adapt_rgb
# ---------------------------------------------------------------------------


def test_label2rgb_suite_cases():
    colors = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    label = torch.arange(3).reshape(1, -1)
    with pytest.warns(FutureWarning, match="The new recommended value"):
        tc.label2rgb(torch.ones((3, 3)), torch.ones((3, 3)))
    with pytest.raises(ValueError):
        tc.label2rgb(torch.ones((3, 3)), torch.ones((2, 2)), bg_label=-1)
    with pytest.raises(ValueError):
        tc.label2rgb(torch.ones((3, 3)), kind="foo", bg_label=-1)
    rng = np.random.RandomState(0)
    img = T(rng.randint(0, 255, (10, 10)).astype(np.uint8))
    labels = torch.zeros((10, 10), dtype=torch.int64)
    labels[1:3, 1:3] = 1
    labels[6:9, 6:9] = 2
    out = tc.label2rgb(labels, image=img, bg_label=0)
    assert out.is_floating_point() and float(out.max()) <= 1
    for kw in ({"image": torch.ones((1, 3)), "alpha": 1, "image_alpha": 1},
               {"image": T(rng.uniform(size=(1, 3))), "alpha": 1,
                "image_alpha": 0}, {}):
        np.testing.assert_array_almost_equal(
            H(tc.label2rgb(label, colors=colors, bg_label=-1, **kw)),
            [colors])
    np.testing.assert_array_almost_equal(
        H(tc.label2rgb(label, image=torch.ones((1, 3)),
                       colors=["red", "lime", "blue"], alpha=1,
                       image_alpha=1, bg_label=-1)), [colors])
    image = T(rng.uniform(size=(3, 3)))
    rgb = tc.label2rgb(T(rng.randint(0, 9, size=(3, 3))), image=image,
                       alpha=0, image_alpha=1, bg_label=-1)
    for c in range(3):
        np.testing.assert_array_almost_equal(H(rgb[..., c]), H(image))
    rgb = tc.label2rgb(torch.arange(10).reshape(1, -1),
                       image=torch.zeros((1, 10)), bg_label=0,
                       bg_color=(0, 0, 0), colors=[(1, 0, 0), (0, 0, 1)],
                       alpha=1)
    np.testing.assert_array_almost_equal(H(rgb[0, 0]), (0, 0, 0))
    for k, pixel in enumerate(H(rgb)[0, 1:]):
        np.testing.assert_array_almost_equal(pixel, [(1, 0, 0),
                                                     (0, 0, 1)][k % 2])
    np.testing.assert_array_almost_equal(
        H(tc.label2rgb(torch.tensor([0, -1, -2, 0]), bg_label=0, alpha=1,
                       image_alpha=1)),
        [(0, 0, 0), (0, 0, 1), (1, 0, 0), (0, 0, 0)])
    np.testing.assert_array_almost_equal(
        H(tc.label2rgb(torch.tensor([0, 2, 4, 0]), colors=[(1, 0, 0),
                                                           (0, 0, 1)],
                       alpha=1, image_alpha=1, bg_label=-1)),
        [(1, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 0)])
    labels = torch.tensor([-1, 0, 1])
    tc.label2rgb(labels, bg_label=-1)
    assert labels.tolist() == [-1, 0, 1]
    with pytest.warns(UserWarning, match="Negative intensities"):
        tc.label2rgb(label, image=-torch.ones((1, 3)), bg_label=-1)


def _np_avg(labels, image, bg_label, bg_color):
    out = np.zeros(labels.shape + (3,))
    for v in np.unique(labels):
        m = labels == v
        out[m] = bg_color if v == bg_label else image[m].mean(0)
    return out


def test_label2rgb_avg_matches_numpy():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 6, (20, 17))
    image = rng.random((20, 17, 3))
    got = tc.label2rgb(T(labels), T(image), kind="avg", bg_label=0)
    assert got.dtype == torch.float64
    close(got, _np_avg(labels, image, 0, (0, 0, 0)), 1e-15)
    grey = rng.random((20, 17)).astype(np.float32)
    got = tc.label2rgb(T(labels), T(grey), kind="avg", bg_label=3,
                       bg_color=(1, 0.5, 0))
    close(got, _np_avg(labels, np.repeat(grey[..., None], 3, -1)
                       .astype(np.float64), 3, (1, 0.5, 0)), 1e-15)


def test_label2rgb_matches_cupyimg_tpu():
    """cupyimg_tpu's label2rgb, eager (it reads the labels on the host):
    overlay on a grey float32 image with a background colour (within
    1e-7: cupyimg_tpu's grey image is float32).  The average colours are
    held against numpy above."""
    rng = np.random.default_rng(9)
    labels = rng.integers(-2, 3, (12, 15))
    image = rng.random((12, 15)).astype(np.float32)
    cases = [
        (dict(label=labels, image=image, bg_label=0, alpha=0.4), 1e-7),
    ]
    for kw, tol in cases:
        want = np.asarray(jc.label2rgb(**{k: jnp.asarray(v) if isinstance(
            v, np.ndarray) else v for k, v in kw.items()}))
        got = tc.label2rgb(**{k: T(v) if isinstance(v, np.ndarray) else v
                              for k, v in kw.items()})
        assert got.dtype == torch.float64
        close(got, want, tol)


def test_adapt_rgb():
    @tc.adapt_rgb(tc.each_channel)
    def double(image):
        return image * 2

    @tc.adapt_rgb(tc.hsv_value)
    def halve(image):
        return image / 2

    rgb = T(_img_rgb()).double() / 255
    assert torch.equal(double(rgb), rgb * 2)
    grey = rgb[..., 0]
    assert torch.equal(double(grey), grey * 2)
    hsv = tc.rgb2hsv(rgb)
    hsv[..., 2] /= 2
    close(halve(rgb), H(tc.hsv2rgb(hsv)), 1e-15)
    close(halve(torch.cat([rgb, rgb[..., :1]], -1)), H(tc.hsv2rgb(hsv)),
          1e-15)


# ---------------------------------------------------------------------------
# against cupyimg_tpu
# ---------------------------------------------------------------------------

# (name, port function, cupyimg_tpu function, extra arguments)
JIT_CASES = [
    ("rgb2hsv", tc.rgb2hsv, jc.rgb2hsv, ()),
    ("hsv2rgb", tc.hsv2rgb, jc.hsv2rgb, ()),
    ("rgb2xyz", tc.rgb2xyz, jc.rgb2xyz, ()),
    ("xyz2rgb", tc.xyz2rgb, jc.xyz2rgb, ()),
    ("rgb2lab D50 10", tc.rgb2lab, jc.rgb2lab, ("D50", "10")),
    ("rgb2luv A 2", tc.rgb2luv, jc.rgb2luv, ("A", "2")),
    ("luv2rgb", tc.luv2rgb, jc.luv2rgb, ()),
    ("rgb2gray", tc.rgb2gray, jc.rgb2gray, ()),
    ("rgb2rgbcie", tc.rgb2rgbcie, jc.rgb2rgbcie, ()),
    ("rgb2ycbcr", tc.rgb2ycbcr, jc.rgb2ycbcr, ()),
    ("ydbdr2rgb", tc.ydbdr2rgb, jc.ydbdr2rgb, ()),
    ("rgb2hed", tc.rgb2hed, jc.rgb2hed, ()),
    ("hed2rgb", tc.hed2rgb, jc.hed2rgb, ()),
    ("separate_stains ahx", tc.separate_stains, jc.separate_stains,
     (tcc.ahx_from_rgb,)),
    ("lab2lch", tc.lab2lch, jc.lab2lch, ()),
]
PAIR_CASES = [("deltaE_cie76", tc.deltaE_cie76, jc.deltaE_cie76),
              ("deltaE_ciede94", tc.deltaE_ciede94, jc.deltaE_ciede94),
              ("deltaE_ciede2000", tc.deltaE_ciede2000, jc.deltaE_ciede2000),
              ("deltaE_cmc", tc.deltaE_cmc, jc.deltaE_cmc)]


def test_conversions_match_cupyimg_tpu():
    """The traceable conversions and the four differences, float64, as
    one jit program of cupyimg_tpu; lab2rgb eager (it counts out-of-gamut
    pixels on the host)."""
    dtype = np.float64
    jit_cases, pair_cases = JIT_CASES, PAIR_CASES
    rng = np.random.default_rng(12)
    rgb = rng.random((9, 11, 3)).astype(dtype)
    rgb[0, :3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5]]  # grey and black
    lab2 = np.asarray(tc.rgb2lab(T(rng.random((9, 11, 3)))))

    @jax.jit
    def ref(x, y):
        outs = [f(x, *args) for _, _, f, args in jit_cases]
        lab = jc.rgb2lab(x)
        return outs + [f(lab, y) for _, _, f in pair_cases]

    want = ref(jnp.asarray(rgb), jnp.asarray(lab2))
    x = T(rgb)
    got = [f(x, *args) for _, f, _, args in jit_cases]
    lab = tc.rgb2lab(x)
    got += [f(lab, T(lab2)) for _, f, _ in pair_cases]
    names = [c[0] for c in jit_cases] + [c[0] for c in pair_cases]
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert H(g).dtype == w.dtype, name
        lab_like = name.startswith(("rgb2lab", "rgb2luv", "luv2", "deltaE"))
        close(g, w, 1e-11 if lab_like else 1e-12)
    labs = np.asarray(jc.rgb2lab(jnp.asarray(rgb)))
    close(tc.lab2rgb(T(labs)), np.asarray(jc.lab2rgb(jnp.asarray(labs))),
          1e-12)


def _np_rgb2lab(rgb):
    """sRGB -> XYZ -> Lab (D65, 2 degrees) in float64 numpy."""
    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                   rgb / 12.92)
    xyz = lin @ tcc.xyz_from_rgb.T / [0.95047, 1.0, 1.08883]
    f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16 / 116)
    return np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                     200 * (f[..., 1] - f[..., 2])], -1)


def test_float32_conversions_match_float64_numpy():
    """The chip path's conversions of float32 images keep float32 (the
    stains and differences: float64, as skimage) and agree with float64
    numpy: Lab within 2e-5 of max|Lab| (116 * cbrt of a float32), the
    rest within 1e-6."""
    rgb = _img_rgb().astype(np.float32) / 255
    rgb64 = rgb.astype(np.float64)
    lab = tc.rgb2lab(T(rgb))
    assert lab.dtype == torch.float32
    close(lab, _np_rgb2lab(rgb64), 2e-5)
    hsv = tc.rgb2hsv(T(rgb))
    assert hsv.dtype == torch.float32
    gt = np.array([colorsys.rgb_to_hsv(*p) for p in rgb64.reshape(-1, 3)])
    close(hsv.reshape(-1, 3), gt, 1e-6)
    close(tc.hsv2rgb(hsv), rgb64, 1e-6)
    close(tc.lab2rgb(lab), rgb64, 2e-5)
    close(tc.rgb2gray(T(rgb)), rgb64 @ [0.2125, 0.7154, 0.0721], 1e-6)
    stains = tc.separate_stains(T(rgb), tcc.hed_from_rgb)
    assert stains.dtype == torch.float64
    od = np.log(np.maximum(rgb64, 1e-6)) / np.log(1e-6)
    close(stains, od @ tcc.hed_from_rgb.astype(np.float32), 1e-6)
    d = tc.deltaE_ciede2000(lab, lab.flip(0))
    assert d.dtype == torch.float64
    close(d, H(tc.deltaE_ciede2000(T(_np_rgb2lab(rgb64)), T(_np_rgb2lab(
        rgb64[::-1])))), 1e-3)


MODULES = ["skimage.color", "skimage.color.colorconv",
           "skimage.color.rgb_colors", "skimage.color.colorlabel",
           "skimage.color.delta_e", "skimage.color.adapt_rgb"]


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_cupyimg_tpu(name):
    jmod = importlib.import_module("cupyimg_tpu." + name)
    tmod = importlib.import_module("cupyimg_tpu_torch." + name)

    def public(mod):
        if hasattr(mod, "__all__"):
            return set(mod.__all__)
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    own = {"annotations", "np", "jnp", "jax", "lax", "linalg", "warn",
           "functools", "itertools", "warnings", "torch"}
    assert (public(jmod) - own) - public(tmod) == set()
    if name == "skimage.color.rgb_colors":
        assert tc.color_dict == jc.color_dict
    if name == "skimage.color.colorconv":
        for k in public(jmod):
            v = getattr(jmod, k)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(tcc, k), v)
        assert tcc.illuminants == importlib.import_module(
            "cupyimg_tpu." + name).illuminants
