"""Thresholding (skimage.filters.thresholding) on torch tensors.

The global methods reduce the image's histogram (``exposure.histogram``)
to one threshold: the cumulative criteria (otsu, yen, isodata) on the
device, the iterative and combinatorial ones (li's loop, minimum's
smoothing, triangle, multi-otsu's dynamic program) on the host, as
skimage's.  The local methods (niblack, sauvola, ``threshold_local``)
compute in float64: plain torch on the card.  Hysteresis labels the low
mask and keeps the components that hold a high pixel.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from cupyimg_tpu_torch.core import util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage._shared.utils import _host, warn
from cupyimg_tpu_torch.skimage.exposure.exposure import histogram

__all__ = [
    "try_all_threshold",
    "threshold_otsu",
    "threshold_yen",
    "threshold_isodata",
    "threshold_li",
    "threshold_local",
    "threshold_minimum",
    "threshold_mean",
    "threshold_niblack",
    "threshold_sauvola",
    "threshold_triangle",
    "threshold_multiotsu",
    "apply_hysteresis_threshold",
]

_F64 = torch.float64


def _validate_image_histogram(image, hist, nbins):
    """(float64 counts, bin centres) of ``hist`` (counts, or counts and
    centres) or of the image's ``nbins``-bin histogram."""
    if image is None and hist is None:
        raise Exception("Either image or hist must be provided.")
    if hist is not None:
        if isinstance(hist, (tuple, list)):
            counts, bin_centers = hist
            counts = util.as_tensor(counts)
            bin_centers = util.as_tensor(bin_centers, device=counts.device)
        else:
            counts = util.as_tensor(hist)
            bin_centers = torch.arange(len(counts), device=counts.device)
        return counts.to(_F64), bin_centers
    counts, bin_centers = histogram(util.as_tensor(image).reshape(-1), nbins,
                                    source_range="image")
    return counts.to(_F64), bin_centers


def _reverse_cumsum(x):
    return torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))


def threshold_otsu(image=None, nbins=256, *, hist=None):
    """Otsu's threshold: the bin centre that maximises the between-class
    variance (a 0-d tensor)."""
    counts, bin_centers = _validate_image_histogram(image, hist, nbins)
    if bin_centers.shape[0] == 1:  # a single-valued image: that value
        return bin_centers[0]
    counts = counts / torch.sum(counts)
    weight1 = torch.cumsum(counts, 0)
    weight2 = _reverse_cumsum(counts)
    csum = torch.cumsum(counts * bin_centers, 0)
    mean1 = csum / torch.where(weight1 == 0, 1, weight1)
    # the mean of bins [i:] counts bin i, as weight2 does
    csum_excl = csum - counts * bin_centers
    mean2 = (csum[-1] - csum_excl) / torch.where(weight2 == 0, 1, weight2)
    variance12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    return bin_centers[torch.argmax(variance12)]


def threshold_yen(image=None, nbins=256, *, hist=None):
    """Yen's threshold (the maximum correlation criterion)."""
    counts, bin_centers = _validate_image_histogram(image, hist, nbins)
    if bin_centers.shape[0] == 1:
        return bin_centers[0]
    pmf = counts / torch.sum(counts)
    P1 = torch.cumsum(pmf, 0)
    P1_sq = torch.cumsum(pmf ** 2, 0)
    P2_sq = _reverse_cumsum(pmf ** 2)
    eps = np.finfo(np.float64).eps
    crit = torch.log(((P1_sq[:-1] * P2_sq[1:]) ** -1 + eps)
                     * (P1[:-1] * (1.0 - P1[:-1])) ** 2 + eps)
    return bin_centers[torch.argmax(crit)]


def threshold_isodata(image=None, nbins=256, return_all=False, *, hist=None):
    """Ridler-Calvard (ISODATA) threshold: the bin centres midway between
    the means of the classes they split (the first, or all of them)."""
    counts, bin_centers = _validate_image_histogram(image, hist, nbins)
    if bin_centers.shape[0] == 1:
        return bin_centers if return_all else bin_centers[0]
    csuml = torch.cumsum(counts, 0)
    csumh = csuml[-1] - csuml
    csum_intensity = torch.cumsum(counts * bin_centers, 0)
    lower = csum_intensity[:-1] / torch.where(csuml[:-1] == 0, 1,
                                              csuml[:-1])
    higher = (csum_intensity[-1] - csum_intensity[:-1]) / torch.where(
        csumh[:-1] == 0, 1, csumh[:-1])
    all_mean = (lower + higher) / 2.0
    bin_width = bin_centers[1] - bin_centers[0]
    distances = all_mean - bin_centers[:-1]
    thresholds_mask = (distances >= 0) & (distances < bin_width)
    thresh_np = _host(bin_centers[:-1])[_host(thresholds_mask)]
    if return_all:
        return util.as_tensor(thresh_np, device=bin_centers.device)
    return thresh_np[0]


def threshold_li(image, *, tolerance=None, initial_guess=None,
                 iter_callback=None):
    """Li's minimum cross-entropy threshold, iterated on the host (one
    read back of the class means an iteration).  NaN is ignored; an image
    of one value thresholds at it, one of only +-inf at 0."""
    image = util.as_tensor(image).reshape(-1)
    if image.is_floating_point():
        image = image[~torch.isnan(image)]
    if image.numel() == 0:
        return float("nan")
    val0 = image[0]
    if bool(torch.all(image == val0)):
        return float(val0)
    if image.is_floating_point():
        finite = image[torch.isfinite(image)]
        if finite.numel() == 0:
            # only +inf and -inf remain: any finite value separates them
            return 0.0
        image = finite
    imin = float(image.min())
    image = image.to(_F64) - imin  # positive values
    if tolerance is None:
        # half the smallest difference between distinct intensities
        tolerance = float(torch.min(torch.diff(torch.unique(image)))) / 2
    if initial_guess is None:
        t_next = float(image.mean())
    elif callable(initial_guess):
        t_next = float(initial_guess(image)) - imin
    else:
        t_next = float(initial_guess) - imin
        if not 0 < t_next < float(image.max()):
            raise ValueError("The initial guess for threshold_li must be "
                             "within the range of the image.")
    t_curr = -2 * tolerance
    if iter_callback is not None:
        iter_callback(t_next + imin)
    eps = np.finfo(np.float64).eps
    while abs(t_next - t_curr) > tolerance:
        t_curr = t_next
        foreground = image > t_curr
        fore = foreground.to(_F64)
        mean_fore = float(torch.mean(torch.where(foreground, image, 0.0))) / (
            max(float(torch.mean(fore)), eps))
        mean_back = float(torch.mean(torch.where(~foreground, image, 0.0))) / (
            max(float(torch.mean(1.0 - fore)), eps))
        if mean_back == 0:
            mean_back = eps
        t_next = (mean_back - mean_fore) / (
            math.log(mean_back + eps) - math.log(mean_fore + eps))
        if iter_callback is not None:
            iter_callback(t_next + imin)
    return t_next + imin


def threshold_minimum(image=None, nbins=256, max_iter=10000, *, hist=None):
    """The minimum method: the histogram smoothed (a 3-bin mean with
    reflected ends) until it has two maxima, thresholded at the valley
    between them (host numpy)."""
    counts, bin_centers = _validate_image_histogram(image, hist, nbins)
    counts_np = _host(counts).astype(np.float64)

    def find_local_maxima_idx(h):
        maximums = []
        direction = 1
        for i in range(h.shape[0] - 1):
            if direction > 0:
                if h[i + 1] < h[i]:
                    direction = -1
                    maximums.append(i)
            else:
                if h[i + 1] > h[i]:
                    direction = 1
        return maximums

    smooth_hist = counts_np
    for counter in range(max_iter):
        padded = np.concatenate(([smooth_hist[0]], smooth_hist,
                                 [smooth_hist[-1]]))
        smooth_hist = np.convolve(padded, np.ones(3) / 3.0, mode="valid")
        maximum_idxs = find_local_maxima_idx(smooth_hist)
        if len(maximum_idxs) < 3:
            break
    if len(maximum_idxs) != 2:
        raise RuntimeError("Unable to find two maxima in histogram")
    if counter == max_iter - 1:
        raise RuntimeError("Maximum iteration reached for histogram "
                           "smoothing")
    threshold_idx = np.argmin(
        smooth_hist[maximum_idxs[0]: maximum_idxs[1] + 1]) + maximum_idxs[0]
    return _host(bin_centers)[threshold_idx]


def threshold_mean(image):
    """The mean intensity (integer images in float64)."""
    image = util.as_tensor(image)
    if not (image.is_floating_point() or image.is_complex()):
        image = image.to(_F64)
    return torch.mean(image)


def threshold_triangle(image, nbins=256):
    """The triangle algorithm (Zack 1977), on the host histogram."""
    counts, bin_centers = _validate_image_histogram(image, None, nbins)
    counts = _host(counts).astype(np.float64)
    nbins = len(counts)
    arg_peak_height = int(np.argmax(counts))
    peak_height = counts[arg_peak_height]
    nz = np.flatnonzero(counts)
    arg_low_level, arg_high_level = nz[0], nz[-1]
    flip = arg_peak_height - arg_low_level < arg_high_level - arg_peak_height
    if flip:
        counts = counts[::-1]
        arg_low_level = nbins - arg_high_level - 1
        arg_peak_height = nbins - arg_peak_height - 1
    del arg_high_level
    width = arg_peak_height - arg_low_level
    x1 = np.arange(width)
    y1 = counts[x1 + arg_low_level]
    norm = np.sqrt(peak_height ** 2 + width ** 2)
    length = peak_height / norm * x1 - width / norm * y1
    arg_level = int(np.argmax(length)) + arg_low_level
    if flip:
        arg_level = nbins - arg_level - 1
    return _host(bin_centers)[arg_level]


def threshold_multiotsu(image, classes=3, nbins=256):
    """Multi-Otsu thresholds for any number of classes: the maximal
    between-class criterion sum_k m_k^2 / w_k by dynamic programming over
    (class, last bin) on the host histogram, O(classes * nbins^2).
    Returns a float64 tensor on the image's device."""
    image = util.as_tensor(image)
    counts, bin_centers = _validate_image_histogram(image, None, nbins)
    prob = _host(counts / torch.sum(counts)).astype(np.float64)
    centers = _host(bin_centers).astype(np.float64)
    nb = len(prob)
    if int(np.count_nonzero(prob)) < classes:
        raise ValueError(
            f"The input image has less unique values "
            f"({int(np.count_nonzero(prob))}) than the desired number of "
            f"classes ({classes})")
    P = np.concatenate([[0.0], np.cumsum(prob)])
    M = np.concatenate([[0.0], np.cumsum(prob * centers)])

    def seg(i, j):
        """The criterion of the class of bins [i, j]."""
        w = P[j + 1] - P[i]
        if w <= 0:
            return 0.0
        m = M[j + 1] - M[i]
        return m * m / w

    # dp[j]: the best score of bins [0..j] in c classes; cut[j]: the last
    # class's first bin at that optimum
    dp = np.array([seg(0, j) for j in range(nb)])
    cuts = []
    for c in range(2, classes + 1):
        ndp = np.full(nb, -np.inf)
        cut = np.zeros(nb, dtype=int)
        for j in range(c - 1, nb):
            best, bi = -np.inf, c - 1
            for i in range(c - 1, j + 1):
                v = dp[i - 1] + seg(i, j)
                if v > best:
                    best, bi = v, i
            ndp[j] = best
            cut[j] = bi
        dp = ndp
        cuts.append(cut)
    # the thresholds are the last bins of every class but the last
    j = nb - 1
    idx = []
    for cut in reversed(cuts):
        i = cut[j]
        idx.append(i - 1)
        j = i - 1
    return util.as_tensor(centers[np.asarray(sorted(idx))],
                          device=image.device)


def threshold_niblack(image, window_size=15, k=0.2):
    """Niblack's local threshold: the local mean less ``k`` local
    standard deviations (float64)."""
    m, s = _mean_std(image, window_size)
    return m - k * s


def threshold_sauvola(image, window_size=15, k=0.2, r=None):
    """Sauvola's local threshold (float64); ``r`` defaults to half the
    image's range."""
    image = util.as_tensor(image)
    if r is None:
        r = 0.5 * (float(image.max()) - float(image.min()))
    m, s = _mean_std(image, window_size)
    return m * (1 + k * ((s / r) - 1))


def _mean_std(image, w):
    """The local mean and standard deviation over a ``w`` window, by two
    float64 uniform filters in mirror mode."""
    image = util.as_tensor(image).to(_F64)
    if np.isscalar(w):
        w = (int(w),) * image.ndim
    if any(wi < 3 or wi % 2 == 0 for wi in w):
        warn("All window sizes should be odd and >= 3")
    m = ndi.uniform_filter(image, size=list(w), mode="mirror")
    m2 = ndi.uniform_filter(image * image, size=list(w), mode="mirror")
    var = torch.clamp(m2 - m * m, min=0)
    return m, torch.sqrt(var)


def threshold_local(image, block_size, method="gaussian", offset=0,
                    mode="reflect", param=None, cval=0):
    """Adaptive threshold surface (float64): the gaussian (sigma ``param``
    or (block - 1) / 6), mean or median of each ``block_size`` window, or
    with 'generic' ``param``'s reduction of it (a function of torch
    tensors, mapped over the windows by ``ndi.generic_filter``), less
    ``offset``."""
    image = util.as_tensor(image).to(_F64)
    if np.isscalar(block_size):
        block_size = (int(block_size),) * image.ndim
    if any(b % 2 == 0 for b in block_size):
        raise ValueError("block_size must be odd! Given block_size "
                         f"{block_size} contains even values.")
    if method == "generic":
        if not callable(param):
            raise ValueError("Method 'generic' requires a callable 'param'")
        thresh = ndi.generic_filter(image, param, size=tuple(block_size),
                                    mode=mode, cval=cval)
        return thresh - offset
    if method == "gaussian":
        sigma = ([(b - 1) / 6.0 for b in block_size] if param is None
                 else param)
        thresh = ndi.gaussian_filter(image, sigma, mode=mode, cval=cval)
    elif method == "mean":
        thresh = ndi.uniform_filter(image, size=list(block_size), mode=mode,
                                    cval=cval)
    elif method == "median":
        thresh = ndi.median_filter(image, size=tuple(block_size), mode=mode,
                                   cval=cval)
    else:
        raise ValueError("Invalid method specified. Please use `generic`, "
                         "`gaussian`, `mean`, or `median`.")
    return thresh - offset


def apply_hysteresis_threshold(image, low, high):
    """Hysteresis thresholding: the components of ``image > low`` that
    hold a pixel of ``image > high``.  One read back: the component
    count."""
    image = util.as_tensor(image)
    high = util.as_tensor(high, device=image.device)
    low = torch.minimum(util.as_tensor(low, device=image.device), high)
    mask_low = image > low
    mask_high = image > high
    labels_low, num_labels = ndi.label(mask_low)
    labels_low = labels_low.long()
    # the components holding a high pixel
    sums = torch.bincount(labels_low[mask_high], minlength=int(num_labels) + 1)
    connected = sums > 0
    connected[0] = False
    return connected[labels_low]


def try_all_threshold(image, figsize=(8, 5), verbose=True):
    """Every global threshold method applied and drawn with matplotlib
    (imported here; the Agg backend unless one is set); returns
    ``(fig, ax)``."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    image = util.as_tensor(image)
    methods = OrderedDict({
        "Isodata": threshold_isodata,
        "Li": threshold_li,
        "Mean": threshold_mean,
        "Minimum": threshold_minimum,
        "Otsu": threshold_otsu,
        "Triangle": threshold_triangle,
        "Yen": threshold_yen,
    })
    num_rows = math.ceil((len(methods) + 1) / 2)
    fig, ax = plt.subplots(num_rows, 2, figsize=figsize, sharex=True,
                           sharey=True)
    ax = ax.ravel()
    ax[0].imshow(_host(image), cmap=plt.cm.gray)
    ax[0].set_title("Original")
    i = 1
    for name, func in methods.items():
        ax[i].set_title(name)
        try:
            t = func(image)
            ax[i].imshow(_host(image > util.as_tensor(t,
                                                      device=image.device)),
                         cmap=plt.cm.gray)
        except Exception as e:
            ax[i].text(0.5, 0.5, f"{type(e).__name__}", ha="center",
                       va="center", transform=ax[i].transAxes)
            if verbose:
                print(f"{name} failed: {e}")
        ax[i].set_axis_off()
        i += 1
    ax[0].set_axis_off()
    for a in ax[i:]:
        a.set_axis_off()
    return fig, ax
