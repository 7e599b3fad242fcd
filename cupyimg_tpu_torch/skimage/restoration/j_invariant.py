"""J-invariant denoiser calibration (skimage.restoration.j_invariant,
Noise2Self) on torch tensors.

The denoiser is any callable of torch tensors.  ``_interpolate_image``
averages each pixel's axis neighbours by one ``ndi.convolve`` in mirror
mode (float64 images: plain torch on the card).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

from cupyimg_tpu_torch.core import dtypes, util
from cupyimg_tpu_torch.scipy import ndimage as ndi
from cupyimg_tpu_torch.skimage.metrics import mean_squared_error
from cupyimg_tpu_torch.skimage.util import img_as_float

__all__ = ["calibrate_denoiser"]


def _interpolate_image(image, *, multichannel=False):
    """Each pixel replaced by the mean of its axis neighbours."""
    spatialdims = image.ndim if not multichannel else image.ndim - 1
    conv_filter = ndi.generate_binary_structure(spatialdims, 1).astype(
        dtypes.to_numpy(image.dtype))
    conv_filter.ravel()[conv_filter.size // 2] = 0
    conv_filter /= conv_filter.sum()
    if multichannel:
        conv_filter = conv_filter[..., np.newaxis]
    return ndi.convolve(image, conv_filter, mode="mirror")


def _generate_grid_slice(shape, *, offset, stride=3):
    """Slices of a grid of points ``stride`` apart, at phase ``offset``."""
    phases = np.unravel_index(offset, (stride,) * len(shape))
    return tuple(slice(int(p), None, stride) for p in phases)


def _invariant_denoise(image, denoise_function, *, stride=4, masks=None,
                       denoiser_kwargs=None):
    """The J-invariant version of ``denoise_function``: each grid of
    pixels denoised from an image where it is replaced by its neighbours'
    mean."""
    image = img_as_float(util.as_tensor(image))
    if denoiser_kwargs is None:
        denoiser_kwargs = {}
    multichannel = denoiser_kwargs.get("multichannel", False)
    interp = _interpolate_image(image, multichannel=multichannel)
    output = image.new_zeros(image.shape)
    if masks is None:
        spatialdims = image.ndim if not multichannel else image.ndim - 1
        n_masks = stride ** spatialdims
        masks = (_generate_grid_slice(image.shape[:spatialdims], offset=idx,
                                      stride=stride)
                 for idx in range(n_masks))
    for mask in masks:
        input_image = image.clone()
        input_image[mask] = interp[mask]
        denoised = util.as_tensor(denoise_function(input_image,
                                                   **denoiser_kwargs),
                                  device=image.device)
        output[mask] = denoised[mask].to(output.dtype)
    return output


def _product_from_dict(dictionary):
    """The cartesian product of a dict of lists, as dicts."""
    keys = dictionary.keys()
    for element in itertools.product(*dictionary.values()):
        yield dict(zip(keys, element))


def calibrate_denoiser(image, denoise_function, denoise_parameters, *,
                       stride=4, approximate_loss=True, extra_output=False):
    """The J-invariant version of ``denoise_function`` at the parameters
    of ``denoise_parameters`` (a dict of lists) with the least
    self-supervised MSE; with ``extra_output`` also the parameters tried
    and their losses."""
    parameters_tested, losses = _calibrate_denoiser_search(
        image, denoise_function, denoise_parameters=denoise_parameters,
        stride=stride, approximate_loss=approximate_loss)
    best_parameters = parameters_tested[int(np.argmin(losses))]
    best_denoise_function = functools.partial(
        _invariant_denoise, denoise_function=denoise_function,
        stride=stride, denoiser_kwargs=best_parameters)
    if extra_output:
        return best_denoise_function, (parameters_tested, losses)
    return best_denoise_function


def _calibrate_denoiser_search(image, denoise_function, denoise_parameters,
                               *, stride=4, approximate_loss=True):
    """Every parameter set of the grid with its self-supervised loss (a
    host float)."""
    image = img_as_float(util.as_tensor(image))
    parameters_tested = list(_product_from_dict(denoise_parameters))
    losses = []
    for denoiser_kwargs in parameters_tested:
        multichannel = denoiser_kwargs.get("multichannel", False)
        if not approximate_loss:
            denoised = _invariant_denoise(image, denoise_function,
                                          stride=stride,
                                          denoiser_kwargs=denoiser_kwargs)
            loss = mean_squared_error(image, denoised)
        else:
            spatialdims = image.ndim if not multichannel else image.ndim - 1
            n_masks = stride ** spatialdims
            mask = _generate_grid_slice(image.shape[:spatialdims],
                                        offset=n_masks // 2, stride=stride)
            masked_denoised = _invariant_denoise(
                image, denoise_function, masks=[mask],
                denoiser_kwargs=denoiser_kwargs)
            loss = mean_squared_error(image[mask], masked_denoised[mask])
        losses.append(float(loss))
    return parameters_tested, losses
