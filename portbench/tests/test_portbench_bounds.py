"""Each bounds file against a count by hand for one call."""

import math

import pytest
import torch
from conftest import CHECKOUT

from portbench.harness import load_file

BYTES, FP32, MINMAX = 3.35e12, 67e12, 33.5e12
N3 = 256 ** 3
N2 = 4096 ** 2


def bound(name, fn, shape, args, operands=None):
    mod = load_file(CHECKOUT / "portbench" / "bounds" / f"{name}.py",
                    f"test_bounds_{name}")
    return mod.bound_s(fn, shape, 4, args, operands or {})


def test_uniform_filter_bytes_bound():
    # one read and one write of a 64 MiB volume; 2 x 5 taps x 3 axes of
    # work a sample is far below it
    assert bound("separable", "uniform_filter", (256,) * 3,
                 {"size": 5}) == pytest.approx(2 * 4 * N3 / BYTES)


def test_uniform_filter_work_bound():
    # 61 taps on each of 3 axes: 366 flops a sample outweigh 8 bytes
    assert bound("separable", "uniform_filter", (100,) * 3,
                 {"size": 61}) == pytest.approx(366 * 1e6 / FP32)


def test_edge_enhance_counts_the_whole_pipeline():
    from portbench.bounds import separable

    # 3-D: gaussian 13 taps x 3 axes x 2 = 78; three sobels of 3 taps on
    # 3 axes x 2 = 54; elementwise: 3 squares, 2 adds, sqrt, 5 mix = 11
    assert separable.work("edge_enhance_pipeline", 3,
                          {"sigma": 1.5, "amount": 0.7}) == (143.0, 0.0)
    # 2-D: 52 + 24 + (2 + 1 + 6)
    assert separable.work("edge_enhance_pipeline", 2,
                          {"sigma": 1.5}) == (85.0, 0.0)
    assert bound("separable", "edge_enhance_pipeline", (256,) * 3,
                 {"sigma": 1.5}) == pytest.approx(2 * 4 * N3 / BYTES)
    # sigma 20: 161 taps an axis, work-bound
    flops = 2 * 161 * 3 + 54 + 11
    assert bound("separable", "edge_enhance_pipeline", (64,) * 3,
                 {"sigma": 20}) == pytest.approx(flops * 64 ** 3 / FP32)


def test_grey_opening_minmax_count():
    from portbench.bounds import separable

    assert separable.work("grey_opening", 3, {"size": 5}) == (0.0, 24.0)
    # size 41 on 2-D: 2 stages x 2 axes x 40 = 160 min/max a sample
    assert bound("separable", "grey_opening", (4096, 4096),
                 {"size": 41}) == pytest.approx(160 * N2 / MINMAX)


def test_gather_bound_counts_taps_not_weights():
    assert bound("gather", "affine_transform", (256,) * 3,
                 {"order": 1}) == pytest.approx(2 * 4 * N3 / BYTES)
    # order 5 in 3-D: 216 taps, 432 flops a sample
    assert bound("gather", "affine_transform", (256,) * 3,
                 {"order": 5}) == pytest.approx(432 * N3 / FP32)
    # an output of another shape: its samples are written and tapped
    b = bound("gather", "affine_transform", (200, 200),
              {"order": 1, "output_shape": [100, 50]})
    assert b == pytest.approx(4 * (40000 + 5000) / BYTES)


def test_fft_bound_three_real_transforms_at_the_full_shape():
    k = torch.zeros((31, 31))
    n = 4096 + 31 - 1
    # real operands: 2.5 N log2 n an axis, half a complex transform
    flops = 3 * 2 * 2.5 * n * n * math.log2(n)
    assert bound("fft", "fftconvolve", (4096, 4096),
                 {"in2": "@k", "mode": "same"}, {"@k": k}) == \
        pytest.approx(flops / FP32)
    # a short 1-D signal is bytes-bound: in, kernel, full output
    k = torch.zeros(3)
    assert bound("fft", "fftconvolve", (1000,),
                 {"in2": "@k", "mode": "full"}, {"@k": k}) == \
        pytest.approx(4 * (1000 + 3 + 1002) / BYTES)


def test_fft_bound_refuses_complex_operands():
    k = torch.zeros((3, 3), dtype=torch.complex64)
    with pytest.raises(KeyError):
        bound("fft", "fftconvolve", (64, 64), {"in2": "@k"}, {"@k": k})
