"""Boundary modes of the torch port against cupyimg_tpu (JAX on the CPU).

Index maps and pads are integer/gather operations: every comparison is
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cupyimg_tpu.core import boundary as jb
from cupyimg_tpu_torch.core import boundary as tb

MODES = sorted(jb.BOUNDARY_MODES)


def test_mode_sets_match():
    assert tb.BOUNDARY_MODES == jb.BOUNDARY_MODES
    for m in MODES:
        assert tb.ndimage_mode_to_pad_mode(m) == jb.ndimage_mode_to_pad_mode(m)


def test_check_mode_error_text():
    with pytest.raises(RuntimeError) as jerr:
        jb.check_mode("bogus")
    with pytest.raises(RuntimeError) as terr:
        tb.check_mode("bogus")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("mode", MODES)
def test_map_indices(mode, n):
    idx = np.arange(-13, 18)
    jm, joob = jb.map_indices(jnp.asarray(idx), n, mode)
    tm, toob = tb.map_indices(torch.from_numpy(idx), n, mode)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (toob is None) == (joob is None)
    if joob is not None:
        np.testing.assert_array_equal(toob.numpy(), np.asarray(joob))
    nm, noob = tb.map_indices_np(idx, n, mode)
    jnm, jnoob = jb.map_indices_np(idx, n, mode)
    np.testing.assert_array_equal(nm, jnm)
    np.testing.assert_array_equal(noob, jnoob)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape, pad_width",
    [
        ((3, 5), ((4, 7), (6, 2))),  # wider than the axis
        ((1, 4), ((3, 2), (0, 9))),  # n == 1
        ((6, 7), ((2, 1), (3, 3))),  # narrower than the axis
    ],
)
def test_pad(mode, shape, pad_width):
    x = np.random.RandomState(0).rand(*shape)
    exp = np.asarray(jb.pad(jnp.asarray(x), pad_width, mode, cval=-1.5))
    got = tb.pad(torch.from_numpy(x), pad_width, mode, cval=-1.5)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_pad_integer_input():
    x = np.arange(12, dtype=np.int16).reshape(3, 4)
    for mode in MODES:
        exp = np.asarray(jb.pad(jnp.asarray(x), ((2, 5), (1, 6)), mode, 7))
        got = tb.pad(torch.from_numpy(x), ((2, 5), (1, 6)), mode, 7)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), exp)


def test_pad_per_axis_modes():
    """One combined extension with a mode per axis, as the fused kernel
    extends its input: axis by axis, each with its own mode."""
    x = np.random.RandomState(1).rand(4, 3, 5)
    pads = ((2, 3), (4, 4), (1, 6))
    modes = ("constant", "mirror", "wrap")
    exp = jnp.asarray(x)
    for ax, (pw, m) in enumerate(zip(pads, modes)):
        one = [(0, 0)] * 3
        one[ax] = pw
        exp = jb.pad(exp, one, m, cval=0.25)
    got = tb.pad(torch.from_numpy(x), pads, modes, cval=0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
