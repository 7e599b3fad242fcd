"""The morphology slice of the torch port against cupyimg_tpu (JAX-CPU,
x64), on the same numpy inputs: a short list of named public calls and
the ten structuring elements.  Each test runs its cupyimg_tpu calls as
ONE jit program, so this file costs seven XLA compilations (run op by
op, every primitive compiles on its own: 80 here); the grids against
scipy are in ``test_torch_morphology.py``.  Exact, except the EDT's
float32 distances (1e-6 relative: the two packages' float32 min-plus
sums may round apart).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cupyimg_tpu.scipy.ndimage as jndi
import cupyimg_tpu.skimage.morphology as jskm
import cupyimg_tpu_torch.scipy.ndimage as ndi
import cupyimg_tpu_torch.skimage.morphology as skm

RNG = np.random.RandomState(11)
X = RNG.rand(24, 20).astype(np.float32)
B = RNG.rand(24, 20) > 0.4
MASK = RNG.rand(24, 20) > 0.2
E = RNG.rand(24, 20) > 0.1


def _jax(fn, x, **kwargs):
    """``fn(x, **kwargs)`` of cupyimg_tpu as one jit program: one XLA
    compilation per call here (run op by op, each primitive compiles on
    its own)."""
    return jax.jit(functools.partial(fn, **kwargs))(jnp.asarray(x))


def _both(name, x, **kwargs):
    """(port, cupyimg_tpu) results of ndimage function ``name``."""
    got = getattr(ndi, name)(torch.from_numpy(x), **kwargs)
    return got, _jax(getattr(jndi, name), x, **kwargs)


def _equal(got, exp):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    exp = [exp] if not isinstance(exp, tuple) else list(exp)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        e = np.asarray(e)
        assert g.numpy().dtype == e.dtype
        np.testing.assert_array_equal(g.numpy(), e)


CASES = {
    "grey_opening-size5": lambda: _both("grey_opening", X, size=5),
    "morphological_laplace-nearest": lambda: _both(
        "morphological_laplace", X, size=(3, 5), mode="nearest"),
    "binary_erosion-fixpoint-mask": lambda: _both(
        "binary_erosion", B, iterations=-1, mask=MASK),
    "binary_fill_holes": lambda: _both("binary_fill_holes", ~B),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_calls_match_cupyimg_tpu(name):
    _equal(*CASES[name]())


def test_distance_transforms_match_cupyimg_tpu():
    (jd, ji), jc = jax.jit(lambda e: (
        jndi.distance_transform_edt(e, sampling=(1.5, 0.7),
                                    return_indices=True),
        jndi.distance_transform_cdt(e, "taxicab"),
    ))(jnp.asarray(E))
    et = torch.from_numpy(E)
    d, i = ndi.distance_transform_edt(et, sampling=(1.5, 0.7),
                                      return_indices=True)
    assert d.dtype == torch.float32 and np.asarray(jd).dtype == np.float32
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
    _equal(i, ji)
    _equal(ndi.distance_transform_cdt(et, "taxicab"), jc)


def test_skimage_opening_square_and_binary_closing_disk_match():
    # the same numpy footprints to both (test_selems_match_cupyimg_tpu
    # holds the two packages' selems equal)
    square5, disk2 = skm.square(5), skm.disk(2)
    jo, jcl = jax.jit(lambda x, b: (
        jskm.opening(x, square5), jskm.binary_closing(b, disk2),
    ))(jnp.asarray(X), jnp.asarray(B))
    _equal(skm.opening(torch.from_numpy(X), square5), jo)
    _equal(skm.binary_closing(torch.from_numpy(B), disk2), jcl)


SELEMS = [
    ("square", (4,)),
    ("rectangle", (3, 5)),
    ("diamond", (3,)),
    ("disk", (4,)),
    ("ellipse", (5, 3)),
    ("cube", (3,)),
    ("octahedron", (2,)),
    ("ball", (3,)),
    ("octagon", (3, 2)),
    ("star", (4,)),
    ("star", (1,)),
]


def test_selems_match_cupyimg_tpu():
    exp = jax.jit(lambda: [getattr(jskm, name)(*args)
                           for name, args in SELEMS])()
    for (name, args), e in zip(SELEMS, exp):
        got = getattr(skm, name)(*args)
        e = np.asarray(e)
        assert isinstance(got, np.ndarray), name
        assert got.dtype == e.dtype == np.uint8, name
        np.testing.assert_array_equal(got, e, err_msg=name)
