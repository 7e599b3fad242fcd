"""The one traffic generator: a cell's inputs, made from ``--seed``.

A configuration (``configs/<name>.json``) gives the items' ``shape``,
``dtype`` and the ``pool`` of distinct inputs; a mix
(``traffic/<name>.json``) gives the calls an item runs, their arguments,
the operands made once at set-up (``operands``: ``shape``; an argument
``"@<name>"`` names one) and the per-item arguments drawn from the seed
(``draws``: a table of ``table`` draws of a ``kind`` below, item ``i``
taking entry ``i mod table``).  The pool and the operands are uniform in
[0, 1), made on the device by one ``torch.Generator`` in one call each;
the draws on the host by ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


def _rotation(angles):
    """The rotation by ``angles`` (radians) about each axis of a 3-D
    volume in turn, or by ``angles[0]`` in the plane of a 2-D image."""
    if len(angles) == 1:
        c, s = math.cos(angles[0]), math.sin(angles[0])
        return np.array([[c, -s], [s, c]])
    out = np.eye(3)
    for axis, a in enumerate(angles):
        c, s = math.cos(a), math.sin(a)
        i, j = [k for k in range(3) if k != axis]
        r = np.eye(3)
        r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
        out = r @ out
    return out


def draw_rigid(rng, shape, max_deg, max_shift):
    """A rigid transform of ``affine_transform``'s convention (output o
    reads input matrix @ o + offset): a rotation by angles uniform in
    +-``max_deg`` about every axis (one in 2-D), and an offset that maps
    the centre to within +-``max_shift`` samples of itself on each
    axis."""
    nd = len(shape)
    angles = np.deg2rad(rng.uniform(-max_deg, max_deg, 3 if nd == 3 else 1))
    matrix = _rotation(angles)
    centre = (np.asarray(shape, dtype=np.float64) - 1.0) / 2.0
    offset = centre - matrix @ centre + rng.uniform(-max_shift, max_shift, nd)
    return {"matrix": matrix, "offset": offset}


DRAWS = {"rigid": draw_rigid}


@dataclass
class Inputs:
    """What one seed gives a cell."""

    pool: list
    operands: dict = field(default_factory=dict)
    table: list = field(default_factory=lambda: [{}])
    input_bytes: int = 0

    def item(self, i):
        """(input, per-item arguments) of item ``i``."""
        return self.pool[i % len(self.pool)], self.table[i % len(self.table)]


def make(config, mix, seed, device, dtype=None):
    """The pool, operands and draws of ``seed``.  ``dtype`` overrides the
    configuration's (the control's lower precision: the same values,
    rounded)."""
    shape = tuple(config["shape"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    block = torch.rand((config["pool"],) + shape, generator=gen,
                       device=device, dtype=getattr(torch, config["dtype"]))
    if dtype is not None:
        block = block.to(dtype)
    operands = {}
    for name, op in sorted(mix.get("operands", {}).items()):
        operands["@" + name] = torch.rand(
            tuple(op["shape"]), generator=gen, device=device,
            dtype=getattr(torch, config["dtype"]))
    table = [{}]
    draw = mix.get("draws")
    if draw:
        rng = np.random.default_rng(int(seed))
        params = {k: v for k, v in draw.items() if k not in ("kind", "table")}
        table = [DRAWS[draw["kind"]](rng, shape, **params)
                 for _ in range(draw["table"])]
    nbytes = block.numel() * block.element_size() + sum(
        t.numel() * t.element_size() for t in operands.values())
    return Inputs(list(block.unbind(0)), operands, table, nbytes)
