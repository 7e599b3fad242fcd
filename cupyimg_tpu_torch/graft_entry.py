"""Entry points: the single-device step and the multi-device dry run.

The counterpart of the JAX package's root ``__graft_entry__.py``:
``entry()`` gives the flagship pipeline and its input, and
``dryrun_multichip(n)`` runs the sharded pipeline and the other sharded
operators in a world of ``n`` ranks (``parallel.run_world``), on a
``("batch", "x")`` mesh of shape ``(2, n/2)`` (``(1, n)`` for odd ``n``)
and a flat ``("x",)`` mesh, at the JAX dry run's sizes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, example_args): the single-device edge-enhance pipeline and a
    128^3 float32 volume (``RandomState(0)``) on ``device`` (default:
    ``config.device``)."""
    from cupyimg_tpu_torch.core.config import config
    from cupyimg_tpu_torch.models import edge_enhance_pipeline

    x = torch.from_numpy(
        np.random.RandomState(0).randn(128, 128, 128).astype(np.float32)
    ).to(device or config.device)
    return edge_enhance_pipeline, (x,)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_rank(world, n_devices):
    """One rank of the dry run (``run_world``'s ``fn``): every sharded call
    of the JAX dry run, each result's shape and finiteness checked.
    Returns the shapes and the label count."""
    from cupyimg_tpu_torch import parallel
    from cupyimg_tpu_torch.models import sharded_edge_enhance

    dev = world.device
    mesh_shape = (2, n_devices // 2) if n_devices % 2 == 0 else (
        1, n_devices)
    mesh = world.mesh(mesh_shape, ("batch", "x"))
    spec = ("batch", "x", None)
    batch, nx = 2 * mesh_shape[0], 16 * mesh_shape[1]
    x = parallel.distribute(torch.from_numpy(
        np.random.RandomState(0).randn(batch, nx, 24).astype(np.float32)
    ).to(dev), mesh, spec)

    out = {}
    y = sharded_edge_enhance(x, mesh, spec, sigma=1.0)
    _check(tuple(y.shape) == tuple(x.shape), "edge enhance shape")
    _check(not bool(torch.isnan(y.to_local()).any()), "edge enhance NaN")
    out["edge_enhance"] = tuple(y.shape)
    # the morphology/rank/FFT sharded paths
    out["minimum"] = tuple(parallel.sharded_minimum_filter(
        x, (1, 3, 3), mesh, spec).shape)
    out["median3"] = tuple(parallel.sharded_median_filter(
        x, (1, 3, 3), mesh, spec).shape)
    bspec = ("batch", None, None)
    xb = parallel.distribute(parallel.full_tensor(x), mesh, bspec)
    k = torch.ones((3, 3), dtype=x.dtype, device=dev) / 9.0
    out["fftconvolve"] = tuple(parallel.sharded_fftconvolve(
        xb, k, mesh, bspec).shape)
    # sharded interpolation (bounded-displacement warp over the mesh)
    out["shift"] = tuple(parallel.sharded_shift(
        x, (0.0, 1.3, -0.7), mesh, spec, order=1).shape)

    # distributed connected components on the flat mesh
    flat = world.mesh((n_devices,), ("x",))
    lspec = ("x", None)
    mask = np.random.RandomState(1).rand(8 * n_devices, 24) > 0.6
    labels, num = parallel.sharded_label(
        torch.from_numpy(mask).to(dev), flat, lspec)
    _check(tuple(labels.shape) == mask.shape and int(num) > 0, "label")
    out["label"] = (tuple(labels.shape), int(num))
    # transpose-based distributed FFT + spatially-sharded FFT convolution
    img = torch.from_numpy(np.random.RandomState(2).randn(
        8 * n_devices, 24).astype(np.float32)).to(dev)
    F = parallel.sharded_fft2(img, flat, lspec)
    _check(tuple(F.shape) == tuple(img.shape), "fft2 shape")
    out["fft2"] = tuple(F.shape)
    k2 = torch.ones((5, 3), dtype=torch.float32, device=dev) / 15.0
    c = parallel.sharded_fftconvolve2d_spatial(img, k2, flat, lspec,
                                               mode="same")
    _check(tuple(c.shape) == tuple(img.shape), "fftconvolve2d shape")
    out["fftconvolve2d"] = tuple(c.shape)
    # sharded rank/median beyond 3x3: a 5x5 window over the spatial axis
    out["median5"] = tuple(parallel.sharded_median_filter(
        x, (1, 5, 5), mesh, spec).shape)
    for name in ("minimum", "median3", "fftconvolve", "shift", "median5"):
        _check(out[name] == tuple(x.shape), f"{name} shape")
    return out


def dryrun_multichip(n_devices: int, device=None):
    """Run the sharded pipeline and operators on ``n_devices`` ranks of
    ``device`` (default ``config.device``; ``"cpu"`` for a gloo world on
    the host).  Returns rank 0's shapes and label count; raises if a rank
    fails."""
    from cupyimg_tpu_torch.parallel import run_world

    return run_world(dryrun_rank, n_devices, device, n_devices)
