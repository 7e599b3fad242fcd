"""Halo exchange and the sharded operators over a ``torch.distributed`` mesh.

The counterpart of ``cupyimg_tpu.parallel.halo`` in PyTorch's SPMD idiom:
every rank of a world (``_world.run_world``) calls the same function on
its own block of the array.

- An array is a ``DTensor`` on a ``DeviceMesh`` whose dimensions are named
  (``("batch", "x")``).  ``spec`` gives, for each array axis, the mesh
  dimension that shards it or ``None`` (the JAX ``PartitionSpec``'s
  entries as a tuple); a ``DTensor`` whose placements disagree with it
  raises ``ValueError``.  A plain tensor or array is taken as the whole
  array, the same on every rank, and each rank keeps its block.  A
  sharded axis must divide its mesh dimension.  Results are ``DTensor``s.
- A sharded axis needs ``lo``/``hi`` halo slabs from its neighbours to
  evaluate a stencil near a shard edge: :func:`halo_exchange` moves them
  with ``batch_isend_irecv``; the global edges take the ndimage boundary
  mode locally (valid while the halo fits in one shard); ``wrap`` and
  ``grid-wrap`` close the ring instead.  With 2-D tiles the axes are
  exchanged one after the other on the already extended slab, so the
  corners arrive too.
- The local compute is the port's single-device call on the extended
  slab, the halo cropped off after it, so on the card a sharded operator
  launches what its single-device counterpart launches on the slab: the
  separable filters one fused separable launch (the correlation is taken
  in the input's float type, ``dtype_mode="float"``), min/max one of its
  min/max op, the median one of the rank kernel, correlate/convolve one
  of the dense kernel, the interpolations the spline gather (and one
  prefilter launch per pole).
- Transport: where ``gloo`` carries CUDA tensors (ranks sharing a card),
  every exchange here stages its slabs through pinned host memory; with
  ``nccl`` they go from the card.  The route follows the process group's
  backend, which ``run_world`` picks from the world's layout.
  ``traffic`` counts the seconds and bytes of this process's exchanges.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from cupyimg_tpu_torch.core import boundary, dtypes, util

__all__ = [
    "halo_exchange",
    "sharded_correlate1d",
    "sharded_separable",
    "sharded_uniform_filter",
    "sharded_gaussian_filter",
    "sharded_min_max_filter",
    "sharded_minimum_filter",
    "sharded_maximum_filter",
    "sharded_median_filter",
    "sharded_fftconvolve",
    "sharded_label",
    "sharded_map_overlap",
    "sharded_correlate",
    "sharded_convolve",
    "sharded_binary_erosion",
    "sharded_binary_dilation",
    "sharded_shift",
    "sharded_map_coordinates",
    "sharded_affine_transform",
    "sharded_fft2",
    "sharded_fftconvolve2d_spatial",
    "distribute",
    "full_tensor",
    "traffic",
]


class Traffic:
    """Host wall seconds and bytes sent of this process's exchanges (the
    halo slabs, the FFT retiles, the label rounds' flags and roots, the
    gathers).  On the staged route the seconds include the copies to and
    from host memory, after the card has finished the work queued before
    them; with ``nccl`` they are the time to enqueue."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.seconds = 0.0
        self.bytes = 0


traffic = Traffic()

# ---------------------------------------------------------------------------
# meshes, specs and blocks
# ---------------------------------------------------------------------------


def _spec_axis_names(spec, ndim):
    """Per-array-axis mesh axis name (or None) from a spec."""
    names = list(spec) + [None] * (ndim - len(list(spec)))
    out = []
    for nm in names:
        if isinstance(nm, (tuple, list)):
            if len(nm) > 1:
                raise NotImplementedError(
                    "multiple mesh axes per array axis not supported"
                )
            nm = nm[0] if nm else None
        out.append(nm)
    return out


def _dim(mesh, name):
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"the mesh has no dimension {name!r} (it has "
                         f"{names})")
    return names.index(name)


def _group(mesh, name):
    return mesh.get_group(_dim(mesh, name))


def _dt():
    """``torch.distributed.tensor`` (imported at first use: it adds a
    second to the import of this module)."""
    import torch.distributed.tensor as dt

    return dt


def _placements(mesh, names):
    """The DTensor placements of an array sharded per ``names``."""
    Shard = _dt().Shard
    out = [_dt().Replicate()] * mesh.ndim
    for axis, nm in enumerate(names):
        if nm is None:
            continue
        d = _dim(mesh, nm)
        if isinstance(out[d], Shard):
            raise ValueError(f"mesh dimension {nm!r} shards two axes")
        out[d] = Shard(axis)
    return out


def _device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_divisible(shape, names, mesh):
    for j, nm in enumerate(names):
        if nm is None:
            continue
        nd = mesh.size(_dim(mesh, nm))
        if shape[j] % nd:
            raise ValueError(
                f"axis {j} ({shape[j]}) must divide mesh axis '{nm}' ({nd})"
            )


def _starts(local_shape, names, mesh):
    """The global index of this rank's block's first element, per axis."""
    return [0 if nm is None else
            mesh.get_local_rank(_dim(mesh, nm)) * local_shape[j]
            for j, nm in enumerate(names)]


def _local(x, mesh, spec):
    """(this rank's block of ``x``, the per-axis mesh dimension names,
    ``x``'s global shape)."""
    if isinstance(x, _dt().DTensor):
        names = _spec_axis_names(spec, x.ndim)
        want = _placements(mesh, names)
        if x.device_mesh != mesh or tuple(x.placements) != tuple(want):
            raise ValueError(
                f"the DTensor's placements {tuple(x.placements)} disagree "
                f"with spec {tuple(spec)} ({tuple(want)} on this mesh)")
        shape = tuple(x.shape)
        _check_divisible(shape, names, mesh)
        return x.to_local(), names, shape
    x = util.as_tensor(x, device=_device(mesh))
    names = _spec_axis_names(spec, x.ndim)
    _placements(mesh, names)
    shape = tuple(x.shape)
    _check_divisible(shape, names, mesh)
    nloc = [n if nm is None else n // mesh.size(_dim(mesh, nm))
            for n, nm in zip(shape, names)]
    block = tuple(slice(s, s + n) for s, n in
                  zip(_starts(nloc, names, mesh), nloc))
    return x[block].contiguous(), names, shape


def _dtensor(local, mesh, names, shape=None):
    """``local`` as this rank's block of a DTensor sharded per ``names``;
    ``shape`` defaults to the blocks' union (every block alike)."""
    if shape is None:
        shape = [n if nm is None else n * mesh.size(_dim(mesh, nm))
                 for n, nm in zip(local.shape, names)]
    stride = [1] * len(shape)
    for j in range(len(shape) - 2, -1, -1):
        stride[j] = stride[j + 1] * max(int(shape[j + 1]), 1)
    return _dt().DTensor.from_local(local.contiguous(), mesh,
                              _placements(mesh, names), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def distribute(x, mesh, spec):
    """``x`` as a DTensor sharded per ``spec``: a DTensor is checked
    against ``spec``; anything else is the whole array, the same on every
    rank, and each rank keeps its block (no communication)."""
    xs, names, shape = _local(x, mesh, spec)
    return _dtensor(xs, mesh, names, shape)


def _ndim(x):
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


def _weights(w):
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _staged(group, device):
    """Stage through host memory: a CUDA tensor over gloo."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _wire(t):
    """``t`` as the transport carries it: bool as uint8, complex as its
    real view."""
    if t.dtype == torch.bool:
        return t.contiguous().view(torch.uint8)
    if t.is_complex():
        return torch.view_as_real(t.contiguous())
    return t.contiguous()


def _wire_empty(shape, dtype, device, pinned):
    if dtype == torch.bool:
        shape, dtype = tuple(shape), torch.uint8
    elif dtype.is_complex:
        shape, dtype = tuple(shape) + (2,), dtype.to_real()
    return torch.empty(shape, dtype=dtype, device=device, pin_memory=pinned)


def _unwire(t, dtype):
    if dtype == torch.bool:
        return t.view(torch.bool)
    if dtype.is_complex:
        return torch.view_as_complex(t)
    return t


def _host(t):
    """A pinned host copy of a CUDA tensor (waits for the card)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


class _Exchange:
    """One staged or direct transfer: sends and buffers on the route the
    group's backend takes, the time and bytes added to ``traffic``."""

    def __init__(self, group, device):
        self.group = group
        self.device = device
        self.staged = _staged(group, device)
        if self.staged:
            # the copies below wait for the card anyway; waiting first
            # keeps the queued compute out of the exchange's seconds
            torch.cuda.current_stream(device).synchronize()
        self.t0 = time.perf_counter()

    def send(self, t):
        w = _wire(t)
        traffic.bytes += w.numel() * w.element_size()
        return _host(w) if self.staged else w

    def empty(self, shape, dtype):
        return _wire_empty(shape, dtype,
                           "cpu" if self.staged else self.device, self.staged)

    def back(self, t, dtype):
        return _unwire(t.to(self.device) if self.staged else t, dtype)

    def done(self, result=None):
        traffic.seconds += time.perf_counter() - self.t0
        return result


def _p2p(group, device, sends, recvs):
    """Post the ``sends`` (tensor, group peer, tag) and ``recvs`` (shape,
    dtype, group peer, tag) together; the received tensors, in order."""
    ex = _Exchange(group, device)
    ops = [dist.P2POp(dist.isend, ex.send(t), group=group, group_peer=peer,
                      tag=tag) for t, peer, tag in sends]
    bufs = [ex.empty(shape, dtype) for shape, dtype, _, _ in recvs]
    ops += [dist.P2POp(dist.irecv, b, group=group, group_peer=peer, tag=tag)
            for b, (_, _, peer, tag) in zip(bufs, recvs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    got = [ex.back(b, dtype) for b, (_, dtype, _, _) in zip(bufs, recvs)]
    ex.done()
    return got


def _all_to_all(group, t, in_splits=None, out_splits=None):
    """``all_to_all_single`` along dim 0 (equal blocks unless splits)."""
    ex = _Exchange(group, t.device)
    rows = sum(out_splits) if out_splits is not None else t.shape[0]
    out = ex.empty((rows,) + tuple(t.shape[1:]), t.dtype)
    dist.all_to_all_single(out, ex.send(t), out_splits, in_splits,
                           group=group)
    return ex.done(ex.back(out, t.dtype))


def _all_gather_rows(group, t):
    """The group's tensors concatenated along dim 0 (any lengths)."""
    p = dist.get_world_size(group)
    ex = _Exchange(group, t.device)
    count = ex.send(torch.tensor([t.shape[0]], dtype=torch.int64,
                                 device=t.device))
    counts = [ex.empty((1,), torch.int64) for _ in range(p)]
    dist.all_gather(counts, count, group=group)
    counts = [int(c.item()) for c in counts]
    most = max(counts)
    padded = torch.zeros((most,) + tuple(t.shape[1:]), dtype=t.dtype,
                         device=t.device)
    padded[:t.shape[0]] = t
    outs = [ex.empty(padded.shape, t.dtype) for _ in range(p)]
    dist.all_gather(outs, ex.send(padded), group=group)
    return ex.done(torch.cat([ex.back(o, t.dtype)[:n]
                              for o, n in zip(outs, counts)]))


def _any(flag, mesh, names):
    """``flag`` (a bool) or-ed over the ranks of the sharded dimensions."""
    for nm in dict.fromkeys(n for n in names if n is not None):
        group = _group(mesh, nm)
        dev = _device(mesh)
        ex = _Exchange(group, dev)
        t = ex.send(torch.tensor([int(flag)], dtype=torch.int32, device=dev))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        flag = bool(ex.done(ex.back(t, torch.int32)).item())
    return flag


def full_tensor(x):
    """The whole array of a DTensor, on every rank: an all-gather over each
    sharded mesh dimension (staged through host memory where gloo carries
    CUDA tensors: ``DTensor.full_tensor`` crashes its process there)."""
    mesh = x.device_mesh
    y = x.to_local()
    for d, pl in enumerate(x.placements):
        if isinstance(pl, _dt().Shard):
            moved = y.movedim(pl.dim, 0)
            rows = _all_gather_rows(mesh.get_group(d), moved)
            y = rows.movedim(0, pl.dim)
    return y.contiguous()


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def _edge_pad(x, lo, hi, axis, mode, cval):
    """Boundary-extend one axis locally (used at global mesh edges)."""
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (lo, hi)
    return boundary.pad(x, pad_width, mode, cval)


def _edge_slab(x, lo, hi, axis, mode, cval):
    """The ``lo`` (or, with ``lo == 0``, the ``hi``) samples that the
    boundary mode puts past one end of ``x``, padded from the edge slab
    alone (every mode reads at most ``lo + 1`` samples from its end)."""
    n = x.shape[axis]
    if lo:
        edge = x.narrow(axis, 0, min(n, lo + 1))
        return _edge_pad(edge, lo, 0, axis, mode, cval).narrow(axis, 0, lo)
    m = min(n, hi + 1)
    edge = x.narrow(axis, n - m, m)
    return _edge_pad(edge, 0, hi, axis, mode, cval).narrow(axis, m, hi)


def halo_exchange(x, lo: int, hi: int, axis: int, axis_name: str, mode: str,
                  cval=0.0, *, mesh):
    """Extend this rank's block ``x`` along ``axis`` by (lo, hi) halo slabs.

    Interior blocks receive their neighbours' slabs; the first/last block
    of the mesh dimension fill their outward-facing halo with the ndimage
    boundary mode (``wrap``/``grid-wrap`` close the ring instead).
    ``mesh`` names the ``DeviceMesh`` whose dimension ``axis_name`` shards
    ``axis`` (a JAX ``shard_map`` binds the axis name instead).
    """
    if lo == 0 and hi == 0:
        return x
    d = _dim(mesh, axis_name)
    n_dev = mesh.size(d)
    idx = mesh.get_local_rank(d)
    nloc = x.shape[axis]
    if lo > nloc or hi > nloc:
        raise ValueError(
            f"halo ({lo},{hi}) exceeds local shard extent {nloc}"
        )
    if n_dev == 1:  # a ring of one: the boundary mode is the whole story
        return _edge_pad(x, lo, hi, axis, mode, cval)
    wrap = mode in ("wrap", "grid-wrap")
    left, right = (idx - 1) % n_dev, (idx + 1) % n_dev
    from_left = lo > 0 and (wrap or idx > 0)
    from_right = hi > 0 and (wrap or idx < n_dev - 1)

    def slab_shape(width):
        shape = list(x.shape)
        shape[axis] = width
        return shape

    # tag 0 flows rightward (my last ``lo`` become my right neighbour's low
    # halo), tag 1 leftward; both ends post in that order
    sends, recvs = [], []
    if lo > 0 and (wrap or idx < n_dev - 1):
        sends.append((x.narrow(axis, nloc - lo, lo), right, 0))
    if hi > 0 and (wrap or idx > 0):
        sends.append((x.narrow(axis, 0, hi), left, 1))
    if from_left:
        recvs.append((slab_shape(lo), x.dtype, left, 0))
    if from_right:
        recvs.append((slab_shape(hi), x.dtype, right, 1))
    got = _p2p(mesh.get_group(d), x.device, sends, recvs)

    parts = []
    if lo > 0:
        parts.append(got.pop(0) if from_left else
                     _edge_slab(x, lo, 0, axis, mode, cval))
    parts.append(x)
    if hi > 0:
        parts.append(got.pop(0) if from_right else
                     _edge_slab(x, 0, hi, axis, mode, cval))
    return torch.cat(parts, axis)


def _extend(xs, depths, names, mesh, mode, cval):
    """``xs`` extended by ``depths`` (lo, hi) per axis, axis after axis
    (corners included): a sharded axis by exchange, an unsharded one by
    the boundary mode."""
    ext = xs
    for axis, (lo, hi) in enumerate(depths):
        if lo == 0 and hi == 0:
            continue
        if names[axis] is None:
            ext = _edge_pad(ext, lo, hi, axis, mode, cval)
        else:
            ext = halo_exchange(ext, lo, hi, axis, names[axis], mode, cval,
                                mesh=mesh)
    return ext


def _on_slab(fn, xs, names, shape, mesh, depths, mode, cval,
             pad_unsharded=False):
    """``fn`` of this rank's block extended by ``depths``, the extension
    cropped off its result, as a DTensor.  Unless ``pad_unsharded``, only
    the sharded axes are extended: ``fn`` (a single-device call given
    ``mode``) extends the others as the whole array's call would."""
    if not pad_unsharded:
        depths = [d if nm is not None else (0, 0)
                  for nm, d in zip(names, depths)]
    out = fn(_extend(xs, depths, names, mesh, mode, cval))
    for axis, (lo, _) in enumerate(depths):
        out = out.narrow(axis, lo, xs.shape[axis])
    return _dtensor(out, mesh, names, shape)


# ---------------------------------------------------------------------------
# separable filters
# ---------------------------------------------------------------------------


def sharded_correlate1d(x, weights, axis, mesh, spec, mode="reflect",
                        cval=0.0, origin=0, acc_dtype=None):
    """1-d correlation along ``axis`` of an array sharded per ``spec``.

    If ``axis`` is sharded, halos move between neighbours; an unsharded
    axis is purely local.  The result is in ``acc_dtype`` (default: the
    input's float type, at least float32).
    """
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    weights = _weights(weights)
    xs, names, shape = _local(x, mesh, spec)
    if acc_dtype is None:
        acc_dtype = dtypes.promote_weights_dtype(xs.dtype, weights.dtype,
                                                 "float")
    axis = util.check_axis(axis, xs.ndim)
    size = weights.shape[0]
    origin = util.check_origin(origin, size)
    lo = size // 2 + origin
    depths = [(0, 0)] * xs.ndim
    depths[axis] = (lo, size - 1 - lo)
    return _on_slab(
        lambda ext: ndi.correlate1d(
            ext.to(dtypes.to_torch(acc_dtype)), weights, axis, mode=mode,
            cval=cval, origin=origin, dtype_mode="float"),
        xs, names, shape, mesh, depths, mode, cval)


def sharded_separable(x, weights_per_axis, mesh, spec, mode="reflect",
                      cval=0.0, out_dtype=None):
    """Chain per-axis 1-d correlations (separable filter), each pass cast to
    ``out_dtype`` (default: the input's).

    One exchange of every sharded axis, then one single-device call on
    the slab (one fused separable launch for CUDA float32 2-D/3-D data).
    A constant mode with ``cval != 0`` on taps that do not sum to 1 (or an
    integer output) re-extends each pass's output with ``cval``, as
    scipy does, which a slab extended once cannot: that case runs one
    sharded 1-d correlation per axis.
    """
    from cupyimg_tpu_torch.scipy.ndimage import filters

    xs, names, shape = _local(x, mesh, spec)
    out_dtype = np.dtype(out_dtype or dtypes.to_numpy(xs.dtype))
    weights = [None if w is None else _weights(w) for w in weights_per_axis]
    weights += [None] * (xs.ndim - len(weights))
    if (mode in ("constant", "grid-constant") and cval != 0
            and (out_dtype.kind != "f" or any(
                w is not None and abs(w.sum() - 1.0) > 1e-9
                for w in weights))):
        y = _dtensor(xs, mesh, names, shape)
        for axis, w in enumerate(weights):
            if w is not None:
                y = sharded_correlate1d(y, w, axis, mesh, spec, mode, cval)
                y = _dtensor(y.to_local().to(dtypes.to_torch(out_dtype)),
                             mesh, names, shape)
        return y
    depths = [(0, 0) if w is None else
              (w.shape[0] // 2, w.shape[0] - 1 - w.shape[0] // 2)
              for w in weights]
    axes_params = [(ax, w, mode, cval, 0) for ax, w in enumerate(weights)]
    return _on_slab(
        lambda ext: filters._run_1d_filters(ext, axes_params, out_dtype,
                                            "float"),
        xs, names, shape, mesh, depths, mode, cval)


def sharded_uniform_filter(x, size, mesh, spec, mode="reflect", cval=0.0):
    """uniform_filter for mesh-sharded volumes (halo exchange)."""
    sizes = util.fix_sequence_arg(size, _ndim(x), "size", int)
    weights = [
        np.full(s, 1.0 / s) if s > 1 else None for s in sizes
    ]
    return sharded_separable(x, weights, mesh, spec, mode, cval)


def sharded_gaussian_filter(x, sigma, mesh, spec, mode="reflect", cval=0.0,
                            truncate=4.0):
    """gaussian_filter for mesh-sharded volumes (halo exchange)."""
    from cupyimg_tpu_torch.scipy.ndimage.filters import _gaussian_kernel1d

    sigmas = util.fix_sequence_arg(sigma, _ndim(x), "sigma", float)
    weights = []
    for s in sigmas:
        if s > 1e-15:
            lw = int(truncate * s + 0.5)
            weights.append(_gaussian_kernel1d(s, 0, lw)[::-1])
        else:
            weights.append(None)
    return sharded_separable(x, weights, mesh, spec, mode, cval)


# ---------------------------------------------------------------------------
# min/max and median
# ---------------------------------------------------------------------------


def sharded_min_max_filter(x, size, mesh, spec, mode="reflect", cval=0.0,
                           *, is_min=True, origin=0):
    """Separable box minimum/maximum filter over a sharded volume: one
    exchange per sharded axis, then one single-device filter call."""
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    xs, names, shape = _local(x, mesh, spec)
    sizes = util.fix_sequence_arg(size, xs.ndim, "size", int)
    origins = util.fix_sequence_arg(origin, xs.ndim, "origin", int)
    depths = []
    for sz, og in zip(sizes, origins):
        lo = sz // 2 + og
        depths.append((lo, sz - 1 - lo) if sz > 1 else (0, 0))
    fn = ndi.minimum_filter if is_min else ndi.maximum_filter
    return _on_slab(
        lambda ext: fn(ext, size=sizes, mode=mode, cval=cval,
                       origin=origins),
        xs, names, shape, mesh, depths, mode, cval)


def sharded_minimum_filter(x, size, mesh, spec, mode="reflect", cval=0.0):
    """minimum_filter for mesh-sharded volumes."""
    return sharded_min_max_filter(
        x, size, mesh, spec, mode, cval, is_min=True
    )


def sharded_maximum_filter(x, size, mesh, spec, mode="reflect", cval=0.0):
    """maximum_filter for mesh-sharded volumes."""
    return sharded_min_max_filter(
        x, size, mesh, spec, mode, cval, is_min=False
    )


def sharded_median_filter(x, size, mesh, spec, mode="reflect", cval=0.0):
    """Box median filter over a sharded volume.

    Halos for every sharded axis are exchanged once, then each shard runs
    the single-device median locally (no further communication)."""
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    xs, names, shape = _local(x, mesh, spec)
    sizes = util.fix_sequence_arg(size, xs.ndim, "size", int)
    depths = [(s // 2, s - 1 - s // 2) for s in sizes]
    return _on_slab(
        lambda ext: ndi.median_filter(ext, size=sizes, mode=mode, cval=cval),
        xs, names, shape, mesh, depths, mode, cval)


# ---------------------------------------------------------------------------
# batch-sharded FFT convolution
# ---------------------------------------------------------------------------


def sharded_fftconvolve(x, kernel, mesh, spec, mode="same"):
    """Batched FFT convolution where only BATCH axes are sharded.

    The convolved (trailing ``kernel.ndim``) axes must be unsharded in
    ``spec``; each rank then runs one single-device fftconvolve over its
    batch block (the batch axes broadcast against the kernel): data
    parallelism with no exchange."""
    from cupyimg_tpu_torch.scipy.signal import fftconvolve

    xs, names, shape = _local(x, mesh, spec)
    kernel = util.as_tensor(kernel, device=xs.device)
    kdim = kernel.ndim
    lead = xs.ndim - kdim
    if any(n is not None for n in names[lead:]):
        raise ValueError(
            "convolved axes must be unsharded; shard only the batch "
            "axes"
        )
    y = fftconvolve(xs, kernel.reshape((1,) * lead + tuple(kernel.shape)),
                    mode=mode, axes=tuple(range(lead, xs.ndim)))
    return _dtensor(y, mesh, names)


# ---------------------------------------------------------------------------
# distributed connected components
# ---------------------------------------------------------------------------


def sharded_label(x, mesh, spec, structure=None):
    """Distributed connected-component labeling over a device mesh.

    Any subset of the array axes may be sharded (1-D row sharding and 2-D
    tiles both work).  Labels are scipy's:

    - every cell's label is a GLOBAL flat index, built from the block's
      global start, so ids agree across ranks without communication;
    - each rank first labels its block with the single-device ``label``
      and gives each local component the smallest global index in it;
    - each round exchanges a one-deep boundary slab of labels on every
      sharded axis (global edges take the background sentinel), takes the
      window minimum over the structure's neighbours at every foreground
      cell, and lowers each local component to the smallest value any of
      its cells saw: a component takes a neighbour's smaller id whole;
    - the rounds continue while the ``all_reduce`` of the ranks' change
      flags says some component changed (a component spanning k blocks
      settles in about k rounds);
    - roots (cells whose label is their own index: the first cell of each
      component in raster order) are gathered from every rank, and the
      labels renumbered 1..N in their order: scipy's numbering.

    Returns ``(labels, num_features)``: an int32 DTensor and a 0-d int32
    tensor.
    """
    from cupyimg_tpu_torch.scipy import ndimage as ndi
    from cupyimg_tpu_torch.scipy.ndimage.measurements import (
        _structure_offsets,
    )

    xs, names, shape = _local(x, mesh, spec)
    ndim = xs.ndim
    if not any(nm is not None for nm in names):
        raise ValueError("spec shards no axis; use ndi.label instead")
    offsets = _structure_offsets(structure, ndim)
    n = int(np.prod(shape, dtype=np.int64))
    if n >= np.iinfo(np.int32).max:
        raise ValueError("sharded_label supports < 2^31 elements")
    sent = n
    dev = xs.device
    strides = [1] * ndim
    for j in range(ndim - 2, -1, -1):
        strides[j] = strides[j + 1] * shape[j + 1]
    starts = _starts(xs.shape, names, mesh)
    gidx = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(ndim):
        g = (torch.arange(xs.shape[j], dtype=torch.int64, device=dev)
             + starts[j]) * strides[j]
        view = [1] * ndim
        view[j] = xs.shape[j]
        gidx = gidx + g.reshape(view)
    gidx = gidx.expand(xs.shape)

    fg = xs != 0
    comp, m = ndi.label(fg, structure)
    comp = comp.reshape(-1).long()
    m = int(m)

    def lower(val, cand):
        """Each local component's value lowered to its cells' least
        ``cand``; slot 0 (background) stays the sentinel."""
        new = val.clone().scatter_reduce_(0, comp, cand.reshape(-1),
                                          "amin")
        new[0] = sent
        return new

    val = lower(torch.full((m + 1,), sent, dtype=torch.int64,
                           device=dev), torch.where(fg, gidx, sent))
    # the neighbours of every cell in a block extended by one on each
    # axis (exchanged on sharded axes, the sentinel elsewhere)
    interior = [slice(1, 1 + s) for s in xs.shape]
    windows = [tuple(slice(1 + o, 1 + o + s)
                     for o, s in zip(off, xs.shape)) for off in offsets]
    while True:
        ext = _extend(val[comp].reshape(xs.shape), [(1, 1)] * ndim, names,
                      mesh, "grid-constant", sent)
        nb = ext[tuple(interior)]
        for w in windows:
            nb = torch.minimum(nb, ext[w])
        new = lower(val, torch.where(fg, nb, sent))
        changed = _any(bool((new < val).any()), mesh, names)
        val = new
        if not changed:
            break

    lab = val[comp].reshape(xs.shape)
    roots = gidx[fg & (lab == gidx)]
    for nm in dict.fromkeys(nm for nm in names if nm is not None):
        roots = _all_gather_rows(_group(mesh, nm), roots)
    roots = torch.sort(roots).values
    num = roots.numel()
    out = torch.where(fg, torch.searchsorted(roots, lab) + 1,
                      0).to(torch.int32)
    return (_dtensor(out, mesh, names, shape),
            torch.tensor(num, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# the generic overlap primitive and the dense stencils
# ---------------------------------------------------------------------------


def _normalize_depth(depth, ndim):
    """Per-axis (lo, hi) halo widths from an int / seq / seq-of-pairs."""
    if np.isscalar(depth):
        return [(int(depth), int(depth))] * ndim
    out = []
    for d in depth:
        if np.isscalar(d):
            out.append((int(d), int(d)))
        else:
            lo, hi = d
            out.append((int(lo), int(hi)))
    if len(out) != ndim:
        raise ValueError("depth must give one entry per array axis")
    return out


def sharded_map_overlap(func, x, depth, mesh, spec, mode="reflect",
                        cval=0.0):
    """Run a local stencil-style op over a sharded volume with halos.

    The generic overlap primitive: every axis is extended by its
    ``depth`` = (lo, hi) halo (sharded axes exchange slabs with their
    mesh neighbours, unsharded axes take the ndimage boundary pad
    locally), then ``func`` (a function of torch tensors) runs on the
    extended local block and the interior is sliced back out.

    ``func`` must be shape-preserving and aligned: output element ``i``
    of the extended block corresponds to input element ``i`` (it consumes
    the pads in place, like a 'same' stencil).
    """
    xs, names, shape = _local(x, mesh, spec)
    return _on_slab(func, xs, names, shape, mesh,
                    _normalize_depth(depth, xs.ndim), mode, cval,
                    pad_unsharded=True)


def sharded_correlate(x, weights, mesh, spec, mode="reflect", cval=0.0,
                      origin=0, acc_dtype=None):
    """Dense nd correlation of a mesh-sharded volume: halo widths from the
    weight shape and origins, then the single-device correlate on the
    slab (one dense kernel launch for CUDA float32 data), in
    ``acc_dtype`` (default: the input's float type, at least float32)."""
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    weights = _weights(weights)
    xs, names, shape = _local(x, mesh, spec)
    if weights.ndim != xs.ndim:
        raise RuntimeError("filter weights array has incorrect shape")
    if acc_dtype is None:
        acc_dtype = dtypes.promote_weights_dtype(
            xs.dtype, weights.dtype, "float"
        )
    origins = util.fix_sequence_arg(origin, xs.ndim, "origin", int)
    depths = []
    for ax in range(xs.ndim):
        size = weights.shape[ax]
        lo = size // 2 + origins[ax]
        hi = size - 1 - lo
        if lo < 0 or hi < 0:
            raise ValueError("invalid origin")
        depths.append((lo, hi))
    return _on_slab(
        lambda ext: ndi.correlate(
            ext.to(dtypes.to_torch(acc_dtype)), weights, mode=mode,
            cval=cval, origin=origins, dtype_mode="float"),
        xs, names, shape, mesh, depths, mode, cval)


def sharded_convolve(x, weights, mesh, spec, mode="reflect", cval=0.0,
                     origin=0, acc_dtype=None):
    """Dense nd convolution of a mesh-sharded volume (mirrored
    correlation, scipy's origin flip for even sizes)."""
    weights = _weights(weights)
    origins = util.fix_sequence_arg(origin, _ndim(x), "origin", int)
    flipped = weights[(slice(None, None, -1),) * weights.ndim]
    new_origins = [
        -o - 1 + (ws % 2) for o, ws in zip(origins, weights.shape)
    ]
    return sharded_correlate(
        x, flipped, mesh, spec, mode, cval, new_origins, acc_dtype
    )


def _sharded_binary(x, structure, mesh, spec, border_value, is_erosion):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    xs, names, shape = _local(x, mesh, spec)
    xs = xs != 0
    if structure is not None:
        structure = _weights(structure)
        if structure.ndim != xs.ndim:
            raise RuntimeError("structure rank must match input rank")
        reach = [s // 2 for s in structure.shape]
    else:
        reach = [1] * xs.ndim
    fn = ndi.binary_erosion if is_erosion else ndi.binary_dilation
    return _on_slab(
        lambda ext: fn(ext, structure, border_value=border_value),
        xs, names, shape, mesh, [(r, r) for r in reach], "grid-constant",
        bool(border_value))


def sharded_binary_erosion(x, structure=None, mesh=None, spec=None,
                           border_value=0):
    """binary_erosion over a mesh-sharded volume (one iteration; the
    border is a constant ``border_value`` plane exchanged like any other
    halo)."""
    return _sharded_binary(x, structure, mesh, spec, border_value, True)


def sharded_binary_dilation(x, structure=None, mesh=None, spec=None,
                            border_value=0):
    """binary_dilation over a mesh-sharded volume (one iteration)."""
    return _sharded_binary(x, structure, mesh, spec, border_value,
                           False)


# ---------------------------------------------------------------------------
# Sharded interpolation: bounded-displacement warps.
#
# A spatially-sharded resample is feasible whenever every output element's
# source coordinate stays within a bounded distance D of its own position
# (registration-style warps, optical-flow resampling, subpixel shifts).
# Then a halo of ceil(D) + spline support suffices and the gather never
# leaves the extended local block.  Spline prefiltering (order >= 2) runs
# locally on the extended block with extra halo: the IIR boundary init
# decays like pole^d, so _PREFILTER_HALO of 16 keeps the error under
# ~2e-6 even for order 5 (pole 0.43).
# ---------------------------------------------------------------------------

_PREFILTER_HALO = 16


def _interp_support(order):
    """Taps reach at most this many pixels from the rounded coordinate."""
    return order // 2 + 1


def _sharded_interp_depths(disp_lo, disp_hi, order, prefilter, ndim):
    r = _interp_support(order)
    p = _PREFILTER_HALO if (order >= 2 and prefilter) else 0
    return [
        (int(np.ceil(disp_lo[j])) + r + p,
         int(np.ceil(disp_hi[j])) + r + p)
        for j in range(ndim)
    ]


def _local_prefilter(ext, order, mode):
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    # modes whose prefilter scipy implements by prepadding reduce to
    # mirror on the extended block; the halo already holds the true
    # neighbour/boundary data
    m = mode if mode in ("mirror", "reflect", "grid-wrap") else "mirror"
    return ndi.spline_filter(ext, order=order, mode=m,
                             output=dtypes.to_numpy(ext.dtype))


def _check_sharded_interp_mode(mode):
    if mode in ("wrap",):
        # legacy 'wrap' has period n-1 (last and first sample overlap),
        # which a ring halo exchange cannot express; grid-wrap (period
        # n) is supported.
        raise NotImplementedError(
            "sharded interpolation supports 'grid-wrap' but not legacy "
            "'wrap'"
        )


def _halo_fill_mode(mode):
    """Halo fill at the GLOBAL edges.

    Legacy 'constant' interpolates via the MIRROR extension of the spline
    coefficients and only masks fully-out-of-domain output coordinates to
    cval (scipy semantics), so its halo fill is mirror and the outer mask
    in the callers does the rest."""
    return "mirror" if mode == "constant" else mode


def _interp_slab(xs, names, mesh, depths, order, mode, cval, prefilter):
    """The block extended on every axis for a gather (exchange or the
    boundary fill), prefiltered where the order asks."""
    ext = _extend(xs, depths, names, mesh, _halo_fill_mode(mode), cval)
    if order >= 2 and prefilter:
        ext = _local_prefilter(ext, order, mode)
    return ext


def _global_index(xs, names, mesh, axis):
    """The global index along ``axis`` of this block's samples (float64)."""
    start = _starts(xs.shape, names, mesh)[axis]
    return torch.arange(xs.shape[axis], dtype=torch.float64,
                        device=xs.device) + start


def _constant_mask(out, bad, cval):
    return torch.where(bad, torch.tensor(cval, dtype=out.dtype,
                                         device=out.device), out)


def sharded_shift(x, shift, mesh, spec, order=1, mode="reflect", cval=0.0,
                  prefilter=True):
    """ndi.shift over a mesh-sharded volume (uniform subpixel shift).

    The displacement is the same everywhere, so the halo per axis is
    ceil(|shift_j|) + spline support (+ prefilter halo).  Matches
    single-device ``ndi.shift`` to ~1e-5 (prefilter truncation at shard
    boundaries); halos must fit in one neighbour shard.  The gather is
    one single-device ``affine_transform`` of the slab whose output is
    the block itself.
    """
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    _check_sharded_interp_mode(mode)
    xs, names, shape = _local(x, mesh, spec)
    shifts = np.atleast_1d(np.asarray(shift, dtype=np.float64))
    if shifts.size == 1:
        shifts = np.full(xs.ndim, float(shifts[0]))
    depths = _sharded_interp_depths(
        np.maximum(shifts, 0), np.maximum(-shifts, 0), order, prefilter,
        xs.ndim,
    )
    ext = _interp_slab(xs, names, mesh, depths, order, mode, cval,
                       prefilter)
    # output[o] = ext[o + lo - shift] over the block
    out = ndi.affine_transform(
        ext, np.ones(xs.ndim), [d[0] - s for d, s in zip(depths, shifts)],
        output_shape=xs.shape, order=order, mode="nearest",
        prefilter=False)
    if mode == "constant":
        # scipy 'constant': a source coordinate outside [0, n-1] yields
        # cval outright (no interpolation into the pad)
        bad = torch.zeros(out.shape, dtype=torch.bool, device=out.device)
        for axis in range(out.ndim):
            src = _global_index(xs, names, mesh, axis) - shifts[axis]
            view = [1] * out.ndim
            view[axis] = out.shape[axis]
            bad = bad | ((src < 0) | (src > shape[axis] - 1)).reshape(view)
        out = _constant_mask(out, bad, cval)
    return _dtensor(out, mesh, names, shape)


def sharded_map_coordinates(x, coordinates, mesh, spec, max_displacement,
                            order=1, mode="reflect", cval=0.0,
                            prefilter=True):
    """ndi.map_coordinates over a mesh-sharded volume.

    ``coordinates`` has shape ``(x.ndim, *x.shape)`` and is sharded with
    the same spec as ``x`` (leading axis replicated); every coordinate
    must satisfy ``|coords[j] - index_j| <= max_displacement[j]``.  The
    gather then stays inside a halo-extended local block.  The local
    coordinates are formed in float64 (exactly).
    """
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    _check_sharded_interp_mode(mode)
    xs, names, shape = _local(x, mesh, spec)
    cspec = (None,) + tuple(names)
    if tuple(coordinates.shape) != (xs.ndim,) + shape:
        raise ValueError(
            "sharded_map_coordinates needs dense identity-shaped "
            "coordinates (ndim, *x.shape)"
        )
    cs, _, _ = _local(coordinates, mesh, cspec)
    disp = np.atleast_1d(np.asarray(max_displacement, dtype=np.float64))
    if disp.size == 1:
        disp = np.full(xs.ndim, float(disp[0]))
    depths = _sharded_interp_depths(disp, disp, order, prefilter, xs.ndim)
    starts = _starts(xs.shape, names, mesh)
    ext = _interp_slab(xs, names, mesh, depths, order, mode, cval,
                       prefilter)
    # global -> extended-local coordinates
    local = torch.stack([cs[j].to(torch.float64) - starts[j]
                         + depths[j][0] for j in range(xs.ndim)])
    out = ndi.map_coordinates(ext, local, order=order, mode="nearest",
                              prefilter=False)
    if mode == "constant":
        bad = torch.zeros(out.shape, dtype=torch.bool, device=out.device)
        for j in range(xs.ndim):
            bad = bad | (cs[j] < 0) | (cs[j] > shape[j] - 1)
        out = _constant_mask(out, bad, cval)
    return _dtensor(out, mesh, names, shape)


def sharded_affine_transform(x, matrix, offset=0.0, mesh=None, spec=None,
                             order=1, mode="reflect", cval=0.0,
                             prefilter=True):
    """ndi.affine_transform over a mesh-sharded volume.

    Feasible for near-identity affines (small rotations/scalings around
    the volume, registration-style): the displacement ``M @ o + off - o``
    is linear in ``o``, so its per-axis extremes over the global output
    box sit at the box corners; those bound the halo.  Raises if the
    halo would exceed one neighbour shard.  The gather is one
    single-device ``affine_transform`` of the slab, its offset moved into
    the slab's frame, whose output is the block itself.
    """
    from cupyimg_tpu_torch.scipy import ndimage as ndi

    _check_sharded_interp_mode(mode)
    xs, names, shape = _local(x, mesh, spec)
    ndim = xs.ndim
    matrix = np.asarray(_weights(matrix), dtype=np.float64)
    if matrix.ndim == 1:
        matrix = np.diag(matrix)
    if matrix.shape != (ndim, ndim):
        raise ValueError("matrix must be (ndim,) or (ndim, ndim)")
    offsets = np.atleast_1d(np.asarray(_weights(offset), dtype=np.float64))
    if offsets.size == 1:
        offsets = np.full(ndim, float(offsets[0]))

    # displacement extremes over the global output box corners
    corners = np.array(
        [[(shape[j] - 1) * ((k >> j) & 1) for j in range(ndim)]
         for k in range(1 << ndim)], dtype=np.float64)
    disp = corners @ matrix.T + offsets - corners  # (2^ndim, ndim)
    disp_hi = np.maximum(disp.max(axis=0), 0)   # source beyond index
    disp_lo = np.maximum(-disp.min(axis=0), 0)  # source before index
    depths = _sharded_interp_depths(disp_lo, disp_hi, order, prefilter,
                                    ndim)
    starts = np.asarray(_starts(xs.shape, names, mesh), dtype=np.float64)
    lo = np.asarray([d[0] for d in depths], dtype=np.float64)
    ext = _interp_slab(xs, names, mesh, depths, order, mode, cval,
                       prefilter)
    # src = M @ (o + starts) + off, in the slab's frame - starts + lo
    out = ndi.affine_transform(
        ext, matrix, matrix @ starts + offsets - starts + lo,
        output_shape=xs.shape, order=order, mode="nearest",
        prefilter=False)
    if mode == "constant":
        gidx = []
        for j in range(ndim):
            view = [1] * ndim
            view[j] = xs.shape[j]
            gidx.append(_global_index(xs, names, mesh, j).reshape(view))
        bad = torch.zeros(out.shape, dtype=torch.bool, device=out.device)
        for i in range(ndim):
            src = float(offsets[i])
            for j in range(ndim):
                src = src + float(matrix[i, j]) * gidx[j]
            bad = bad | (src < 0) | (src > shape[i] - 1)
        out = _constant_mask(out, bad, cval)
    return _dtensor(out, mesh, names, shape)


# ---------------------------------------------------------------------------
# transpose-based distributed FFT: shard non-FFT axes, retile with
# all-to-all between axis transforms
# ---------------------------------------------------------------------------


def _retile(y, sharded, local, group, p):
    """The all-to-all between the passes of a 2-D FFT: this block's
    complete axis ``local`` cut into ``p`` pieces, piece j to group rank
    j, the pieces received joined along ``sharded`` in rank order.  After
    it ``sharded`` is complete and ``local`` sharded."""
    yt = y.movedim(local, 0)
    n, m = yt.shape[0], yt.shape[1]
    got = _all_to_all(group, yt.reshape(p, n // p, m))
    return got.permute(1, 0, 2).reshape(n // p, p * m).movedim(0, local)


def _fft_layout(names, shape, mesh):
    if len(shape) != 2:
        raise ValueError("sharded_fft2 expects a 2-D array")
    if sum(nm is not None for nm in names) != 1:
        raise ValueError("spec must shard exactly one of the two axes")
    sh = 0 if names[0] is not None else 1
    p = mesh.size(_dim(mesh, names[sh]))
    if shape[1 - sh] % p:
        raise ValueError(
            f"axis {1 - sh} ({shape[1 - sh]}) must divide mesh axis "
            f"'{names[sh]}' ({p})")
    return sh, 1 - sh, _group(mesh, names[sh]), p


def sharded_fft2(x, mesh, spec, inverse=False, transposed_out=False):
    """Distributed 2-D FFT of a 2-D array sharded along ONE axis.

    Transpose-based decomposition: each rank transforms its local rows
    along the *unsharded* axis, one ``all_to_all`` retiles so the other
    axis becomes fully local, the second transform runs, and (unless
    ``transposed_out``) a final ``all_to_all`` restores the input layout.
    Both axes must divide the mesh dimension.

    ``spec`` must shard exactly one of the two axes.  With
    ``transposed_out=True`` the result is returned still sharded along the
    OTHER axis (spec reversed), saving one all_to_all: callers doing
    fwd->pointwise->inv round trips should use it for the forward pass and
    feed the same layout to the inverse.
    """
    xs, names, shape = _local(x, mesh, spec)
    sh, loc, group, p = _fft_layout(names, shape, mesh)
    fft = torch.fft.ifft if inverse else torch.fft.fft
    y = fft(xs if xs.dtype == torch.complex128 else
            xs.to(torch.complex64), dim=loc)
    y = _retile(y, sh, loc, group, p)
    y = fft(y, dim=sh)
    out_names = list(names)
    if transposed_out:
        out_names.reverse()
    else:
        y = _retile(y, loc, sh, group, p)
    return _dtensor(y, mesh, out_names, shape)


def _recut(t, axis, block, start, length, group, p, me):
    """Rows ``[start, start + length)`` of an array whose rank r holds rows
    ``[r * block, (r + 1) * block)`` along ``axis``, re-cut as torch.chunk
    cuts ``length`` rows over ``p`` ranks: one all_to_all of uneven
    pieces."""
    c = -(-length // p)

    def piece(src, dst):
        a = max(src * block, start + dst * c)
        b = min((src + 1) * block, start + min((dst + 1) * c, length))
        return max(0, b - a)

    tt = t.movedim(axis, 0)
    first = min(max(start, me * block), (me + 1) * block)
    ins = [piece(me, q) for q in range(p)]
    outs = [piece(r, me) for r in range(p)]
    send = tt.narrow(0, first - me * block, sum(ins))
    return _all_to_all(group, send, ins, outs).movedim(0, axis)


def sharded_fftconvolve2d_spatial(x, kernel, mesh, spec, mode="same"):
    """2-D FFT convolution with the IMAGE spatially sharded.

    For images too large for one device: the distributed forward FFT
    (its zero padding folded into each pass: the sharded axis is padded
    by its second pass, after the retile), the pointwise product with
    this rank's block of the kernel's spectrum, the distributed inverse
    left in the padded layout, and one uneven all_to_all that crops the
    'same' or 'full' window and cuts it over the ranks as torch.chunk
    does.  ``spec`` shards exactly one image axis.
    """
    xs, names, shape = _local(x, mesh, spec)
    kernel = util.as_tensor(kernel, device=xs.device)
    if xs.ndim != 2 or kernel.ndim != 2:
        raise ValueError("expects 2-D image and kernel")
    if mode not in ("same", "full"):
        raise ValueError("mode must be 'same' or 'full'")
    sh = 0 if names[0] is not None else 1
    loc = 1 - sh
    if names[loc] is not None or names[sh] is None:
        raise ValueError("spec must shard exactly one of the two axes")
    group = _group(mesh, names[sh])
    p = mesh.size(_dim(mesh, names[sh]))
    me = mesh.get_local_rank(_dim(mesh, names[sh]))
    full = [shape[a] + kernel.shape[a] - 1 for a in range(2)]
    # padded global sizes: divisible by the mesh extent on BOTH axes so
    # the all_to_all retiles have uniform blocks
    S = [-(-full[a] // p) * p for a in range(2)]
    cdt = torch.complex128 if torch.promote_types(
        xs.dtype, kernel.dtype) == torch.float64 else torch.complex64
    y = torch.fft.fft(xs.to(cdt), n=S[loc], dim=loc)
    y = _retile(y, sh, loc, group, p)
    y = torch.fft.fft(y, n=S[sh], dim=sh)
    kf = torch.fft.fft2(kernel.to(cdt), s=S)
    width = S[loc] // p
    y = y * kf.narrow(loc, me * width, width)
    y = torch.fft.ifft(y, dim=sh)
    y = _retile(y, loc, sh, group, p)
    y = torch.fft.ifft(y, dim=loc).real
    out_shape = list(full if mode == "full" else shape)
    starts = [(f - n) // 2 for f, n in zip(full, out_shape)]
    y = y.narrow(loc, starts[loc], out_shape[loc])
    y = _recut(y, sh, S[sh] // p, starts[sh], out_shape[sh], group, p,
               me)
    return _dtensor(y, mesh, names, out_shape)
