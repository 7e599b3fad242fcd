"""Start a world of ranks, one process each, and run one function in it.

The JAX package runs one controller over a ``Mesh`` of devices; the port
runs PyTorch's SPMD idiom instead: one process per rank, every rank
calling the same sharded functions on its own block.  :func:`run_world`
starts ``nprocs`` such processes (the ``spawn`` method: CUDA may already
be live in the caller), joins them in one ``torch.distributed`` process
group through a file store in a fresh temporary directory (no TCP port,
so concurrent callers never collide), runs ``fn(world, *args)`` on each
and returns rank 0's result, its tensors as numpy arrays.

The transport is picked once, from the world's layout, and printed:

- ``nccl`` where each rank has a card of its own;
- ``gloo`` where ranks run on the CPU or share a card.  Gloo's point to
  point calls take CPU tensors only, so the exchanges of ``halo.py``
  stage a CUDA tensor's slabs through pinned host memory.

A rank that raises fails the call at once with its traceback (the other
ranks are stopped); a rank that dies (its Python stack printed by
``faulthandler``) or waits on a dead peer fails it within the process
group's ``timeout``.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback

import torch

__all__ = ["World", "run_world", "transport"]


def transport(device_type, nprocs, device_count):
    """``"nccl"`` where every one of ``nprocs`` CUDA ranks has its own
    card, else ``"gloo"`` (the CPU, or ranks sharing cards)."""
    if device_type == "cuda" and device_count >= nprocs:
        return "nccl"
    return "gloo"


class World:
    """What a rank of :func:`run_world` knows: its rank, the world's
    size, its device and the transport, and the meshes it has built."""

    def __init__(self, rank, size, device, transport):
        self.rank = rank
        self.size = size
        self.device = device
        self.transport = transport
        self._meshes = {}

    def mesh(self, shape, names):
        """The ``DeviceMesh`` of ``shape`` with dimension ``names`` over
        the world's ranks, built once (every rank must ask for the same
        meshes in the same order: building one is collective)."""
        from torch.distributed.device_mesh import init_device_mesh

        key = (tuple(shape), tuple(names))
        if key not in self._meshes:
            self._meshes[key] = init_device_mesh(
                self.device.type, tuple(shape), mesh_dim_names=tuple(names))
        return self._meshes[key]


def _to_host(obj):
    """``obj`` with every tensor in it as a numpy array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, nprocs, device_type, backend, store, timeout, fn, args,
               results):
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()  # a rank that crashes prints where
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(World(rank, nprocs, device, backend), *args)
            results.put(("ok", rank, _to_host(out) if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 -- reported to the parent, which raises
        results.put(("error", rank, traceback.format_exc()))


def run_world(fn, nprocs, device=None, *args, timeout=60.0):
    """Run ``fn(world, *args)`` on ``nprocs`` ranks; return rank 0's result.

    ``fn`` and ``args`` are pickled by reference, so ``fn`` is a function
    at the top level of a module.  ``device`` is ``"cpu"`` or ``"cuda"``
    (default: ``config.device``); rank r uses ``cuda:(r % device_count)``.
    ``timeout`` (seconds) bounds every collective call.
    """
    import multiprocessing as mp

    from cupyimg_tpu_torch.core.config import config

    device_type = torch.device(device or config.device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_world: CUDA is not available; pass "
                           "device='cpu'")
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = transport(device_type, nprocs, count)
    shared = " (ranks share the card; slabs staged through pinned host " \
             "memory)" if device_type == "cuda" and backend == "gloo" else ""
    print(f"run_world: {nprocs} ranks on {device_type} over {backend}"
          f"{shared}", flush=True)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cupyimg_world_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, nprocs, device_type, backend, os.path.join(tmp, "store"), timeout,
        fn, args, results)) for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        reported, out = set(), None
        while len(reported) < nprocs:
            try:
                kind, rank, payload = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that reports exits 0 after its report is queued
                for r, p in enumerate(procs):
                    if r not in reported and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"run_world: rank {r} exited with code "
                            f"{p.exitcode} before reporting") from None
                continue
            if kind == "error":
                raise RuntimeError(f"run_world: rank {rank} failed:\n"
                                   f"{payload}")
            reported.add(rank)
            if rank == 0:
                out = payload
        for p in procs:
            p.join(timeout)
        return out
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)

