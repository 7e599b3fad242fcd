"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so nvcc builds it in seconds.  The shared library goes to
``build/kernels/<name>-<hash>.so`` at the root of the checkout, at first
use, where the hash covers the source and every shared header
(``csrc/*.cuh``): a changed source or header gets a new file.  nvcc's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
it as ``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
SOURCES = ("fused_separable", "fused_dense", "fused_rank", "spline_gather",
           "fused_fft")
# flags of one source only: the gather rounds every product and sum on its
# own, as its plain PyTorch version does (no fused multiply-adds)
EXTRA_FLAGS = {"spline_gather": ["-fmad=false"]}


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(EXTRA_FLAGS.get(name, ())).encode())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Raises with nvcc's output
    if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
               str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs.append((so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for so, tmp, proc in procs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{so.name}:\n{log}")
        else:
            os.replace(tmp, so)  # atomic: a parallel build wins or loses whole
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
