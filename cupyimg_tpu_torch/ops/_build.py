"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so nvcc builds it in seconds.  The shared library goes to
``build/kernels/<name>-<hash>.so`` at the root of the checkout, at first
use, where the hash covers the source, its flags and every shared header
(``csrc/*.cuh``): a changed source or header gets a new file.  A source in
``PARTS`` is compiled once per part (``<name>.<part>-<hash>.so``), each
with its own define, so that its many template instances build in
parallel; at most one nvcc a processor runs at a time, the longest
first.  nvcc's
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
import time
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
# sources compiled once per part (-D<macro>=<part>), one library each, all
# parts in parallel: the gather's instances of one (data type, coordinate
# type, components) each; the rank kernel's compile-time instances spread
# by their unrolled size (ops/fused_rank.py:INSTANCE_PARTS, the generic
# instance in part 0); the separable kernel's element types (float32,
# float16, bfloat16)
PARTS = {"spline_gather": ("SG_PART", 8), "fused_rank": ("RN_PART", 4),
         "fused_separable": ("FS_PART", 3)}
#: the order builds start in, the longest first (on an H100 machine of 8
#: processors: the gather's parts 45-90 s each, the FFT about 30, the
#: separable kernel about 20, the rank kernel's parts about 20, the dense
#: kernel 6), so that the short ones fill the processors the long ones
#: leave
BUILD_ORDER = ("spline_gather", "fused_fft", "fused_separable", "fused_rank",
               "fused_dense")


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name, part):
    flags = list(EXTRA_FLAGS.get(name, ()))
    if part is not None:
        flags.append(f"-D{PARTS[name][0]}={part}")
    return flags


def parts(name):
    """The parts ``name`` is compiled in: (None,) for a single library."""
    return tuple(range(PARTS[name][1])) if name in PARTS else (None,)


def library_path(name: str, part=None) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(_flags(name, part)).encode())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = name if part is None else f"{name}.{part}"
    return BUILD_DIR / f"{tag}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compile every library in ``names`` (every part of each) that is not
    built yet, one nvcc process per library, as many at once as the
    machine has processors, the longest builds started first
    (``BUILD_ORDER``).  Returns the seconds from the start to each
    library's end, by file name.  Raises with nvcc's output if any
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    queue = [(n, p) for n in sorted(names, key=BUILD_ORDER.index)
             for p in parts(n)]
    queue = [(n, p) for n, p in queue if not library_path(n, p).exists()]
    slots = max(1, os.cpu_count() or 1)
    start = time.perf_counter()
    running, failed, seconds = [], [], {}
    while queue or running:
        while queue and len(running) < slots:
            name, part = queue.pop(0)
            so = library_path(name, part)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *_flags(name, part), "-o",
                   str(tmp), str(SRC_DIR / f"{name}.cu")]
            # nvcc's report goes to a file: a pipe could fill and stall it
            log = open(so.with_suffix(f".{os.getpid()}.log"), "w")
            running.append((so, tmp, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        for item in [r for r in running if r[3].poll() is not None]:
            running.remove(item)
            so, tmp, log, proc = item
            seconds[so.name] = time.perf_counter() - start
            log.close()
            os.replace(log.name, so.with_suffix(".log"))
            if proc.returncode != 0:
                text = so.with_suffix(".log").read_text()
                failed.append(f"{so.name}:\n{text}")
            else:
                os.replace(tmp, so)  # atomic: a parallel build wins or loses whole
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


@functools.cache
def load(name: str, part=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (of one part, for a source
    in ``PARTS``), built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name, part)))
