#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cupyimg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a traceback and a non-zero exit):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``cupyimg_tpu_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, over
   every boundary mode, origins, skipped axes, short axes and 4..64 taps;
4. the main path: the public ``uniform_filter(256^3 f32, size=5)``,
   ``gaussian_filter(2048^2 f32, sigma=3)`` and ``sobel(256^3 f32)`` on
   the card, each checked to launch the kernel exactly once and to agree
   with scipy.ndimage in float64 on the host;
5. times from CUDA events (median over 100 launches after a warm-up),
   printed as one ``{"cases": ...}`` and one ``{"kernels": ...}`` JSON
   line.

The last line is ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is not available.
"""

import json
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 flop/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
N_TIMED = 100


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, *args, n=N_TIMED):
    from cupyimg_tpu_torch.time import repeat

    res = repeat(fn, args, n_repeat=n, n_warmup=5)
    return float(np.median(res.gpu_times[0]) * 1e3)


def bound(numel, ntaps):
    """(bound_ms, bound_by): bytes = one read + one write of float32,
    flops = one multiply-add per tap per axis per voxel."""
    t_bytes = 8 * numel / PEAK_BYTES
    t_ops = 2 * sum(ntaps) * numel / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


def kernel_vs_plain(fs, torch, g25):
    """Phase 3: the kernel against its plain version on the card."""
    rng = np.random.RandomState(3)
    u5 = (0.2,) * 5
    asym4 = (0.3, -0.7, 1.2, 0.4)
    t64 = rng.uniform(-1, 1, 64)
    t64 = tuple(t64 / np.abs(t64).sum())
    modes = ("reflect", "mirror", "nearest", "wrap", "constant",
             "grid-mirror", "grid-wrap", "grid-constant")
    cases = [(f"u5-3d-{m}", (37, 45, 70), (u5,) * 3, (0, 0, 0), (m,) * 3,
              0.5) for m in modes]
    cases += [
        ("g25-3d-mixed-origins", (40, 33, 130), (g25,) * 3, (1, -2, 3),
         ("constant", "reflect", "mirror"), 0.5),
        ("asym4-3d-skip-axis", (21, 50, 67), (asym4, None, asym4), (-1, 0, 1),
         ("wrap", "nearest", "grid-constant"), 0.25),
        ("t64-3d-short-axes", (16, 24, 40), (t64,) * 3, (0, 5, -7),
         ("constant", "reflect", "wrap"), 0.5),
        ("t64-3d-n1", (1, 3, 40), (t64,) * 3, (0, 0, 0),
         ("mirror", "mirror", "reflect"), 0.0),
        ("g25-3d-n1", (1, 5, 70), (g25,) * 3, (0, 0, 0),
         ("reflect", "mirror", "wrap"), 0.0),
        ("u5-3d-headline", (256, 256, 256), (u5,) * 3, (0, 0, 0),
         ("reflect",) * 3, 0.0),
    ]
    cases += [(f"g25-2d-{m}", (300, 517), (g25, g25), (0, 0), (m, m), 0.5)
              for m in modes]
    cases += [
        ("u5-2d-origins", (64, 100), (u5, u5), (-2, 2),
         ("reflect", "constant"), 0.0),
        ("t64-2d", (40, 52), (t64, t64), (3, -3), ("mirror", "wrap"), 0.0),
        ("asym4-2d-skip-axis", (33, 250), (None, asym4), (0, -2),
         ("reflect", "nearest"), 0.0),
        ("g25-2d-headline", (2048, 2048), (g25, g25), (0, 0),
         ("reflect",) * 2, 0.0),
    ]
    for name, shape, weights, origins, cmodes, cval in cases:
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
        got = fs.fused_separable_correlate(x, weights, origins, cmodes, cval)
        ref = fs.fused_separable_correlate_ref(
            x, weights, origins, cmodes, cval
        )
        torch.cuda.synchronize()
        ws = [w for w in weights if w is not None]
        normalized = all(abs(sum(w) - 1) < 1e-9 and min(w) >= 0 for w in ws)
        tol = 2e-6 if normalized else 1e-5 * float(
            np.prod([np.abs(w).sum() for w in ws]))
        err = float((got - ref).abs().max())
        print(f"kernel-vs-plain {name:24s} {str(shape):17s} "
              f"max_abs_err {err:.3e} (atol {tol:.1e})")
        check(got.shape == x.shape and bool(torch.isfinite(got).all()),
              f"{name}: bad output")
        check(err <= tol, f"{name}: kernel disagrees with its plain version")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import scipy.ndimage as sndi

    import cupyimg_tpu_torch.scipy.ndimage as ndi
    from cupyimg_tpu_torch.core import boundary
    from cupyimg_tpu_torch.ops import _build
    from cupyimg_tpu_torch.ops import fused_separable as fs
    from cupyimg_tpu_torch.scipy.ndimage.filters import _gaussian_kernel1d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for src in _build.SOURCES:
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    # -- phase 3: kernel vs plain version -----------------------------------
    g25 = tuple(_gaussian_kernel1d(3.0, 0, 12)[::-1])
    kernel_vs_plain(fs, torch, g25)

    # -- phase 4: the main path through the public API ----------------------
    rng = np.random.default_rng(0)
    x3 = rng.random((256, 256, 256), dtype=np.float32)
    x2 = rng.random((2048, 2048), dtype=np.float32)
    xc3 = torch.from_numpy(x3).cuda()
    xc2 = torch.from_numpy(x2).cuda()
    torch.cuda.synchronize()
    main_path = [
        ("uniform_filter", "uniform_filter(256^3 f32, size=5)",
         lambda: ndi.uniform_filter(xc3, size=5),
         lambda: sndi.uniform_filter(x3.astype(np.float64), size=5), 2e-6),
        ("gaussian_filter", "gaussian_filter(2048^2 f32, sigma=3)",
         lambda: ndi.gaussian_filter(xc2, sigma=3),
         lambda: sndi.gaussian_filter(x2.astype(np.float64), sigma=3), 2e-6),
        # sum|taps| = 2 * 4 * 4 for the derivative and two smoothing axes
        ("sobel", "sobel(256^3 f32)", lambda: ndi.sobel(xc3),
         lambda: sndi.sobel(x3.astype(np.float64)), 1e-5 * 32),
    ]
    fs.fused_separable_correlate.launches = 0
    outputs = {}
    per_call = {}
    for key, label, run, _, _ in main_path:
        before = fs.fused_separable_correlate.launches
        outputs[key] = run()
        per_call[key] = fs.fused_separable_correlate.launches - before
    torch.cuda.synchronize()
    launches = fs.fused_separable_correlate.launches
    for key, label, run, reference, tol in main_path:
        y = outputs[key]
        check(per_call[key] == 1,
              f"{label} launched the kernel {per_call[key]} times, not 1")
        exp = reference()
        check(y.dtype == torch.float32 and tuple(y.shape) == exp.shape,
              f"{label}: dtype/shape {y.dtype} {tuple(y.shape)}")
        got = y.cpu().numpy()
        check(np.isfinite(got).all(), f"{label}: non-finite output")
        err = float(np.abs(got - exp).max())
        print(f"main path {label:38s} launches {per_call[key]} "
              f"max_abs_err vs scipy f64 {err:.3e} (atol {tol:.1e})")
        check(err <= tol, f"{label}: disagrees with scipy.ndimage")
    del outputs

    # -- phase 5: times -----------------------------------------------------
    u5 = (0.2,) * 5
    d3 = (-1.0, 0.0, 1.0)
    s3 = (1.0, 2.0, 1.0)
    sobel_w = (s3, s3, d3)  # sobel(axis=-1): derivative on the last axis
    timed = [
        ("uniform_filter 256^3 size=5", xc3, (u5,) * 3,
         torch.full((1, 1, 5, 5, 5), 1 / 125, device="cuda")),
        ("gaussian_filter 2048^2 sigma=3", xc2, (g25,) * 2,
         torch.tensor(np.outer(g25, g25), dtype=torch.float32,
                      device="cuda")[None, None]),
        ("sobel 256^3", xc3, sobel_w,
         torch.tensor(np.einsum("i,j,k->ijk", *sobel_w),
                      dtype=torch.float32, device="cuda")[None, None]),
        # the kernel's own floor: every axis skipped, a copy through it
        ("no taps 256^3", xc3, (None,) * 3, None),
    ]
    rows = []
    for label, x, weights, dense in timed:
        nd = x.ndim
        args = (x, weights, (0,) * nd, ("reflect",) * nd, 0.0)
        y = fs.fused_separable_correlate(*args)
        ref = fs.fused_separable_correlate_ref(*args)
        err = float((y - ref).abs().max())
        out = torch.empty_like(x)
        ntaps = [0 if w is None else len(w) for w in weights]
        b_ms, b_by = bound(x.numel(), ntaps)
        row = {
            "case": label,
            "ms": median_ms(fs.fused_separable_correlate, *args),
            "plain_ms": median_ms(fs.fused_separable_correlate_ref, *args,
                                  n=50),
            "copy_ms": median_ms(out.copy_, x),
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "max_abs_err": err,
        }
        if dense is not None:
            # the yardstick: one dense cuDNN convolution (not separable)
            # over a volume padded beforehand; the pad is not timed
            xp = boundary.pad(x, [(k // 2, k // 2) for k in ntaps],
                              "reflect")[None, None]
            conv = (torch.nn.functional.conv3d if nd == 3
                    else torch.nn.functional.conv2d)
            lib_err = float((conv(xp, dense)[0, 0] - ref).abs().max())
            check(lib_err <= 1e-4 * float(dense.abs().sum()),
                  f"{label}: library yardstick disagrees ({lib_err:.2e})")
            row["library_ms"] = median_ms(conv, xp, dense, n=50)
        rows.append(row)
    print(json.dumps({"card": card, "cases": rows}))
    head = rows[0]
    print(json.dumps({"kernels": [{
        "name": "fused_separable_correlate",
        "route": "cuda",
        "source": "cupyimg_tpu_torch/csrc/fused_separable.cu",
        "replaces": "cupyimg_tpu/ops/pallas_stencil.py:1034",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": "cuDNN conv3d with the dense 5x5x5 box, TF32 off, "
                        "on an input padded beforehand (pad not timed)",
        "copy_ms": head["copy_ms"],
        "shape": "uniform_filter 256^3 f32 size=5",
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
