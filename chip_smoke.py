#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cupyimg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a traceback and a non-zero exit):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``cupyimg_tpu_torch/csrc`` with nvcc, one
   nvcc per source, all started together;
3. hold each kernel against its plain PyTorch version on the card:
   the fused separable correlation over every boundary mode, origins,
   skipped axes, short axes and 4..64 taps (tolerance from the taps);
   its min/max op on both of its paths (planes; rows for a 2-D array),
   the rank kernel (exact, NaN included; each of its compile-time
   instances once, and the generic instance) and the dense
   kernel (1e-5 * sum|w| * max|x|) over every mode, origins at both ends,
   short axes and the most extended footprints their gates admit; the
   spline gather (both entries, orders 0-5, every mode, float32/float64
   data and coordinates, 2-D and 3-D, knife-edge and far-out
   coordinates, NaN and complex data: 1e-5 / 1e-12 of max|x|, order 0
   exactly), each of the gather's 408 table instances and its generic
   instance once (every order pattern, float32/float64 data and
   coordinates, real and complex, 1-D to 3-D; 1e-12 where data and
   coordinates are both float64), the spline prefilter's FIR on the
   fused separable kernel
   against the recursion (orders 2-5, 1e-5 of the coefficients' range),
   and the fused separable kernel's two-stage (opening, closing) and
   pair (gradient, laplace) modes, exactly, NaN included, under every
   mode, sizes 1-9 mixed across axes, even sizes with origins under wrap,
   and the widest windows the planner fuses, on each of their paths (2-D
   rows with windows of 3, 9 and 64; 3-D planes with the axis-0 window
   of 1, 3 and 5 in registers, and rings for 7 and an even window); the
   dense kernel's register-blocked instances (each (K0, S) once, a span
   cut into chunks, zero-bordered weights) and its generic kernel
   (sparse footprints), a zero tap over an inf in each (skipped: the
   plain version's infinities, no NaN); the FFT kernel's rows and
   strided entries (forward, real input, inverse with a broadcast
   product, scale and real output, a round trip, the folded zero pad
   and crop with odd starts) at the smallest and largest sizes its gate
   admits and at 384, 1215, 2000 and 4320 (5e-5 / 1e-4 of max|X|, the
   JAX suite's tolerances), and the 2-D and 1-D convolution routes with
   the pad and crop folded in, modes full, same and valid, against their
   plain versions and scipy;
4. the main path: eleven public ``scipy.ndimage`` filter calls and ten
   interpolation calls at full size (256^3 and 2048^2/4096^2 float32, a
   4096^2 int32 image), each checked to launch its kernels exactly as
   often as planned (one spline gather per interpolation, plus one fused
   separable launch per pole where it prefilters) and to agree with
   scipy.ndimage on the host (float64 for the correlations and
   interpolations, exactly for min/max/rank and order 0); then the
   morphology path, its counts set to 0 before it: seven grey calls
   (one two-stage or pair launch each, or two min/max launches outside
   the gate; exact against scipy, the laplace against its contract) and
   three plain-torch calls (binary erosion, hole filling, the EDT with
   indices; no launch; exact, the EDT within 1e-6 relative), with the
   binary fixpoint's step count and the plain calls' device times; then
   the signal path, its counts set to 0 before it: ``scipy.signal``'s
   fftconvolve, oaconvolve, convolve and correlate (method "auto") on a
   4096^2 float32 image with a 31x31 kernel and on 2^22 samples with
   257 taps, the Fourier filters on a 4096^2 spectrum, hilbert and
   resample on 2^20 samples (each call's launches of the FFT kernel's
   rows and strided entries against its route, or none where it takes
   torch.fft; values vs scipy within 5e-4 of max|ref|), and with cuDNN's
   TF32 allowed, convolve2d (4096^2, 31x31), correlate2d (4096^2, 9x9,
   symm) and wiener (4096^2, 5) on the dense kernel (one launch per
   correlation), upfirdn (101 taps, 2^20, up 2, down 3) and
   resample_poly (2^20, 2/3) in plain torch; then the measurements path,
   its counts set to 0 before it (no kernel launched): label of 4096^2
   blobs and of 256^3 blobs with the 3x3x3 structure (labels, numbering
   and count exactly as scipy's; the propagation sweeps printed), the
   labeled reductions over its N labels (sums, means, variances and
   centres of mass within 1e-10 of max|ref|, extrema, positions,
   medians, histograms and bounding boxes exactly), value_indices,
   labeled_comprehension, remove_small_objects/holes, reconstruction of
   a 2048^2 h-dome (sweeps printed), convex_hull_image and
   skimage.measure.label, each against scipy on the host and timed;
   then the base path, its counts set to 0 before it (no kernel
   launched): numpy's histograms (4096^2 into 256 bins, unweighted and
   with float32 and int32 weights; histogram2d of 2^22 points,
   histogramdd of 2^20 x 3), gradient (256^3, both edge orders, a
   spacing array), 1-d convolve/correlate (2^20 x 101; float32 in three
   modes, int32, uint8 and int16 wrapping as numpy's) and quantile
   (4100^2, above torch.quantile's 2^24 limit), the five
   scipy.special functions on 4096^2, stats.entropy, a
   RegularGridInterpolator on a 256^3 grid at 2^20 points, every
   img_as_* from uint8, uint16, int16, float32 and bool at 4096^2,
   invert, random_noise (gaussian, s&p, poisson; 5-sigma statistics),
   map_array over the 4096^2 label image, view_as_blocks/_windows,
   ensure_spacing of 2000 points, and map_coordinates (orders 1 and 3)
   and shift of 4-D data (the plain gather on the card), each against
   numpy/scipy on the host (the skimage calls against the port's CPU
   result) and timed;
5. times from CUDA events (median over up to 100 launches after a
   warm-up), printed as one ``{"cases": ...}`` and one ``{"kernels":
   ...}`` JSON line, with each kernel's bound and a PyTorch yardstick
   (cuFFT for the FFT kernel's passes, cuDNN conv2d for the 37-tap
   prefilter, and beside the dense cuDNN convolution of each separable
   correlation a composite of one 1-D cuDNN convolution per filtered
   axis), every main-path launch of the separable correlation timed
   (the prefilter's poles: order 3's 37 taps on 4096^2 and 2048^2,
   order 5's 57 and 17 taps on 4096^2), each rank and dense row beside
   the same call on the generic instance or kernel
   (``generic_kernel_ms``), each B1-morph row beside the two B1 min/max
   launches of the two-call route (``two_launch_ms``,
   ``two_launch_kernel_ms``, and whether the fused kernel wins), the
   signal path's direct ``convolve(4096^2, 31x31)`` on the dense kernel
   (not in its ``loss_ms``), each kernel's
   ``loss_ms`` (the sum over its main-path launches of kernel_ms -
   bound_ms), the end-to-end fftconvolve
   against torch.fft, and the direct and fft times of the main-path
   convolutions.

The last line is ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is not available.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 flop/s
# (FMA counted as 2), and fp32 non-FMA instructions/s (a min or a max)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_MINMAX = 33.5e12
PEAK_FP64 = 34e12  # float64 outside the tensor cores
N_TIMED = 100
MODES = ("reflect", "mirror", "nearest", "wrap", "constant",
         "grid-mirror", "grid-wrap", "grid-constant")


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


def median_ms(fn, *args, n=N_TIMED, n_warmup=5):
    from cupyimg_tpu_torch.time import repeat

    res = repeat(fn, args, n_repeat=n, n_warmup=n_warmup)
    return float(np.median(res.gpu_times[0]) * 1e3)


def kernel_ms(launch, kernel, n=20, per_call=1):
    """Device time of the launches of the CUDA kernel named ``kernel``
    in one call of ``launch`` (``per_call`` of them), from torch.profiler
    over ``n`` calls: the wrapper's host work (planning, argument checks)
    is left out.  The profiler can lose kernel records (a run of 20
    calls once came back with 16, another with none): such a run is
    profiled again, up to four times; more records than launches fail.
    Where every try comes back short, the mean of the most records a try
    got, per launch, times ``per_call`` stands in, and where no try
    recorded any, the call's CUDA-event time (``ms``, host work
    included); each is printed as such."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    want = n * per_call
    best = (0.0, 0)
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                launch()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                total_us += getattr(ev, "device_time_total",
                                    getattr(ev, "cuda_time_total", 0.0))
                count += ev.count
        check(count <= want, f"{kernel}: {count} launches profiled, not "
                             f"{want}")
        if count == want:
            return total_us / n / 1e3
        print(f"{kernel}: the profiler recorded {count} of {want} launches; "
              "profiling again")
        if count > best[1]:
            best = (total_us, count)
    total_us, count = best
    if count:
        print(f"{kernel}: kernel_ms from the mean of {count} recorded "
              "launches")
        return total_us / count * per_call / 1e3
    print(f"{kernel}: no launch recorded; kernel_ms from CUDA events "
          "around the call")
    return median_ms(launch)


def bound(numel, flops=0.0, minmax_ops=0.0):
    """(bound_ms, bound_by): the larger of one read + one write of
    4-byte values at PEAK_BYTES and the work at its peak rate: ``flops``
    per voxel at PEAK_FP32, ``minmax_ops`` (min/max instructions) per
    voxel at PEAK_MINMAX."""
    t_bytes = 8 * numel / PEAK_BYTES
    t_ops = numel * (flops / PEAK_FP32 + minmax_ops / PEAK_MINMAX)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


# float64 operations per axis of one output sample of the spline gather:
# the weights of each order (ops/interp.py:spline_weights plus the floor
# and the fraction), counted from the code
W_OPS = {0: 2, 1: 4, 2: 11, 3: 21, 4: 33, 5: 47}


def gather_bound(n_in, n_out, orders, coord_ops=0, coord_bytes=0,
                 weights_f64=True):
    """(bound_ms, bound_by) of one spline gather of 4-byte data: one
    read of the input, the coordinate field and one write of the output
    at PEAK_BYTES, against 2 flops per tap (float32) plus the
    coordinate and weight arithmetic (float64 at PEAK_FP64 unless the
    coordinates are float32)."""
    taps = int(np.prod([o + 1 for o in orders]))
    w_ops = coord_ops + sum(W_OPS[o] for o in orders)
    t_bytes = (4 * (n_in + n_out) + coord_bytes) / PEAK_BYTES
    t_ops = n_out * (2 * taps / PEAK_FP32
                     + w_ops / (PEAK_FP64 if weights_f64 else PEAK_FP32))
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


def coef_tol(order, ndim):
    """1e-5 of the largest spline coefficient inputs in [0, 1) can have:
    each pole's FIR sums to ((1+|z|)/(1-|z|))^2 in absolute value, per
    axis (9 for order 3 in 2-D, 56 for order 5)."""
    from cupyimg_tpu_torch.ops import iir

    g = np.prod([((1 + abs(z)) / (1 - abs(z))) ** 2
                 for z in iir.get_poles(order)])
    return 1e-5 * g ** ndim


def same(a, b):
    """Exact equality of two tensors, NaN positions equal as NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        na, nb = a.isnan(), b.isnan()
        if not torch.equal(na, nb):
            return False
        a, b = a.masked_fill(na, 0), b.masked_fill(nb, 0)
    return torch.equal(a, b)


def least_ces(footprint, rank):
    """The fewest compare-exchanges known per output for this footprint
    and rank: a rectangle's shared presort (the lane window sorted once,
    3-D rows merged once, then the pruned merge of the sorted runs), else
    the rank-pruned Batcher network."""
    from cupyimg_tpu_torch.ops import sorting_networks as sn

    if not footprint.all():
        return len(sn.pruned_network(int(footprint.sum()), rank))
    if footprint.ndim == 2:
        w0, w1 = footprint.shape
        return len(sn.batcher_network(w1)) + len(
            sn.presorted_rank_network(w1, w0, rank)[0])
    w0, w1, w2 = footprint.shape
    return (len(sn.batcher_network(w2))
            + len(sn.merge_runs_full_network(w2, w1)[0])
            + len(sn.presorted_rank_network(w1 * w2, w0, rank)[0]))


def ptxas_entries(text):
    """(kernel name, registers, spill store bytes, spill load bytes, stack
    bytes) of each entry function in an ``-Xptxas -v`` report."""
    out = []
    for f in re.split(r"ptxas info\s+: Compiling entry function", text)[1:]:
        name = f.split("'")[1]
        regs = re.findall(r"Used (\d+) registers", f)
        spill = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", f)
        stack = re.findall(r"(\d+) bytes stack frame", f)
        out.append((name, int(regs[0]) if regs else 0,
                    int(spill[0][0]) if spill else 0,
                    int(spill[0][1]) if spill else 0,
                    int(stack[0]) if stack else 0))
    return out


def ptxas_lines(_build, fr):
    """The register and spill lines of the rank kernel's main-path
    instances (each must show no spill and no stack) and of the separable
    kernel's two paths."""
    main = {  # label: (dtype code, footprint as (F0, F1, F2), mask, rank)
        "median 5x5": ("f", (5, 1, 5), (1 << 25) - 1, 12),
        "percentile 30 5x5": ("f", (5, 1, 5), (1 << 25) - 1, 7),
        "median 3x3x3": ("f", (3, 3, 3), (1 << 27) - 1, 13),
        "rank 2 cross int32": ("i", (3, 1, 3), 0xba, 2),
    }
    entries = []
    for part in _build.parts("fused_rank"):
        log = _build.library_path("fused_rank", part).with_suffix(".log")
        entries += ptxas_entries(log.read_text())
    for label, (t, (f0, f1, f2), mask, rank) in main.items():
        key = (f"rank_instance_kernelI{t}Li{f0}ELi{f1}ELi{f2}ELm{mask}"
               f"ELi{rank}E")
        hit = [e for e in entries if key in e[0]]
        check(len(hit) == 1, f"ptxas: no single entry for {label}")
        _, regs, st, ld, stack = hit[0]
        print(f"ptxas B3 instance {label}: {regs} registers, {st} bytes "
              f"spill stores, {ld} bytes spill loads, {stack} bytes stack")
        check(st == ld == stack == 0, f"ptxas: {label} uses local memory")
    inst = [e for e in entries if "rank_instance_kernel" in e[0]]
    print(f"ptxas B3 instances: {len(inst)} kernels, at most "
          f"{max(e[1] for e in inst)} registers, "
          f"{sum(1 for e in inst if e[2] or e[4])} with spills or stack")
    log = _build.library_path("fused_separable").with_suffix(".log")
    kinds = ("opening", "closing", "gradient", "laplace")
    for name, regs, st, ld, stack in ptxas_entries(log.read_text()):
        spill = (f"{regs} registers, {st} bytes spill stores, {ld} bytes "
                 f"spill loads, {stack} bytes stack")
        m = re.search(r"morph_planes_f32_kernelILi(\d)ELi(\d)E", name)
        if m:
            window = ("ring" if m.group(2) == "0" else
                      f"axis-0 window {m.group(2)} in registers")
            print(f"ptxas B1-morph planes path {kinds[int(m.group(1))]}, "
                  f"{window}: {spill}")
            continue
        m = re.search(r"morph_rows_f32_kernelILi(\d)E", name)
        if m:
            print(f"ptxas B1-morph rows path {kinds[int(m.group(1))]}: "
                  f"{spill}")
            continue
        for kernel, path in (("fused_separable_f32_kernel", "planes"),
                             ("rows_f32_kernel", "rows")):
            if kernel in name:
                op = ("corr", "min", "max")[int(re.search(
                    kernel + r"ILi(\d)E", name).group(1))]
                print(f"ptxas B1 {path} path {op}: {spill}")
    log = _build.library_path("fused_dense").with_suffix(".log")
    for name, regs, st, ld, stack in ptxas_entries(log.read_text()):
        m = re.search(r"dense_blocked_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                      name)
        label = (f"blocked instance K0 {m.group(1)} S {m.group(2)} R "
                 f"{m.group(3)}" if m else "generic kernel")
        print(f"ptxas B2 {label}: {regs} registers, {st} bytes spill "
              f"stores, {ld} bytes spill loads, {stack} bytes stack")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def separable_vs_plain(fs, torch, g25):
    """The fused separable correlation against its plain version."""
    rng = np.random.RandomState(3)
    u5 = (0.2,) * 5
    asym4 = (0.3, -0.7, 1.2, 0.4)
    t64 = rng.uniform(-1, 1, 64)
    t64 = tuple(t64 / np.abs(t64).sum())
    cases = [(f"u5-3d-{m}", (37, 45, 70), (u5,) * 3, (0, 0, 0), (m,) * 3,
              0.5) for m in MODES]
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
              for m in MODES]
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
        print(f"kernel-vs-plain corr {name:24s} {str(shape):17s} "
              f"max_abs_err {err:.3e} (atol {tol:.1e})")
        check(got.shape == x.shape and bool(torch.isfinite(got).all()),
              f"{name}: bad output")
        check(err <= tol, f"{name}: kernel disagrees with its plain version")


def minmax_vs_plain(fs, torch):
    """The min/max op of the fused separable kernel: exact."""
    rng = np.random.RandomState(4)
    # every mode in 3-D and 2-D, min and max in turn
    cases = [(f"3d-{m}", (37, 45, 70), (3, 4, 5), (0, 1, -2), (m,) * 3, 0.5,
              i % 2 == 0) for i, m in enumerate(MODES)]
    cases += [(f"2d-{m}", (300, 517), (7, 2), (-3, 0), (m, m), 0.5,
               i % 2 == 1) for i, m in enumerate(MODES)]
    cases += [
        ("3d-skip-axis-mixed", (21, 50, 67), (6, 1, 9), (2, 0, -4),
         ("wrap", "nearest", "grid-constant"), -0.5, True),
        ("3d-64-short-axes", (16, 24, 40), (64, 64, 64), (0, 5, -7),
         ("constant", "reflect", "mirror"), 0.5, False),
        ("3d-sizes-2", (9, 10, 11), (2, 2, 2), (-1, 0, -1),
         ("reflect", "wrap", "constant"), 0.25, True),
        ("2d-short-axis", (5, 700), (33, 17), (10, -8),
         ("mirror", "nearest"), 0.0, False),
        ("3d-n1", (1, 3, 40), (5, 5, 5), (0, 0, 0),
         ("mirror", "reflect", "wrap"), 0.0, True),
    ]
    for name, shape, sizes, origins, cmodes, cval, is_min in cases:
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
        if name == "3d-skip-axis-mixed":
            x[3, 7, 11] = float("nan")
            x[20, 49, 0] = float("nan")
        got = fs.fused_separable_minmax(x, sizes, origins, cmodes, cval,
                                        is_min)
        ref = fs.fused_separable_minmax_ref(x, sizes, origins, cmodes, cval,
                                            is_min)
        torch.cuda.synchronize()
        ok = same(got, ref)
        print(f"kernel-vs-plain {'min' if is_min else 'max'} {name:22s} "
              f"{str(shape):17s} sizes {str(sizes):13s} equal {ok} "
              f"nan {int(ref.isnan().sum())}")
        check(ok, f"minmax {name}: kernel differs from its plain version")


def _dilation_origins(sizes, origins):
    """grey_dilation's origins for the max stage: negated, shifted by one
    for an even size."""
    return tuple(-o - 1 if s % 2 == 0 else -o for s, o in zip(sizes, origins))


def morph_vs_plain(fs, torch):
    """B1's two-stage (opening, closing) and pair (gradient, laplace)
    kernels against their plain versions: exact, NaN included, under
    every mode (nearest and constant too: the kernel computes the
    extend-once contract whatever the morphology gate says)."""
    rng = np.random.RandomState(9)
    sizes3 = [(3, 5, 9), (9, 1, 3), (5, 3, 1), (1, 9, 5)]
    sizes2 = [(5, 9), (9, 3), (1, 5), (3, 1)]
    kinds = ("opening", "closing", "grad", "laplace")
    # (name, shape, sizes, origins, modes, cval, kind)
    cases = []
    for i, m in enumerate(MODES):
        for j, kind in enumerate(kinds):
            cases.append((f"3d-{m}", (37, 45, 70), sizes3[(i + j) % 4],
                          (0, 0, 0), (m,) * 3, 0.5, kind))
            cases.append((f"2d-{m}", (300, 517), sizes2[(i + j) % 4], (0, 0),
                          (m, m), -0.25, kind))
    for kind in kinds:
        cases += [
            ("3d-wrap-even-origins", (21, 50, 67), (4, 6, 2), (1, -2, 0),
             ("wrap", "grid-wrap", "wrap"), 0.0, kind),
            ("2d-wrap-even-origins", (64, 100), (4, 6), (1, -2),
             ("grid-wrap", "wrap"), 0.0, kind),
            ("3d-mixed-modes", (21, 50, 67), (3, 9, 5), (0, 0, 0),
             ("constant", "reflect", "nearest"), 1.5, kind),
            ("2d-short-axis", (5, 700), (9, 9), (0, 0),
             ("mirror", "reflect"), 0.0, kind),
            ("3d-n1", (1, 3, 40), (5, 5, 5), (0, 0, 0),
             ("mirror", "reflect", "wrap"), 0.0, kind),
            ("3d-nan", (30, 40, 50), (3, 1, 3), (0, 0, 0),
             ("reflect",) * 3, 0.0, kind),
            ("2d-nan", (200, 317), (3, 3), (0, 0), ("constant",) * 2, 0.5,
             kind),
        ]
    # the widest windows the two-stage planner fuses, and 64 per axis in
    # the pair mode
    cases += [("2d-50x50", (200, 300), (50, 50), (0, 0), ("reflect",) * 2,
               0.0, k) for k in ("opening", "closing")]
    cases += [("3d-21^3", (30, 40, 70), (21, 21, 21), (0, 0, 0),
               ("mirror",) * 3, 0.0, k) for k in ("opening", "closing")]
    cases += [("3d-64^3", (16, 24, 40), (64, 64, 64), (0, 0, 0),
               ("constant", "reflect", "wrap"), 0.5, k)
              for k in ("grad", "laplace")]
    # each path and fold of the kernels: the rows path's windows of
    # 3, 9 and 64 over several strips and row runs, NaN; the planes path's
    # register windows (K0 = 1, 3, 5) and rings (K0 = 7, and an even one)
    # over several blocks of planes, with wrap and constant modes
    for kind in kinds:
        cases += [
            ("2d-rows-3x3-wrap", (1000, 700), (3, 3), (0, 0),
             ("wrap",) * 2, 0.0, kind),
            ("2d-rows-9x9-nan", (1000, 700), (9, 9), (0, 0),
             ("reflect", "constant"), 0.5, kind),
            ("2d-rows-64x64", (400, 500), (64, 64), (0, 0),
             ("mirror", "wrap"), 0.0, kind),
            ("3d-window-1", (40, 45, 70), (1, 9, 5), (0, 0, 0),
             ("reflect",) * 3, 0.0, kind),
            ("3d-window-3-nan", (64, 45, 70), (3, 3, 3), (0, 0, 0),
             ("wrap",) * 3, 0.0, kind),
            ("3d-window-5", (64, 45, 70), (5, 5, 5), (0, 0, 0),
             ("constant", "reflect", "grid-wrap"), -0.5, kind),
            ("3d-ring-7", (40, 45, 70), (7, 5, 3), (0, 0, 0),
             ("mirror", "nearest", "wrap"), 0.0, kind),
            ("3d-ring-4-nan", (40, 45, 70), (4, 2, 6), (1, 0, -2),
             ("wrap",) * 3, 0.0, kind),
        ]
    for name, shape, sizes, origins, cmodes, cval, kind in cases:
        xh = rng.randn(*shape).astype(np.float32)
        if "nan" in name:
            xh[rng.rand(*shape) < 0.02] = np.nan
        x = torch.from_numpy(xh).cuda()
        if kind in ("opening", "closing"):
            opening = kind == "opening"
            o_dil = _dilation_origins(sizes, origins)
            o1, o2 = (origins, o_dil) if opening else (o_dil, origins)
            args = (x, sizes, o1, o2, cmodes, cval, opening)
            got = fs.fused_separable_open_close(*args)
            ref = fs.fused_separable_open_close_ref(*args)
        else:
            args = (x, sizes, origins, cmodes, cval, kind)
            got = fs.fused_separable_morph_pair(*args)
            ref = fs.fused_separable_morph_pair_ref(*args)
        torch.cuda.synchronize()
        ok = same(got, ref)
        print(f"kernel-vs-plain morph {kind:8s} {name:22s} {str(shape):15s} "
              f"sizes {str(sizes):12s} equal {ok} "
              f"nan {int(ref.isnan().sum())}")
        check(ok, f"morph {kind} {name}: kernel differs from its plain "
                  "version")
    print(f"kernel-vs-plain morph: {len(cases)} cases passed")


def _sparse(shape, nnz, rng):
    w = np.zeros(int(np.prod(shape)))
    w[rng.choice(w.size, nnz, replace=False)] = rng.uniform(-1, 1, nnz)
    return w.reshape(shape)


def dense_vs_plain(fd, torch):
    """The dense kernel: within 1e-5 * sum|w| * max|x|."""
    rng = np.random.RandomState(5)
    w7 = rng.randn(7, 7)
    cases = [(f"2d-7x7-{m}", (300, 517), w7, (0, 0), m, 0.5) for m in MODES]
    cases += [(f"3d-3x3x3-{m}", (40, 50, 70), rng.randn(3, 3, 3), (1, 0, -1),
               m, 0.5) for m in ("reflect", "constant", "wrap")]
    cases += [
        ("2d-3x3", (300, 517), rng.randn(3, 3), (0, 0), "reflect", 0.0),
        ("2d-15x15", (300, 517), rng.randn(15, 15), (0, 0), "mirror", 0.0),
        ("2d-37x37-1369-taps", (300, 517), rng.randn(37, 37), (0, 0),
         "nearest", 0.0),
        ("3d-11x11x11", (40, 50, 70), rng.randn(11, 11, 11), (0, 0, 0),
         "reflect", 0.0),
        ("2d-sparse-25x40", (300, 517), _sparse((25, 40), 60, rng), (0, 0),
         "wrap", 0.0),
        ("3d-sparse-60^3-1400-taps", (40, 45, 70),
         _sparse((60, 60, 60), 1400, rng), (0, 0, 0), "constant", 0.25),
        ("2d-origins-lo-0", (300, 517), rng.randn(6, 5), (-3, -2), "reflect",
         0.0),
        ("2d-origins-lo-max", (300, 517), rng.randn(6, 5), (2, 2),
         "grid-wrap", 0.0),
        ("3d-origins-both-ends", (40, 50, 70), rng.randn(4, 3, 5),
         (-2, 1, 2), "mirror", 0.0),
        ("2d-short-axes", (5, 9), rng.randn(9, 17), (0, 0), "reflect", 0.0),
        ("2d-row-split-1x13000", (8, 7000),
         _sparse((1, 13000), 3, rng), (0, 0), "wrap", 0.0),
    ]
    # each instance of the blocked kernel, a span wider than the
    # widest (rows cut into chunks), zero-bordered weights, several blocks
    # of planes; sparse footprints take the generic kernel
    cases += [(f"2d-blocked-{k}x{k + 2}", (600, 517), rng.randn(k, k + 2),
               (0, 0), "reflect", 0.0) for k in (1, 3, 5, 7, 9, 16)]
    cases += [(f"3d-blocked-{k0}x{k}x{k}", (70, 50, 70),
               rng.randn(k0, k, k), (0, 0, 0), "mirror", 0.0)
              for k0 in (2, 3, 4, 5) for k in (3, 5)]
    w_border = np.zeros((11, 9))
    w_border[3:8, 1:6] = rng.randn(5, 5)
    cases += [
        ("2d-blocked-31x31-chunks", (600, 517), rng.randn(31, 31), (0, 0),
         "constant", 0.0),
        ("2d-blocked-zero-border", (600, 517), w_border, (1, -2), "wrap",
         0.0),
        ("3d-blocked-4x7x7-chunks", (70, 50, 70), rng.randn(4, 7, 7),
         (1, 0, -2), "grid-constant", 0.5),
    ]
    for name, shape, w, origins, mode, cval in cases:
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
        route = ("generic" if fd.blocked_plan(np.asarray(w, np.float32))
                 is None else "blocked")
        got = fd.fused_dense_correlate(x, w, origins, mode, cval)
        ref = fd.fused_dense_correlate_ref(x, w, origins, mode, cval)
        torch.cuda.synchronize()
        tol = 1e-5 * float(np.abs(w).sum()) * max(1.0, abs(cval))
        err = float((got - ref).abs().max())
        print(f"kernel-vs-plain dense {name:26s} {str(shape):15s} "
              f"nnz {int(np.count_nonzero(w)):5d} {route:7s} max_abs_err "
              f"{err:.3e} (atol {tol:.1e})")
        check(bool(torch.isfinite(got).all()), f"dense {name}: bad output")
        check(err <= tol, f"dense {name}: kernel disagrees with its plain "
                          "version")
    # a zero tap over an inf is skipped, not multiplied: both kernels give
    # the plain version's infinities and no NaN
    for name, shape, w in (("2d-zero-tap-over-inf", (300, 517),
                            np.array([[0.0, 1.0, -2.0], [0.5, 0.0, 0.0],
                                      [1.0, 0.25, 3.0]])),
                           ("3d-zero-tap-over-inf", (20, 50, 70),
                            np.where(rng.rand(3, 3, 3) < 0.3, 0.0,
                                     rng.randn(3, 3, 3))),
                           ("2d-sparse-zero-tap-over-inf", (300, 517),
                            _sparse((25, 40), 60, rng))):
        xh = rng.rand(*shape).astype(np.float32)
        xh[tuple(rng.randint(0, n, 40) for n in shape)] = np.inf
        xh[tuple(rng.randint(0, n, 40) for n in shape)] = -np.inf
        x = torch.from_numpy(xh).cuda()
        nd = len(shape)
        got = fd.fused_dense_correlate(x, w, (0,) * nd, "reflect", 0.0)
        ref = fd.fused_dense_correlate_ref(x, w, (0,) * nd, "reflect", 0.0)
        torch.cuda.synchronize()
        fin = torch.isfinite(ref)
        ok = (torch.equal(got.isnan(), ref.isnan())
              and torch.equal(torch.isfinite(got), fin)
              and torch.equal(got[~fin & ~ref.isnan()],
                              ref[~fin & ~ref.isnan()]))
        err = float((got - ref)[fin].abs().max())
        tol = 1e-5 * float(np.abs(w).sum())
        print(f"kernel-vs-plain dense {name:26s} {str(shape):15s} non-finite "
              f"{int((~fin).sum())} same {ok} max_abs_err {err:.3e} (atol "
              f"{tol:.1e})")
        check(ok and err <= tol, f"dense {name}: kernel disagrees with its "
                                 "plain version")


def rank_vs_plain(fr, torch):
    """The rank kernel: exact, NaN included."""
    rng = np.random.RandomState(6)
    cross = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
    rand5 = rng.rand(5, 5) < 0.5
    ext2 = np.zeros((1, 4000), bool)
    ext2[0, rng.choice(4000, 64, replace=False)] = True
    ext3 = np.zeros(64000, bool)
    ext3[rng.choice(64000, 64, replace=False)] = True
    ext3 = ext3.reshape(40, 40, 40)
    box3 = np.ones((3, 3), bool)
    cases = []
    for dt in (np.float32, np.int32):
        tag = "f32" if dt == np.float32 else "i32"
        for r in (1, 4, 7):  # 1, K//2, K-2
            cases.append((f"3x3-rank{r}-{tag}", (300, 517), dt, box3, (0, 0),
                          r, "reflect", 0.0))
        cases += [
            (f"cross-{tag}", (300, 517), dt, cross, (0, 1), 2, "nearest",
             0.0),
            (f"random-5x5-{tag}", (300, 517), dt, rand5, (0, 0),
             int(rand5.sum()) // 2, "mirror", 0.0),
            (f"even-4x2-origins-{tag}", (300, 517), dt,
             np.ones((4, 2), bool), (-2, -1), 3, "wrap", 0.0),
            (f"64-taps-8x8-{tag}", (120, 150), dt, np.ones((8, 8), bool),
             (1, -2), 32, "reflect", 0.0),
            (f"3d-3x3x3-{tag}", (30, 40, 50), dt, np.ones((3, 3, 3), bool),
             (0, 0, 0), 13, "constant", 3.0),
        ]
    cases += [(f"5x5-median-{m}", (200, 317), np.float32,
               np.ones((5, 5), bool), (0, 0), 12, m, 0.5) for m in MODES]
    cases += [(f"cross-int32-{m}", (200, 317), np.int32, cross, (0, 0), 2, m,
               -7.0) for m in MODES]
    cases += [
        ("extent-1x4000-64-ones", (64, 3000), np.float32, ext2, (0, 0), 32,
         "reflect", 0.0),
        ("extent-40^3-64-ones", (30, 40, 50), np.float32, ext3, (0, 0, 0),
         31, "wrap", 0.0),
        ("short-axes-5x5", (3, 4), np.float32, np.ones((5, 5), bool), (0, 0),
         12, "mirror", 0.0),
        ("nan-5x5", (200, 317), np.float32, np.ones((5, 5), bool), (0, 0), 12,
         "reflect", 0.0),
    ]
    for name, shape, dt, fp, origins, rank, mode, cval in cases:
        if dt == np.int32:
            xh = rng.randint(-1000, 1000, shape).astype(np.int32)
        else:
            xh = rng.randn(*shape).astype(np.float32)
        if name.startswith("nan"):
            xh[rng.rand(*shape) < 0.02] = np.nan
        x = torch.from_numpy(xh).cuda()
        got = fr.fused_rank_filter(x, fp, origins, rank, mode, cval)
        ref = fr.fused_rank_filter_ref(x, fp, origins, rank, mode, cval)
        torch.cuda.synchronize()
        ok = same(got, ref)
        print(f"kernel-vs-plain rank {name:24s} {str(shape):15s} "
              f"K {int(fp.sum()):2d} rank {rank:2d} equal {ok}"
              + (f" nan {int(ref.isnan().sum())}" if name.startswith("nan")
                 else ""))
        check(ok, f"rank {name}: kernel differs from its plain version")


def rank_instances_vs_plain(fr, torch):
    """Each compile-time instance of the rank kernel once in each type
    it is built for (float32 with NaN, int32), against the plain
    version: exact."""
    rng = np.random.RandomState(11)
    for i, (f3, mask, rank) in enumerate(fr.INSTANCES):
        nd = 3 if f3[1] > 1 else 2
        fshape = f3 if nd == 3 else (f3[0], f3[2])
        fp = np.array([(mask >> b) & 1 for b in range(int(np.prod(fshape)))],
                      bool).reshape(fshape)
        shape = (37, 45, 70) if nd == 3 else (300, 517)
        for tdt in fr.INSTANCE_TYPES[i]:
            dt = np.float32 if tdt == torch.float32 else np.int32
            check(fr.instance(fp, rank, tdt).id == i,
                  f"instance {i} not picked")
            if dt == np.int32:
                xh = rng.randint(-99, 99, shape).astype(np.int32)
            else:
                xh = rng.randn(*shape).astype(np.float32)
                xh[rng.rand(*shape) < 0.01] = np.nan
            x = torch.from_numpy(xh).cuda()
            mode = MODES[i % len(MODES)]
            got = fr.fused_rank_filter(x, fp, (0,) * nd, rank, mode, 1.5)
            ref = fr.fused_rank_filter_ref(x, fp, (0,) * nd, rank, mode, 1.5)
            torch.cuda.synchronize()
            check(same(got, ref), f"rank instance {i} {f3} rank {rank} "
                                  f"{dt.__name__}: differs from plain")
    print(f"kernel-vs-plain rank: {len(fr.INSTANCES)} compile-time instances"
          f" ({sum(map(len, fr.INSTANCE_TYPES))} with their types) exact "
          "(float32 with NaN, int32)")


def knife_coords(shape, out_shape, rng, dtype):
    """A (ndim, *out_shape) coordinate field: uniform over and beyond the
    domain, with knife edges mixed in on every axis (integers,
    half-integers, -0.5, n-1, n-0.5) and far-out points."""
    size = int(np.prod(out_shape))
    out = []
    for n in shape:
        special = np.concatenate([
            np.arange(-3, n + 3, dtype=np.float64),
            np.arange(-3, n + 3) + 0.5,
            [-0.5, n - 1, n - 0.5, -1e6, 1e6, -3.7e9, 5.1e9],
        ])
        c = rng.uniform(-2 * n, 3 * n, size)
        c[rng.choice(size, min(size, len(special)), replace=False)] = (
            special[:size])
        out.append(c.reshape(out_shape))
    return np.stack(out).astype(dtype)


def spline_gather_vs_plain(sg, torch):
    """The spline gather against its plain version (gather_general):
    within 1e-5 (float32 data) / 1e-12 (float64) of max(|x|, |cval|),
    order 0 exactly, NaN positions included."""
    rng = np.random.RandomState(7)
    cval = 0.5
    n_cases = 0
    worst = {}

    def compare(tag, got, ref, order, tol, scale):
        nonlocal n_cases
        torch.cuda.synchronize()
        n_cases += 1
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"spline_gather {tag}: shape/dtype {got.shape} {got.dtype}")
        if order == 0:
            ok = same(torch.view_as_real(got) if got.is_complex() else got,
                      torch.view_as_real(ref) if ref.is_complex() else ref)
            check(ok, f"spline_gather {tag}: order 0 differs from plain")
            err = 0.0
        else:
            gn, rn = got.isnan(), ref.isnan()
            check(torch.equal(gn, rn), f"spline_gather {tag}: NaN differs")
            err = float((got - ref).masked_fill(gn, 0).abs().max())
            check(err <= tol * scale,
                  f"spline_gather {tag}: {err:.3e} > {tol * scale:.1e}")
        key = tag.split(" ")[0]
        worst[key] = max(worst.get(key, 0.0), err / scale)

    shapes = {2: ((37, 45), (23, 19)), 3: ((9, 14, 17), (7, 9, 11))}
    mats = {
        2: [(np.array([[0.8, 0.65], [-0.6, 0.9]]), np.array([3.3, -4.1])),
            # knife edges: half-integer steps from -0.5
            (np.array([[0.5, 0.0], [0.25, 1.5]]), np.array([-0.5, 0.25]))],
        3: [(np.array([[1.0, 0, 0], [0, 0.8, 0.6], [0, -0.6, 0.8]]),
             np.array([0.0, 2.5, -3.0])),
            (np.array([[0.9, 0.1, 0.2], [-0.1, 1.2, 0.0], [0.3, 0.0, 0.7]]),
             np.array([-1.5, 0.5, 2.0]))],
    }
    for ndim, (shape, out_shape) in shapes.items():
        for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            x = torch.from_numpy(rng.rand(*shape) - 0.25).to(dt).cuda()
            scale = max(float(x.abs().max()), cval)
            for order in range(6):
                for mi, mode in enumerate(MODES):
                    # both coordinate dtypes on float32 data, in turn
                    cdt = (np.float64 if dt == torch.float64 or mi % 2
                           else np.float32)
                    c = torch.from_numpy(knife_coords(
                        shape, out_shape, rng, cdt)).cuda()
                    tag = f"map-{ndim}d-{str(dt)[6:]} o{order} {mode}"
                    compare(tag, sg.spline_map(x, c, order, mode, cval),
                            sg.spline_map_ref(x, c, order, mode, cval),
                            order, tol, scale)
                    m, off = mats[ndim][mi % 2]
                    # the plane route: order 0 on an identity axis
                    orders = ([0, order, order] if ndim == 3 and mi % 2 == 0
                              else order)
                    ct = torch.float32 if cdt == np.float32 else torch.float64
                    args = (x, m, off, out_shape, orders, mode, cval,
                            ct)
                    tag = f"affine-{ndim}d-{str(dt)[6:]} o{order} {mode}"
                    compare(tag, sg.spline_affine(*args),
                            sg.spline_affine_ref(*args), order, tol, scale)
    # 5 % NaN, and complex data with a complex cval
    x = torch.from_numpy(rng.rand(40, 50).astype(np.float32)).cuda()
    x[torch.from_numpy(rng.rand(40, 50) < 0.05).cuda()] = float("nan")
    c = torch.from_numpy(knife_coords((40, 50), (30, 31), rng,
                                      np.float32)).cuda()
    for order in range(6):
        for mode in ("reflect", "constant", "grid-constant", "wrap"):
            compare(f"nan-2d o{order} {mode}",
                    sg.spline_map(x, c, order, mode, cval),
                    sg.spline_map_ref(x, c, order, mode, cval), order, 1e-5,
                    1.0)
    for dt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
        xc = torch.from_numpy(rng.rand(9, 14, 17) + 1j * rng.rand(9, 14, 17)
                              ).to(dt).cuda()
        c = torch.from_numpy(knife_coords(xc.shape, (7, 9, 11), rng,
                                          np.float64)).cuda()
        for order in (0, 1, 3, 5):
            for mode in ("mirror", "grid-constant"):
                compare(f"complex-{str(dt)[6:]} o{order} {mode}",
                        sg.spline_map(xc, c, order, mode, 0.5 - 0.25j),
                        sg.spline_map_ref(xc, c, order, mode, 0.5 - 0.25j),
                        order, tol, float(xc.abs().max()))
    for key, err in sorted(worst.items()):
        print(f"kernel-vs-plain spline_gather {key:18s} "
              f"max_err/scale {err:.3e}")
    print(f"kernel-vs-plain spline_gather: {n_cases} cases passed")


def gather_instances_vs_plain(sg, torch):
    """Every instance of the spline gather's table (both entries, each
    order pattern, float32/float64 data and coordinates, real and
    complex) and its generic instance (mixed orders, a 2-D plane pattern,
    a 3-axis field with an order-0 axis) once on the card against the
    plain version, at knife-edge coordinates in a mode that turns with
    the case: within 1e-5 of max|x| (1e-12 where data and coordinates
    are both float64), order 0 exactly.  Each case records which
    instance served it (``sg.instance``); every instance must serve
    one."""
    rng = np.random.RandomState(11)
    shapes = {1: (61,), 2: (23, 19), 3: (9, 8, 7)}
    out_shapes = {1: (37,), 2: (13, 11), 3: (6, 5, 7)}
    mats = {1: np.array([[0.7]]),
            2: np.array([[0.8, 0.65], [-0.6, 0.9]]),
            3: np.array([[0.9, 0.1, 0.2], [-0.1, 1.2, 0.0], [0.3, 0.0, 0.7]])}
    dts = {(0, 1): torch.float32, (0, 2): torch.complex64,
           (1, 1): torch.float64, (1, 2): torch.complex128}
    cases = []
    for entry, patterns in (("affine", sg.AFFINE_PATTERNS),
                            ("map", sg.MAP_PATTERNS)):
        for part in range(8):
            t, c, nc = part >> 2, (part >> 1) & 1, (part & 1) + 1
            for orders in patterns:
                cases.append((entry, orders, dts[(t, nc)],
                              (torch.float32, torch.float64)[c]))
    generic = [("affine", (1, 3), torch.float32, torch.float64),
               ("affine", (0, 3), torch.complex64, torch.float64),
               ("map", (0, 1, 1), torch.float64, torch.float32),
               ("map", (2, 5), torch.float32, torch.float32)]
    served, worst = set(), 0.0
    for i, (entry, orders, dt, cdt) in enumerate(cases + generic):
        nd = len(orders)
        mode = MODES[i % len(MODES)]
        x = torch.from_numpy(rng.rand(*shapes[nd]) - 0.25)
        if dt.is_complex:
            x = x + 1j * torch.from_numpy(rng.rand(*shapes[nd]))
        x = x.to(dt).cuda()
        cval = 0.5 - 0.25j if dt.is_complex else 0.5
        if entry == "affine":
            off = rng.uniform(-2, 2, nd)
            args = (x, mats[nd], off, out_shapes[nd], list(orders), mode,
                    cval, cdt)
            got, ref = sg.spline_affine(*args), sg.spline_affine_ref(*args)
            n_out = int(np.prod(out_shapes[nd]))
        else:
            cf = torch.from_numpy(knife_coords(
                shapes[nd], (7, 9), rng,
                np.float32 if cdt == torch.float32 else np.float64)).cuda()
            got = sg.spline_map(x, cf, list(orders), mode, cval)
            ref = sg.spline_map_ref(x, cf, list(orders), mode, cval)
            n_out = 63
        inst = sg.instance(entry, orders, dt, cdt, x.numel(), n_out)
        served.add(inst)
        torch.cuda.synchronize()
        tag = f"{entry} {orders} {dt} coords {cdt} {mode} ({inst})"
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"gather instance {tag}: shape/dtype")
        if max(orders) == 0:
            check(same(torch.view_as_real(got) if dt.is_complex else got,
                       torch.view_as_real(ref) if dt.is_complex else ref),
                  f"gather instance {tag}: order 0 differs from plain")
        else:
            # 1e-12 where data and coordinates are float64; float32
            # weights differ from the plain version's on the card by an
            # ulp (it divides by a scalar as a product by the reciprocal)
            tol = 1e-12 if (dt in (torch.float64, torch.complex128)
                            and cdt == torch.float64) else 1e-5
            scale = max(float(x.abs().max()), abs(cval))
            err = float((got - ref).abs().max())
            check(err <= tol * scale, f"gather instance {tag}: {err:.3e} > "
                                      f"{tol * scale:.1e}")
            worst = max(worst, err / (tol * scale))
    n_fast = sum(1 for i in served if i.key is not None)
    check(n_fast == len(cases) and sg.Instance("affine", 0, None) in served
          and sg.Instance("map", 0, None) in served,
          f"gather instances: {n_fast} fast of {len(cases)}, generic "
          "not served")
    print(f"kernel-vs-plain spline_gather instances: {n_fast} fast "
          f"instances and the generic one ({len(generic)} cases), worst "
          f"err/tol {worst:.3f}")


def prefilter_vs_plain(iir, torch):
    """The spline prefilter's FIR (one fused separable launch per pole)
    against the recursion, float32, within 1e-5 of the coefficients'
    max|c| (inputs in [0, 1); the 3-D order-5 coefficients reach 64,
    and both float32 routes sit within 5e-7 * max|c| of float64)."""
    rng = np.random.RandomState(8)
    for shape in ((200, 300), (40, 50, 60)):
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
        axes = tuple(range(x.ndim))
        worst = 0.0
        for order in (2, 3, 4, 5):
            for mode in ("mirror", "reflect", "grid-wrap", "nearest"):
                got = iir.spline_filter_fir(x, order, axes, mode)
                check(got is not None, f"FIR gate refused {shape} {order}")
                ref = x
                for ax in axes:
                    ref = iir.spline_filter1d(ref, order, ax, mode)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max() / ref.abs().max())
                check(err <= 1e-5, f"prefilter {shape} order {order} "
                                   f"{mode}: {err:.3e} of max|c|")
                worst = max(worst, err)
        print(f"kernel-vs-plain prefilter FIR {str(shape):14s} orders 2-5 "
              f"x 4 modes max_err/max|c| {worst:.3e} (tol 1e-5)")


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def time_row(label, launch, plain, x, bound_ms_by, atol, library=None,
             library_call=None, n_plain=20, kernel=None, per_call=1):
    """One timed case: the kernel's wrapper (``ms``, CUDA events around
    each call, so host work that starves the card counts), the kernel
    alone (``kernel_ms``, profiler), its plain version, a copy of the
    input and, where there is one, the library yardstick (whose result is
    checked against the plain version's).  The kernel's result is held
    against its plain version's on the same full-size inputs: within
    ``atol`` (a number, or a function of the plain result), exactly
    where it is 0 (NaN positions included)."""
    import torch

    y = launch()
    ref = plain()
    torch.cuda.synchronize()
    tol = atol(ref) if callable(atol) else atol
    if tol == 0:
        err = 0.0
        check(same(y, ref), f"{label}: kernel differs from its plain version")
    else:
        check(y.shape == ref.shape and y.dtype == ref.dtype
              and bool(torch.isfinite(y).all()), f"{label}: bad output")
        err = float((y - ref).abs().max())
        check(err <= tol, f"{label}: kernel disagrees with its plain version "
                          f"({err:.3e} > {tol:.1e})")
    print(f"time-row kernel-vs-plain {label:48s} max_abs_err {err:.3e} "
          f"({'exact' if tol == 0 else f'atol {tol:.1e}'})")
    out = torch.empty_like(x)
    row = {
        "case": label,
        "ms": median_ms(launch),
        "kernel_ms": None if kernel is None else kernel_ms(launch, kernel,
                                                           per_call=per_call),
        "plain_ms": median_ms(plain, n=n_plain, n_warmup=min(5, n_plain)),
        "copy_ms": median_ms(out.copy_, x),
        "bound_ms": bound_ms_by[0],
        "bound_by": bound_ms_by[1],
        "library_ms": None,
        "library_call": library_call,
        "max_abs_err": err,
        "atol": tol,
    }
    if library is not None:
        fn, tol = library
        if tol is not None:  # None: another function, timed only
            lib_err = float((fn().reshape(ref.shape).to(ref.dtype) - ref)
                            .abs().max())
            check(lib_err <= tol,
                  f"{label}: library yardstick disagrees ({lib_err:.2e})")
        row["library_ms"] = median_ms(fn, n=20)
    return row


def _blobs(shape, size, level, rng):
    """Boolean blobs with holes: a box-smoothed random field above
    ``level`` (made on the host from ``rng``)."""
    import scipy.ndimage as sndi

    field = sndi.uniform_filter(rng.random(shape, dtype=np.float32), size)
    return field > level


def morphology_path(fs, ndi, sndi, torch, x3, xc3, img, imgc, shape2):
    """Phase 4, morphology: public calls at full size, each held against
    scipy.ndimage on the host (grey and binary exactly, the laplace
    exactly against its contract built from scipy's dilation and erosion,
    the EDT within 1e-6 relative) and each call's launches against its
    plan.  The counts are set to 0 just before this path and read just
    after.  Returns the path's launches and the plain-torch calls' times
    (binary ops and the EDT, which launch no kernel)."""
    import cupyimg_tpu_torch.skimage.morphology as skm
    from cupyimg_tpu_torch.scipy.ndimage import morphology as morph

    rng = np.random.default_rng(1)
    b3 = _blobs(x3.shape, 5, 0.5, rng)
    b2 = _blobs(shape2, 15, 0.5, rng)
    b3c = torch.from_numpy(b3).cuda()
    b2c = torch.from_numpy(b2).cuda()
    f64 = np.float64

    def laplace_contract(x, **kw):
        """cupyimg_tpu's laplace, (dilation + erosion) - 2x in float32,
        from scipy's own dilation and erosion."""
        d = sndi.grey_dilation(x, **kw)
        e = sndi.grey_erosion(x, **kw)
        return (d + e) - np.float32(2) * x

    def edt_check(y):
        d, i = y
        dr, ir = sndi.distance_transform_edt(b2, return_indices=True)
        check(d.dtype == torch.float32 and i.dtype == torch.int32,
              f"edt dtypes {d.dtype} {i.dtype}")
        d = d.cpu().numpy().astype(f64)
        err = float(np.abs(d - dr).max())
        check(bool((np.abs(d - dr) <= 1e-6 * dr).all()),
              f"edt disagrees with scipy ({err:.3e})")
        check(np.array_equal(i.cpu().numpy(), ir),
              "edt indices differ from scipy's")
        return err, "rtol 1e-6, indices exact"

    oc = {"fused_separable_open_close": 1}
    counters = {
        "fused_separable_open_close": fs.fused_separable_open_close,
        "fused_separable_morph_pair": fs.fused_separable_morph_pair,
        "fused_separable_minmax": fs.fused_separable_minmax,
    }
    # (label, {kernel: launches}, call, reference: an array (exact) or a
    # function of the result giving (err, tolerance text))
    path = [
        ("grey_opening(256^3 f32, size=5)", oc,
         lambda: ndi.grey_opening(xc3, size=5),
         lambda: sndi.grey_opening(x3, size=5)),
        ("grey_closing(4096^2 f32, size=7, wrap)", oc,
         lambda: ndi.grey_closing(imgc, size=7, mode="wrap"),
         lambda: sndi.grey_closing(img, size=7, mode="wrap")),
        ("grey_opening(4096^2 f32, size=5, constant)",
         {"fused_separable_minmax": 2},
         lambda: ndi.grey_opening(imgc, size=5, mode="constant"),
         lambda: sndi.grey_opening(img, size=5, mode="constant")),
        ("morphological_gradient(256^3 f32, size=3)",
         {"fused_separable_morph_pair": 1},
         lambda: ndi.morphological_gradient(xc3, size=3),
         lambda: sndi.morphological_gradient(x3, size=3)),
        ("morphological_laplace(4096^2 f32, size=5, nearest)",
         {"fused_separable_morph_pair": 1},
         lambda: ndi.morphological_laplace(imgc, size=5, mode="nearest"),
         lambda: laplace_contract(img, size=5, mode="nearest")),
        ("white_tophat(4096^2 f32, size=9)", oc,
         lambda: ndi.white_tophat(imgc, size=9),
         lambda: sndi.white_tophat(img, size=9)),
        ("skimage opening(4096^2 f32, square(5))", oc,
         lambda: skm.opening(imgc, skm.square(5)),
         lambda: sndi.grey_opening(img, footprint=np.ones((5, 5)))),
        ("binary_erosion(256^3 bool blobs, iterations=3)", {},
         lambda: ndi.binary_erosion(b3c, iterations=3),
         lambda: sndi.binary_erosion(b3, iterations=3)),
        ("binary_fill_holes(2048^2 bool blobs)", {},
         lambda: ndi.binary_fill_holes(b2c),
         lambda: sndi.binary_fill_holes(b2)),
        ("distance_transform_edt(2048^2 bool blobs, indices)", {},
         lambda: ndi.distance_transform_edt(b2c, return_indices=True),
         edt_check),
    ]
    for c in counters.values():
        c.launches = 0
    morph._iterate_binary_op.steps = 0
    outputs = []
    for label, _, run, _ in path:
        before = {k: c.launches for k, c in counters.items()}
        steps = morph._iterate_binary_op.steps
        y = run()
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        outputs.append((y, delta, morph._iterate_binary_op.steps - steps))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    for (label, plan, _, reference), (y, delta, steps) in zip(path, outputs):
        want = {k: plan.get(k, 0) for k in counters}
        check(delta == want, f"{label} launched {delta}, not as planned: "
                             f"{plan}")
        if isinstance(y, tuple):
            err, tol = reference(y)
        else:
            exp = reference()
            want_dtype = torch.bool if exp.dtype == np.bool_ else torch.float32
            check(tuple(y.shape) == exp.shape and y.dtype == want_dtype,
                  f"{label}: dtype/shape {y.dtype} {tuple(y.shape)}")
            got = y.cpu().numpy()
            err = float(np.abs(got.astype(f64) - exp.astype(f64)).max())
            check(np.array_equal(got, exp),
                  f"{label}: differs from scipy.ndimage ({err:.3e})")
            tol = "exact"
        planned = " ".join(f"{k} x{n}" for k, n in plan.items()) or (
            "no kernel (plain torch)")
        print(f"main path {label:52s} {planned:34s} "
              f"max_abs_err vs scipy {err:.3e} ({tol})"
              + (f"; binary steps {steps}" if steps else ""))
    # the laplace's contract against scipy's own laplace, which subtracts
    # the input twice: one float32 ulp of values below 2 at most
    lap = outputs[4][0].cpu().numpy()
    err = float(np.abs(lap - sndi.morphological_laplace(
        img, size=5, mode="nearest")).max())
    check(err <= 2.4e-7, f"laplace vs scipy's: {err:.3e}")
    print(f"main path laplace vs scipy.ndimage.morphological_laplace: "
          f"max_abs_err {err:.3e} (atol 2.4e-07, one ulp)")
    print(f"morphology path launches: {json.dumps(launches)}")
    check(launches["fused_separable_open_close"] >= 1
          and launches["fused_separable_morph_pair"] >= 1,
          "a B1-morph kernel was not launched on the morphology path")
    del outputs

    # the plain-torch calls' device time (no kernel of the port)
    plain_rows = []
    for label, call, n in (
        (path[7][0], path[7][2], 10),
        (path[8][0], path[8][2], 5),
        (path[9][0], path[9][2], 5),
    ):
        morph._iterate_binary_op.steps = 0
        ms = median_ms(call, n=n, n_warmup=1)
        runs = n + 1
        plain_rows.append({"case": label, "ms": ms,
                           "binary_steps": morph._iterate_binary_op.steps
                           // runs})
        print(f"plain torch {label:52s} {ms:10.3f} ms "
              f"(binary steps per call {plain_rows[-1]['binary_steps']})")
    return launches, plain_rows


def morph_rows(fs, boundary, torch, rows, xc3, imgc):
    """Phase 5, B1-morph: the two-stage and pair kernels at the main
    path's shapes, each against its plain version (exact), beside the two
    B1 min/max launches the two-call route takes (``two_launch_ms``, CUDA
    events around both calls, and ``two_launch_kernel_ms``, the two
    kernels by profiler; for the pair the min and the max, the combine
    not counted) and the max_pool composite (the input padded beforehand,
    not timed).  Prints whether the fused kernel wins."""
    F = torch.nn.functional

    def pool(x, size, is_min):
        """Stride-1 box max (or min, as -max(-x)) by max_pool: 'valid'
        windows, one size-``size`` window per axis."""
        nd = x.ndim
        op = F.max_pool3d if nd == 3 else F.max_pool2d
        y = x[None, None]
        out = -op(-y, size, stride=1) if is_min else op(y, size, stride=1)
        return out[0, 0]

    def two_launch(label, two, x):
        """The two-call route's two B1 min/max launches beside the row's
        fused kernel."""
        row = rows[label]
        b1 = "rows_f32_kernel" if x.ndim == 2 else "fused_separable_f32_kernel"
        row["two_launch_ms"] = median_ms(two)
        row["two_launch_kernel_ms"] = kernel_ms(two, b1, per_call=2)
        verdict = ("wins" if row["kernel_ms"] < row["two_launch_kernel_ms"]
                   else "loses")
        print(f"B1-morph {label}: kernel_ms {row['kernel_ms']:.4f} against "
              f"two B1 launches {row['two_launch_kernel_ms']:.4f}: {verdict}")

    def open_close_row(label, x, size, mode, opening):
        nd = x.ndim
        sizes, zero = (size,) * nd, (0,) * nd
        args = (x, sizes, zero, zero, (mode,) * nd, 0.0, opening)
        h = size // 2
        xp = boundary.pad(x, [(2 * h, 2 * h)] * nd, mode)
        lib = (lambda: pool(pool(xp, size, opening), size, not opening), 0.0)
        rows[label] = time_row(
            label, lambda: fs.fused_separable_open_close(*args),
            lambda: fs.fused_separable_open_close_ref(*args), x,
            bound(x.numel(), minmax_ops=2 * nd * (size - 1)), 0, lib,
            f"composite: two torch max_pool{nd}d stride 1 (min as "
            "-max_pool(-x), negations timed) on an input padded "
            "beforehand by both windows (pad not timed); no single "
            "PyTorch call computes an opening",
            n_plain=10, kernel="morph_")
        two_launch(label, lambda: fs.fused_separable_minmax(
            fs.fused_separable_minmax(x, sizes, zero, (mode,) * nd, 0.0,
                                      opening),
            sizes, zero, (mode,) * nd, 0.0, not opening), x)

    def pair_row(label, x, size, mode, combine):
        nd = x.ndim
        sizes, zero = (size,) * nd, (0,) * nd
        args = (x, sizes, zero, (mode,) * nd, 0.0, combine)
        h = size // 2
        xp = boundary.pad(x, [(h, h)] * nd, mode)

        def lib():
            mx, mn = pool(xp, size, False), pool(xp, size, True)
            return mx - mn if combine == "grad" else mx + mn - 2.0 * x

        rows[label] = time_row(
            label, lambda: fs.fused_separable_morph_pair(*args),
            lambda: fs.fused_separable_morph_pair_ref(*args), x,
            bound(x.numel(), minmax_ops=2 * nd * (size - 1)
                  + (1 if combine == "grad" else 3)), 0, (lib, 0.0),
            f"composite: torch max_pool{nd}d stride 1 for the max and "
            "-max_pool(-x) for the min, then the combine, on an input "
            "padded beforehand (pad not timed)",
            n_plain=10, kernel="morph_")
        two_launch(label, lambda: (
            fs.fused_separable_minmax(x, sizes, zero, (mode,) * nd, 0.0,
                                      True),
            fs.fused_separable_minmax(x, sizes, zero, (mode,) * nd, 0.0,
                                      False)), x)

    open_close_row("grey_opening 256^3 size=5 (two-stage)", xc3, 5,
                   "reflect", True)
    open_close_row("grey_closing 4096^2 size=7 wrap (two-stage)", imgc, 7,
                   "wrap", False)
    open_close_row("grey_opening 4096^2 size=9 (two-stage, white_tophat)",
                   imgc, 9, "reflect", True)
    open_close_row("grey_opening 4096^2 size=5 (two-stage, skimage square)",
                   imgc, 5, "reflect", True)
    pair_row("morphological_gradient 256^3 size=3 (pair)", xc3, 3, "reflect",
             "grad")
    pair_row("morphological_laplace 4096^2 size=5 nearest (pair)", imgc, 5,
             "nearest", "laplace")


def fft_vs_plain(ff, torch):
    """Phase 3, B4/B5: both entries of the FFT kernel against
    ``fused_fft_ref`` on the card, at n in {270 and 14400 (the smallest
    and largest sizes the gate admits), 384, 1215, 2000, 4320}: forward
    (complex and real input), the inverse with a product broadcast over
    the leading axis, a scale and a real output, and a kernel round trip
    (forward, then inverse with 1/n).  Tolerances are the JAX suite's:
    5e-5 * max|X| for a forward transform, 1e-4 * max|X| for an inverse
    and a round trip."""
    rng = np.random.default_rng(5)
    sizes = [n for n in range(257, 20000) if ff.supports(n)]
    ns = sorted({sizes[0], 384, 1215, 2000, 4320, sizes[-1]})

    def c64(shape):
        return torch.complex(
            *[torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .cuda() for _ in range(2)])

    count, worst = 0, 0.0
    for n in ns:
        for entry, shape, launch in (("rows", (9, n), ff.fft_rows),
                                     ("strided", (3, n, 7), ff.fft_strided)):
            x = c64(shape)
            cases = [
                ("forward", x, {}, 5e-5),
                ("forward, real input", x.real.contiguous(), {}, 5e-5),
                ("inverse", x, dict(inverse=True), 1e-4),
                ("inverse, broadcast product, scale, real output", x,
                 dict(inverse=True, real_out=True, mul=c64(shape[1:]),
                      scale=1.0 / n), 1e-4),
            ]
            # the folded pad (an axis 37 short of n) and crop (odd starts)
            short = x[:, :n - 37].contiguous()
            cases += [
                ("forward, zero pad, window (3, n - 10)", short,
                 dict(n=n, window=(3, n - 10)), 5e-5),
                ("forward, real input, zero pad", short.real.contiguous(),
                 dict(n=n), 5e-5),
                ("inverse, real output, scale, window (1, n // 2)", x,
                 dict(inverse=True, real_out=True, scale=1.0 / n,
                      window=(1, n // 2)), 1e-4),
            ]
            for label, inp, kw, rel in cases:
                got = launch(inp, **kw)
                ref = ff.fused_fft_ref(inp, entry, **kw)
                torch.cuda.synchronize()
                check(got.shape == ref.shape and got.dtype == ref.dtype
                      and bool(torch.isfinite(torch.view_as_real(got)
                                              if got.is_complex() else got)
                               .all()),
                      f"fused_fft {entry} n={n} {label}: bad output")
                err = float((got - ref).abs().max())
                tol = rel * float(ref.abs().max())
                check(err <= tol, f"fused_fft {entry} n={n} {label}: "
                                  f"{err:.3e} > {tol:.3e}")
                worst = max(worst, err / tol)
                count += 1
            spec = launch(x)
            back = launch(spec, inverse=True, scale=1.0 / n)
            torch.cuda.synchronize()
            err = float((back - x).abs().max())
            tol = 1e-4 * float(spec.abs().max())
            check(err <= tol, f"fused_fft {entry} n={n} round trip: "
                              f"{err:.3e} > {tol:.3e}")
            worst = max(worst, err / tol)
            count += 1
    print(f"fused_fft kernel-vs-plain: {count} cases (n = "
          f"{', '.join(map(str, ns))}; rows and strided), worst err/tol "
          f"{worst:.3f}")
    count += fft_routes_vs_plain(torch)


def fft_routes_vs_plain(torch):
    """The routes with the folded pad and crop: the 2-D and 1-D real
    convolutions on the card, reading unpadded operands and storing the
    window of modes full, same and valid (and an odd start), against the
    same route's plain version on the host (the kernel's passes in
    PyTorch) and against scipy: 1e-4 / 5e-4 of max|ref|.  Returns the
    number of cases."""
    import scipy.signal as ss

    from cupyimg_tpu_torch.scipy.signal import signaltools as st

    rng = np.random.default_rng(6)
    count = 0
    for s1, s2 in (((300, 280), (13, 31)), ((257, 301), (140, 129))):
        a = rng.standard_normal(s1).astype(np.float32)
        b = rng.standard_normal(s2).astype(np.float32)
        shape = [x + y - 1 for x, y in zip(s1, s2)]
        fshape = [st.next_fast_len(v) for v in shape]
        for mode in ("full", "same", "valid"):
            win = st._mode_window(shape, s1, s2, mode, [0, 1])
            cases = [("2-D", lambda v, w, win=win: st._fused_fft2_real_conv(
                v, w, [0, 1], fshape, win), ss.fftconvolve(a, b, mode)),
                     ("1-D rows", lambda v, w, win=win:
                      st._fused_fft1_real_conv(v, w[:1], [1], fshape[1:],
                                               (win[1][0] + 1,
                                                win[1][1] - 1)),
                      None)]
            for label, route, want in cases:
                got = route(torch.from_numpy(a).cuda(),
                            torch.from_numpy(b).cuda()).cpu()
                ref = route(torch.from_numpy(a), torch.from_numpy(b))
                tol = 1e-4 * float(ref.abs().max())
                err = float((got - ref).abs().max())
                check(got.shape == ref.shape and err <= tol,
                      f"fused_fft route {label} {s1} {s2} {mode}: "
                      f"{err:.3e} > {tol:.3e}")
                if want is not None:
                    err = float(np.abs(got.numpy() - want).max())
                    check(err <= 5e-4 * np.abs(want).max(),
                          f"fused_fft route {label} {mode} vs scipy")
                count += 1
    print(f"fused_fft routes with the folded pad and crop: {count} cases "
          "(modes full, same, valid; 2-D and 1-D) passed")
    return count


def signal_path(counters, torch, img, imgc):
    """Phase 4, signal: the FFT-domain calls of ``bench_suite.py:734-747``
    at full size, each held against scipy on the host (float64 inputs;
    5e-4 * max|ref|, the JAX suite's convolution tolerance) and each
    call's launches against its route: the FFT kernel's two passes per
    2-D transform, a rows launch and two strided launches (the strided
    entry's two steps), the input read unpadded and only the "same"
    window written (a 31x31 second operand is transformed by a direct
    DFT product), its rows entry for the 1-D overlap-add blocks, and
    torch.fft (no launch) where the gate declines the padded size; then
    the direct and polyphase calls (``bench_suite.py:748-757`` for the
    last two): convolve2d, correlate2d and wiener on the dense kernel B2
    (one launch per correlation), upfirdn and resample_poly in plain
    torch (no launch), run with cuDNN's TF32 allowed, PyTorch's default,
    so that a TF32 leak into them shows.  The counts are set to 0 just
    before this path and read just after.  Returns the path's launches,
    its inputs, and the times of the calls outside the FFT kernel."""
    import scipy.ndimage as sndi
    import scipy.signal as ss

    import cupyimg_tpu_torch.scipy.ndimage as ndi
    import cupyimg_tpu_torch.scipy.signal as sig

    rng = np.random.default_rng(2)
    k31 = rng.standard_normal((31, 31)).astype(np.float32)
    x1 = rng.standard_normal(1 << 22).astype(np.float32)
    h257 = rng.standard_normal(257).astype(np.float32)
    xh = rng.standard_normal(1 << 20).astype(np.float32)
    k9 = rng.standard_normal((9, 9)).astype(np.float32)
    h101 = rng.standard_normal(101).astype(np.float32)
    k31c, x1c, h257c, xhc, k9c, h101c = (torch.from_numpy(v).cuda()
                                         for v in (k31, x1, h257, xh, k9,
                                                   h101))
    spec = torch.fft.rfft2(imgc)  # (4096, 2049) complex64
    spec_np = spec.cpu().numpy()
    f64 = np.float64
    refs = {}

    def ref(key, fn):
        def get():
            if key not in refs:
                refs[key] = fn()
            return refs[key]
        return get

    conv2 = ref("conv2", lambda: ss.fftconvolve(
        img.astype(f64), k31.astype(f64), "same"))
    # correlation = convolution with the reversed kernel (odd sizes: the
    # same centring)
    corr2 = ref("corr2", lambda: ss.fftconvolve(
        img.astype(f64), k31[::-1, ::-1].astype(f64), "same"))
    conv1 = ref("conv1", lambda: ss.oaconvolve(
        x1.astype(f64), h257.astype(f64), "same"))
    corr1 = ref("corr1", lambda: ss.oaconvolve(
        x1.astype(f64), h257[::-1].astype(f64), "same"))
    # two rows passes and two strided passes of two steps each
    two_d = {"fft_rows": 2, "fft_strided": 4}
    for a, b in ((imgc, k31c), (x1c, h257c)):
        check(sig.choose_conv_method(a, b, "same") == "fft",
              "choose_conv_method: fft expected on the main path")
    # (label, {kernel: launches}, route, call, reference)
    path = [
        ("fftconvolve(4096^2 f32, 31x31, same)", two_d, "fused_fft",
         lambda: sig.fftconvolve(imgc, k31c, "same"), conv2),
        ("oaconvolve(4096^2 f32, 31x31, same)", {}, "torch.fft (108-sample "
         "blocks, 4126 columns: outside the gate)",
         lambda: sig.oaconvolve(imgc, k31c, "same"), conv2),
        ("oaconvolve(2^22 f32, 257 taps, same)", {"fft_rows": 3},
         "fused_fft (1215-sample blocks)",
         lambda: sig.oaconvolve(x1c, h257c, "same"), conv1),
        ("convolve(4096^2 f32, 31x31, same, auto)", two_d, "fused_fft",
         lambda: sig.convolve(imgc, k31c, "same"), conv2),
        ("correlate(4096^2 f32, 31x31, same, auto)", two_d, "fused_fft",
         lambda: sig.correlate(imgc, k31c, "same"), corr2),
        ("convolve(2^22 f32, 257 taps, same, auto)", {}, "torch.fft "
         "(n = 4,194,560: outside the gate)",
         lambda: sig.convolve(x1c, h257c, "same"), conv1),
        ("correlate(2^22 f32, 257 taps, same, auto)", {}, "torch.fft "
         "(n = 4,194,560: outside the gate)",
         lambda: sig.correlate(x1c, h257c, "same"), corr1),
        ("fourier_gaussian(rfft2 4096^2 c64, 3)", {}, "plain torch",
         lambda: ndi.fourier_gaussian(spec, 3.0, n=4096),
         lambda: sndi.fourier_gaussian(spec_np, 3.0, n=4096)),
        ("fourier_ellipsoid(rfft2 4096^2 c64, 9)", {}, "plain torch",
         lambda: ndi.fourier_ellipsoid(spec, 9.0, n=4096),
         lambda: sndi.fourier_ellipsoid(spec_np, 9.0, n=4096)),
        ("hilbert(2^20 f32)", {}, "plain torch (torch.fft)",
         lambda: sig.hilbert(xhc), lambda: ss.hilbert(xh.astype(f64))),
        ("resample(2^20 f32, 699050)", {}, "plain torch (torch.fft)",
         lambda: sig.resample(xhc, 699050),
         lambda: ss.resample(xh.astype(f64), 699050)),
    ]
    # the direct and polyphase calls, run with TF32 allowed (index 11 on)
    b2 = "fused_dense_correlate"
    path += [
        ("convolve2d(4096^2 f32, 31x31, same)", {b2: 1},
         "fused_dense (B2), padded by the fill",
         lambda: sig.convolve2d(imgc, k31c, "same"), conv2),
        ("correlate2d(4096^2 f32, 9x9, same, symm)", {b2: 1},
         "fused_dense (B2), padded symmetric",
         lambda: sig.correlate2d(imgc, k9c, "same", boundary="symm"),
         ref("corr9", lambda: sndi.correlate(img.astype(f64),
                                             k9.astype(f64),
                                             mode="reflect"))),
        ("wiener(4096^2 f32, 5)", {b2: 2},
         "fused_dense (B2) x2: local mean and mean square",
         lambda: sig.wiener(imgc, 5),
         ref("wiener", lambda: ss.wiener(img.astype(f64), 5))),
        ("upfirdn(101 taps, 2^20 f32, up 2, down 3)", {},
         "plain torch (one conv1d per phase, TF32 off)",
         lambda: sig.upfirdn(h101c, xhc, 2, 3),
         ref("upfirdn", lambda: ss.upfirdn(h101.astype(f64),
                                           xh.astype(f64), 2, 3))),
        ("resample_poly(2^20 f32, 2, 3)", {},
         "plain torch (upfirdn, firwin on the host)",
         lambda: sig.resample_poly(xhc, 2, 3),
         ref("resample_poly", lambda: ss.resample_poly(xh.astype(f64),
                                                       2, 3))),
    ]
    first_tf32 = 11

    def run_call(i, call):
        """``call()``, with cuDNN's TF32 allowed for the calls from
        ``first_tf32`` on (PyTorch's default; main() turned it off)."""
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = i >= first_tf32
        try:
            return call()
        finally:
            torch.backends.cudnn.allow_tf32 = saved

    for c in counters.values():
        c.launches = 0
    outputs = []
    for i, (label, _, _, run, _) in enumerate(path):
        before = {k: c.launches for k, c in counters.items()}
        y = run_call(i, run)
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        outputs.append((y, delta))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    for (label, plan, route, _, reference), (y, delta) in zip(path, outputs):
        want = {k: plan.get(k, 0) for k in counters}
        check(delta == want, f"{label} launched {delta}, not as planned: "
                             f"{plan}")
        exp = reference()
        want_dtype = torch.complex64 if np.iscomplexobj(exp) else (
            torch.float32)
        check(tuple(y.shape) == exp.shape and y.dtype == want_dtype,
              f"{label}: dtype/shape {y.dtype} {tuple(y.shape)}")
        got = y.cpu().numpy()
        check(np.isfinite(got).all(), f"{label}: non-finite output")
        err = float(np.abs(got - exp).max())
        tol = 5e-4 * float(np.abs(exp).max())
        check(err <= tol, f"{label}: disagrees with scipy ({err:.3e} > "
                          f"{tol:.3e})")
        planned = " ".join(f"{k} x{n}" for k, n in plan.items()) or route
        print(f"signal path {label:44s} {planned:46s} "
              f"max_abs_err vs scipy {err:.3e} (atol {tol:.1e})")
    print(f"signal path launches: {json.dumps(launches)}")
    for kernel in ("fft_rows", "fft_strided", b2):
        check(launches[kernel] >= 1,
              f"{kernel} not launched on the signal path")
    del outputs
    plain_rows = []
    for i in (1, 5, 7, 8, 9, 10) + tuple(range(first_tf32, len(path))):
        label, call = path[i][0], path[i][3]
        ms = median_ms(lambda i=i, call=call: run_call(i, call), n=10,
                       n_warmup=2)
        plain_rows.append({"case": label, "route": path[i][2], "ms": ms,
                           "b2_launches": path[i][1].get(b2, 0)})
        print(f"signal path timed {label:44s} {ms:10.3f} ms ({path[i][2]})")
    return launches, dict(k31c=k31c, x1c=x1c, h257c=h257c), plain_rows


def _levels_reference(levels):
    """skimage.measure.label's result by scipy: scipy.ndimage.label of
    each nonzero level (full connectivity), the components renumbered
    1..N in raster order of their first pixel."""
    import scipy.ndimage as sndi

    st = np.ones((3,) * levels.ndim, bool)
    parts = []  # (first flat index of each component, level, its labels)
    for v in np.unique(levels[levels != 0]):
        lab, n = sndi.label(levels == v, st)
        _, first = np.unique(lab.ravel(), return_index=True)
        parts.append((first[1:], lab, n))
    order = np.argsort(np.concatenate([f for f, _, _ in parts]),
                       kind="stable")
    number = np.empty(order.size, np.int64)
    number[order] = np.arange(1, order.size + 1)
    out = np.zeros(levels.shape, np.int64)
    start = 0
    for _, lab, n in parts:
        table = np.concatenate([[0], number[start:start + n]])
        out = np.where(lab > 0, table[lab], out)
        start += n
    return out, order.size


def _fixpoint_reference(seed, mask):
    """Reconstruction by dilation on the host: scipy's 3x3 grey dilation
    and a minimum with the mask, iterated until nothing changes."""
    import scipy.ndimage as sndi

    rec = seed
    while True:
        new = np.minimum(sndi.grey_dilation(rec, size=(3, 3),
                                            mode="nearest"), mask)
        if np.array_equal(new, rec):
            return rec
        rec = new


def measurements_path(counters, torch, x2):
    """Phase 4, measurements: scipy.ndimage.label and the labeled
    reductions, skimage's small-object filters, reconstruction, convex
    hull and measure.label at full size, in plain torch on the card (no
    kernel of the port is on this path: every count must stay 0; the
    counts are set to 0 just before it and read just after).  Each call
    is held against scipy on the host: labels, numbering and counts,
    extrema, positions, medians, histograms, bounding boxes and masks
    exactly; the float64 sums, means, variances, deviations and centres
    of mass within 1e-10 of the largest reference value.  Prints the
    propagation sweeps of label and reconstruction, and times each call
    (median of 10 after 2 warm-ups).  Returns the calls' rows and the
    4096^2 label image."""
    import scipy.ndimage as sndi
    from scipy.spatial import ConvexHull

    import cupyimg_tpu_torch.scipy.ndimage as ndi
    import cupyimg_tpu_torch.skimage.measure as skmeasure
    import cupyimg_tpu_torch.skimage.morphology as skm
    from cupyimg_tpu_torch.scipy.ndimage import measurements as meas
    from cupyimg_tpu_torch.skimage.morphology import greyreconstruct

    rng = np.random.default_rng(3)
    f64 = np.float64
    b2 = _blobs((4096, 4096), 15, 0.5, rng)
    b3 = _blobs((256, 256, 256), 5, 0.5, rng)
    # distinct float32 values k / 2^24 (exact), so that no label ties at
    # its extremum and positions are unique
    vals = (rng.permutation(1 << 24) * 2.0 ** -24).astype(np.float32)
    vals = vals.reshape(4096, 4096)
    box3 = np.ones((3, 3, 3), bool)
    field = sndi.uniform_filter(rng.random((2048, 2048), dtype=np.float32),
                                9)
    levels = np.searchsorted(np.quantile(field, [0.25, 0.5, 0.75]),
                             field).astype(np.int32)
    del field
    pts = np.zeros(2048 * 2048, bool)
    pts[rng.choice(pts.size, 1000, replace=False)] = True
    pts = pts.reshape(2048, 2048)
    b2c, b3c, valsc, levelsc, ptsc = (torch.from_numpy(v).cuda()
                                      for v in (b2, b3, vals, levels, pts))
    x2c = torch.from_numpy(x2).cuda()
    seed2c = x2c - 0.1
    torch.cuda.synchronize()

    for c in counters.values():
        c.launches = 0
    meas.label.sweeps = 0
    lab2c, n2c = ndi.label(b2c)
    sweeps2 = meas.label.sweeps
    lab3c, n3c = ndi.label(b3c, box3)
    sweeps3 = meas.label.sweeps - sweeps2
    lab2 = lab2c.cpu().numpy()
    n2 = int(n2c)
    index = np.arange(1, n2 + 1)
    crop = np.ascontiguousarray(lab2[:1024, :1024])
    cropc = torch.from_numpy(crop).cuda()
    ten = np.linspace(1, n2, 10).astype(np.int64)
    greyreconstruct.reconstruction.sweeps = 0
    # (label, call); results checked below, each call's value kept
    calls = [
        ("label(4096^2 bool blobs)", lambda: ndi.label(b2c)),
        ("label(256^3 bool blobs, 3x3x3)", lambda: ndi.label(b3c, box3)),
        ("sum(4096^2 f32, labels, 1..N)",
         lambda: ndi.sum(valsc, lab2c, index)),
        ("mean(4096^2 f32, labels, 1..N)",
         lambda: ndi.mean(valsc, lab2c, index)),
        ("variance(4096^2 f32, labels, 1..N)",
         lambda: ndi.variance(valsc, lab2c, index)),
        ("standard_deviation(4096^2 f32, labels, 1..N)",
         lambda: ndi.standard_deviation(valsc, lab2c, index)),
        ("center_of_mass(4096^2 f32, labels, 1..N)",
         lambda: ndi.center_of_mass(valsc, lab2c, index)),
        ("minimum(4096^2 f32, labels, 1..N)",
         lambda: ndi.minimum(valsc, lab2c, index)),
        ("maximum(4096^2 f32, labels, 1..N)",
         lambda: ndi.maximum(valsc, lab2c, index)),
        ("minimum_position(4096^2 f32, labels, 1..N)",
         lambda: ndi.minimum_position(valsc, lab2c, index)),
        ("maximum_position(4096^2 f32, labels, 1..N)",
         lambda: ndi.maximum_position(valsc, lab2c, index)),
        ("extrema(4096^2 f32, labels, 1..N)",
         lambda: ndi.extrema(valsc, lab2c, index)),
        ("median(4096^2 f32, labels, 1..N)",
         lambda: ndi.median(valsc, lab2c, index)),
        ("histogram(4096^2 f32, 0, 1, 16, labels, 1..N)",
         lambda: ndi.histogram(valsc, 0, 1, 16, lab2c, index)),
        ("find_objects(4096^2 labels)", lambda: ndi.find_objects(lab2c)),
        ("value_indices(1024^2 labels)", lambda: ndi.value_indices(cropc)),
        ("labeled_comprehension(4096^2 f32, ten labels, np.ptp)",
         lambda: ndi.labeled_comprehension(valsc, lab2c, ten, np.ptp, f64,
                                           -1.0)),
        ("remove_small_objects(4096^2 bool blobs, 64)",
         lambda: skm.remove_small_objects(b2c, 64)),
        ("remove_small_holes(4096^2 bool blobs, 64)",
         lambda: skm.remove_small_holes(b2c, 64)),
        ("reconstruction(2048^2 f32 h-dome, seed = image - 0.1)",
         lambda: skm.reconstruction(seed2c, x2c)),
        ("convex_hull_image(2048^2, 1000 points)",
         lambda: skm.convex_hull_image(ptsc)),
        ("skimage.measure.label(2048^2 i32, 4 levels)",
         lambda: skmeasure.label(levelsc)),
    ]
    rec_sweeps = None
    results = {}
    for label, call in calls:
        if label.startswith("reconstruction"):
            greyreconstruct.reconstruction.sweeps = 0
            results[label] = call()
            rec_sweeps = greyreconstruct.reconstruction.sweeps
        else:
            results[label] = call()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    check(all(n == 0 for n in launches.values()),
          f"the measurements path launched a kernel: {launches}")

    def exact(label, got, ref):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        check(np.array_equal(np.asarray(got), np.asarray(ref)),
              f"{label}: differs from scipy")
        return "exact"

    def close(label, got, ref):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        got, ref = np.asarray(got, f64), np.asarray(ref, f64)
        check(got.shape == ref.shape, f"{label}: shape {got.shape}")
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        check(err <= 1e-10, f"{label}: disagrees with scipy ({err:.3e})")
        return f"{err:.3e} of max|ref| (tol 1e-10)"

    checks = {}
    ref2, rn2 = sndi.label(b2)
    check(lab2c.dtype == torch.int32 and n2c.dtype == torch.int32
          and n2c.ndim == 0 and n2c.is_cuda, "label: dtypes")
    check(n2 == rn2, f"label 4096^2: {n2} features, scipy {rn2}")
    checks[calls[0][0]] = exact(calls[0][0], lab2, ref2)
    ref3, rn3 = sndi.label(b3, box3)
    check(int(n3c) == rn3, f"label 256^3: {int(n3c)} features, scipy {rn3}")
    checks[calls[1][0]] = exact(calls[1][0], lab3c, ref3)
    del ref3, lab3c
    v64 = vals.astype(f64)
    for i, fn in ((2, "sum"), (3, "mean"), (4, "variance"),
                  (5, "standard_deviation"), (6, "center_of_mass")):
        checks[calls[i][0]] = close(calls[i][0], results[calls[i][0]],
                                    getattr(sndi, fn)(v64, lab2, index))
    ext = sndi.extrema(vals, lab2, index)
    for i, k in ((7, 0), (8, 1), (9, 2), (10, 3)):
        checks[calls[i][0]] = exact(calls[i][0], results[calls[i][0]],
                                    ext[k])
    got = results[calls[11][0]]
    for k in range(4):
        exact(calls[11][0], got[k], ext[k])
    checks[calls[11][0]] = "exact"
    checks[calls[12][0]] = exact(calls[12][0], results[calls[12][0]],
                                 sndi.median(vals, lab2, index))
    hist = results[calls[13][0]]
    checks[calls[13][0]] = exact(
        calls[13][0], torch.stack(hist),
        np.stack(sndi.histogram(vals, 0, 1, 16, lab2, index)))
    check(results[calls[14][0]] == sndi.find_objects(lab2),
          "find_objects differs from scipy")
    checks[calls[14][0]] = "exact"
    got, ref = results[calls[15][0]], sndi.value_indices(crop)
    check(list(got) == list(ref) and all(
        all(np.array_equal(a, b) for a, b in zip(got[k], ref[k]))
        for k in ref), "value_indices differs from scipy")
    checks[calls[15][0]] = "exact"
    checks[calls[16][0]] = exact(
        calls[16][0], results[calls[16][0]],
        sndi.labeled_comprehension(vals, lab2, ten, np.ptp, f64, -1.0))
    sizes = np.bincount(ref2.ravel())
    checks[calls[17][0]] = exact(calls[17][0], results[calls[17][0]],
                                 b2 & (sizes[ref2] >= 64))
    holes, _ = sndi.label(~b2)
    hsizes = np.bincount(holes.ravel())
    checks[calls[18][0]] = exact(calls[18][0], results[calls[18][0]],
                                 ~(~b2 & (hsizes[holes] >= 64)))
    del holes, ref2
    checks[calls[19][0]] = exact(calls[19][0], results[calls[19][0]],
                                 _fixpoint_reference(x2 - np.float32(0.1),
                                                     x2))
    corners = (np.argwhere(pts).astype(f64)[:, None, :] + np.array(
        [[-0.5, 0], [0.5, 0], [0, -0.5], [0, 0.5]])).reshape(-1, 2)
    eq = ConvexHull(corners).equations
    rr = np.arange(2048, dtype=f64)[:, None]
    cc = np.arange(2048, dtype=f64)[None, :]
    hull = np.ones((2048, 2048), bool)
    for a0, a1, b in eq:  # the port's order of operations, in float64
        hull &= (b + rr * a0) + cc * a1 < 1e-10
    checks[calls[20][0]] = exact(calls[20][0], results[calls[20][0]], hull)
    lev_ref, lev_n = _levels_reference(levels)
    got = results[calls[21][0]]
    check(got.dtype == torch.int32 and int(got.max()) == lev_n,
          f"measure.label: {int(got.max())} labels, reference {lev_n}")
    checks[calls[21][0]] = exact(calls[21][0], got, lev_ref)
    del results, lev_ref
    print(f"measurements path label 4096^2: {n2} features in {sweeps2} "
          f"sweeps; 256^3 (3x3x3): {rn3} features in {sweeps3} sweeps; "
          f"reconstruction 2048^2: {rec_sweeps} sweeps")
    print(f"measurements path launches: {json.dumps(launches)}")
    rows = []
    for label, call in calls:
        ms = median_ms(call, n=10, n_warmup=2)
        rows.append({"case": label, "route": "plain torch", "ms": ms,
                     "check": checks[label]})
        print(f"measurements path {label:54s} {ms:10.3f} ms (plain torch) "
              f"vs scipy: {checks[label]}")
    rows[0]["sweeps"], rows[1]["sweeps"] = sweeps2, sweeps3
    rows[19]["sweeps"] = rec_sweeps
    return rows, lab2c


def _spacing_reference(pts, spacing):
    """ensure_spacing's definition in numpy: a point survives unless an
    earlier survivor lies within ``spacing`` (Chebyshev distance)."""
    keep = []
    for i, q in enumerate(pts):
        if not keep or np.abs(pts[keep] - q).max(axis=-1).min() >= spacing:
            keep.append(i)
    return pts[keep]


def base_path(counters, torch, lab2c):
    """Phase 4, base path: the gap-fillers (``numpy``, ``scipy.special``,
    ``scipy.stats``, ``scipy.interpolate``), skimage's base
    (``skimage.util``, ``skimage._shared.coord``) and the interpolation
    of more than 3 axes, at full size in plain torch on the card (no
    kernel of the port is on this path: every count must stay 0; the
    counts are set to 0 just before it and read just after).  Each call
    is held on the host against numpy/scipy where they have the function
    (histograms, counts, the quantiles, map_array, the integer
    convolutions and the nearest interpolation exactly; the rest within
    the tolerance it prints), the skimage conversions and ``invert``
    against the port's own CPU result of the same call, exactly, and
    ``random_noise`` by its statistics (5-sigma bands).  Times each call
    (median of 10 after 2 warm-ups).  Returns the calls' rows."""
    import scipy.ndimage as sndi
    import scipy.special as sps
    import scipy.stats as spst
    from numpy.lib.stride_tricks import sliding_window_view
    from scipy.interpolate import RegularGridInterpolator as SpRGI

    import cupyimg_tpu_torch.numpy as tnp
    import cupyimg_tpu_torch.scipy.ndimage as ndi
    import cupyimg_tpu_torch.scipy.special as tsp
    import cupyimg_tpu_torch.scipy.stats as tst
    import cupyimg_tpu_torch.skimage.util as tutil
    from cupyimg_tpu_torch.scipy.interpolate import RegularGridInterpolator
    from cupyimg_tpu_torch.skimage._shared.coord import ensure_spacing

    rng = np.random.default_rng(11)
    f64 = np.float64

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    img = rng.random((4096, 4096), dtype=np.float32)
    w32 = rng.random((4096, 4096), dtype=np.float32)
    wi32 = rng.integers(0, 100, (4096, 4096)).astype(np.int32)
    xy = rng.standard_normal((2, 1 << 22))
    s3 = rng.random((1 << 20, 3))
    vol = rng.random((256, 256, 256), dtype=np.float32)
    sig = rng.random(1 << 20, dtype=np.float32)
    taps = rng.standard_normal(101).astype(np.float32)
    sig_i = rng.integers(0, 1 << 20, 1 << 20).astype(np.int32)
    taps_i = rng.integers(-(1 << 12), 1 << 12, 101).astype(np.int32)
    sig_u8 = rng.integers(0, 256, 1 << 20).astype(np.uint8)
    taps_u8 = rng.integers(0, 256, 101).astype(np.uint8)
    sig_i16 = rng.integers(-3000, 3000, 1 << 20).astype(np.int16)
    taps_i16 = rng.integers(-300, 300, 101).astype(np.int16)
    qimg = rng.random((4100, 4100), dtype=np.float32)  # > 2^24 elements
    qs = np.array([0.1, 0.5, 0.99])
    sx = (rng.random((4096, 4096), dtype=np.float32) * 4 - 1)
    sy = (rng.random((4096, 4096), dtype=np.float32) * 4 - 1)
    sx[::7, ::5] = 0  # the x = 0 branches
    pk = rng.random(1 << 20)
    grid = [np.sort(rng.random(256)) * (k + 1) for k in range(3)]
    gvals = rng.random((256, 256, 256))
    lo = np.array([g[0] for g in grid])
    hi = np.array([g[-1] for g in grid])
    xi = lo + (hi - lo) * rng.random((1 << 20, 3))
    spacing = np.sort(rng.random(256)) * 3 + 0.1
    u16 = rng.integers(0, 65536, (4096, 4096)).astype(np.uint16)
    i16 = rng.integers(-32768, 32768, (4096, 4096)).astype(np.int16)
    u8 = rng.integers(0, 256, (4096, 4096)).astype(np.uint8)
    f32 = rng.random((4096, 4096), dtype=np.float32) * 2 - 1
    b = rng.random((4096, 4096)) > 0.5
    half = np.full((4096, 4096), 0.5, np.float32)
    n_lab = int(lab2c.max())
    lut_out = rng.random(n_lab + 1).astype(np.float32)
    pts = rng.integers(0, 4096, (2000, 2)).astype(np.float32)
    v4 = rng.random((32, 32, 32, 32), dtype=np.float32)
    c4 = (rng.random((4, 1 << 18)) * 31).astype(np.float32)
    u64 = rng.integers(0, 1 << 64, 1 << 20, dtype=np.uint64)
    (imgc_, w32c, wi32c, xyc, s3c, volc, sigc, taps_c, sig_ic, taps_ic,
     sig_u8c, taps_u8c, sig_i16c, taps_i16c, qimgc, sxc, syc, pkc, gvalsc,
     xic, spacingc, u16c, i16c, u8c, f32c, bc, halfc, lutc, ptsc, v4c,
     c4c, u64c) = (dev(a) for a in (
         img, w32, wi32, xy, s3, vol, sig, taps, sig_i, taps_i, sig_u8,
         taps_u8, sig_i16, taps_i16, qimg, sx, sy, pk, gvals, xi, spacing,
         u16, i16, u8, f32, b, half, lut_out, pts, v4, c4, u64))
    keys_in = torch.arange(1, n_lab + 1, device="cuda", dtype=torch.int32)
    rgi_lin = RegularGridInterpolator(grid, gvalsc)
    rgi_near = RegularGridInterpolator(grid, gvalsc, method="nearest")
    torch.cuda.synchronize()

    def host(v):
        if isinstance(v, torch.Tensor):
            return v.cpu().numpy()
        if isinstance(v, (list, tuple)):
            return [host(u) for u in v]
        return v

    def exact(label, got, ref):
        got, ref = host(got), ref
        if isinstance(ref, (list, tuple)):
            for g, r in zip(got, ref):
                exact(label, g, r)
            return "exact"
        check(np.asarray(got).dtype == np.asarray(ref).dtype,
              f"{label}: dtype {np.asarray(got).dtype}, "
              f"reference {np.asarray(ref).dtype}")
        check(np.array_equal(got, ref, equal_nan=True),
              f"{label}: differs from its reference")
        return "exact"

    def close(label, got, ref, tol, what="max|ref|"):
        got = np.asarray(host(got), f64)
        ref = np.asarray(ref, f64)
        check(got.shape == ref.shape, f"{label}: shape {got.shape}")
        fin = np.isfinite(ref)
        check(np.array_equal(np.isnan(got), np.isnan(ref))
              and np.array_equal(got[np.isinf(ref)], ref[np.isinf(ref)]),
              f"{label}: NaN or inf out of place")
        scale = np.abs(ref[fin]).max() if fin.any() else 1.0
        err = float(np.abs(got[fin] - ref[fin]).max() / scale) if (
            fin.any()) else 0.0
        check(err <= tol, f"{label}: {err:.3e} of {what} (tol {tol:.0e})")
        return f"{err:.3e} of {what} (tol {tol:.0e})"

    def rel(label, got, ref, tol, floor=1e-300):
        """Relative error, below ``floor`` absolute (inf and NaN in
        place)."""
        got = np.atleast_1d(np.asarray(host(got), f64))
        ref = np.atleast_1d(np.asarray(ref, f64))
        check(got.shape == ref.shape, f"{label}: shape {got.shape}")
        with np.errstate(all="ignore"):
            err = np.abs(got - ref) / np.maximum(np.abs(ref), floor)
        err[(got == ref) | (np.isnan(got) & np.isnan(ref))] = 0
        e = float(err.max())
        check(e <= tol, f"{label}: {e:.3e} relative (tol {tol:.0e})")
        return f"{e:.3e} relative (tol {tol:.0e})"

    # the checks: each takes (label, result) and returns its message; a
    # reference is computed on the host only when its check runs
    def equals(ref_fn):
        return lambda label, got: exact(label, got, ref_fn())

    def hist_f32_weights(label, got):
        h, e = got
        nh, ne = np.histogram(img, 256, weights=w32)
        exact(label, e, ne)
        check(h.dtype == torch.float32, "histogram: float32 weights' dtype")
        # numpy sums the weights of each 65536-sample block in float64 and
        # the blocks' float32 partial sums in float32; the port sums in
        # float64
        return rel(label, h, nh, 1e-5)

    def hist_int64(ref_fn):
        """Counts in int64 (numpy: integer weights in their own dtype,
        histogramdd in float64; ROADMAP C), the edges exactly."""
        def verify(label, got):
            ref = ref_fn()
            exact(label, got[1:], ref[1:])
            return exact(label, got[0], ref[0].astype(np.int64))
        return verify

    def gradient_of(*args, **kw):
        def verify(label, got):
            ref = np.gradient(vol, *args, **kw)
            got, ref = ([v] if isinstance(v, np.ndarray | torch.Tensor)
                        else v for v in (got, ref))
            return [close(label, g, r, 1e-5) for g, r in zip(got, ref)][0]
        return verify

    def f32_conv(fn, mode):
        def verify(label, got):
            check(got.dtype == torch.float32, f"{label}: dtype")
            return close(label, got, getattr(np, fn)(sig, taps, mode), 1e-5)
        return verify

    def special(fn, *args):
        def verify(label, got):
            check(got.dtype == torch.float32, f"{label}: dtype")
            with np.errstate(all="ignore"):
                ref = fn(*args)
            # float64 inside, one rounding to float32, as scipy's loops;
            # kl_div cancels where x is near y, hence the floor
            return rel(label, got, ref, 1e-6, floor=1e-6)
        return verify

    def gaussian(label, g):
        n = img.size
        check(torch.equal(g, tutil.random_noise(halfc, seed=3)),
              "random_noise: one seed, two outputs")
        gm, gv = float(g.double().mean()), float(g.double().var())
        check(abs(gm - 0.5) < 5 * np.sqrt(0.01 / n)
              and abs(gv - 0.01) < 5 * 0.01 * np.sqrt(2 / n),
              f"random_noise gaussian: mean {gm}, variance {gv}")
        return (f"mean {gm:.6f} var {gv:.6f} within 5 sigma, same seed "
                f"same output")

    def salt_and_pepper(label, got):
        n = img.size
        sp_ = host(got)
        changed = sp_ != img
        nc = int(changed.sum())
        salt = int((changed & (sp_ == 1.0)).sum())
        check(abs(nc - 0.1 * n) < 5 * np.sqrt(n * 0.09)
              and abs(salt - nc / 2) < 5 * np.sqrt(nc / 4)
              and salt + int((changed & (sp_ == 0.0)).sum()) == nc,
              f"random_noise s&p: {nc} changed, {salt} salt")
        return f"{nc} flipped, {salt} salt: within 5 sigma"

    def poisson(label, got):
        po = host(got)
        x = u8.astype(f64) / 255
        vals = 2 ** np.ceil(np.log2(len(np.unique(u8))))
        check(np.array_equal(po * vals, np.round(po * vals)),
              "random_noise poisson: not multiples of 1 / vals")
        pm = float(po.mean())
        check(abs(pm - x.mean()) < 5 * np.sqrt(x.mean() / vals / img.size),
              f"random_noise poisson: mean {pm}")
        return f"multiples of 1/{vals:.0f}, mean {pm:.6f} within 5 sigma"

    def mapped(label, got):
        lab2 = host(lab2c)
        return exact(label, got, np.where(lab2 > 0, lut_out[lab2], 0)
                     .astype(np.float32))

    def blocks(label, vb):
        check(vb.shape == (64, 64, 64, 64)
              and vb.data_ptr() == imgc_.data_ptr(),
              "view_as_blocks: not a view of its shape")
        return exact(label, vb,
                     img.reshape(64, 64, 64, 64).transpose(0, 2, 1, 3))

    def windows(label, vw):
        ref = sliding_window_view(img, (7, 7))[::4, ::4]
        check(vw.shape == ref.shape and vw.data_ptr() == imgc_.data_ptr(),
              "view_as_windows: not a view of its shape")
        pick = (slice(None, None, 97), slice(None, None, 89))
        return exact(label, vw[pick], ref[pick])

    def scipy_4d(ref_fn, tol):
        def verify(label, got):
            check(got.is_cuda and got.dtype == torch.float32,
                  f"{label}: device or dtype")
            return close(label, got, ref_fn(v4.astype(f64)), tol)
        return verify

    conversions = [(f, name, xc) for f in (
        "img_as_float32", "img_as_float64", "img_as_float", "img_as_uint",
        "img_as_int", "img_as_ubyte", "img_as_bool")
        for name, xc in (("uint8", u8c), ("uint16", u16c), ("int16", i16c),
                         ("float32", f32c), ("bool", bc))]
    # (label, call, check)
    calls = [
        ("histogram(4096^2 f32, 256)",
         lambda: tnp.histogram(imgc_, 256),
         equals(lambda: np.histogram(img, 256))),
        ("histogram(4096^2 f32, 256, f32 weights)",
         lambda: tnp.histogram(imgc_, 256, weights=w32c), hist_f32_weights),
        ("histogram(4096^2 f32, 256, i32 weights)",
         lambda: tnp.histogram(imgc_, 256, weights=wi32c),
         hist_int64(lambda: np.histogram(img, 256, weights=wi32))),
        ("histogram(2^20 u64 up to 2^64 - 1, 64)",
         lambda: tnp.histogram(u64c, 64),
         equals(lambda: np.histogram(u64, 64))),
        ("histogram2d(2^22 points, 256x256)",
         lambda: tnp.histogram2d(xyc[0], xyc[1], 256),
         hist_int64(lambda: np.histogram2d(xy[0], xy[1], 256))),
        ("histogramdd(2^20 x 3, 32^3)",
         lambda: tnp.histogramdd(s3c, 32),
         hist_int64(lambda: np.histogramdd(s3, 32))),
        ("gradient(256^3 f32, edge_order=1)",
         lambda: tnp.gradient(volc), gradient_of()),
        ("gradient(256^3 f32, edge_order=2)",
         lambda: tnp.gradient(volc, edge_order=2),
         gradient_of(edge_order=2)),
        ("gradient(256^3 f32, axis 2 spacing array)",
         lambda: tnp.gradient(volc, spacingc, axis=2),
         gradient_of(spacing, axis=2)),
    ] + [
        (f"{fn}(2^20 f32, 101, {mode})",
         (lambda fn=fn, mode=mode: getattr(tnp, fn)(sigc, taps_c, mode)),
         f32_conv(fn, mode))
        for fn in ("convolve", "correlate")
        for mode in ("full", "same", "valid")
    ] + [
        ("convolve(2^20 i32, 101 i32, full; wraps)",
         lambda: tnp.convolve(sig_ic, taps_ic),
         equals(lambda: np.convolve(sig_i, taps_i))),
        ("correlate(2^20 u8, 101 u8, same; wraps)",
         lambda: tnp.correlate(sig_u8c, taps_u8c, "same"),
         equals(lambda: np.correlate(sig_u8, taps_u8, "same"))),
        ("convolve(2^20 i16, 101 i16, valid; wraps)",
         lambda: tnp.convolve(sig_i16c, taps_i16c, "valid"),
         equals(lambda: np.convolve(sig_i16, taps_i16, "valid"))),
        ("quantile(4100^2 f32, (0.1, 0.5, 0.99))",
         lambda: tnp.quantile(qimgc, qs),
         equals(lambda: np.quantile(qimg, qs))),
        ("entr(4096^2 f32)", lambda: tsp.entr(sxc), special(sps.entr, sx)),
        ("kl_div(4096^2 f32)", lambda: tsp.kl_div(sxc, syc),
         special(sps.kl_div, sx, sy)),
        ("rel_entr(4096^2 f32)", lambda: tsp.rel_entr(sxc, syc),
         special(sps.rel_entr, sx, sy)),
        ("huber(4096^2 f32)", lambda: tsp.huber(syc, sxc),
         special(sps.huber, sy, sx)),
        ("pseudo_huber(4096^2 f32)", lambda: tsp.pseudo_huber(syc, sxc),
         special(sps.pseudo_huber, sy, sx)),
        ("entropy(2^20 f64)", lambda: tst.entropy(pkc, base=2),
         lambda label, got: rel(label, got, spst.entropy(pk, base=2),
                                1e-10)),
        ("RegularGridInterpolator(256^3, 2^20 points, linear)",
         lambda: rgi_lin(xic),
         lambda label, got: close(label, got, SpRGI(grid, gvals)(xi),
                                  1e-12)),
        ("RegularGridInterpolator(256^3, 2^20 points, nearest)",
         lambda: rgi_near(xic),
         equals(lambda: SpRGI(grid, gvals, method="nearest")(xi))),
    ] + [
        # the port's own CPU result of the same call: no skimage on the card
        (f"{f}(4096^2 {name})",
         (lambda f=f, xc=xc: getattr(tutil, f)(xc)),
         equals(lambda f=f, xc=xc: host(getattr(tutil, f)(xc.cpu()))))
        for f, name, xc in conversions
    ] + [
        ("invert(4096^2 u8)", lambda: tutil.invert(u8c),
         equals(lambda: host(tutil.invert(u8c.cpu())))),
        ("invert(4096^2 f32)", lambda: tutil.invert(f32c),
         equals(lambda: host(tutil.invert(f32c.cpu())))),
        ("random_noise(4096^2 f32 0.5, gaussian)",
         lambda: tutil.random_noise(halfc, seed=3), gaussian),
        ("random_noise(4096^2 f32, s&p 0.1)",
         lambda: tutil.random_noise(imgc_, "s&p", seed=3, amount=0.1),
         salt_and_pepper),
        ("random_noise(4096^2 u8, poisson)",
         lambda: tutil.random_noise(u8c, "poisson", seed=3, clip=False),
         poisson),
        ("map_array(4096^2 labels, 1..N)",
         lambda: tutil.map_array(lab2c, keys_in, lutc[1:]), mapped),
        ("view_as_blocks(4096^2 f32, 64x64)",
         lambda: tutil.view_as_blocks(imgc_, (64, 64)), blocks),
        ("view_as_windows(4096^2 f32, 7x7, step 4)",
         lambda: tutil.view_as_windows(imgc_, (7, 7), step=4), windows),
        ("ensure_spacing(2000 points, 30)",
         lambda: ensure_spacing(ptsc, 30),
         equals(lambda: _spacing_reference(pts, 30))),
        ("map_coordinates(32^4 f32, 2^18 points, order=1)",
         lambda: ndi.map_coordinates(v4c, c4c, order=1),
         scipy_4d(lambda v: sndi.map_coordinates(v, c4, order=1), 1e-5)),
        ("map_coordinates(32^4 f32, 2^18 points, order=3)",
         lambda: ndi.map_coordinates(v4c, c4c, order=3),
         scipy_4d(lambda v: sndi.map_coordinates(v, c4, order=3),
                  coef_tol(3, 4))),
        ("shift(32^4 f32, (0.5, -1.25, 0, 2.5), order=3)",
         lambda: ndi.shift(v4c, (0.5, -1.25, 0, 2.5)),
         scipy_4d(lambda v: sndi.shift(v, (0.5, -1.25, 0, 2.5)),
                  coef_tol(3, 4))),
    ]
    for c in counters.values():
        c.launches = 0
    results = {label: call() for label, call, _ in calls}
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    check(all(n == 0 for n in launches.values()),
          f"the base path launched a kernel: {launches}")
    checks = {label: verify(label, results.pop(label))
              for label, _, verify in calls}
    print(f"base path launches: {json.dumps(launches)}")
    rows = []
    for label, call, _ in calls:
        ms = median_ms(call, n=10, n_warmup=2)
        rows.append({"case": label, "route": "plain torch", "ms": ms,
                     "check": checks[label]})
        print(f"base path {label:54s} {ms:10.3f} ms (plain torch) "
              f"vs reference: {checks[label]}")
    return rows


def fft_bound(numel, n, in_bytes, out_bytes, mul_bytes=0):
    """(bound_ms, bound_by) of one FFT pass over ``numel`` points along
    an axis of ``n``: one read of each operand and one write at
    PEAK_BYTES, against 5 * numel * log2(n) flops at PEAK_FP32 (a count
    of the transform's work, whatever the algorithm)."""
    t_bytes = numel * (in_bytes + out_bytes + mul_bytes) / PEAK_BYTES
    t_ops = 5.0 * numel * np.log2(n) / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


def fft_rows_phase5(ff, torch, rows, imgc, inputs):
    """Phase 5, B4/B5: each pass of the main path's transforms at its
    shape (fftconvolve 4096^2 31x31: fshape 4320^2; oaconvolve 2^22 with
    257 taps: 4374 blocks of 1215), held against its plain version,
    with cuFFT (torch.fft) along the same axis of the same tensor as the
    yardstick (a product-fused pass against the multiply plus the
    transform, labelled composite); then the end-to-end fftconvolve
    against torch.fft.rfft2 -> product -> irfft2 at the same fshape, and
    the direct and fft times of the main-path convolutions.  Returns the
    labels of the pass rows and the end-to-end and method rows."""
    import cupyimg_tpu_torch.scipy.signal as sig
    from cupyimg_tpu_torch.scipy.signal import signaltools as st

    k31c, x1c, h257c = inputs["k31c"], inputs["x1c"], inputs["h257c"]
    n0 = 4320
    xpad = st._zero_pad(imgc, [(0, n0 - 4096)] * 2)
    big = xpad.numel()
    F1 = ff.fft_rows(xpad)
    F = ff.fft_strided(F1.reshape(1, n0, n0))
    K = ff.fft2(k31c, s=(n0, n0)).reshape(1, n0, n0)
    G = ff.fft_strided(F, inverse=True, mul=K).reshape(n0, n0)
    fwd = lambda ref: 5e-5 * float(ref.abs().max())  # noqa: E731
    inv = lambda ref: 1e-4 * float(ref.abs().max())  # noqa: E731
    labels = []

    def row(label, launch, plain, x, bound_ms_by, atol, library, lib_call,
            kernel):
        before = ff.fft_rows.launches + ff.fft_strided.launches
        launch()
        per_call = ff.fft_rows.launches + ff.fft_strided.launches - before
        rows[label] = time_row(label, launch, plain, x, bound_ms_by, atol,
                               library, lib_call, n_plain=5, kernel=kernel,
                               per_call=per_call)
        rows[label]["launches_per_call"] = per_call
        labels.append(label)

    s = 1.0 / (n0 * n0)
    row("fused_fft rows forward, real input 4320^2 (fftconvolve pass 1)",
        lambda: ff.fft_rows(xpad), lambda: ff.fused_fft_ref(xpad, "rows"),
        xpad, fft_bound(big, n0, 4, 8), fwd,
        (lambda: torch.fft.fft(xpad, dim=-1), fwd(F1)),
        "cuFFT: torch.fft.fft(dim=-1) of the same float32 tensor",
        "::fft_")
    row("fused_fft strided forward 4320^2 c64 (fftconvolve pass 2)",
        lambda: ff.fft_strided(F1.reshape(1, n0, n0)),
        lambda: ff.fused_fft_ref(F1.reshape(1, n0, n0), "strided"), F1,
        fft_bound(big, n0, 8, 8), fwd,
        (lambda: torch.fft.fft(F1.reshape(1, n0, n0), dim=1), fwd(F)),
        "cuFFT: torch.fft.fft(dim=1) of the same complex64 tensor",
        "::fft_")
    row("fused_fft strided inverse with the spectrum product 4320^2 "
        "(fftconvolve pass 3)",
        lambda: ff.fft_strided(F, inverse=True, mul=K),
        lambda: ff.fused_fft_ref(F, "strided", inverse=True, mul=K), F,
        fft_bound(big, n0, 8, 8, 8), inv,
        (lambda: torch.fft.ifft(F * K, dim=1, norm="forward"), inv(G)),
        "composite: F * K, then cuFFT torch.fft.ifft(dim=1, "
        "norm='forward')", "::fft_")
    row("fused_fft rows inverse, real output, scaled 4320^2 "
        "(fftconvolve pass 4)",
        lambda: ff.fft_rows(G, inverse=True, real_out=True, scale=s),
        lambda: ff.fused_fft_ref(G, "rows", inverse=True, real_out=True,
                                 scale=s), G,
        fft_bound(big, n0, 8, 4), inv,
        (lambda: torch.fft.ifft(G, dim=-1).real, None),
        "composite: cuFFT torch.fft.ifft(dim=-1), then the real part "
        "(timed only: 1/n0 where the pass scales by 1/(n0*n1))",
        "::fft_")
    del F, G
    # the main path's passes, the pad and the crop folded in: 4096^2 read,
    # 4320-point transforms, the "same" window (15, 4096) written
    m0, o0 = 4096, 15
    win = (o0, m0)
    P1 = ff.fft_rows(imgc, n=n0)
    P2 = ff.fft_strided(P1.reshape(1, m0, n0), n=n0)
    P3 = ff.fft_strided(P2, inverse=True, mul=K, window=win)
    row("fused_fft rows forward, real input 4096^2 at 4320, pad folded "
        "(fftconvolve pass 1)", lambda: ff.fft_rows(imgc, n=n0),
        lambda: ff.fused_fft_ref(imgc, "rows", n=n0), imgc,
        fft_bound(m0 * n0, n0, 4 * m0 / n0, 8), fwd,
        (lambda: torch.fft.fft(imgc, n=n0, dim=-1), fwd(P1)),
        "cuFFT: torch.fft.fft(n=4320, dim=-1) of the same float32 tensor",
        "::fft_")
    row("fused_fft strided forward 4096 -> 4320 rows x 4320 c64, pad folded "
        "(fftconvolve pass 2)",
        lambda: ff.fft_strided(P1.reshape(1, m0, n0), n=n0),
        lambda: ff.fused_fft_ref(P1.reshape(1, m0, n0), "strided", n=n0),
        P1, fft_bound(big, n0, 8 * m0 / n0, 8), fwd,
        (lambda: torch.fft.fft(P1.reshape(1, m0, n0), n=n0, dim=1),
         fwd(P2)),
        "cuFFT: torch.fft.fft(n=4320, dim=1) of the same complex64 tensor",
        "::fft_")
    row("fused_fft strided inverse with the product, window 4096 rows "
        "(fftconvolve pass 3)",
        lambda: ff.fft_strided(P2, inverse=True, mul=K, window=win),
        lambda: ff.fused_fft_ref(P2, "strided", inverse=True, mul=K,
                                 window=win), P2,
        fft_bound(big, n0, 8, 8 * m0 / n0, 8), inv,
        (lambda: torch.fft.ifft(P2 * K, dim=1, norm="forward")[:, o0:o0 + m0],
         inv(P3)),
        "composite: P2 * K, cuFFT torch.fft.ifft(dim=1, norm='forward'), "
        "the window sliced", "::fft_")
    row("fused_fft rows inverse, real output, scaled, window 4096^2 "
        "(fftconvolve pass 4)",
        lambda: ff.fft_rows(P3.reshape(m0, n0), inverse=True, real_out=True,
                            scale=s, window=win),
        lambda: ff.fused_fft_ref(P3.reshape(m0, n0), "rows", inverse=True,
                                 real_out=True, scale=s, window=win), P3,
        fft_bound(m0 * n0, n0, 8, 4 * m0 / n0), inv,
        (lambda: torch.fft.ifft(P3.reshape(m0, n0), dim=-1).real[:, o0:o0 + m0],
         None),
        "composite: cuFFT torch.fft.ifft(dim=-1), the real part of the "
        "window (timed only: 1/n0 where the pass scales by 1/(n0*n1))",
        "::fft_")
    del P1, P2, P3
    nb, blk = 4374, 1215
    xb = st._zero_pad(st._zero_pad(x1c, [(0, nb * 959 - x1c.numel())])
                      .reshape(nb, 959), [(0, 0), (0, blk - 959)])
    Hb = ff.fft_rows(h257c.reshape(1, -1), n=blk)
    Xb = ff.fft_rows(xb)
    row("fused_fft rows forward, real input 4374 x 1215 (oaconvolve "
        "2^22 blocks)", lambda: ff.fft_rows(xb),
        lambda: ff.fused_fft_ref(xb, "rows"), xb,
        fft_bound(xb.numel(), blk, 4, 8), fwd,
        (lambda: torch.fft.fft(xb, dim=-1), fwd(Xb)),
        "cuFFT: torch.fft.fft(dim=-1) of the same float32 tensor",
        "::fft_")
    yb = ff.fft_rows(Xb, inverse=True, real_out=True, mul=Hb, scale=1 / blk)
    row("fused_fft rows inverse, broadcast product, real output 4374 x "
        "1215", lambda: ff.fft_rows(Xb, inverse=True, real_out=True,
                                    mul=Hb, scale=1 / blk),
        lambda: ff.fused_fft_ref(Xb, "rows", inverse=True, real_out=True,
                                 mul=Hb, scale=1 / blk), Xb,
        fft_bound(Xb.numel(), blk, 8, 4, 8), inv,
        (lambda: torch.fft.ifft(Xb * Hb, dim=-1).real, inv(yb)),
        "composite: Xb * Hb, then cuFFT torch.fft.ifft(dim=-1), real part",
        "::fft_")
    del xb, Xb, Hb, yb, xpad, F1, K
    torch.cuda.empty_cache()

    # end to end: the public call against cuFFT's real transforms
    port = sig.fftconvolve(imgc, k31c, "same")
    sl = (slice(15, 15 + 4096),) * 2

    def lib():
        fs = (n0, n0)
        return torch.fft.irfft2(torch.fft.rfft2(imgc, s=fs)
                                * torch.fft.rfft2(k31c, s=fs), s=fs)[sl]

    err = float((lib() - port).abs().max())
    tol = 5e-4 * float(port.abs().max())
    check(err <= tol, f"fftconvolve end to end vs torch.fft ({err:.3e})")
    e2e = {
        "case": "fftconvolve 4096^2 f32 31x31 same (end to end)",
        "route": "fused_fft: 2 + 2 passes, direct DFT of the 31x31 operand",
        "ms": median_ms(lambda: sig.fftconvolve(imgc, k31c, "same"), n=20),
        "library_ms": median_ms(lib, n=20),
        "library_call": "torch.fft.rfft2 of both operands at 4320^2, "
                        "product, irfft2 (cuFFT), cropped",
        "max_abs_err_vs_library": err,
    }
    print(f"end to end {e2e['case']}: {e2e['ms']:.3f} ms, torch.fft "
          f"{e2e['library_ms']:.3f} ms")
    methods = []
    for label, a, b in (("convolve 4096^2 f32 31x31 same", imgc, k31c),
                        ("convolve 2^22 f32 257 taps same", x1c, h257c)):
        entry = {"case": label, "auto": sig.choose_conv_method(a, b, "same")}
        for m in ("direct", "fft"):
            entry[f"{m}_ms"] = median_ms(
                lambda m=m: sig.convolve(a, b, "same", method=m), n=10,
                n_warmup=2)
        methods.append(entry)
        print(f"methods {label}: direct {entry['direct_ms']:.3f} ms, fft "
              f"{entry['fft_ms']:.3f} ms, auto picks {entry['auto']}")
    return labels, e2e, methods


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
    from cupyimg_tpu_torch.ops import fused_dense as fd
    from cupyimg_tpu_torch.ops import fused_fft as ff
    from cupyimg_tpu_torch.ops import fused_rank as fr
    from cupyimg_tpu_torch.ops import fused_separable as fs
    from cupyimg_tpu_torch.ops import iir
    from cupyimg_tpu_torch.ops import spline_gather as sg
    from cupyimg_tpu_torch.scipy.ndimage.filters import _gaussian_kernel1d

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for lib, sec in sorted(seconds.items(), key=lambda kv: kv[1]):
        print(f"build: {lib} done at {sec:.1f} s")
    for src in _build.SOURCES:
        for part in _build.parts(src):
            log = _build.library_path(src, part).with_suffix(".log")
            if not log.exists():
                continue
            text = log.read_text().strip()
            if part is None:
                print(text)
                continue
            # a part holds dozens of instances: their largest numbers
            regs = [int(v) for v in re.findall(r"Used (\d+) registers",
                                               text)]
            spills = [int(v) for v in re.findall(r"(\d+) bytes spill",
                                                 text)]
            print(f"ptxas {src} part {part}: {len(regs)} kernels, at most "
                  f"{max(regs, default=0)} registers and "
                  f"{max(spills, default=0)} bytes of spills")
    ptxas_lines(_build, fr)

    # -- phase 3: kernels vs plain versions ---------------------------------
    t0 = time.perf_counter()
    g25 = tuple(_gaussian_kernel1d(3.0, 0, 12)[::-1])
    separable_vs_plain(fs, torch, g25)
    minmax_vs_plain(fs, torch)
    dense_vs_plain(fd, torch)
    rank_vs_plain(fr, torch)
    rank_instances_vs_plain(fr, torch)
    spline_gather_vs_plain(sg, torch)
    gather_instances_vs_plain(sg, torch)
    prefilter_vs_plain(iir, torch)
    morph_vs_plain(fs, torch)
    fft_vs_plain(ff, torch)
    print(f"kernel-vs-plain: {time.perf_counter() - t0:.1f} s")

    # -- phase 4: the main path through the public API ----------------------
    rng = np.random.default_rng(0)
    x3 = rng.random((256, 256, 256), dtype=np.float32)
    x2 = rng.random((2048, 2048), dtype=np.float32)
    img = rng.random((4096, 4096), dtype=np.float32)
    img_i = rng.integers(-1000, 1001, (4096, 4096)).astype(np.int32)
    w9 = rng.standard_normal((9, 9))
    w333 = rng.standard_normal((3, 3, 3))
    cross = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
    xc3 = torch.from_numpy(x3).cuda()
    xc2 = torch.from_numpy(x2).cuda()
    imgc = torch.from_numpy(img).cuda()
    imgc_i = torch.from_numpy(img_i).cuda()
    torch.cuda.synchronize()
    # interpolation inputs: bench_suite.py's matrices and smooth warp
    mat = np.array([[0.9, 0.1], [-0.1, 0.9]], np.float32)
    r40 = np.deg2rad(40.0)
    rot40 = np.array([[np.cos(r40), np.sin(r40)],
                      [-np.sin(r40), np.cos(r40)]], np.float32)
    rr, cc = np.mgrid[0:2048, 0:2048].astype(np.float32)
    warp = np.stack([
        rr + 11.0 * np.sin(cc / 97.0) + 5.0 * np.cos(rr / 53.0),
        cc + 9.0 * np.cos(rr / 71.0) - 4.0 * np.sin(cc / 89.0),
    ])
    del rr, cc
    warpc = torch.from_numpy(warp).cuda()
    counters = {
        "fused_separable_correlate": fs.fused_separable_correlate,
        "fused_separable_minmax": fs.fused_separable_minmax,
        "fused_dense_correlate": fd.fused_dense_correlate,
        "fused_rank_filter": fr.fused_rank_filter,
        "spline_gather": sg,
    }
    f64 = np.float64
    gather = {"spline_gather": 1}

    def prefiltered(poles):
        return {"spline_gather": 1, "fused_separable_correlate": poles}

    # (label, kernel or {kernel: launches}, call, scipy reference, atol;
    # 0 = exact)
    main_path = [
        ("uniform_filter(256^3 f32, size=5)", "fused_separable_correlate",
         lambda: ndi.uniform_filter(xc3, size=5),
         lambda: sndi.uniform_filter(x3.astype(f64), size=5), 2e-6),
        ("gaussian_filter(2048^2 f32, sigma=3)", "fused_separable_correlate",
         lambda: ndi.gaussian_filter(xc2, sigma=3),
         lambda: sndi.gaussian_filter(x2.astype(f64), sigma=3), 2e-6),
        # sum|taps| = 2 * 4 * 4 for the derivative and two smoothing axes
        ("sobel(256^3 f32)", "fused_separable_correlate",
         lambda: ndi.sobel(xc3), lambda: sndi.sobel(x3.astype(f64)),
         1e-5 * 32),
        ("correlate(4096^2 f32, 9x9, float)", "fused_dense_correlate",
         lambda: ndi.correlate(imgc, w9, mode="reflect", dtype_mode="float"),
         lambda: sndi.correlate(img.astype(f64), w9, mode="reflect"),
         1e-5 * np.abs(w9).sum()),
        ("convolve(256^3 f32, 3x3x3, float)", "fused_dense_correlate",
         lambda: ndi.convolve(xc3, w333, dtype_mode="float"),
         lambda: sndi.convolve(x3.astype(f64), w333),
         1e-5 * np.abs(w333).sum()),
        ("minimum_filter(256^3 f32, 5)", "fused_separable_minmax",
         lambda: ndi.minimum_filter(xc3, 5),
         lambda: sndi.minimum_filter(x3, 5), 0),
        ("maximum_filter(4096^2 f32, 9)", "fused_separable_minmax",
         lambda: ndi.maximum_filter(imgc, 9),
         lambda: sndi.maximum_filter(img, 9), 0),
        ("median_filter(4096^2 f32, 5)", "fused_rank_filter",
         lambda: ndi.median_filter(imgc, 5),
         lambda: sndi.median_filter(img, 5), 0),
        ("percentile_filter(4096^2 f32, 30, 5)", "fused_rank_filter",
         lambda: ndi.percentile_filter(imgc, 30, size=5),
         lambda: sndi.percentile_filter(img, 30, size=5), 0),
        ("median_filter(256^3 f32, 3)", "fused_rank_filter",
         lambda: ndi.median_filter(xc3, 3),
         lambda: sndi.median_filter(x3, 3), 0),
        ("rank_filter(4096^2 i32, 2, cross)", "fused_rank_filter",
         lambda: ndi.rank_filter(imgc_i, 2, footprint=cross),
         lambda: sndi.rank_filter(img_i, 2, footprint=cross), 0),
        # interpolation: order 0 exactly (the coordinates are exact in
        # float64 for these float32 matrices), else within 1e-5 of the
        # inputs' range [0, 1), or of the spline coefficients' largest
        # possible magnitude where the call prefilters (coef_tol)
        ("affine_transform(4096^2 f32, order=0)", gather,
         lambda: ndi.affine_transform(imgc, mat, order=0, mode="nearest",
                                      prefilter=False),
         lambda: sndi.affine_transform(img, mat, order=0, mode="nearest",
                                       prefilter=False), 0),
        ("affine_transform(4096^2 f32, order=1)", gather,
         lambda: ndi.affine_transform(imgc, mat, order=1, mode="nearest",
                                      prefilter=False),
         lambda: sndi.affine_transform(img.astype(f64), mat, order=1,
                                       mode="nearest", prefilter=False),
         1e-5),
        ("affine_transform(4096^2 f32, order=3)", gather,
         lambda: ndi.affine_transform(imgc, mat, order=3, mode="nearest",
                                      prefilter=False),
         lambda: sndi.affine_transform(img.astype(f64), mat, order=3,
                                       mode="nearest", prefilter=False),
         1e-5),
        ("affine_transform(4096^2 f32, rot40, order=1)", gather,
         lambda: ndi.affine_transform(imgc, rot40, order=1, mode="nearest",
                                      prefilter=False),
         lambda: sndi.affine_transform(img.astype(f64), rot40, order=1,
                                       mode="nearest", prefilter=False),
         1e-5),
        ("rotate(256^3 f32, 17, axes=(1, 2), order=1)", gather,
         lambda: ndi.rotate(xc3, 17, axes=(1, 2), reshape=False, order=1,
                            mode="nearest", prefilter=False),
         lambda: sndi.rotate(x3.astype(f64), 17, axes=(1, 2), reshape=False,
                             order=1, mode="nearest", prefilter=False),
         1e-5),
        ("map_coordinates(2048^2 f32, warp, order=1)", gather,
         lambda: ndi.map_coordinates(xc2, warpc, order=1, mode="reflect"),
         lambda: sndi.map_coordinates(x2.astype(f64), warp, order=1,
                                      mode="reflect"), 1e-5),
        ("map_coordinates(2048^2 f32, warp, order=3)", prefiltered(1),
         lambda: ndi.map_coordinates(xc2, warpc, order=3, mode="reflect"),
         lambda: sndi.map_coordinates(x2.astype(f64), warp, order=3,
                                      mode="reflect"), coef_tol(3, 2)),
        ("shift(4096^2 f32, (2.3, -1.7), order=5)", prefiltered(2),
         lambda: ndi.shift(imgc, (2.3, -1.7), order=5, mode="reflect"),
         lambda: sndi.shift(img.astype(f64), (2.3, -1.7), order=5,
                            mode="reflect"), coef_tol(5, 2)),
        ("zoom(2048^2 f32, 2.0, order=3)", prefiltered(1),
         lambda: ndi.zoom(xc2, 2.0, order=3),
         lambda: sndi.zoom(x2.astype(f64), 2.0, order=3), coef_tol(3, 2)),
        ("spline_filter(4096^2 f32, order=3)",
         {"fused_separable_correlate": 1},
         lambda: ndi.spline_filter(imgc, order=3, output=np.float32),
         lambda: sndi.spline_filter(img.astype(f64), order=3),
         coef_tol(3, 2)),
    ]
    for c in counters.values():
        c.launches = 0
    outputs = []
    for label, kernel, run, _, _ in main_path:
        before = {k: c.launches for k, c in counters.items()}
        y = run()
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        outputs.append((y, delta))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    for (label, kernel, _, reference, tol), (y, delta) in zip(main_path,
                                                              outputs):
        if isinstance(kernel, str):
            kernel = {kernel: 1}
        want = {k: kernel.get(k, 0) for k in counters}
        check(delta == want,
              f"{label} launched {delta}, not as planned: {kernel}")
        exp = reference()
        # every call keeps its input's dtype
        want_dtype = torch.int32 if exp.dtype == np.int32 else torch.float32
        check(tuple(y.shape) == exp.shape and y.dtype == want_dtype,
              f"{label}: dtype/shape {y.dtype} {tuple(y.shape)}")
        got = y.cpu().numpy()
        check(np.isfinite(got).all(), f"{label}: non-finite output")
        if tol == 0:
            err = float(np.abs(got.astype(f64) - exp.astype(f64)).max())
            check(np.array_equal(got, exp),
                  f"{label}: differs from scipy.ndimage ({err:.3e})")
        else:
            err = float(np.abs(got - exp).max())
            check(err <= tol, f"{label}: disagrees with scipy.ndimage")
        planned = " ".join(f"{k} x{n}" for k, n in kernel.items())
        print(f"main path {label:45s} {planned:50s} "
              f"max_abs_err vs scipy {err:.3e} "
              f"({'exact' if tol == 0 else f'atol {tol:.1e}'})")
    print(f"main path launches: {json.dumps(launches)}")
    del outputs
    for kernel in counters:
        check(launches[kernel] >= 1, f"{kernel} not launched on the main path")
    morph_launches, plain_rows = morphology_path(
        fs, ndi, sndi, torch, x3, xc3, img, imgc, x2.shape)
    all_counters = dict(counters)
    all_counters.update({
        "fused_separable_open_close": fs.fused_separable_open_close,
        "fused_separable_morph_pair": fs.fused_separable_morph_pair,
        "fft_rows": ff.fft_rows,
        "fft_strided": ff.fft_strided,
    })
    sig_launches, sig_inputs, sig_plain_rows = signal_path(
        all_counters, torch, img, imgc)
    meas_rows, lab2c = measurements_path(all_counters, torch, x2)
    torch.cuda.empty_cache()
    base_rows = base_path(all_counters, torch, lab2c)
    del lab2c
    torch.cuda.empty_cache()

    # -- phase 5: times -----------------------------------------------------
    F = torch.nn.functional
    u5 = (0.2,) * 5
    d3 = (-1.0, 0.0, 1.0)
    s3 = (1.0, 2.0, 1.0)
    sobel_w = (s3, s3, d3)  # sobel(axis=-1): derivative on the last axis
    rows = {}

    def sep_kernel(x):
        """The separable kernel's entry on the path a call of ``x`` takes:
        the rows path for a 2-D array, else the planes path."""
        return "rows_f32_kernel" if x.ndim == 2 else (
            "fused_separable_f32_kernel")

    def composite(x, weights, mode):
        """One 1-D cuDNN convolution per filtered axis (TF32 off), each
        on the previous one's output, over the input padded beforehand
        by every axis' halo (pad not timed): the same function as the
        kernel's, extended once."""
        nd = x.ndim
        conv = F.conv3d if nd == 3 else F.conv2d
        pads = [(0, 0) if w is None else (len(w) // 2, len(w) - 1 - len(w) // 2)
                for w in weights]
        xp = boundary.pad(x, pads, mode)[None, None]
        ks = []
        for ax, w in enumerate(weights):
            if w is not None:
                shape = [1] * nd
                shape[ax] = len(w)
                ks.append(torch.tensor(w, dtype=torch.float32,
                                       device="cuda").reshape(1, 1, *shape))

        def run():
            y = xp
            for k in ks:
                y = conv(y, k)
            return y
        return run

    def sep_row(label, x, weights, dense, mode="reflect", atol=None,
                n_plain=50):
        nd = x.ndim
        args = (x, weights, (0,) * nd, (mode,) * nd, 0.0)
        ntaps = [0 if w is None else len(w) for w in weights]
        lib = None
        if dense is not None:
            # one dense cuDNN convolution (not separable) over a volume
            # padded beforehand; the pad is not timed
            xp = boundary.pad(x, [(k // 2, k - 1 - k // 2) for k in ntaps],
                              mode)[None, None]
            conv = F.conv3d if nd == 3 else F.conv2d
            lib = (lambda: conv(xp, dense), 1e-4 * float(dense.abs().sum()))
        ws = [w for w in weights if w is not None]
        normalized = all(abs(sum(w) - 1) < 1e-9 and min(w) >= 0 for w in ws)
        if atol is None:
            atol = 2e-6 if normalized else 1e-5 * float(
                np.prod([np.abs(w).sum() for w in ws]))
        rows[label] = time_row(
            label, lambda: fs.fused_separable_correlate(*args),
            lambda: fs.fused_separable_correlate_ref(*args), x,
            bound(x.numel(), flops=2 * sum(ntaps)), atol, lib,
            None if dense is None else
            "cuDNN conv with the dense filter, TF32 off, on an input padded "
            "beforehand (pad not timed)", n_plain=n_plain,
            kernel=sep_kernel(x))
        if ws:
            run = composite(x, weights, mode)
            ref = fs.fused_separable_correlate_ref(*args)
            err = float((run().reshape(ref.shape) - ref).abs().max())
            tol = atol(ref) if callable(atol) else atol
            check(err <= 10 * tol, f"{label}: the separable composite "
                                   f"disagrees ({err:.2e})")
            rows[label]["composite_ms"] = median_ms(run, n=20)
            rows[label]["composite_call"] = (
                f"composite: one 1-D cuDNN conv{nd}d per filtered axis, TF32 "
                "off, on an input padded beforehand (pad not timed)")

    sep_row("uniform_filter 256^3 size=5", xc3, (u5,) * 3,
            torch.full((1, 1, 5, 5, 5), 1 / 125, device="cuda"))
    sep_row("gaussian_filter 2048^2 sigma=3", xc2, (g25,) * 2,
            torch.tensor(np.outer(g25, g25), dtype=torch.float32,
                         device="cuda")[None, None])
    sep_row("sobel 256^3", xc3, sobel_w,
            torch.tensor(np.einsum("i,j,k->ijk", *sobel_w),
                         dtype=torch.float32, device="cuda")[None, None])
    # the kernel's own floor: every axis skipped, a copy through it
    sep_row("no taps 256^3", xc3, (None,) * 3, None)

    def minmax_row(label, x, size, is_min):
        nd = x.ndim
        args = (x, (size,) * nd, (0,) * nd, ("reflect",) * nd, 0.0, is_min)
        h = size // 2
        xp = boundary.pad(x, [(h, size - 1 - h)] * nd, "reflect")[None, None]
        pool = F.max_pool3d if nd == 3 else F.max_pool2d
        # min as -max(-x), the negations timed too
        lib = ((lambda: -pool(-xp, size, stride=1)) if is_min
               else (lambda: pool(xp, size, stride=1)))
        rows[label] = time_row(
            label, lambda: fs.fused_separable_minmax(*args),
            lambda: fs.fused_separable_minmax_ref(*args), x,
            bound(x.numel(), minmax_ops=nd * (size - 1)), 0, (lib, 0.0),
            f"torch max_pool{nd}d stride 1 on an input padded beforehand "
            "(pad not timed)" + (", on -x with both negations timed"
                                 if is_min else ""),
            kernel=sep_kernel(x))

    minmax_row("minimum_filter 256^3 size=5", xc3, 5, True)
    minmax_row("maximum_filter 4096^2 size=9", imgc, 9, False)

    def dense_row(label, x, w, origins, mode="reflect", n_plain=20):
        nd = x.ndim
        args = (x, w, origins, mode, 0.0)
        pads = [(s // 2 + o, s - 1 - s // 2 - o)
                for s, o in zip(w.shape, origins)]
        xp = boundary.pad(x, pads, mode)[None, None]
        wt = torch.tensor(w, dtype=torch.float32, device="cuda")[None, None]
        conv = F.conv3d if nd == 3 else F.conv2d
        launch = lambda: fd.fused_dense_correlate(*args)  # noqa: E731
        rows[label] = time_row(
            label, launch, lambda: fd.fused_dense_correlate_ref(*args), x,
            bound(x.numel(), flops=2 * int(np.count_nonzero(w))),
            1e-5 * float(np.abs(w).sum()),
            (lambda: conv(xp, wt), 1e-5 * float(np.abs(w).sum())),
            f"cuDNN conv{nd}d, TF32 off, on an input padded beforehand "
            "(pad not timed)", n_plain=n_plain, kernel="dense_")
        bp = fd.blocked_plan(np.asarray(w, np.float32))
        rows[label]["route"] = ("generic kernel" if bp is None else
                                f"blocked instance K0 {bp.k0} S {bp.s}")
        # the generic kernel on the same call, as before the blocked one
        blocked = fd._blocked_device_plan
        fd._blocked_device_plan = lambda *a: (None, None)
        try:
            rows[label]["generic_kernel_ms"] = kernel_ms(
                launch, "fused_dense_f32_kernel")
        finally:
            fd._blocked_device_plan = blocked

    dense_row("correlate 4096^2 9x9", imgc, w9, (0, 0))
    # convolve = correlate with the flipped weights and mirrored origins
    dense_row("convolve 256^3 3x3x3", xc3, np.flip(w333).copy(), (0, 0, 0))
    # scipy.signal.convolve(4096^2, 31x31, method="direct") on B2: the
    # kernel on the unpadded image with zero extension (the signal path
    # pads beforehand and runs it on 4126^2); not on the main path
    w31 = np.random.default_rng(31).standard_normal((31, 31))
    dense_row("convolve 4096^2 31x31 direct (signal path)", imgc,
              np.flip(w31).copy(), (0, 0), mode="constant", n_plain=2)

    def rank_row(label, x, fp, rank):
        nd = x.ndim
        args = (x, fp, (0,) * nd, rank, "reflect", 0.0)
        xp = boundary.pad(x, [(s // 2, s - 1 - s // 2) for s in fp.shape],
                          "reflect")
        win = xp
        for ax, s in enumerate(fp.shape):
            win = win.unfold(ax, s, 1)
        win = win.reshape(*x.shape, -1)[..., torch.from_numpy(
            np.flatnonzero(fp.ravel())).cuda()].contiguous()
        rows[label] = time_row(
            label, lambda: fr.fused_rank_filter(*args),
            lambda: fr.fused_rank_filter_ref(*args), x,
            bound(x.numel(), minmax_ops=2 * least_ces(fp, rank)), 0,
            (lambda: torch.kthvalue(win, rank + 1, dim=-1).values, 0.0),
            "torch.kthvalue over the Tensor.unfold windows, gathered "
            "beforehand (not timed)", n_plain=10,
            kernel="rank_instance_kernel")
        check(fr.instance(fp, rank, x.dtype).id is not None,
              f"{label}: no compile-time instance")
        del win
        # the same call on the generic instance (the runtime network of
        # the previous design, with the shared presort laid out flat)
        real = fr.instance
        fr.instance = lambda *a: fr.Instance(None, 0)
        try:
            y = fr.fused_rank_filter(*args)
            check(same(y, fr.fused_rank_filter_ref(*args)),
                  f"{label}: the generic instance differs from plain")
            rows[label]["generic_kernel_ms"] = kernel_ms(
                lambda: fr.fused_rank_filter(*args), "fused_rank_kernel")
        finally:
            fr.instance = real

    box5 = np.ones((5, 5), bool)
    rank_row("median_filter 4096^2 5x5", imgc, box5, 12)
    rank_row("percentile_filter 4096^2 30 5x5", imgc, box5, 7)
    rank_row("median_filter 256^3 3x3x3", xc3, np.ones((3, 3, 3), bool), 13)
    rank_row("rank_filter 4096^2 i32 cross rank 2", imgc_i, cross, 2)
    torch.cuda.empty_cache()

    # the spline gather; the yardstick is grid_sample on a sampling grid
    # built beforehand (not timed), align_corners=True: nearest, bilinear
    # or bicubic for orders 0, 1, 3 (its bicubic is Keys' cubic
    # convolution, not the B-spline: timed only)
    grid_modes = {0: "nearest", 1: "bilinear", 3: "bicubic"}

    def sample_grid(coords, shape):
        """grid_sample's normalized grid, last axis first."""
        return torch.stack([2 * c / (n - 1) - 1 for c, n in
                            zip(reversed(coords), reversed(shape))],
                           -1)[None].float()

    def grid_sample(x, grid, order, padding):
        return F.grid_sample(x[None, None], grid, mode=grid_modes[order],
                             padding_mode=padding, align_corners=True)

    def gather_atol(x, order):
        """The gather against its plain version, as in the kernel-vs-plain
        phase: order 0 exactly, else 1e-5 of max|x| (float32 data)."""
        return 0 if order == 0 else 1e-5 * float(x.abs().max())

    def generic_ms(label, launch):
        """The same call on the gather's generic instance (runtime orders,
        64-bit unravel: the previous design), kernel time alone."""
        real = sg.instance
        sg.instance = lambda entry, *a, **k: sg.Instance(entry, 0, None)
        try:
            rows[label]["generic_kernel_ms"] = kernel_ms(
                launch, "spline_gather_kernel")
        finally:
            sg.instance = real

    def affine_row(label, x, m, off, out_shape, orders, mode, lib_check):
        nd = x.ndim
        args = (x, m, off, out_shape, orders, mode, 0.0)
        lib = lib_call = None
        order = max(orders)
        if order in grid_modes and mode == "nearest":
            coords = sg.affine_coords(m, off, out_shape, torch.float64,
                                      x.device)
            grid = sample_grid(coords, x.shape)
            del coords
            lib = (lambda: grid_sample(x, grid, order, "border"),
                   1e-3 if lib_check else None)
            lib_call = (f"torch grid_sample {grid_modes[order]}, border, "
                        "align_corners=True, grid built beforehand (not "
                        "timed)" + ("" if lib_check else
                                    "; another function, timed only"))
        rows[label] = time_row(
            label, lambda: sg.spline_affine(*args),
            lambda: sg.spline_affine_ref(*args), x,
            gather_bound(x.numel(), int(np.prod(out_shape)), orders,
                         coord_ops=nd * (2 * nd + 1)),
            gather_atol(x, order), lib, lib_call, n_plain=3,
            kernel="fast_kernel")
        generic_ms(label, lambda: sg.spline_affine(*args))

    def map_row(label, x, coords, order, mode):
        args = (x, coords, order, mode, 0.0)
        grid = sample_grid(list(coords.unbind(0)), x.shape)
        rows[label] = time_row(
            label, lambda: sg.spline_map(*args),
            lambda: sg.spline_map_ref(*args), x,
            gather_bound(x.numel(), coords[0].numel(), [order] * x.ndim,
                         coord_bytes=coords.numel() * coords.element_size(),
                         weights_f64=coords.dtype == torch.float64),
            gather_atol(x, order),
            (lambda: grid_sample(x, grid, order, "reflection"), None),
            f"torch grid_sample {grid_modes[order]}, reflection, "
            "align_corners=True, grid built beforehand (not timed); "
            "another boundary rule and, for order 3, another cubic: "
            "timed only", n_plain=3, kernel="fast_kernel")
        generic_ms(label, lambda: sg.spline_map(*args))

    zeros2 = np.zeros(2)
    for order in (0, 1, 3):
        affine_row(f"affine_transform 4096^2 order {order} nearest", imgc,
                   mat.astype(f64), zeros2, (4096, 4096), [order] * 2,
                   "nearest", order == 1)
    affine_row("affine_transform 4096^2 rot40 order 1 nearest", imgc,
               rot40.astype(f64), zeros2, (4096, 4096), [1, 1], "nearest",
               True)
    # rotate(256^3, 17, axes=(1, 2)) as the public call builds it
    s17, c17 = np.sin(np.deg2rad(17.0)), np.cos(np.deg2rad(17.0))
    m3 = np.array([[1.0, 0, 0], [0, c17, s17], [0, -s17, c17]])
    ctr = np.full(2, 127.5)
    off3 = np.concatenate([[0.0], ctr - m3[1:, 1:] @ ctr])
    affine_row("rotate 256^3 axes (1, 2) 17 deg order 1 nearest", xc3, m3,
               off3, (256, 256, 256), [0, 1, 1], "nearest", True)
    map_row("map_coordinates 2048^2 warp order 1 reflect", xc2, warpc, 1,
            "reflect")
    coef2 = iir.spline_filter_fir(xc2, 3, (0, 1), "reflect")
    map_row("map_coordinates 2048^2 warp order 3 reflect (gather)", coef2,
            warpc, 3, "reflect")
    coef5 = iir.spline_filter_fir(imgc, 5, (0, 1), "reflect")
    affine_row("shift 4096^2 (2.3, -1.7) order 5 reflect (gather)", coef5,
               np.eye(2), np.array([-2.3, 1.7]), (4096, 4096), [5, 5],
               "reflect", False)
    coefz = iir.spline_filter_fir(xc2, 3, (0, 1), "constant")
    affine_row("zoom 2048^2 x2 order 3 constant (gather)", coefz,
               np.diag([2047 / 4095] * 2), zeros2, (4096, 4096), [3, 3],
               "constant", False)
    del coef2, coef5, coefz
    # the spline prefilter on the fused separable kernel: one launch of
    # order 3's 37-tap FIR over both axes, against the recursion
    taps3 = iir.pole_taps(3)[0]
    h3 = len(taps3) // 2
    # the yardstick: one cuDNN convolution with the 37x37 outer product of
    # the taps (TF32 off), on the input mirror-padded beforehand (not timed)
    xp37 = boundary.pad(imgc, [(h3, h3)] * 2, "mirror")[None, None]
    w37 = torch.tensor(np.outer(taps3, taps3), dtype=torch.float32,
                       device="cuda")[None, None]
    c_max = float(fs.fused_separable_correlate(
        imgc, (taps3, taps3), (0, 0), ("mirror",) * 2, 0.0).abs().max())
    rows["spline_filter 4096^2 order 3 (37 taps)"] = time_row(
        "spline_filter 4096^2 order 3 (37 taps)",
        lambda: fs.fused_separable_correlate(
            imgc, (taps3, taps3), (0, 0), ("mirror",) * 2, 0.0),
        lambda: iir.spline_filter1d(iir.spline_filter1d(imgc, 3, 0, "mirror"),
                                    3, 1, "mirror"),
        imgc, bound(imgc.numel(), flops=2 * 2 * len(taps3)),
        # as the prefilter phase: 1e-5 of the coefficients' max|c|
        lambda c: 1e-5 * float(c.abs().max()),
        (lambda: F.conv2d(xp37, w37), 1e-4 * c_max),
        "cuDNN conv2d with the 37x37 outer product of the taps, TF32 off, "
        "on an input mirror-padded beforehand (pad not timed)",
        n_plain=2, kernel=sep_kernel(imgc))
    del xp37
    r37 = rows["spline_filter 4096^2 order 3 (37 taps)"]
    run = composite(imgc, (taps3, taps3), "mirror")
    err = float((run()[0, 0] - fs.fused_separable_correlate(
        imgc, (taps3, taps3), (0, 0), ("mirror",) * 2, 0.0)).abs().max())
    check(err <= 1e-4 * c_max, f"37-tap composite disagrees ({err:.2e})")
    r37["composite_ms"] = median_ms(run, n=20)
    r37["composite_call"] = ("composite: one 1-D cuDNN conv2d per axis, TF32 "
                             "off, on an input mirror-padded beforehand (pad "
                             "not timed)")
    del run
    # the other prefilter poles of the main path, each one launch over
    # both axes: order 3's on 2048^2 (map_coordinates, zoom), order 5's
    # two on 4096^2 (shift); within 1e-5 of the pass's max|c|
    taps57, taps17 = iir.pole_taps(5)
    for label, x, taps in (
            ("prefilter 2048^2 order 3 (37 taps)", xc2, taps3),
            ("prefilter 4096^2 order 5 pole 1 (57 taps)", imgc, taps57),
            ("prefilter 4096^2 order 5 pole 2 (17 taps)", imgc, taps17)):
        sep_row(label, x, (taps, taps), None, mode="mirror",
                atol=lambda c: 1e-5 * float(c.abs().max()), n_plain=5)
    torch.cuda.empty_cache()

    morph_rows(fs, boundary, torch, rows, xc3, imgc)
    torch.cuda.empty_cache()
    fft_labels, fft_e2e, conv_methods = fft_rows_phase5(ff, torch, rows, imgc,
                                                        sig_inputs)
    torch.cuda.empty_cache()

    print(json.dumps({"card": card, "cases": list(rows.values()),
                      "plain_torch": plain_rows + sig_plain_rows
                      + meas_rows + base_rows,
                      "end_to_end": [fft_e2e], "conv_methods": conv_methods}))
    stencil = "cupyimg_tpu/ops/pallas_stencil.py"
    kernels = [
        ("fused_separable_correlate", "fused_separable.cu",
         f"{stencil}:1034", "uniform_filter 256^3 size=5"),
        ("fused_separable_minmax", "fused_separable.cu", f"{stencil}:946",
         "minimum_filter 256^3 size=5"),
        ("fused_dense_correlate", "fused_dense.cu", f"{stencil}:1740",
         "correlate 4096^2 9x9"),
        ("fused_rank_filter", "fused_rank.cu", f"{stencil}:2070",
         "median_filter 4096^2 5x5"),
        ("spline_gather", "spline_gather.cu",
         "cupyimg_tpu/ops/gtg_interp.py:176, "
         "cupyimg_tpu/ops/warp_gather.py:111, "
         "cupyimg_tpu/ops/pallas_interp.py:161, "
         "cupyimg_tpu/ops/pallas_interp.py:279",
         "affine_transform 4096^2 order 1 nearest"),
    ]
    kernels.append(
        ("fused_separable_morph", "fused_separable.cu",
         f"{stencil}:1388, {stencil}:1451 (specs2 / pair_combine of "
         f"_fused_separable, {stencil}:1034)",
         "grey_opening 256^3 size=5 (two-stage)"))
    launches["fused_separable_morph"] = (
        morph_launches["fused_separable_open_close"]
        + morph_launches["fused_separable_morph_pair"])
    kernels.append(
        ("fused_fft", "fused_fft.cu",
         "cupyimg_tpu/ops/pallas_fft.py:309, "
         "cupyimg_tpu/ops/pallas_fft.py:395", fft_labels[1]))
    launches["fused_fft"] = (sig_launches["fft_rows"]
                             + sig_launches["fft_strided"])
    # each kernel's main-path launches by timed row: (row, calls); a
    # row's kernel_ms covers its call's launches (the strided FFT's two)
    fft_main = [lb for lb in fft_labels
                if "pad folded" in lb or "window 4096" in lb]
    loss_rows = {
        "fused_separable_correlate": [
            ("uniform_filter 256^3 size=5", 1),
            ("gaussian_filter 2048^2 sigma=3", 1), ("sobel 256^3", 1),
            ("prefilter 2048^2 order 3 (37 taps)", 2),
            ("prefilter 4096^2 order 5 pole 1 (57 taps)", 1),
            ("prefilter 4096^2 order 5 pole 2 (17 taps)", 1),
            ("spline_filter 4096^2 order 3 (37 taps)", 1)],
        "fused_separable_minmax": [("minimum_filter 256^3 size=5", 1),
                                   ("maximum_filter 4096^2 size=9", 1)],
        "fused_dense_correlate": [("correlate 4096^2 9x9", 1),
                                  ("convolve 256^3 3x3x3", 1)],
        "fused_rank_filter": [(lb, 1) for lb in (
            "median_filter 4096^2 5x5", "percentile_filter 4096^2 30 5x5",
            "median_filter 256^3 3x3x3",
            "rank_filter 4096^2 i32 cross rank 2")],
        "spline_gather": [(lb, 1) for lb in rows
                          if lb.startswith(("affine_transform 4096^2",
                                            "rotate 256^3",
                                            "map_coordinates 2048^2",
                                            "shift 4096^2", "zoom 2048^2"))],
        "fused_separable_morph": [(lb, 1) for lb in rows
                                  if lb.endswith(("(two-stage)", "(pair)"))
                                  or "(two-stage, " in lb],
        # fftconvolve, convolve and correlate: the four passes each;
        # oaconvolve: its blocks' forward and inverse passes (the 257-tap
        # operand's forward pass is not timed)
        "fused_fft": [(lb, 3) for lb in fft_main] + [
            (lb, 1) for lb in fft_labels if "4374 x" in lb],
    }
    line = []
    for kname, src, replaces, case in kernels:
        r = rows[case]
        covered = sum(n * rows[lb].get("launches_per_call", 1)
                      for lb, n in loss_rows[kname])
        loss = sum(n * (rows[lb]["kernel_ms"] - rows[lb]["bound_ms"])
                   for lb, n in loss_rows[kname])
        check(covered <= launches[kname], f"{kname}: {covered} launches "
                                          f"timed of {launches[kname]}")
        print(f"loss_ms {kname:28s} {loss:.5f} over {covered} of "
              f"{launches[kname]} main-path launches")
        line.append({
            "name": kname,
            "route": "cuda",
            "source": f"cupyimg_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r["library_call"],
            "copy_ms": r["copy_ms"],
            "shape": case,
            "card": card,
            "loss_ms": loss,
            "loss_launches_timed": covered,
        })
    for entry in line:  # B2 also runs on the signal path (2-D calls)
        if entry["name"] == "fused_dense_correlate":
            entry["launches_signal_path"] = sig_launches[
                "fused_dense_correlate"]
    line[-1]["entries"] = [
        {k: rows[lb][k] for k in ("case", "ms", "kernel_ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "library_call", "max_abs_err")}
        for lb in fft_labels]
    line[-1]["launches_by_entry"] = {k: sig_launches[k]
                                     for k in ("fft_rows", "fft_strided")}
    print(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
