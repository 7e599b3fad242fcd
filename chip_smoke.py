#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cupyimg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a traceback and a non-zero exit):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``cupyimg_tpu_torch/csrc`` with nvcc, one
   nvcc per source, all started together; then ``time.trace`` around one
   uniform_filter of 256^3 (the process's first profiler session): its
   Chrome trace must hold B1's kernel;
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
   result) and timed; then the skimage path, its counts set to 0 before
   it: regionprops_table of a 2048^2 label image of ~960 blobs with a
   float32 intensity image (nine properties), perimeter,
   perimeter_crofton and euler_number of a 4096^2 mask and euler_number
   of a 256^3 one, moments of order 3 of 4096^2, profile_line across
   4096^2 five pixels wide at orders 1 and 3 (one spline gather launch
   each, and one fused separable launch for order 3's prefilter: every
   other call of the path launches none), block_reduce, rgb2lab,
   lab2rgb, rgb2hsv, hsv2rgb, rgb2gray and separate_stains of 4096^2x3
   float32 and deltaE_ciede2000 of two 4096^2 Lab images (with matmul
   TF32 allowed, so that a product on the tensor cores would fail their
   checks), label2rgb (overlay and avg), histogram, equalize_hist and
   rescale_intensity of 4096^2 uint16, equalize_adapthist of 2048^2
   uint16 and 1024^2 RGB and match_histograms of 2048^2 RGB, each
   against numpy/scipy or the port's CPU result (of a crop for the
   pixel-wise colour calls; CLAHE within one grey level of 2^14) and
   timed; then the transform path, its counts set to 0 before it, with
   matmul TF32 allowed: resize (4096^2 -> 2048^2 anti-aliased, 2048^2 ->
   4096^2 at order 3), rescale of 4096^2x3, rotate (orders 1 and 3,
   resized), warp by an affine, a projective and a piecewise affine
   (1024^2) transform, swirl, warp_polar, the gaussian and laplacian
   pyramids (5 levels), integral_image, integrate (10^5 windows),
   downscale_local_mean, corner_harris, corner_shi_tomasi, corner_peaks,
   hessian_matrix_det, shape_index, hessian_matrix and its eigenvalues
   (256^3), peak_local_max (plain and over 16 labels), match_template
   (31x31), daisy (2048^2), structural_similarity, the three simple
   metrics and estimate_transform on 1000 point pairs; each call's
   launches of B1 (correlation, min/max), the gather and the FFT
   kernel held to its plan, each result against scipy/numpy (the warps
   on output windows) or the port's CPU result (the peak finders,
   exactly), each timed; then the filters path, its counts set to 0
   before it, with matmul TF32 allowed: gaussian, difference_of_gaussians,
   median (float32 and uint8), unsharp_mask, window, canny, sobel,
   threshold_otsu, threshold_local and gabor on 4096^2, frangi (five
   sigmas), the TV denoiser and richardson_lucy (5x5, 10 iterations) on
   2048^2, wiener and unsupervised_wiener on the 512^2 float64 input of
   ``tests/data/restoration``; each call's launches of B1, B3, the
   gather and B2 held to its plan (the float64 and uint8 calls launch
   none), each result against scipy/numpy on windows, a float64
   numpy/scipy canny and Richardson-Lucy, the port's CPU result on crops
   (frangi, the TV denoiser) or the restoration goldens, each timed;
   then the registration path, its counts set to 0 before it, with
   matmul TF32 allowed: phase_cross_correlation on 4096^2 (integer and
   subpixel shifts, Fourier-space spectra) and masked on 1024^2, the
   TV-L1 and iLK flows of the registration suite's sine flow on 2048^2
   (TV-L1 with its median prefilter on 1024^2; both on 256^2 against the
   port's CPU result), find_boundaries in its four modes,
   relabel_sequential, join_segmentations and clear_border on a 4096^2
   segmentation of ~1000 regions, mark_boundaries (thick, subpixel) on
   2048^2 RGB, the morphological snakes on 1024^2, edge_enhance_pipeline
   on 256^3, richardson_lucy_step on 2048^2 and convolve_separable on
   4096^2; each call's launches of B1, B3 and the gather held to its
   plan (the correlations, label operations and level sets launch none),
   each result against its known shift or flow (mean error under half a
   pixel), numpy/scipy or the port's CPU result, each timed; then the
   parallel path: ``parallel.run_world`` starts 2 ranks on the one card
   (gloo: NCCL needs a card a rank; the slabs and retiles staged through
   pinned host memory) once every kernel is built, and each rank runs 14
   sharded calls at full size (uniform, gaussian and minimum filters of
   256^3 on a (2,) mesh; median 5x5, correlate 9x9, shift, an
   affine_transform and map_coordinates of bounded displacement, binary
   erosion, label, fft2 and the spatially sharded FFT convolution of
   4096^2; the batch-sharded fftconvolve of (4, 2048, 2048) with 31x31;
   sharded_edge_enhance of (4, 1024, 1024) on a (1, 2) mesh), its counts
   set to 0 before each call: each rank's launches must equal the
   single-device plan on its block (one B1, B1 min/max, B3 or B2 launch;
   a B1 prefilter and a gather launch for the shift; what the
   single-device fftconvolve launches on the batch block; none for the
   plain-torch calls), rank 0 holds each gathered result against the
   port's single-device call on the card (1e-5 of max|ref| for the
   separable filters and the pipeline, 1e-5 * sum|w| for correlate,
   1e-4 of max|ref| for the FFTs, 2e-5 of max|x| for the
   interpolations, exactly for min, median, erosion and label), and
   each call is timed (median of 5, a barrier before each; the
   exchange's host milliseconds beside it); then, in 2-rank worlds of
   their own, which gloo collectives take CUDA tensors as they are (a
   probe that crashes its world is reported so); then the half path
   (``half_path``): B1's kernels in float16 and bfloat16 against their
   plain versions (every kind, both paths, four modes, two row
   alignments, and the branches of the redesigned half kernels: rows of
   n2 % 8 of 0 and 3, shifted tiles, 1 to 64 taps along the contiguous
   axis, axis-0 register windows of 1, 3 and 5 and a ring of 7; exact
   but corr and laplace, within 1 ulp of the type),
   then, its counts set to 0, eight calls in each type (uniform,
   gaussian, minimum, grey_opening and morphological_gradient of 256^3;
   uniform, sobel and grey_closing of 4096^2), each one B1 launch and
   held to SciPy in float64 on the same values, each timed at 2 bytes a
   sample beside the same call's kernel in float32; the kernels line
   gains an entry for each of B1 corr, min/max and B1-morph in each half
   type, and ``launches_half_path`` on every entry;
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

``python3 chip_smoke.py --half`` runs the half path alone: it builds the
separable source only, prints its ptxas lines and runs ``half_path`` as
above, then prints its kernels line and the same last line; it fails, as
the whole run does, where a half instance spills more than its float32
twin.
"""

import json
import os
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


def bound(numel, flops=0.0, minmax_ops=0.0, itemsize=4):
    """(bound_ms, bound_by): the larger of one read + one write of
    ``itemsize``-byte values at PEAK_BYTES and the work at its peak rate:
    ``flops`` per voxel at PEAK_FP32, ``minmax_ops`` (min/max
    instructions) per voxel at PEAK_MINMAX (the half types' kernels
    compute in float32)."""
    t_bytes = 2 * itemsize * numel / PEAK_BYTES
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


def dev(x):
    """A contiguous CUDA tensor of a numpy array."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


def host(v):
    """A tensor, or a list or tuple of them, as numpy; else ``v``."""
    import torch

    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    if isinstance(v, (list, tuple)):
        return [host(u) for u in v]
    return v


def rel(got, ref, tol, what="max|ref|"):
    """max|got - ref| over max|ref|, finite and of ``ref``'s shape."""
    got = np.asarray(host(got), np.float64)
    ref = np.asarray(ref, np.float64)
    check(got.shape == ref.shape, f"shape {got.shape}, want {ref.shape}")
    check(np.isfinite(got).all(), "non-finite values")
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(got - ref).max()) / scale
    check(err <= tol, f"{err:.3e} of {what} (tol {tol:.0e})")
    return f"{err:.3e} of {what} (tol {tol:.0e})"


def identical(got, ref):
    """``got`` equals ``ref``, dtype included."""
    got = host(got)
    check(np.asarray(got).dtype == np.asarray(ref).dtype,
          f"dtype {np.asarray(got).dtype}, want {np.asarray(ref).dtype}")
    check(np.array_equal(got, ref), "differs from its reference")
    return "exact"


def _run_calls(phase, counters, calls, torch, plain_route="plain torch"):
    """Run a path's ``calls`` (label, {kernel: launches}, call, check)
    once with every count set to 0 and TF32 allowed (a float32 call that
    a matmul served would show), hold each call's launches to its plan
    and its result to its check, then time each call (CUDA events: median
    of 10 after 2 warm-ups, of 3 for calls over 100 ms).  Returns the
    rows and the path's launches.  ``plain_route(label)`` names the route
    of a call that launches no kernel."""
    sync = torch.cuda.synchronize
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for c in counters.values():
            c.launches = 0
        results, deltas = {}, {}
        for label, _, fn, _ in calls:
            before = {k: c.launches for k, c in counters.items()}
            results[label] = fn()
            deltas[label] = {k: c.launches - before[k]
                             for k, c in counters.items()}
        sync()
        launches = {k: c.launches for k, c in counters.items()}
        checks = {}
        for label, kernels, _, verify in calls:
            want = {k: kernels.get(k, 0) for k in counters}
            check(deltas[label] == want,
                  f"{label} launched {deltas[label]}, not as planned")
            try:
                checks[label] = verify(results.pop(label))
            except RuntimeError as err:
                raise RuntimeError(f"{phase} {label}: {err}") from err
        print(f"{phase} launches: {json.dumps(launches)}")
        width = max(len(label) for label, *_ in calls)
        rows = []
        for label, kernels, fn, _ in calls:
            t0 = time.perf_counter()
            fn()
            sync()
            slow = time.perf_counter() - t0 > 0.1
            ms = median_ms(fn, n=3 if slow else 10, n_warmup=0 if slow
                           else 2)
            route = " + ".join(f"{k} x{v}" for k, v in kernels.items()) or (
                plain_route if isinstance(plain_route, str)
                else plain_route(label))
            rows.append({"case": label, "route": route, "ms": ms,
                         "check": checks[label]})
            print(f"{phase} {label:{width}s} {ms:10.3f} ms ({route}) "
                  f"vs reference: {checks[label]}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows, launches


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


def ptxas_b1_lines(_build):
    """The register and spill lines of every instance of the separable
    source, B1 and B1-morph in each element type.  Returns the float16
    and bfloat16 instances that spill more than their float32 twins (the
    half types' kernels should keep float32's registers: their tiles are
    widened or their samples converted in pairs), for the caller to
    check."""
    kinds = ("opening", "closing", "gradient", "laplace")
    spills = {}
    # one part per element type, its kernels' last template argument
    for part in _build.parts("fused_separable"):
        log = _build.library_path("fused_separable", part).with_suffix(".log")
        for name, regs, st, ld, stack in ptxas_entries(log.read_text()):
            spill = (f"{regs} registers, {st} bytes spill stores, {ld} "
                     f"bytes spill loads, {stack} bytes stack")
            etype = ("bfloat16" if "__nv_bfloat16" in name else
                     "float16" if "__half" in name else "float32")
            m = re.search(r"morph_planes_f32_kernelILi(\d)ELi(\d)E", name)
            if m:
                window = ("ring" if m.group(2) == "0" else
                          f"axis-0 window {m.group(2)} in registers")
                label = (f"B1-morph planes path {kinds[int(m.group(1))]}, "
                         f"{window}")
            elif re.search(r"morph_rows_f32_kernelILi(\d)E", name):
                m = re.search(r"morph_rows_f32_kernelILi(\d)E", name)
                label = f"B1-morph rows path {kinds[int(m.group(1))]}"
            else:
                for kernel, path in (("fused_separable_f32_kernel", "planes"),
                                     ("rows_f32_kernel", "rows")):
                    m = re.search(kernel + r"ILi(\d)E(?:Li(\d)E)?", name)
                    if m:
                        break
                else:
                    continue
                op = ("corr", "min", "max")[int(m.group(1))]
                window = ("" if m.group(2) is None else
                          ", ring" if m.group(2) == "0" else
                          f", axis-0 window {m.group(2)} in registers")
                label = f"B1 {path} path {op}{window}"
            print(f"ptxas {label}, {etype}: {spill}")
            spills[label, etype] = st + ld + stack
    return [f"{label}, {etype}: {n} bytes of local memory, float32 "
            f"{spills[label, 'float32']}"
            for (label, etype), n in sorted(spills.items())
            if n > spills[label, "float32"]]


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
    worse = ptxas_b1_lines(_build)
    check(not worse, f"ptxas: half instances spill: {worse}")
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

    def rel_each(label, got, ref, tol, floor=1e-300):
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
        return rel_each(label, h, nh, 1e-5)

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
            return rel_each(label, got, ref, 1e-6, floor=1e-6)
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
         lambda label, got: rel_each(label, got, spst.entropy(pk, base=2),
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


def _closed_euler(img):
    """The Euler characteristic of the union of closed unit pixels
    (voxels): cells of every dimension counted, ``V - E + F (- C)``;
    skimage's Euler number under 8- (2-D) or 26-connectivity (3-D)."""
    import itertools

    P = np.pad(img.astype(bool), 1)
    chi = 0
    for S in itertools.product((0, 1), repeat=img.ndim):
        arr = P
        for ax, vertex_like in enumerate(S):
            n = arr.shape[ax]
            lo = np.take(arr, range(0, n - 1), axis=ax)
            hi = np.take(arr, range(1, n), axis=ax)
            arr = (lo | hi) if vertex_like else np.take(
                arr, range(1, n - 1), axis=ax)
        chi += (-1) ** (img.ndim - sum(S)) * int(arr.sum())
    return chi


def _perimeters_reference(mask):
    """skimage's perimeter (4-neighbourhood) and Crofton perimeter (4
    directions) on scipy.ndimage and numpy."""
    import math

    import scipy.ndimage as sndi

    img = mask.astype(np.uint8)
    border = img - sndi.binary_erosion(
        img, np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]), border_value=0)
    codes = sndi.convolve(border.astype(np.int32),
                          [[10, 2, 10], [2, 1, 2], [10, 2, 10]],
                          mode="constant")
    w = np.zeros(50)
    w[[5, 7, 15, 17, 25, 27]] = 1
    w[[21, 33]] = math.sqrt(2)
    w[[13, 23]] = (1 + math.sqrt(2)) / 2
    per = np.bincount(codes.ravel(), minlength=50) @ w
    codes = sndi.convolve(np.pad(img.astype(np.int32), 1),
                          [[0, 0, 0], [0, 1, 4], [0, 2, 8]], mode="constant")
    pi, sq2 = np.pi, math.sqrt(2)
    coefs = [0, pi / 4 * (1 + 1 / sq2), pi / (4 * sq2), pi / (2 * sq2), 0,
             pi / 4 * (1 + 1 / sq2), 0, pi / (4 * sq2), pi / 4, pi / 2,
             pi / (4 * sq2), pi / (4 * sq2), pi / 4, pi / 2, 0, 0]
    return per, np.dot(coefs, np.bincount(codes.ravel(), minlength=16))


def _profile_reference(img, src, dst, linewidth, order, mode):
    """skimage's profile_line on numpy and scipy.ndimage.map_coordinates
    (float64), the mean across the width."""
    import scipy.ndimage as sndi

    d = np.subtract(dst, src, dtype=float)
    theta = np.arctan2(d[0], d[1])
    n = int(np.ceil(np.hypot(*d) + 1))
    frac = np.linspace(-1, 1, linewidth)
    rows = np.linspace(src[0], dst[0], n)[:, None] + frac * (
        (linewidth - 1) * np.cos(theta) / 2)
    cols = np.linspace(src[1], dst[1], n)[:, None] + frac * (
        (linewidth - 1) * np.sin(-theta) / 2)
    out = sndi.map_coordinates(img.astype(np.float64), np.stack([rows, cols]),
                               order=order, mode=mode, prefilter=order > 1)
    return out.mean(axis=1)


def _match_reference(src, tmpl):
    """skimage's match_histograms of one channel in numpy."""
    s = np.sort(src.ravel())
    q = np.searchsorted(s, src.ravel(), side="right") / src.size
    t = np.sort(tmpl.ravel()).astype(np.float64)
    return np.interp(q, np.arange(1, t.size + 1) / t.size, t).reshape(
        src.shape)


def skimage_path(counters, torch):
    """Phase 4, skimage path: ``skimage.measure`` (regionprops_table, the
    perimeters and Euler numbers, moments, profile_line, block_reduce),
    ``skimage.color`` and ``skimage.exposure`` at full size on the card
    (the counts are set to 0 just before it and read just after).  Only
    ``profile_line`` reaches a kernel: one spline gather launch per call,
    and for order 3 one fused separable launch (the prefilter's pole)
    before it; every other call is plain torch and launches none.  The
    colour calls run with TF32 allowed for matmuls, so that a float32
    product on the tensor cores would fail their checks.  Each call is
    held against numpy/scipy where the transcription is cheap, else
    against the port's own CPU result of the same call (on a crop for
    the pixel-wise colour calls); CLAHE within one grey level of 2^14.
    Times each call (median of 10 after 2 warm-ups; 3 after none for the
    calls of more than 100 ms).  Returns the calls' rows and the launch
    counts of the path."""
    import scipy.ndimage as sndi

    import cupyimg_tpu_torch.skimage.color as tcolor
    import cupyimg_tpu_torch.skimage.exposure as texp
    import cupyimg_tpu_torch.skimage.measure as tmeas

    rng = np.random.default_rng(12)
    f64 = np.float64

    # ~1000 blobs of ~1000 pixels: coarse noise, upsampled, thresholded
    coarse = rng.random((96, 96), dtype=np.float32)
    blobs = sndi.zoom(coarse, 2048 / 96, order=3)[:2048, :2048] > 0.72
    lab2, n_lab = sndi.label(blobs)
    lab2 = lab2.astype(np.int32)
    inten = rng.random((2048, 2048), dtype=np.float32)
    mask = sndi.uniform_filter(rng.random((4096, 4096), dtype=np.float32),
                               9) > 0.5
    vol = sndi.uniform_filter(rng.random((256, 256, 256), dtype=np.float32),
                              5) > 0.5
    img = rng.random((4096, 4096), dtype=np.float32)
    rgb = rng.random((4096, 4096, 3), dtype=np.float32)
    lab_a = rng.random((4096, 4096, 3), dtype=np.float32) * [100, 200, 200] \
        - [0, 100, 100]
    lab_b = np.clip(lab_a + rng.standard_normal(lab_a.shape) * 5,
                    [0, -100, -100], [100, 100, 100])
    u16 = (rng.random((4096, 4096)) ** 2 * 50000 + 3000).astype(np.uint16)
    u16_2k = np.ascontiguousarray(u16[:2048, :2048])
    rgb_1k = (rng.random((1024, 1024, 3)) * 255).astype(np.uint8)
    rgb_2k = np.ascontiguousarray(rgb[:2048, :2048])
    tmpl_2k = rng.random((2048, 2048, 3), dtype=np.float32) ** 3
    (lab2c, intenc, maskc, volc, imgc, rgbc, lab_ac, lab_bc, u16c, u16_2kc,
     rgb_1kc, rgb_2kc, tmpl_2kc) = (dev(a) for a in (
         lab2, inten, mask, vol, img, rgb, lab_a.astype(f64),
         lab_b.astype(f64), u16, u16_2k, rgb_1k, rgb_2k, tmpl_2k))
    torch.cuda.synchronize()
    props = ("label", "bbox", "area", "centroid", "eccentricity",
             "mean_intensity", "perimeter", "solidity", "moments_hu")
    crop = (slice(1000, 1512), slice(2000, 2512))
    src, dst = (100.5, 20.0), (3900.0, 4001.25)

    # (label, {kernel: launches}, call, check); a check takes the result
    calls = []

    def call(label, fn, verify, kernels=None):
        calls.append((label, kernels or {}, fn, verify))

    def cpu_crop(fn, *arrays, tol):
        """The port's CPU result of the same call on a crop."""
        def verify(got):
            ref = fn(*(a[crop].cpu() for a in arrays))
            check(got.dtype == ref.dtype, f"dtype {got.dtype}")
            return rel(got[crop], ref.numpy(), tol) + " (port CPU, crop)"
        return verify

    def table(got):
        index = np.arange(1, n_lab + 1)
        bbox = sndi.find_objects(lab2)
        check(np.array_equal(got["label"], index), "labels")
        for k in range(4):
            want = [b[k % 2].start if k < 2 else b[k % 2].stop
                    for b in bbox]
            check(np.array_equal(got[f"bbox-{k}"], want), "bbox")
        check(np.array_equal(got["area"], np.bincount(lab2.ravel())[1:]),
              "area")
        cen = np.array(sndi.center_of_mass(np.ones_like(lab2), lab2, index))
        msg = rel(np.stack([got["centroid-0"], got["centroid-1"]], 1), cen,
                  1e-12)
        rel(got["mean_intensity"], sndi.mean(inten.astype(f64), lab2,
                                             index), 1e-5)
        cpu = tmeas.regionprops(torch.from_numpy(lab2),
                                torch.from_numpy(inten))[:50]
        for prop in ("eccentricity", "perimeter", "solidity"):
            rel(got[prop][:50], [r[prop] for r in cpu], 1e-9)
        rel(np.stack([got[f"moments_hu-{j}"][:50] for j in range(7)], 1),
            np.stack([r.moments_hu.numpy() for r in cpu]), 1e-9)
        return (f"{n_lab} regions; bbox, area exactly, centroid {msg}, "
                f"mean_intensity 1e-5 vs scipy; eccentricity, perimeter, "
                f"solidity, moments_hu within 1e-9 of the port's CPU result "
                f"(50 regions)")

    per_ref = {}

    def perimeters(index):
        def verify(got):
            if not per_ref:
                per_ref["p"] = _perimeters_reference(mask)
            return rel(got, per_ref["p"][index], 1e-12)
        return verify

    def euler(ref_img):
        def verify(got):
            check(got == _closed_euler(ref_img), "euler_number")
            return f"exact ({got})"
        return verify

    def moments(got):
        r = np.arange(4096, dtype=f64)
        vr = r[:, None] ** np.arange(4)
        ref = vr.T @ img.astype(f64) @ vr
        check(got.dtype == torch.float64, "moments dtype")
        err = float((np.abs(host(got) - ref) / np.abs(ref)).max())
        check(err <= 1e-10, f"moments: {err:.3e} relative")
        return f"{err:.3e} relative (tol 1e-10)"

    def profile(order, tol):
        def verify(got):
            check(got.dtype == torch.float32, "profile dtype")
            return rel(got, _profile_reference(img, src, dst, 5, order,
                                               "reflect"), tol)
        return verify

    def blocks(got):
        ref = img.astype(f64).reshape(1024, 4, 1024, 4).sum(axis=(1, 3))
        return rel(got, ref, 1e-6)

    def hist(got):
        h, c = got
        lo = int(u16.min())
        identical(h, np.bincount(u16.ravel().astype(np.int64) - lo))
        check(np.array_equal(host(c), np.arange(lo, int(u16.max()) + 1)),
              "bin centres")
        return "exact"

    def equalized(got):
        h = np.bincount(u16.ravel().astype(np.int64) - int(u16.min()))
        cdf = np.cumsum(h) / h.sum()
        centres = np.arange(int(u16.min()), int(u16.max()) + 1, dtype=f64)
        check(got.dtype == torch.float64, "equalize_hist dtype")
        return rel(got, np.interp(u16.ravel(), centres, cdf).reshape(
            u16.shape), 1e-12)

    def rescaled(got):
        x = u16.astype(f64)
        ref = ((x - x.min()) / (x.max() - x.min()) * 65535).astype(np.uint16)
        return identical(got, ref)

    def clahe(x):
        def verify(got):
            ref = texp.equalize_adapthist(x.cpu())
            check(got.dtype == ref.dtype, "CLAHE dtype")
            err = float((got.cpu() - ref).abs().max())
            check(err <= 1.5 / 16383,
                  f"CLAHE: {err:.3e} (tol one level, 1.5 / 16383)")
            return f"{err:.3e} vs the port's CPU result (one level: " \
                   f"{1 / 16383:.3e})"
        return verify

    def matched(got):
        ref = np.stack([_match_reference(rgb_2k[..., c], tmpl_2k[..., c])
                        for c in range(3)], -1)
        return rel(got, ref, 1e-12)

    def label2rgb_avg(got):
        index = np.arange(0, n_lab + 1)
        means = np.stack([sndi.mean(rgb_2k[..., c].astype(f64), lab2, index)
                          for c in range(3)], -1)
        means[0] = 0
        return rel(got, means[lab2], 1e-12)

    def label2rgb_overlay(got):
        ref = tcolor.label2rgb(torch.from_numpy(lab2),
                               torch.from_numpy(inten), bg_label=0)
        return rel(got, ref.numpy(), 1e-12) + " (port CPU)"

    call("regionprops_table(2048^2 i32, ~1000 blobs, f32 intensity)",
         lambda: tmeas.regionprops_table(lab2c, intenc, properties=props),
         table)
    call("perimeter(4096^2 bool)", lambda: tmeas.perimeter(maskc),
         perimeters(0))
    call("perimeter_crofton(4096^2 bool)",
         lambda: tmeas.perimeter_crofton(maskc), perimeters(1))
    call("euler_number(4096^2 bool)", lambda: tmeas.euler_number(maskc),
         euler(mask))
    call("euler_number(256^3 bool)", lambda: tmeas.euler_number(volc),
         euler(vol))
    call("moments(4096^2 f32, order 3)", lambda: tmeas.moments(imgc, 3),
         moments)
    call("profile_line(4096^2 f32, width 5, order 1)",
         lambda: tmeas.profile_line(imgc, src, dst, linewidth=5, order=1,
                                    mode="reflect"),
         profile(1, 1e-5), {"spline_gather": 1})
    call("profile_line(4096^2 f32, width 5, order 3)",
         lambda: tmeas.profile_line(imgc, src, dst, linewidth=5, order=3,
                                    mode="reflect"),
         profile(3, coef_tol(3, 2)),
         {"spline_gather": 1, "fused_separable_correlate": 1})
    call("block_reduce(4096^2 f32, (4, 4))",
         lambda: tmeas.block_reduce(imgc, (4, 4)), blocks)
    color_calls = [
        ("rgb2lab", tcolor.rgb2lab, (rgbc,), 2e-5),
        ("lab2rgb", tcolor.lab2rgb, (tcolor.rgb2lab(rgbc),), 1e-5),
        ("rgb2hsv", tcolor.rgb2hsv, (rgbc,), 1e-6),
        ("hsv2rgb", tcolor.hsv2rgb, (tcolor.rgb2hsv(rgbc),), 1e-6),
        ("rgb2gray", tcolor.rgb2gray, (rgbc,), 1e-6),
        ("separate_stains hed", lambda x: tcolor.separate_stains(
            x, tcolor.hed_from_rgb), (rgbc,), 1e-6),
    ]
    for name, fn, args, tol in color_calls:
        call(f"{name}(4096^2x3 f32, TF32 allowed)",
             (lambda fn=fn, args=args: fn(*args)),
             cpu_crop(fn, *args, tol=tol))
    call("deltaE_ciede2000(4096^2 Lab pairs, f64, TF32 allowed)",
         lambda: tcolor.deltaE_ciede2000(lab_ac, lab_bc),
         cpu_crop(tcolor.deltaE_ciede2000, lab_ac, lab_bc, tol=1e-12))
    call("label2rgb(2048^2 labels, f32 image, overlay)",
         lambda: tcolor.label2rgb(lab2c, intenc, bg_label=0),
         label2rgb_overlay)
    call("label2rgb(2048^2 labels, 2048^2x3 f32, avg)",
         lambda: tcolor.label2rgb(lab2c, rgb_2kc, kind="avg", bg_label=0),
         label2rgb_avg)
    call("histogram(4096^2 u16)", lambda: texp.histogram(u16c), hist)
    call("equalize_hist(4096^2 u16)", lambda: texp.equalize_hist(u16c),
         equalized)
    call("rescale_intensity(4096^2 u16)",
         lambda: texp.rescale_intensity(u16c), rescaled)
    call("equalize_adapthist(2048^2 u16)",
         lambda: texp.equalize_adapthist(u16_2kc), clahe(u16_2kc))
    call("equalize_adapthist(1024^2x3 u8)",
         lambda: texp.equalize_adapthist(rgb_1kc), clahe(rgb_1kc))
    call("match_histograms(2048^2x3 f32)",
         lambda: texp.match_histograms(rgb_2kc, tmpl_2kc, channel_axis=-1),
         matched)

    return _run_calls("skimage path", counters, calls, torch)


def _clip_to(ref, x, mode, cval):
    """skimage's clip of a warp's output to the input's range (and
    ``cval`` in mode 'constant')."""
    lo, hi = float(x.min()), float(x.max())
    if mode == "constant":
        lo, hi = min(lo, cval), max(hi, cval)
    return np.clip(ref, lo, hi)


def _daisy_reference(img, step, radius, rings, histograms, orientations,
                     normalization="l1"):
    """DAISY in float64 numpy/scipy: orientation maps of the forward
    differences, a scipy gaussian per ring, windows at the rings' sample
    points, normalized (skimage's 'l1', 'l2', 'daisy' or 'off').  The
    port's CPU tests hold ``daisy`` against it too."""
    import math

    import scipy.ndimage as sndi

    dx = np.pad(np.diff(img, axis=1), ((0, 0), (0, 1)))
    dy = np.pad(np.diff(img, axis=0), ((0, 1), (0, 0)))
    mag, ori = np.hypot(dx, dy), np.arctan2(dy, dx)
    maps = [np.exp(orientations / np.pi * np.cos(
        ori - (2 * o * np.pi / orientations - np.pi))) * mag
        for o in range(orientations)]
    sigmas = [radius * (i + 1) / (2 * rings) for i in range(rings)]
    radii = [radius * (i + 1) / rings for i in range(rings)]
    sigmas = [sigmas[0]] + sigmas
    rows, cols = img.shape[0] - 2 * radius, img.shape[1] - 2 * radius
    blocks = []
    for ring in range(rings + 1):
        sm = [sndi.gaussian_filter(m, sigmas[ring]) for m in maps]
        offsets = [(0, 0)] if ring == 0 else [
            (int(round(radii[ring - 1] * math.sin(2 * np.pi * j
                                                   / histograms))),
             int(round(radii[ring - 1] * math.cos(2 * np.pi * j
                                                   / histograms))))
            for j in range(histograms)]
        for oy, ox in offsets:
            for s in sm:
                blocks.append(s[radius + oy:radius + oy + rows:step,
                                radius + ox:radius + ox + cols:step])
    d = np.stack(blocks, -1)
    if normalization == "off":
        return d
    d = d + 1e-10
    if normalization == "l1":
        return d / d.sum(-1, keepdims=True)
    if normalization == "l2":
        return d / np.sqrt((d * d).sum(-1, keepdims=True))
    parts = np.split(d, d.shape[-1] // orientations, axis=-1)
    return np.concatenate([p / np.sqrt((p * p).sum(-1, keepdims=True))
                           for p in parts], -1)


def transform_path(counters, torch):
    """Phase 4, transform/feature path: ``skimage.transform``,
    ``skimage.feature`` (all but canny) and ``skimage.metrics`` at full
    size (4096^2 float32 images, 4096^2x3 RGB, a 256^3 volume for the
    Hessian, 2048^2 for daisy, 1024^2 for the piecewise affine warp), the
    counts set to 0 just before it and read just after.  The
    float32 calls run on the kernels: B1's correlation (the anti-aliasing
    and pyramid gaussians, sobels, the structure tensor, the Hessian,
    daisy, the order-3 prefilters), B1 min/max (peak_local_max), the
    spline gather's affine entry (affine warps, rotate, resize, rescale
    and the pyramids through zoom) and map entry (projective and callable
    warps, swirl, warp_polar, the piecewise affine warp) and the FFT
    kernel (match_template); each call's launches must be as planned.
    Matmul TF32 is allowed over the path, so that a float32 product on
    the tensor cores would fail a check.  Each call is held against
    scipy/numpy on the host (the warps on output windows, from the
    transform's float64 params: 1e-5 of max|ref| for order 1,
    ``coef_tol`` for order 3), or against the port's CPU result of the
    same call on the same input (the peak finders, exactly).  Times each
    call (median of 10 after 2 warm-ups; 3 after none for calls of more
    than 100 ms).  Returns the calls' rows and the path's launches."""
    import scipy.ndimage as sndi

    import cupyimg_tpu_torch.skimage.feature as tfeat
    import cupyimg_tpu_torch.skimage.metrics as tmet
    import cupyimg_tpu_torch.skimage.transform as ttr

    rng = np.random.default_rng(13)
    f64 = np.float64
    n, n2, nv, npw, w = 4096, 2048, 256, 1024, 256
    sync = torch.cuda.synchronize

    img = rng.random((n, n), dtype=np.float32)
    img2 = rng.random((n2, n2), dtype=np.float32)
    rgb = rng.random((n, n, 3), dtype=np.float32)
    noisy = np.clip(img + 0.1 * rng.standard_normal((n, n)), 0, 1).astype(
        np.float32)
    smooth = sndi.gaussian_filter(rng.random((n, n), dtype=np.float32), 12,
                                  truncate=2.5)
    smooth = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    vol = sndi.gaussian_filter(rng.random((nv, nv, nv), dtype=np.float32),
                               2)
    u8 = (rng.random((n, n)) * 256).astype(np.uint8)
    blocks = (np.arange(n)[:, None] * 4 // n * 4
              + np.arange(n)[None, :] * 4 // n + 1).astype(np.int32)
    tmpl = img[1000:1031, 2000:2031].copy()
    starts = rng.integers(0, n - 64, (100000, 2))
    ends = starts + rng.integers(0, 64, (100000, 2))
    src = rng.random((1000, 2)) * n
    sim = ttr.SimilarityTransform(scale=1.3, rotation=0.4,
                                  translation=(20.0, -30.0))
    proj_true = np.array([[1.1, 0.05, 12.0], [-0.03, 0.95, -7.0],
                          [2e-5, -1e-5, 1.0]])
    dst_sim = host(sim(torch.from_numpy(src)))
    dst_proj = host(ttr.ProjectiveTransform(proj_true)(
        torch.from_numpy(src)))
    grid = np.stack(np.meshgrid(np.linspace(0, npw - 1, 9),
                                np.linspace(0, npw - 1, 9)), -1).reshape(
        -1, 2)
    pw = ttr.PiecewiseAffineTransform()
    pw.estimate(grid, grid + rng.standard_normal(grid.shape) * npw / 200)
    (imgc, img2c, rgbc, noisyc, smoothc, volc, u8c, blocksc, tmplc,
     pwc) = (dev(a) for a in (img, img2, rgb, noisy, smooth, vol, u8, blocks,
                              tmpl, img[:npw, :npw]))
    sync()

    aff = ttr.AffineTransform(scale=(1.05, 0.9), rotation=0.3, shear=0.1,
                              translation=(-150.0, 80.0))
    proj = ttr.ProjectiveTransform(np.array([[1.02, 0.08, -40.0],
                                             [-0.05, 0.97, 60.0],
                                             [2e-5, -3e-5, 1.0]]))
    swirl_kw = dict(strength=4, radius=n / 3)
    # output windows: one inside, one at the corner (the boundary modes)
    wins = [(n // 2 - w, n // 3), (0, 0)]
    x64, x2_64 = img.astype(f64), img2.astype(f64)
    coefs = {}

    def spline(x, order, mode):
        key = (id(x), order, mode)
        if key not in coefs:
            coefs[key] = sndi.spline_filter(x, order, mode=mode)
        return coefs[key]

    def sample(x, rows, cols, order, mode, cval=0.0):
        """scipy's map_coordinates at float64 (row, col) points of x."""
        c = x if order < 2 else spline(x, order, mode)
        return sndi.map_coordinates(c, np.stack([rows, cols]), order=order,
                                    mode=mode, cval=cval, prefilter=False)

    def window(r0, c0, shape, size=w):
        rr = np.arange(r0, min(r0 + size, shape[0]), dtype=f64)
        cc = np.arange(c0, min(c0 + size, shape[1]), dtype=f64)
        return np.meshgrid(rr, cc, indexing="ij")

    def f32(got):
        check(got.dtype == torch.float32, f"dtype {got.dtype}, not float32")

    def warped(x, params, order, mode, cval=0.0, tol=1e-5, mapping=None):
        """A warp of x against map_coordinates at its params' (or
        ``mapping``'s) source points on the output windows, clipped."""
        def verify(got):
            f32(got)
            msgs = []
            for r0, c0 in wins:
                rr, cc = window(r0, c0, got.shape)
                if mapping is not None:
                    sx, sy = mapping(cc, rr)
                else:
                    M = params
                    wgt = M[2, 0] * cc + M[2, 1] * rr + M[2, 2]
                    sx = (M[0, 0] * cc + M[0, 1] * rr + M[0, 2]) / wgt
                    sy = (M[1, 0] * cc + M[1, 1] * rr + M[1, 2]) / wgt
                ref = _clip_to(sample(x, sy, sx, order, mode, cval), x, mode,
                               cval)
                sl = (slice(r0, r0 + w), slice(c0, c0 + w))
                msgs.append(rel(got[sl], ref, tol))
            return "; ".join(msgs) + " (output windows vs map_coordinates)"
        return verify

    def zoomed(x, factors, order, sigma=None):
        """resize: scipy's gaussian (mode mirror) if ``sigma``, then
        zoom(grid_mode=True) as map_coordinates at (o + 0.5) * f - 0.5,
        on the output windows."""
        def verify(got):
            f32(got)
            y = x if sigma is None else sndi.gaussian_filter(x, sigma,
                                                             mode="mirror")
            msgs = []
            for r0, c0 in wins:
                rr, cc = window(r0, c0, got.shape)
                sr = (rr + 0.5) * factors[0] - 0.5
                sc = (cc + 0.5) * factors[1] - 0.5
                if y.ndim == 3:
                    ref = np.stack([sample(y[..., k], sr, sc, order,
                                           "mirror")
                                    for k in range(y.shape[2])], -1)
                else:
                    ref = sample(y, sr, sc, order, "mirror")
                sl = (slice(r0, r0 + w), slice(c0, c0 + w))
                msgs.append(rel(got[sl], _clip_to(ref, y, "mirror", 0.0),
                                1e-5 if order < 2 else coef_tol(order, 2)))
            return "; ".join(msgs) + " (windows vs gaussian + zoom)"
        return verify

    def rotated(order, resize):
        a = np.deg2rad(30.0)
        rows = cols = n
        center = np.array([(rows - 1) / 2, (cols - 1) / 2])
        m = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
        out_center = center
        if resize:
            corners = np.array([[0, 0], [0, cols - 1], [rows - 1, cols - 1],
                                [rows - 1, 0]], f64) - center
            rot = corners @ np.linalg.inv(m).T
            out_center = -rot.min(0)
        offset = center - m @ out_center

        def mapping(cc, rr):
            return (m[1, 0] * rr + m[1, 1] * cc + offset[1],
                    m[0, 0] * rr + m[0, 1] * cc + offset[0])
        return warped(x64, None, order, "constant", mapping=mapping,
                      tol=1e-5 if order < 2 else coef_tol(order, 2))

    def swirled(got):
        x0, y0 = n / 2, n / 2
        radius = swirl_kw["radius"] / 5 * np.log(2)

        def mapping(cc, rr):
            rho = np.hypot(cc - x0, rr - y0)
            theta = swirl_kw["strength"] * np.exp(-rho / radius) + \
                np.arctan2(rr - y0, cc - x0)
            return x0 + rho * np.cos(theta), y0 + rho * np.sin(theta)
        return warped(x64, None, 1, "mirror", mapping=mapping)(got)

    def polar(got):
        f32(got)
        radius = np.sqrt(2 * (n / 2) ** 2)
        height, width = 360, int(np.ceil(radius))
        rr, cc = np.mgrid[0:height, 0:width].astype(f64)
        ang = rr / (height / (2 * np.pi))
        rad = cc / (width / radius)
        c0 = n / 2 - 0.5
        ref = sample(x64, rad * np.sin(ang) + c0, rad * np.cos(ang) + c0, 1,
                     "constant")
        return rel(got, _clip_to(ref, x64, "constant", 0.0), 1e-5)

    def pyramid(kind):
        def verify(levels):
            msgs = []
            prev = x64
            for k, lv in enumerate(levels):
                f32(lv)
                if kind == "gaussian":
                    if k == 0:
                        ref = prev
                    else:
                        y = sndi.gaussian_filter(prev, 2 / 3, mode="mirror")
                        shape = tuple(-(-s // 2) for s in prev.shape)
                        ref = sndi.zoom(y, np.divide(shape, prev.shape),
                                        order=1, mode="mirror",
                                        grid_mode=True)
                        ref = _clip_to(ref, y, "mirror", 0.0)
                    # the next level from the card's own level
                    prev = host(lv).astype(f64)
                    msgs.append(rel(lv, ref, 1e-5))
            return f"{len(levels)} levels: " + "; ".join(msgs[1:])
        return verify

    def laplacian(levels):
        # float64 on the host: smooth, layer = resized - smooth(resized)
        smooth_ = sndi.gaussian_filter(x64, 2 / 3, mode="mirror")
        refs = [x64 - smooth_]
        cur = smooth_
        for _ in range(len(levels) - 1):
            shape = tuple(-(-s // 2) for s in cur.shape)
            resized = _clip_to(sndi.zoom(cur, np.divide(shape, cur.shape),
                                         order=1, mode="mirror",
                                         grid_mode=True), cur, "mirror", 0.0)
            cur = sndi.gaussian_filter(resized, 2 / 3, mode="mirror")
            refs.append(resized - cur)
        msgs = []
        for lv, ref in zip(levels, refs):
            f32(lv)
            err = float(np.abs(host(lv) - ref).max())
            check(err <= 1e-5, f"laplacian level: {err:.3e} (tol 1e-5 of "
                               f"the image's range, 1)")
            msgs.append(f"{err:.1e}")
        return f"{len(levels)} levels within {max(msgs)} of the image's " \
               f"range (tol 1e-5)"

    def integral(got):
        return identical(got, u8.astype(np.int64).cumsum(0).cumsum(1))

    ii_host = u8.astype(np.int64).cumsum(0).cumsum(1)
    iic = dev(ii_host)

    def integrated(got):
        want = np.array([u8[a:c + 1, b:d + 1].sum() for (a, b), (c, d) in
                         zip(starts[:2000], ends[:2000])])
        check(got.dtype == torch.int64, "integrate dtype")
        gh = host(got)
        check(np.array_equal(gh[:2000], want), "integrate vs direct sums")
        pad = np.pad(ii_host, ((1, 0), (1, 0)))
        a, b = starts[:, 0], starts[:, 1]
        c, d = ends[:, 0] + 1, ends[:, 1] + 1
        check(np.array_equal(gh, pad[c, d] - pad[a, d] - pad[c, b]
                             + pad[a, b]), "integrate vs numpy corners")
        return "exact (2000 windows by direct sums, all by numpy corners)"

    def local_mean(got):
        f32(got)
        return rel(got, x64.reshape(n // 4, 4, n // 4, 4).mean(axis=(1, 3)),
                   1e-6)

    def structure(x, margin=16):
        """scipy's sobel derivatives and gaussian products on a window
        with a margin (the image's edge in mode constant at the corner
        window)."""
        out = []
        for r0, c0 in wins:
            lo_r, lo_c = max(0, r0 - margin), max(0, c0 - margin)
            sub = x[lo_r:r0 + w + margin, lo_c:c0 + w + margin].astype(f64)
            d = [sndi.sobel(sub, axis=i, mode="constant") for i in (0, 1)]
            A = [sndi.gaussian_filter(p * q, 1, mode="constant")
                 for p, q in ((d[0], d[0]), (d[0], d[1]), (d[1], d[1]))]
            out.append(((r0, c0), [a[r0 - lo_r:r0 - lo_r + w,
                                     c0 - lo_c:c0 - lo_c + w] for a in A]))
        return out

    def corner(kind):
        def verify(got):
            f32(got)
            msgs = []
            for (r0, c0), (arr, arc, acc) in structure(img):
                if kind == "harris":
                    ref = arr * acc - arc ** 2 - 0.05 * (arr + acc) ** 2
                else:
                    ref = (arr + acc - np.sqrt((arr - acc) ** 2
                                               + 4 * arc ** 2)) / 2
                msgs.append(rel(got[r0:r0 + w, c0:c0 + w], ref, 1e-5))
            return "; ".join(msgs) + " (windows vs scipy sobel/gaussian)"
        return verify

    harris_smooth = tfeat.corner_harris(smoothc)
    sync()

    def same_as_cpu(fn, *args):
        """The port's CPU result of the same call on the same input:
        the same coordinates in the same order."""
        def verify(got):
            ref = fn(*(a.cpu() for a in args))
            check(got.dtype == torch.int64, "coordinates dtype")
            check(torch.equal(got.cpu(), ref), f"{got.shape[0]} peaks vs "
                  f"{ref.shape[0]} of the port's CPU result")
            pts = host(got)
            vals = host(args[0])[tuple(pts.T)]
            # by label (when labels are given), then by intensity
            lab = (host(args[1])[tuple(pts.T)] if len(args) > 1
                   else np.zeros(len(pts)))
            check(np.all(np.diff(lab) >= 0), "peaks not by label")
            same_lab = np.diff(lab) == 0
            check(np.all(np.diff(vals)[same_lab] <= 0),
                  "peaks not by intensity")
            return f"{got.shape[0]} peaks, exactly as the port's CPU " \
                   f"result"
        return verify

    def hessian_det(got):
        check(got.dtype == torch.float64, "hessian_matrix_det dtype")
        msgs = []
        for r0, c0 in wins:
            lo_r, lo_c = max(0, r0 - 16), max(0, c0 - 16)
            sub = img[lo_r:r0 + w + 16, lo_c:c0 + w + 16]
            ref = host(tfeat.hessian_matrix_det(torch.from_numpy(sub)))
            msgs.append(rel(got[r0:r0 + w, c0:c0 + w],
                            ref[r0 - lo_r:r0 - lo_r + w,
                                c0 - lo_c:c0 - lo_c + w], 1e-7))
        return "; ".join(msgs) + " (windows vs the port's CPU result)"

    def hessian_of(x, margin=12):
        """scipy's gaussian and numpy's gradient on a window with a
        margin, 'rc' order (the last axis first)."""
        g = np.gradient(sndi.gaussian_filter(x.astype(f64), 1,
                                             mode="constant"))
        axes = list(range(x.ndim))[::-1]
        return [np.gradient(g[a], axis=b) for a, b in
                [(axes[i], axes[j]) for i in range(x.ndim)
                 for j in range(i, x.ndim)]]

    def shape_idx(got):
        f32(got)
        r0, c0 = wins[0]
        sub = img[r0 - 16:r0 + w + 16, c0 - 16:c0 + w + 16]
        hrr, hrc, hcc = (h[16:16 + w, 16:16 + w] for h in hessian_of(sub))
        tr, dt = (hrr + hcc) / 2, np.sqrt(((hrr - hcc) / 2) ** 2 + hrc ** 2)
        with np.errstate(divide="ignore", invalid="ignore"):
            ref = 2 / np.pi * np.arctan(((tr - dt) + (tr + dt))
                                        / ((tr - dt) - (tr + dt)))
        err = np.abs(host(got)[r0:r0 + w, c0:c0 + w] - ref)
        err = err[np.isfinite(ref)]
        med, p999 = float(np.median(err)), float(np.quantile(err, 0.999))
        check(np.isfinite(host(got)).sum() >= got.numel() - 16,
              "shape_index: non-finite values")
        check(med <= 1e-5 and p999 <= 1e-2, f"shape_index: median "
              f"{med:.2e}, 99.9th percentile {p999:.2e}")
        return f"median {med:.2e} (tol 1e-5), 99.9th percentile " \
               f"{p999:.2e} (tol 1e-2: arctan of an eigenvalue ratio, " \
               f"ill-conditioned where the eigenvalues meet)"

    def hessian3d(got):
        elems, eig = got
        for e in elems:
            f32(e)
        msgs = []
        sl = tuple(slice(nv // 2 - 8, nv // 2 + 8) for _ in range(3))
        sub_sl = tuple(slice(s.start - 8, s.stop + 8) for s in sl)
        refs = hessian_of(vol[sub_sl])
        inner = tuple(slice(8, 24) for _ in range(3))
        vmax = float(np.abs(vol).max())
        errs = []
        for e, r in zip(elems, refs):
            # second differences of a float32 gaussian: the rounding of
            # the smoothed values (~eps32 of the input) is what remains
            err = float(np.abs(host(e[sl]).astype(f64) - r[inner]).max())
            check(err <= 1e-6 * vmax, f"hessian element: {err:.3e} "
                                      f"(tol 1e-6 of max|volume|)")
            errs.append(err / vmax)
        msgs.append(f"within {max(errs):.3e} of max|volume| (tol 1e-6)")
        H = np.stack([host(e).ravel().astype(f64) for e in elems], -1)
        pick = rng.integers(0, H.shape[0], 100000)
        a, b, c, d, e_, f = H[pick].T
        M = np.stack([np.stack([a, b, c], -1), np.stack([b, d, e_], -1),
                      np.stack([c, e_, f], -1)], -2)
        ref = np.linalg.eigvalsh(M)[:, ::-1].T
        got_e = host(eig).reshape(3, -1)[:, pick]
        # the closed form's arccos near +-1 turns float32 rounding into
        # ~sqrt(eps32) of the angle: 8.5e-5 of max|eigenvalue| over a
        # whole 128^3 volume on the CPU
        msgs.append(rel(got_e, ref, 5e-4, "max|eigenvalue|"))
        return f"elements {msgs[0]} (a window vs scipy); eigenvalues " \
            f"{msgs[-1]} (1e5 voxels vs eigvalsh)"

    def ncc_points(got):
        """match_template at sampled windows against the direct float64
        normalized cross-correlation.  The bound: float32 window sums are
        differences of a two-stage cumulative sum whose largest prefix is
        P = 31 * (n + 62) * max|x|^2; each carries ~eps32 * P, so the
        correlation moves by at most ~8 eps32 P / V, V the smallest
        window variance sum sampled."""
        f32(got)
        gh = host(got)
        m = n - 30
        pick = np.concatenate([rng.integers(0, m, (2000, 2)),
                               [[0, 0], [m - 1, m - 1], [0, m - 1]]])
        t = tmpl.astype(f64) - tmpl.mean(dtype=f64)
        vals, vmin = [], np.inf
        for i, j in pick:
            win_ = x64[i:i + 31, j:j + 31]
            win_ = win_ - win_.mean()
            v = (win_ * win_).sum()
            vmin = min(vmin, v)
            vals.append((win_ * t).sum() / np.sqrt(v * (t * t).sum()))
        P = 31 * (n + 62) * float(np.abs(x64).max()) ** 2
        tol = 8 * np.finfo(np.float32).eps * P / vmin
        err = float(np.abs(gh[tuple(pick.T)] - np.array(vals)).max())
        check(got.shape == (m, m), f"match_template shape {got.shape}")
        check(err <= tol, f"match_template: {err:.3e} (tol {tol:.2e})")
        return f"{err:.3e} at 2003 windows vs direct float64 NCC (tol " \
               f"8 eps32 P / V = {tol:.2e})"

    def daisy_check(got):
        f32(got)
        step, radius = 4, 15
        r0 = c0 = n2 // 4            # a multiple of the step
        margin = 48
        sub = img2[r0 - margin:r0 + 2 * w + margin,
                   c0 - margin:c0 + 2 * w + margin].astype(f64)
        ref = _daisy_reference(sub, step, radius, 3, 8, 8)
        # descriptor (a, b) of the window: pixel r0 - margin + 15 + 4a
        a0 = (margin - 15 + 15) // step   # clear of the gaussians' reach
        k = (r0 - margin) // step
        sl = slice(a0, a0 + (2 * w - 2 * margin) // step)
        return rel(host(got)[k + sl.start:k + sl.stop,
                             k + sl.start:k + sl.stop], ref[sl, sl], 1e-5) \
            + " (a window vs scipy's gaussians in float64)"

    def ssim(got):
        x, y = x64, noisy.astype(f64)
        f = lambda v: sndi.uniform_filter(v, 7)  # noqa: E731
        ux, uy = f(x), f(y)
        cov = 49 / 48
        vx, vy = cov * (f(x * x) - ux * ux), cov * (f(y * y) - uy * uy)
        vxy = cov * (f(x * y) - ux * uy)
        c1, c2 = (0.01 * 2) ** 2, (0.03 * 2) ** 2
        S = ((2 * ux * uy + c1) * (2 * vxy + c2)
             / ((ux * ux + uy * uy + c1) * (vx + vy + c2)))
        ref = S[3:-3, 3:-3].mean()
        check(got.dtype == torch.float64, "SSIM dtype")
        err = abs(float(got) - ref) / abs(ref)
        check(err <= 1e-10, f"SSIM: {err:.3e} relative")
        return f"{err:.3e} relative (tol 1e-10) vs scipy's uniform filters"

    mse_ref = np.mean((x64 - noisy.astype(f64)) ** 2)

    def scalar(ref_fn):
        def verify(got):
            ref = ref_fn()
            err = abs(float(got) - ref) / abs(ref)
            check(err <= 1e-5, f"{err:.3e} relative")
            return f"{err:.3e} relative (tol 1e-5) vs float64 numpy"
        return verify

    def estimated(truth):
        def verify(got):
            check(isinstance(got.params, np.ndarray)
                  and got.params.dtype == f64, "params not float64 numpy")
            err = float(np.abs(got.params / got.params[2, 2]
                               - truth / truth[2, 2]).max())
            check(err <= 1e-9, f"params {err:.3e} from the truth")
            return f"params {err:.3e} from the truth (tol 1e-9)"
        return verify

    def piecewise(got):
        f32(got)
        rr, cc = window(npw // 4, npw // 4, got.shape, npw // 2)
        pts = np.stack([cc.ravel(), rr.ravel()], -1)
        src_pts = host(pw(torch.from_numpy(pts)))
        ref = sample(img[:npw, :npw].astype(f64), src_pts[:, 1].reshape(
            rr.shape), src_pts[:, 0].reshape(rr.shape), 1, "constant")
        ref = np.where((src_pts[:, 0] == -1).reshape(rr.shape), 0.0, ref)
        ref = _clip_to(ref, img[:npw, :npw], "constant", 0.0)
        sl = (slice(npw // 4, npw // 4 + rr.shape[0]),
              slice(npw // 4, npw // 4 + rr.shape[1]))
        check((pw._tesselation.find_simplex(pts) >= 0).all(),
              "window outside the mesh")
        return rel(got[sl], ref, 1e-5) + " (a window vs map_coordinates " \
            "at the host mesh's points)"

    G = {"spline_gather": 1}
    B1G = {"spline_gather": 1, "fused_separable_correlate": 1}
    calls = []

    def call(label, fn, verify, kernels=None):
        calls.append((label, kernels or {}, fn, verify))

    call(f"resize({n}^2 -> {n2}^2 f32, order 1, anti-aliased)",
         lambda: ttr.resize(imgc, (n2, n2)),
         zoomed(x64, (2.0, 2.0), 1, sigma=0.5), B1G)
    call(f"resize({n2}^2 -> {n}^2 f32, order 3)",
         lambda: ttr.resize(img2c, (n, n), order=3),
         zoomed(x2_64, (0.5, 0.5), 3), B1G)
    call(f"rescale({n}^2x3 f32, 0.5, multichannel)",
         lambda: ttr.rescale(rgbc, 0.5, multichannel=True),
         zoomed(rgb.astype(f64), (2.0, 2.0), 1, sigma=(0.5, 0.5, 0)), B1G)
    call(f"rotate({n}^2 f32, 30, order 1)",
         lambda: ttr.rotate(imgc, 30, order=1), rotated(1, False), G)
    call(f"rotate({n}^2 f32, 30, order 3, resize)",
         lambda: ttr.rotate(imgc, 30, order=3, resize=True),
         rotated(3, True), B1G)
    call(f"warp({n}^2 f32, AffineTransform)",
         lambda: ttr.warp(imgc, aff), warped(x64, aff.params, 1, "constant"),
         G)
    call(f"warp({n}^2 f32, ProjectiveTransform)",
         lambda: ttr.warp(imgc, proj, mode="edge"),
         warped(x64, proj.params, 1, "nearest"), G)
    call(f"swirl({n}^2 f32)", lambda: ttr.swirl(imgc, **swirl_kw), swirled,
         G)
    call(f"warp_polar({n}^2 f32)", lambda: ttr.warp_polar(imgc), polar, G)
    call(f"pyramid_gaussian({n}^2 f32, 5 levels)",
         lambda: list(ttr.pyramid_gaussian(imgc, max_layer=4)),
         pyramid("gaussian"),
         {"spline_gather": 4, "fused_separable_correlate": 4})
    call(f"pyramid_laplacian({n}^2 f32, 5 levels)",
         lambda: list(ttr.pyramid_laplacian(imgc, max_layer=4)), laplacian,
         {"spline_gather": 4, "fused_separable_correlate": 5})
    call(f"integral_image({n}^2 u8)", lambda: ttr.integral_image(u8c),
         integral)
    call(f"integrate({n}^2 integral, 1e5 windows)",
         lambda: ttr.integrate(iic, starts, ends), integrated)
    call(f"downscale_local_mean({n}^2 f32, (4, 4))",
         lambda: ttr.downscale_local_mean(imgc, (4, 4)), local_mean)
    call(f"corner_harris({n}^2 f32)", lambda: tfeat.corner_harris(imgc),
         corner("harris"), {"fused_separable_correlate": 5})
    call(f"corner_shi_tomasi({n}^2 f32)",
         lambda: tfeat.corner_shi_tomasi(imgc), corner("shi_tomasi"),
         {"fused_separable_correlate": 5})
    call(f"corner_peaks(harris of smooth {n}^2, 25)",
         lambda: tfeat.corner_peaks(harris_smooth, min_distance=25),
         same_as_cpu(lambda h: tfeat.corner_peaks(h, min_distance=25),
                     harris_smooth), {"fused_separable_minmax": 1})
    call(f"hessian_matrix_det({n}^2 f32, SURF, f64 integral)",
         lambda: tfeat.hessian_matrix_det(imgc), hessian_det)
    call(f"shape_index({n}^2 f32)", lambda: tfeat.shape_index(imgc),
         shape_idx, {"fused_separable_correlate": 1})
    call(f"hessian_matrix + eigvals({nv}^3 f32)",
         lambda: (lambda h: (h, tfeat.hessian_matrix_eigvals(h)))(
             tfeat.hessian_matrix(volc)), hessian3d,
         {"fused_separable_correlate": 1})
    call(f"peak_local_max(smooth {n}^2 f32, 5)",
         lambda: tfeat.peak_local_max(smoothc, min_distance=5),
         same_as_cpu(lambda x: tfeat.peak_local_max(x, min_distance=5),
                     smoothc), {"fused_separable_minmax": 1})
    call(f"peak_local_max(smooth {n}^2 f32, 5, 16 labels)",
         lambda: tfeat.peak_local_max(smoothc, min_distance=5,
                                      labels=blocksc),
         same_as_cpu(lambda x, lb: tfeat.peak_local_max(
             x, min_distance=5, labels=lb), smoothc, blocksc),
         {"fused_separable_minmax": 16})
    call(f"match_template({n}^2 f32, 31x31)",
         lambda: tfeat.match_template(imgc, tmplc), ncc_points,
         {"fft_rows": 2, "fft_strided": 4})
    call(f"daisy({n2}^2 f32)", lambda: tfeat.daisy(img2c), daisy_check,
         {"fused_separable_correlate": 32})
    call(f"structural_similarity({n}^2 f32 pair, f64)",
         lambda: tmet.structural_similarity(imgc, noisyc), ssim)
    call(f"mean_squared_error({n}^2 f32)",
         lambda: tmet.mean_squared_error(imgc, noisyc),
         scalar(lambda: mse_ref))
    call(f"normalized_root_mse({n}^2 f32)",
         lambda: tmet.normalized_root_mse(imgc, noisyc),
         scalar(lambda: np.sqrt(mse_ref) / np.sqrt(np.mean(x64 ** 2))))
    call(f"peak_signal_noise_ratio({n}^2 f32)",
         lambda: tmet.peak_signal_noise_ratio(imgc, noisyc),
         scalar(lambda: 10 * np.log10(1.0 / mse_ref)))
    call("estimate_transform(similarity, 1000 points)",
         lambda: ttr.estimate_transform("similarity", src, dst_sim),
         estimated(sim.params))
    call("estimate_transform(projective, 1000 points)",
         lambda: ttr.estimate_transform("projective", src, dst_proj),
         estimated(proj_true))
    call(f"warp({npw}^2 f32, PiecewiseAffineTransform 9x9)",
         lambda: ttr.warp(pwc, pw), piecewise, G)

    return _run_calls(
        "transform path", counters, calls, torch,
        lambda label: ("host numpy" if label.startswith("estimate_transform")
                       else "plain torch"))


def _canny_reference(img, sigma, low, high):
    """skimage's canny in numpy/scipy, float64 throughout, no mask: the
    masked gaussian's quotient, the sobels, the four sectors' non-maximum
    suppression in skimage's order and the hysteresis by ``label``."""
    import scipy.ndimage as sndi

    eps = np.finfo(np.float64).eps
    smoothed = sndi.gaussian_filter(img.astype(np.float64), sigma,
                                    mode="constant") / (
        sndi.gaussian_filter(np.ones(img.shape), sigma, mode="constant")
        + eps)
    isobel = sndi.sobel(smoothed, axis=0)
    jsobel = sndi.sobel(smoothed, axis=1)
    ai, aj = np.abs(isobel), np.abs(jsobel)
    mag = np.hypot(isobel, jsobel)
    eroded = sndi.binary_erosion(np.ones(img.shape, bool),
                                 np.ones((3, 3), bool), border_value=0)
    eroded &= mag > 0
    pad = np.pad(mag, 1)
    n0, n1 = img.shape

    def m(di, dj):
        return pad[1 + di:1 + di + n0, 1 + dj:1 + dj + n1]

    with np.errstate(divide="ignore", invalid="ignore"):
        w_ij = np.where(ai == 0, 0.0, aj / np.where(ai == 0, 1.0, ai))
        w_ji = np.where(aj == 0, 0.0, ai / np.where(aj == 0, 1.0, aj))

    def le(c2, c1, w):
        return c2 * w + c1 * (1 - w) <= mag

    same = ((isobel >= 0) & (jsobel >= 0)) | ((isobel <= 0) & (jsobel <= 0))
    opp = ((isobel <= 0) & (jsobel >= 0)) | ((isobel >= 0) & (jsobel <= 0))
    local = np.zeros(img.shape, bool)
    for pts, val in (
            (eroded & same & (ai >= aj),
             le(m(1, 1), m(1, 0), w_ij) & le(m(-1, -1), m(-1, 0), w_ij)),
            (eroded & same & (ai <= aj),
             le(m(1, 1), m(0, 1), w_ji) & le(m(-1, -1), m(0, -1), w_ji)),
            (eroded & opp & (ai <= aj),
             le(m(-1, 1), m(0, 1), w_ji) & le(m(1, -1), m(0, -1), w_ji)),
            (eroded & opp & (ai >= aj),
             le(m(-1, 1), m(-1, 0), w_ij) & le(m(1, -1), m(1, 0), w_ij))):
        local = np.where(pts, val, local)
    high_mask = local & (mag >= high)
    low_mask = local & (mag >= low)
    labels, count = sndi.label(low_mask, np.ones((3, 3), bool))
    good = np.zeros(count + 1, bool)
    good[labels[high_mask]] = True
    good[0] = False
    return good[labels]


def _tv(x):
    """The anisotropic total variation of a 2-D array (float64)."""
    x = np.asarray(x, np.float64)
    return float(np.abs(np.diff(x, axis=0)).sum()
                 + np.abs(np.diff(x, axis=1)).sum())


def filters_path(counters, torch):
    """Phase 4, filters path: ``skimage.filters``, ``feature.canny`` and
    ``skimage.restoration`` at full size (4096^2 float32 images; frangi,
    the TV denoiser and Richardson-Lucy at 2048^2; the Wiener pair on the
    512^2 float64 restoration input of ``tests/data/restoration``), the
    counts set to 0 just before it and read just after, matmul TF32
    allowed.  The float32 calls run on the kernels: B1's correlation
    (gaussian, difference_of_gaussians, unsharp_mask, frangi's Hessian
    for the sigmas of at most 64 taps, canny's image gaussian), B3
    (median of float32), the gather's map entry (window) and B2
    (richardson_lucy's two convolutions an iteration); each call's
    launches must be as planned, and every other call (the float64 edge
    filters, local thresholds and gabor, the uint8 median, the TV
    denoiser, the Wiener pair on torch.fft) launches none.  Each result
    is held against scipy/numpy on the host (on windows for the
    stencils; canny and Richardson-Lucy whole, in float64), against the
    port's CPU result on crops (frangi, the TV denoiser) or against the
    restoration goldens (wiener, unsupervised_wiener).  Times each call
    (median of 10 after 2 warm-ups; 3 after none for calls of more than
    100 ms).  Returns the calls' rows and the path's launches."""
    import os

    import scipy.ndimage as sndi
    import scipy.signal as ssig
    from scipy.signal import get_window

    import cupyimg_tpu_torch.skimage.filters as tfil
    import cupyimg_tpu_torch.skimage.restoration as trest
    from cupyimg_tpu_torch.skimage.feature import canny

    rng = np.random.default_rng(14)
    f64 = np.float64
    n, n2, w = 4096, 2048, 256
    sync = torch.cuda.synchronize
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "restoration")

    img = rng.random((n, n), dtype=np.float32)
    blobs = sndi.gaussian_filter(rng.random((n, n), dtype=np.float32), 8,
                                 truncate=2.5)
    blobs = ((blobs - blobs.min()) / (blobs.max() - blobs.min())
             + 0.05 * rng.standard_normal((n, n))).astype(np.float32)
    u8 = (rng.random((n, n)) * 256).astype(np.uint8)
    # frangi's gamma of 15 expects grey levels of 0-255
    vessels = np.ascontiguousarray(blobs[:n2, :n2] * np.float32(255))
    noisy = np.ascontiguousarray(img[:n2, :n2])
    psf = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float32) / 256
    blurred = ssig.convolve(blobs[:n2, :n2].astype(f64) + 0.1, psf,
                            mode="same").astype(np.float32)
    degraded = np.load(os.path.join(data, "degraded_input.npy"))
    golden = np.load(os.path.join(data, "camera_wiener.npy"))
    psf25 = np.ones((5, 5)) / 25
    (imgc, blobsc, u8c, vesselsc, noisyc, blurredc, degradedc, psfc,
     psf25c) = (dev(a) for a in (img, blobs, u8, vessels, noisy, blurred,
                                 degraded, psf, psf25))
    sync()
    # output windows: one inside, one at the corner (the boundary modes)
    wins = [(n // 2 - w, n // 3), (0, 0)]

    def windowed(x, ref_fn, tol, dtype, margin=48, exact=False):
        """``ref_fn`` (scipy, float64) of a crop with a margin, against
        the result on each output window."""
        def verify(got):
            check(got.dtype == dtype, f"dtype {got.dtype}, want {dtype}")
            msgs = []
            for r0, c0 in wins:
                a0, b0 = max(r0 - margin, 0), max(c0 - margin, 0)
                crop = x[a0:r0 + w + margin, b0:c0 + w + margin]
                ref = ref_fn(crop)[r0 - a0:r0 - a0 + w, c0 - b0:c0 - b0 + w]
                part = host(got[r0:r0 + w, c0:c0 + w])
                if exact:
                    check(np.array_equal(part, ref), "differs from scipy")
                    msgs.append("exact")
                else:
                    msgs.append(rel(part, ref, tol))
            return "; ".join(msgs) + " (output windows vs scipy)"
        return verify

    def frangi_check(got):
        """The port's CPU float64 frangi on crops with a margin: its
        measures divide by eigenvalues near zero, where float32
        Hessians (B1 sums in float32) move a few pixels by up to a
        tenth of the maximum (a CPU run summing in float32 moved a 400^2
        crop's by 9.5 %), so 99.9 % of the pixels are held within 1e-3
        of max|ref| and every pixel within 0.25."""
        check(got.dtype == torch.float64, f"dtype {got.dtype}")
        msgs = []
        margin = 40
        for r0, c0 in ((n2 // 2 - w // 2, n2 // 3), (0, 0)):
            a0, b0 = max(r0 - margin, 0), max(c0 - margin, 0)
            ref = tfil.frangi(torch.from_numpy(vessels[
                a0:r0 + w + margin, b0:c0 + w + margin].astype(f64)))
            ref = ref.numpy()[r0 - a0:r0 - a0 + w, c0 - b0:c0 - b0 + w]
            err = np.abs(host(got[r0:r0 + w, c0:c0 + w]) - ref)
            scale = float(np.abs(ref).max()) or 1.0
            p999 = float(np.quantile(err, 0.999)) / scale
            worst = float(err.max()) / scale
            check(np.isfinite(err).all() and p999 <= 1e-3 and worst <= 0.25,
                  f"99.9th percentile {p999:.3e}, worst {worst:.3e} of "
                  f"max|ref|")
            msgs.append(f"99.9 % within {p999:.3e}, worst {worst:.3e} of "
                        f"max|ref|")
        return "; ".join(msgs) + " (port CPU float64, crops)"

    def dog_ref(c):
        c = c.astype(f64)
        return (sndi.gaussian_filter(c, 1, mode="nearest")
                - sndi.gaussian_filter(c, 2, mode="nearest"))

    def unsharp_ref(c):
        c = c.astype(f64)
        return np.clip(c + (c - sndi.gaussian_filter(c, 1, mode="nearest")),
                       0, 1)

    def sobel_ref(c):
        c = c.astype(f64)
        h = sndi.correlate1d(sndi.correlate1d(c, [-1, 0, 1], 0),
                             [0.25, 0.5, 0.25], 1)
        v = sndi.correlate1d(sndi.correlate1d(c, [-1, 0, 1], 1),
                             [0.25, 0.5, 0.25], 0)
        return np.sqrt((h * h + v * v) / 2)

    gk = tfil.gabor_kernel(0.2, device="cpu").numpy()

    def gabor_check(got):
        real, imag = got
        m1 = windowed(img, lambda c: sndi.convolve(c.astype(f64), gk.real),
                      1e-12, torch.float64)(real)
        m2 = windowed(img, lambda c: sndi.convolve(c.astype(f64), gk.imag),
                      1e-12, torch.float64)(imag)
        return f"real {m1}; imaginary {m2}"

    def window_check(got):
        check(got.dtype == torch.float64, f"dtype {got.dtype}")
        prof = get_window("hann", n, fftbins=False)
        c = np.float32(n / 2 - 0.5)
        msgs = []
        for r0, c0 in wins:
            rr = np.arange(r0, r0 + w, dtype=np.float32) - c
            cc = np.arange(c0, c0 + w, dtype=np.float32) - c
            dist = np.sqrt(rr[:, None] * rr[:, None]
                           + cc[None, :] * cc[None, :]) + c
            ref = sndi.map_coordinates(prof, dist[None].astype(f64),
                                       order=1, mode="constant")
            msgs.append(rel(got[r0:r0 + w, c0:c0 + w], ref, 1e-6))
        return "; ".join(msgs) + " (output windows vs map_coordinates)"

    def canny_check(got):
        check(got.dtype == torch.bool, f"dtype {got.dtype}")
        ref = _canny_reference(blobs, 2.0, 0.1, 0.2)
        got = host(got)
        bad = int((got != ref).sum())
        check(bad <= 1e-5 * got.size, f"{bad} pixels differ from the "
              f"float64 reference")
        return (f"{int(got.sum())} edge pixels, {bad} differ from a float64 "
                f"numpy/scipy canny (tol 1e-5 of the pixels)")

    def otsu_check(got):
        ref = tfil.threshold_otsu(torch.from_numpy(img))
        check(got.dtype == ref.dtype and float(got) == float(ref),
              f"{float(got)} against the port's CPU result {float(ref)}")
        return f"{float(got):.6f}, exactly the port's CPU result"

    def tv_check(got):
        check(got.dtype == torch.float32, f"dtype {got.dtype}")
        out = host(got)
        mean_err = abs(float(out.astype(f64).mean()) - float(
            noisy.astype(f64).mean()))
        check(mean_err <= 1e-5, f"mean moved by {mean_err:.3e}")
        tv_in, tv_out = _tv(noisy), _tv(out)
        check(tv_out < 0.5 * tv_in, f"total variation {tv_out} of {tv_in}")
        crop = np.ascontiguousarray(noisy[:w, :w])
        small = trest.denoise_tv_chambolle(dev(crop), weight=0.1)
        ref = trest.denoise_tv_chambolle(torch.from_numpy(crop), weight=0.1)
        msg = rel(small, ref.numpy(), 1e-5)
        return (f"mean kept within {mean_err:.1e}, total variation "
                f"{tv_out:.4g} of {tv_in:.4g}; a {w}^2 crop {msg} vs the "
                f"port's CPU result")

    def rl_check(got):
        check(got.dtype == torch.float32, f"dtype {got.dtype}")
        image = blurred.astype(f64)
        p = psf.astype(f64)
        est = np.full(image.shape, 0.5)
        # 'same' convolutions of an odd PSF: ndimage's, zero-extended
        for _ in range(10):
            conv = sndi.convolve(est, p, mode="constant")
            est = est * sndi.convolve(image / conv, p[::-1, ::-1],
                                      mode="constant")
        return rel(got, np.clip(est, -1, 1), 1e-4) + (
            " (float64 Richardson-Lucy on scipy)")

    def golden_check(got):
        diff = np.abs(host(got) - golden)
        check(np.all(diff <= 1e-3 * np.abs(golden)),
              "differs from camera_wiener.npy by more than rtol 1e-3")
        err = float((diff / np.maximum(np.abs(golden), 1e-300)).max())
        return f"{err:.3e} relative to camera_wiener.npy (rtol 1e-3)"

    uw_state = {}

    def uw_call():
        out, chains = trest.unsupervised_wiener(
            degradedc, psf25c, user_params={"rng": np.random.RandomState(5)})
        uw_state["iterations"] = len(chains["noise"]) - 1
        return out

    def uw_check(got):
        err = float(np.median(np.abs(host(got) - golden)))
        check(err < 0.05, f"median error {err:.3e} against the golden")
        return (f"median |x - camera_wiener.npy| {err:.3e} (tol 0.05), "
                f"{uw_state['iterations']} iterations")

    B1 = {"fused_separable_correlate": 1}
    calls = []

    def call(label, fn, verify, kernels=None):
        calls.append((label, kernels or {}, fn, verify))

    call(f"gaussian({n}^2 f32, sigma 2)", lambda: tfil.gaussian(imgc, 2),
         windowed(img, lambda c: sndi.gaussian_filter(
             c.astype(f64), 2, mode="nearest"), 2e-6, torch.float32), B1)
    call(f"difference_of_gaussians({n}^2 f32, 1, 2)",
         lambda: tfil.difference_of_gaussians(imgc, 1, 2),
         windowed(img, dog_ref, 2e-6, torch.float32),
         {"fused_separable_correlate": 2})
    call(f"median({n}^2 f32, 3x3)", lambda: tfil.median(imgc),
         windowed(img, lambda c: sndi.median_filter(c, 3, mode="nearest"),
                  0, torch.float32, exact=True), {"fused_rank_filter": 1})
    call(f"median({n}^2 u8, 3x3)", lambda: tfil.median(u8c),
         windowed(u8, lambda c: sndi.median_filter(c, 3, mode="nearest"),
                  0, torch.uint8, exact=True))
    call(f"unsharp_mask({n}^2 f32, radius 1)",
         lambda: tfil.unsharp_mask(imgc), windowed(img, unsharp_ref, 4e-6,
                                                   torch.float32), B1)
    call(f"window(hann, {n}^2)",
         lambda: tfil.window("hann", (n, n), device="cuda"), window_check,
         {"spline_gather": 1})
    call(f"frangi({n2}^2 f32, sigmas 1-9)",
         lambda: tfil.frangi(vesselsc), frangi_check,
         {"fused_separable_correlate": 4})
    call(f"canny({n}^2 f32, sigma 2)", lambda: canny(blobsc, 2.0),
         canny_check, B1)
    call(f"sobel({n}^2 f32 -> f64)", lambda: tfil.sobel(imgc),
         windowed(img, sobel_ref, 1e-12, torch.float64))
    call(f"threshold_otsu({n}^2 f32)", lambda: tfil.threshold_otsu(imgc),
         otsu_check)
    call(f"threshold_local({n}^2 f32, 31, f64)",
         lambda: tfil.threshold_local(imgc, 31),
         windowed(img, lambda c: sndi.gaussian_filter(
             c.astype(f64), 5.0, mode="reflect"), 1e-12, torch.float64))
    call(f"gabor({n}^2 f32, 0.2, f64)", lambda: tfil.gabor(imgc, 0.2),
         gabor_check)
    call(f"denoise_tv_chambolle({n2}^2 f32)",
         lambda: trest.denoise_tv_chambolle(noisyc, weight=0.1), tv_check)
    call(f"richardson_lucy({n2}^2 f32, 5x5, 10 iterations)",
         lambda: trest.richardson_lucy(blurredc, psfc, 10), rl_check,
         {"fused_dense_correlate": 20})
    call("wiener(512^2 f64)", lambda: trest.wiener(degradedc, psf25c, 0.05),
         golden_check)
    call("unsupervised_wiener(512^2 f64)", uw_call, uw_check)

    return _run_calls("filters path", counters, calls, torch)


def _sine_flow(shape, rng, max_motion=4.5, npics=5):
    """The registration suite's pair: white noise and the same noise
    warped by a sine flow along the first axis (``max_motion`` pixels,
    ``npics`` half-periods); the warp runs on the card before the path's
    counts are set to 0.  Returns (image0, image1, flow) as CUDA
    tensors."""
    import torch

    from cupyimg_tpu_torch.skimage.transform import warp

    image0 = dev(rng.standard_normal(shape, dtype=np.float32))
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=image0.device)
          for n in shape], indexing="ij"))
    flow = torch.zeros_like(grid)
    flow[0] = max_motion * torch.sin(grid[0] / grid[0].max() * npics * np.pi)
    return image0, warp(image0, grid - flow, mode="nearest"), flow


def _segments(shape, cells, phase, rng):
    """A segmentation of about cells^2 regions: a grid of ``cells`` cells
    an axis bent by sines, each cell a random label of 1..cells^2 (a
    tenth of them 0, the background)."""
    n = cells * cells
    labels = rng.permutation(n).astype(np.int32) + 1
    labels[rng.random(n) < 0.1] = 0
    rr = np.arange(shape[0], dtype=np.float32)[:, None]
    cc = np.arange(shape[1], dtype=np.float32)[None, :]
    r = rr + 0.3 * shape[0] / cells * np.sin(cc / 97.0 + phase)
    c = cc + 0.3 * shape[1] / cells * np.cos(rr / 83.0 + phase)
    i = np.clip((r * cells / shape[0]).astype(np.int64), 0, cells - 1)
    j = np.clip((c * cells / shape[1]).astype(np.int64), 0, cells - 1)
    return labels[i * cells + j]


def _relabel_reference(lab, offset=1):
    """skimage's relabel_sequential by np.unique and searchsorted."""
    vals = np.unique(lab)
    out = np.arange(offset, offset + len(vals))
    if vals[0] == 0:
        out = np.concatenate([[0], out[:-1]])
    return out[np.searchsorted(vals, lab)]


def _boundaries_reference(lab, mode):
    """skimage's thick, inner and outer boundaries of int32 labels on
    scipy's grey dilation and erosion."""
    import scipy.ndimage as sndi

    cross = sndi.generate_binary_structure(2, 1)
    b = sndi.grey_dilation(lab, footprint=cross) != sndi.grey_erosion(
        lab, footprint=cross)
    if mode == "inner":
        b &= lab != 0
    elif mode == "outer":
        bg = lab == 0
        full = np.ones((3, 3), bool)
        inverted = np.where(bg, np.iinfo(lab.dtype).max, lab)
        b &= bg | ((sndi.grey_dilation(lab, footprint=full)
                    != sndi.grey_erosion(inverted, footprint=full)) & ~bg)
    return b


def _subpixel_reference(lab, r0, c0, w):
    """skimage's subpixel boundaries of ``lab`` on the expanded window of
    ``w`` labels from ``(r0, c0)``, by scipy: an interstitial pixel is a
    boundary when the minimum and the maximum of the labels in its 3x3
    window of the expanded grid (zero outside it) differ."""
    import scipy.ndimage as sndi

    a, b = max(r0 - 1, 0), max(c0 - 1, 0)
    crop = lab[a:r0 + w + 1, b:c0 + w + 1].astype(np.int32)
    shape = tuple(2 * s - 1 for s in crop.shape)
    # int32 bounds: scipy's minimum_filter turns int64's maximum into
    # its minimum
    lo = np.full(shape, np.iinfo(np.int32).max, np.int32)
    hi = np.full(shape, np.iinfo(np.int32).min, np.int32)
    lo[::2, ::2] = hi[::2, ::2] = crop
    edges = np.ones(shape, bool)
    edges[::2, ::2] = False
    ref = edges & (sndi.minimum_filter(lo, 3, mode="constant")
                   != sndi.maximum_filter(hi, 3, mode="constant"))
    return ref[2 * (r0 - a):2 * (r0 - a + w) - 1,
               2 * (c0 - b):2 * (c0 - b + w) - 1]


def _edge_reference(x, sigma=1.5, amount=0.7):
    """tests/test_models.py's scipy composition of edge_enhance_pipeline,
    in float64."""
    import scipy.ndimage as sndi

    x = x.astype(np.float64)
    sm = sndi.gaussian_filter(x, sigma)
    grad = sum(sndi.sobel(sm, axis=ax) ** 2 for ax in range(x.ndim))
    return (1 + amount) * x - amount * sm + 0.1 * np.sqrt(grad)


def device_busy(fn, torch):
    """(wall_ms, device_ms, kernels) of one call of ``fn`` after one
    warm-up: CUDA events around the call, and the summed time and count
    of the CUDA kernels that torch.profiler recorded in it (0 where it
    recorded none: printed as not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    return (start.elapsed_time(end),
            sum(ev.self_device_time_total for ev in kernels) / 1e3,
            sum(ev.count for ev in kernels))


def registration_path(counters, torch):
    """Phase 4, registration path: ``skimage.registration``,
    ``skimage.segmentation``, the pipelines and ``convolve_separable`` at
    full size, the counts set to 0 just before it and read just after,
    matmul TF32 allowed.  phase_cross_correlation on 4096^2 float32 (an
    integer shift, a subpixel shift upsampled 20 times, Fourier-space
    input: torch.fft and a complex128 upsampled DFT, no launch) and the
    masked one on 1024^2 (complex128 FFTs); optical_flow_tvl1 and
    optical_flow_ilk (window, gaussian) on 2048^2 float32 with the
    registration suite's sine flow, TV-L1 with ``tol=0`` so that every
    level runs its five warps (seven levels: six reduces an image, each
    a B1 and a gather launch; six flow resizes on the gather; one gather
    launch a warp, iLK's five window sums a warp on B1), TV-L1 on 1024^2
    with ``prefilter=True`` (one B3 launch a warp), and both solvers on
    256^2 against the port's CPU result (beside the CPU's own spread
    when the second image moves by one unit in the last place); the
    segmentation calls on a
    4096^2 int32 label image of about 1000 regions (plain torch), exactly
    against numpy/scipy; mark_boundaries on 2048^2 RGB float32 (thick:
    plain; subpixel: a B1 prefilter and a gather launch a channel);
    morphological_chan_vese (20 iterations, float64) and
    morphological_geodesic_active_contour on inverse_gaussian_gradient
    of a float32 image (B1, one launch an axis) on 1024^2, against the
    port's CPU result; edge_enhance_pipeline on 256^3 float32 (1 + 3
    B1 launches) against tests/test_models.py's scipy composition on
    windows; richardson_lucy_step on 2048^2 (torch.fft) against numpy;
    convolve_separable on 4096^2 float32 with two filters under
    ``dtype_mode="float"`` (a B1 launch an axis) against scipy.  The
    2048^2 TV-L1 call is then profiled once (``device_busy``: the card's
    busy time and idle share).  Returns the calls' rows and the path's
    launches."""
    import scipy.ndimage as sndi

    import cupyimg_tpu_torch
    from cupyimg_tpu_torch import models
    from cupyimg_tpu_torch.skimage import registration as treg
    from cupyimg_tpu_torch.skimage import segmentation as tseg

    t_path = time.perf_counter()
    n, n2, n1, n0 = 4096, 2048, 1024, 256
    rng = np.random.default_rng(15)
    f64 = np.float64
    device = dev(np.zeros(1)).device
    sync = torch.cuda.synchronize

    # registration: a smooth 4096^2 image and its shifted copies
    smooth = sndi.zoom(rng.random((n // 16, n // 16), dtype=np.float32), 16,
                       order=3)[:n, :n] + 0.05 * rng.random((n, n),
                                                            dtype=np.float32)
    smoothc = dev(smooth)
    shift = (-37.0, 211.0)
    sub = (13.35, -7.6)
    rolled = torch.roll(smoothc, (37, -211), (0, 1))
    fr = [torch.fft.fftfreq(s, device=device, dtype=torch.float64)
          for s in (n, n)]
    ramp = torch.exp(-2j * np.pi * (sub[0] * fr[0][:, None]
                                    + sub[1] * fr[1][None, :]))
    spectrum = torch.fft.fftn(smoothc.double())
    rolled_spectrum = torch.fft.fftn(rolled.double())
    sub_spectrum = spectrum * ramp
    subpixel = torch.fft.ifftn(sub_spectrum).real.float().contiguous()
    del ramp
    # masked: 1024^2 crops of the pair, each cut by its own mask
    fixed = smoothc[:n1, :n1].contiguous()
    moving = torch.roll(smoothc, (19, -23), (0, 1))[:n1, :n1].contiguous()
    fmask = torch.ones((n1, n1), dtype=torch.bool, device=device)
    fmask[:n1 // 3, :n1 // 5] = False
    mmask = torch.ones_like(fmask)
    mmask[n1 * 2 // 3:, n1 * 5 // 8:] = False
    # optical flow pairs
    i0, i1, gt = _sine_flow((n2, n2), rng)
    p0, p1, pgt = _sine_flow((n1, n1), rng)
    s0, s1, sgt = _sine_flow((n0, n0), rng)
    # segmentation: two 4096^2 segmentations of ~1000 and ~1600 regions
    seg1 = _segments((n, n), n // 128, 0.0, rng)
    seg2 = _segments((n, n), n // 100, 1.3, rng)
    seg1c, seg2c = dev(seg1), dev(seg2)
    rgb = rng.random((n2, n2, 3), dtype=np.float32)
    rgbc = dev(rgb)
    lab2 = np.ascontiguousarray(seg1[:n2, :n2])
    lab2c = dev(lab2)
    # snakes: a smooth 1024^2 float64 image, and a float32 one's gradient
    blobs = sndi.zoom(rng.random((n1 // 16, n1 // 16)), 16, order=3)
    blobsc = dev(blobs)
    blobs32c = dev(blobs.astype(np.float32))
    vol = rng.random((n0,) * 3, dtype=np.float32)
    volc = dev(vol)
    est = rng.random((n2, n2), dtype=np.float32) + 0.5
    image = rng.random((n2, n2), dtype=np.float32) + 0.5
    psf = np.zeros((n2, n2), np.float32)
    psf[:5, :5] = 1 / 25
    psf = np.roll(psf, (-2, -2), (0, 1))
    psf_fft = np.fft.rfftn(psf)
    estc, imagec, psfc = dev(est), dev(image), dev(psf_fft.astype(
        np.complex64))
    psf_conjc = psfc.conj().contiguous()
    conv_x = rng.random((n, n), dtype=np.float32)
    conv_xc = dev(conv_x)
    taps = [np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16,
            np.array([-1.0, 0.0, 1.0])]
    sync()

    def pcc_exact(want):
        def verify(got):
            got = host(got if isinstance(got, torch.Tensor) else got[0])
            check(np.array_equal(got, want), f"shifts {got}, want {want}")
            return f"shifts {got.tolist()} exactly"
        return verify

    def pcc_subpixel(got):
        shifts, error, phase = host(got)
        want = -np.asarray(sub)
        err = float(np.abs(shifts - want).max())
        check(err <= 1 / 20, f"shifts {shifts}, want {want} within 0.05")
        # the port's CPU result: a product on the tensor cores would move
        # the error^2 and the phase by ~1e-3
        ref = treg.phase_cross_correlation(
            torch.from_numpy(smooth), subpixel.cpu(), upsample_factor=20)
        check(np.array_equal(shifts, ref[0].numpy()),
              f"shifts {shifts} differ from the CPU result {ref[0]}")
        d_err = abs(float(error) ** 2 - float(ref[1]) ** 2)
        d_phase = abs(float(phase) - float(ref[2]))
        check(d_err <= 1e-5 and d_phase <= 1e-5,
              f"error^2 {d_err:.2e} / phase {d_phase:.2e} off the CPU "
              "result (tol 1e-5)")
        return (f"shifts {shifts.tolist()} within {err:.3f} of the shift; "
                f"error^2 {d_err:.1e}, phase {d_phase:.1e} from the CPU "
                "result")

    def flow_check(truth):
        def verify(got):
            check(got.dtype == torch.float32, f"dtype {got.dtype}")
            err = float((got - truth).abs().mean())
            check(err < 0.5, f"mean |flow - truth| {err:.3f} (tol 0.5)")
            return f"mean |flow - truth| {err:.4f} px (tol 0.5)"
        return verify

    def spread(d):
        """(mean, 99.9th percentile, worst) of |flow differences|."""
        return (float(d.mean()), float(torch.quantile(d.reshape(-1), 0.999)),
                float(d.max()))

    def flow_cpu(fn):
        """The 256^2 flow against the port's CPU result of the same call.
        TV-L1 on white noise amplifies rounding at a few unstable pixels:
        the CPU result moves as far from itself when the second image
        moves by about one unit in the last place at random pixels
        (printed beside it), so float32 sums in another order on the card
        are held in the mean (1e-3 px), the 99.9th percentile (0.05 px)
        and the worst pixel (0.5 px)."""
        def verify(got):
            a, b = s0.cpu(), s1.cpu()
            ref = fn(a, b)
            ulp = np.random.default_rng(1).choice([-1.0, 0.0, 1.0], b.shape)
            ulp = torch.from_numpy(ulp.astype(np.float32)) * np.finfo(
                np.float32).eps
            own = spread((fn(a, b * (1 + ulp)) - ref).abs())
            mean, p999, worst = spread((got.cpu() - ref).abs())
            check(mean <= 1e-3 and p999 <= 0.05 and worst <= 0.5,
                  f"mean {mean:.2e}, 99.9th percentile {p999:.2e}, worst "
                  f"{worst:.2e} px from the CPU result (tol 1e-3, 0.05, "
                  "0.5)")
            err = float((got - sgt).abs().mean())
            check(err < 0.5, f"mean |flow - truth| {err:.3f} (tol 0.5)")
            return (f"mean {mean:.2e} px, 99.9th percentile {p999:.2e}, "
                    f"worst {worst:.2e} px from the port's CPU result (the "
                    f"CPU's own one-ulp spread: {own[0]:.2e}, {own[1]:.2e}, "
                    f"{own[2]:.2e}); mean |flow - truth| {err:.4f}")
        return verify

    def exact_np(ref_fn, dtype=None):
        def verify(got):
            ref = ref_fn()
            if dtype is not None:
                check(got.dtype == dtype, f"dtype {got.dtype}, want {dtype}")
            check(np.array_equal(host(got), ref), "differs from numpy/scipy")
            return "exact (numpy/scipy)"
        return verify

    def joined():
        r1, r2 = _relabel_reference(seg1), _relabel_reference(seg2)
        return _relabel_reference((r2.max() + 1) * r1.astype(np.int64) + r2)

    def cleared():
        border = np.ones(seg1.shape, bool)
        border[1:-1, 1:-1] = False
        touching = np.setdiff1d(np.unique(seg1[border]), [0])
        return np.where(np.isin(seg1, touching), 0, seg1)

    def subpixel_check(got):
        check(got.shape == (2 * n - 1, 2 * n - 1), f"shape {got.shape}")
        w = min(256, n // 4)
        for r0, c0 in ((0, 0), (n * 3 // 8, n * 9 // 16), (n - w, 7)):
            part = host(got[2 * r0:2 * (r0 + w) - 1, 2 * c0:2 * (c0 + w) - 1])
            check(np.array_equal(part, _subpixel_reference(seg1, r0, c0, w)),
                  f"window {(r0, c0)} differs from scipy")
        return "exact on three 511^2 windows (scipy min/max filters)"

    b2 = _boundaries_reference(lab2, "thick")

    def marked_thick(got):
        ref = np.where(b2[..., None], np.float32([1, 1, 0]), rgb)
        check(np.array_equal(host(got), ref), "differs from numpy")
        return "exact (numpy)"

    def marked_subpixel(got):
        check(got.dtype == torch.float32 and got.shape == (2 * n2 - 1,
                                                           2 * n2 - 1, 3),
              f"{got.dtype} {tuple(got.shape)}")
        coefs = [sndi.spline_filter(rgb[..., ch].astype(f64), 3,
                                    mode="reflect") for ch in range(3)]
        errs, w = [], min(128, n2 // 4)
        for r0, c0 in ((0, 0), (n2 // 2, n2 // 4)):
            part = host(got[2 * r0:2 * (r0 + w) - 1, 2 * c0:2 * (c0 + w) - 1])
            bnd = _subpixel_reference(lab2, r0, c0, w)
            check(np.array_equal(part[bnd], np.tile(
                np.float32([1, 1, 0]), (int(bnd.sum()), 1))),
                "a boundary pixel is not the colour")
            # the zoom by (2 * 2048 - 1) / 2048 samples at half pixels
            rr, cc = np.mgrid[2 * r0:2 * (r0 + w) - 1,
                              2 * c0:2 * (c0 + w) - 1].astype(f64) * 0.5
            for ch in range(3):
                ref = sndi.map_coordinates(coefs[ch], [rr, cc], order=3,
                                           mode="reflect", prefilter=False)
                errs.append(float(np.abs(part[..., ch] - ref)[~bnd].max()))
        tol = coef_tol(3, 2)
        check(max(errs) <= tol, f"{max(errs):.3e} off scipy's zoom (tol "
              f"{tol:.1e})")
        return (f"boundaries exactly the colour; the zoom within "
                f"{max(errs):.2e} of scipy (tol {tol:.1e}) on two output "
                "windows")

    def level_set_cpu(fn, *inputs):
        def verify(got):
            check(got.dtype == torch.int8, f"dtype {got.dtype}")
            ref = fn(*[x.cpu() for x in inputs])
            flips = int((got.cpu() != ref).sum())
            check(flips == 0, f"{flips} pixels differ from the CPU result")
            return (f"exactly the port's CPU result ({int(got.sum())} "
                    "pixels inside)")
        return verify

    def edge_check(got):
        check(got.dtype == torch.float32, f"dtype {got.dtype}")
        m, w = 8, min(48, n0 // 4)
        msgs = []
        for c in ((0, 0, 0), (n0 * 3 // 8, n0 // 8, n0 * 5 // 8)):
            lo = [max(v - m, 0) for v in c]
            crop = vol[tuple(slice(a, v + w + m) for a, v in zip(lo, c))]
            ref = _edge_reference(crop)[tuple(
                slice(v - a, v - a + w) for a, v in zip(lo, c))]
            part = host(got[tuple(slice(v, v + w) for v in c)])
            check(np.allclose(part, ref, rtol=2e-4, atol=2e-4),
                  f"window {c} off the scipy composition")
            msgs.append(float(np.abs(part - ref).max()))
        return (f"windows within {max(msgs):.2e} of tests/test_models.py's "
                "scipy composition (rtol, atol 2e-4)")

    def rl_check(got):
        e, i = est.astype(f64), image.astype(f64)
        pf = psf_fft
        conv = np.fft.irfft2(np.fft.rfft2(e) * pf, s=e.shape)
        ref = e * np.fft.irfft2(np.fft.rfft2(i / (conv + 1e-12))
                                * np.conj(pf), s=e.shape)
        return rel(got, ref, 1e-5) + " (numpy.fft, float64)"

    def conv_check(got):
        check(got.dtype == torch.float32, f"dtype {got.dtype}")
        ref = sndi.convolve1d(sndi.convolve1d(conv_x.astype(f64), taps[0], 0),
                              taps[1], 1)
        return rel(got, ref, 2e-6) + " (scipy, float64)"

    B1, G, B3 = ("fused_separable_correlate", "spline_gather",
                 "fused_rank_filter")

    def flow_plan(size, warps, sums=0, median=False):
        """The launches of a coarse-to-fine solve of a ``size``^2 pair:
        a B1 and a gather launch a reduce (one an image a level below
        the finest), a gather launch a flow resize, a gather launch a
        warp, ``sums`` B1 launches a warp and, with ``median``, a B3
        launch a warp.  2048^2 has 7 levels (2048..32), 1024^2 6, 256^2
        4."""
        levels, s = 1, size
        while levels < 10 and s > 32:
            s, levels = -(-s // 2), levels + 1
        plan = {B1: 2 * (levels - 1) + sums * warps * levels,
                G: 3 * (levels - 1) + warps * levels}
        if median:
            plan[B3] = warps * levels
        return plan

    calls = []

    def call(label, fn, verify, kernels=None):
        calls.append((label, kernels or {}, fn, verify))

    call(f"phase_cross_correlation({n}^2 f32, integer shift)",
         lambda: treg.phase_cross_correlation(smoothc, rolled),
         pcc_exact(np.asarray(shift)))
    call(f"phase_cross_correlation({n}^2 f32, subpixel, upsample 20)",
         lambda: treg.phase_cross_correlation(smoothc, subpixel,
                                              upsample_factor=20),
         pcc_subpixel)
    call(f"phase_cross_correlation({n}^2 c128 spectra, space='fourier')",
         lambda: treg.phase_cross_correlation(
             spectrum, rolled_spectrum, space="fourier", return_error=False),
         pcc_exact(np.asarray(shift)))
    call(f"phase_cross_correlation({n1}^2 f32, masked, f64)",
         lambda: treg.phase_cross_correlation(
             fixed, moving, reference_mask=fmask, moving_mask=mmask),
         pcc_exact(np.asarray([-19.0, 23.0])))
    tvl1_label = f"optical_flow_tvl1({n2}^2 f32, attachment 5, tol 0)"
    call(tvl1_label,
         lambda: treg.optical_flow_tvl1(i0, i1, attachment=5, tol=0),
         flow_check(gt), flow_plan(n2, 5))
    call(f"optical_flow_tvl1({n1}^2 f32, tol 0, prefilter)",
         lambda: treg.optical_flow_tvl1(p0, p1, attachment=5, tol=0,
                                        prefilter=True),
         flow_check(pgt), flow_plan(n1, 5, median=True))
    call(f"optical_flow_ilk({n2}^2 f32, radius 7)",
         lambda: treg.optical_flow_ilk(i0, i1), flow_check(gt),
         flow_plan(n2, 10, sums=5))
    call(f"optical_flow_ilk({n2}^2 f32, gaussian)",
         lambda: treg.optical_flow_ilk(i0, i1, gaussian=True),
         flow_check(gt), flow_plan(n2, 10, sums=5))
    tv256 = dict(attachment=5, tol=0)
    call(f"optical_flow_tvl1({n0}^2 f32, tol 0)",
         lambda: treg.optical_flow_tvl1(s0, s1, **tv256),
         flow_cpu(lambda a, b: treg.optical_flow_tvl1(a, b, **tv256)),
         flow_plan(n0, 5))
    call(f"optical_flow_ilk({n0}^2 f32)",
         lambda: treg.optical_flow_ilk(s0, s1),
         flow_cpu(treg.optical_flow_ilk), flow_plan(n0, 10, sums=5))
    for mode in ("thick", "inner", "outer"):
        call(f"find_boundaries({n}^2 i32, {mode})",
             lambda mode=mode: tseg.find_boundaries(seg1c, mode=mode),
             exact_np(lambda mode=mode: _boundaries_reference(seg1, mode)))
    call(f"find_boundaries({n}^2 i32, subpixel)",
         lambda: tseg.find_boundaries(seg1c, mode="subpixel"),
         subpixel_check)
    call(f"relabel_sequential({n}^2 i32)",
         lambda: tseg.relabel_sequential(seg1c)[0],
         exact_np(lambda: _relabel_reference(seg1).astype(np.int32),
                  torch.int32))
    call(f"join_segmentations({n}^2 i32, ~1000 and ~1600 regions)",
         lambda: tseg.join_segmentations(seg1c, seg2c),
         exact_np(lambda: joined().astype(np.int32), torch.int32))
    call(f"clear_border({n}^2 i32)", lambda: tseg.clear_border(seg1c),
         exact_np(cleared, torch.int32))
    call(f"mark_boundaries({n2}^2 RGB f32, thick)",
         lambda: tseg.mark_boundaries(rgbc, lab2c, mode="thick"),
         marked_thick)
    call(f"mark_boundaries({n2}^2 RGB f32, subpixel)",
         lambda: tseg.mark_boundaries(rgbc, lab2c, mode="subpixel"),
         marked_subpixel, {B1: 3, G: 3})
    cv = dict(iterations=20, init_level_set="checkerboard")
    call(f"morphological_chan_vese({n1}^2 f64, 20 iterations)",
         lambda: tseg.morphological_chan_vese(blobsc, **cv),
         level_set_cpu(lambda x: tseg.morphological_chan_vese(x, **cv),
                       blobsc))
    igg = {}

    def gac(g):
        return tseg.morphological_geodesic_active_contour(
            g, 20, init_level_set="disk", balloon=-1)

    def igg_then_gac():
        igg["g"] = tseg.inverse_gaussian_gradient(blobs32c, sigma=2.0)
        return gac(igg["g"])

    call(f"inverse_gaussian_gradient + geodesic_active_contour({n1}^2 f32, "
         "20 iterations)", igg_then_gac,
         lambda got: level_set_cpu(gac, igg["g"])(got), {B1: 2})
    call(f"edge_enhance_pipeline({n0}^3 f32)",
         lambda: models.edge_enhance_pipeline(volc), edge_check, {B1: 4})
    call(f"richardson_lucy_step({n2}^2 f32)",
         lambda: models.richardson_lucy_step(imagec, estc, psfc, psf_conjc),
         rl_check)
    call(f"convolve_separable({n}^2 f32, 5 and 3 taps, dtype_mode float)",
         lambda: cupyimg_tpu_torch.convolve_separable(conv_xc, taps,
                                                      dtype_mode="float"),
         conv_check, {B1: 2})

    rows, launches = _run_calls("registration path", counters, calls, torch)
    # the most host-bound call: how much of it the card is busy
    t_prof = time.perf_counter()
    row = next(r for r in rows if r["case"] == tvl1_label)
    wall, busy, count = device_busy(
        next(c[2] for c in calls if c[0] == tvl1_label), torch)
    row.update(profiled_ms=wall, device_ms=busy, kernels=count,
               idle_share=1 - busy / wall if busy else None)
    print(f"registration path {row['case']}: {count} kernels, device "
          f"{busy:.2f} ms of {wall:.2f} ms (idle share "
          + (f"{1 - busy / wall:.3f}" if busy else "not measured")
          + f"), profiled in {time.perf_counter() - t_prof:.1f} s")
    print(f"registration path: {time.perf_counter() - t_path:.1f} s")
    return rows, launches


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


PARALLEL_RANKS = 2


def _parallel_rank(world):
    """One rank of the parallel path (``parallel.run_world``'s ``fn``):
    each sharded call at full size, its launches on this rank held to
    its plan, its result gathered and held by rank 0 against the port's
    single-device call on the card, then timed (median of 5, a barrier
    before each, CUDA events; the exchange's host seconds from
    ``parallel.traffic``).  Returns rank 0's rows and every rank's
    launches."""
    import torch
    import torch.distributed as dist

    import cupyimg_tpu_torch.scipy.ndimage as ndi
    import cupyimg_tpu_torch.scipy.signal as sig
    from cupyimg_tpu_torch import parallel as par
    from cupyimg_tpu_torch.models import (edge_enhance_pipeline,
                                         sharded_edge_enhance)
    from cupyimg_tpu_torch.ops import fused_dense as fd
    from cupyimg_tpu_torch.ops import fused_fft as ff
    from cupyimg_tpu_torch.ops import fused_rank as fr
    from cupyimg_tpu_torch.ops import fused_separable as fs
    from cupyimg_tpu_torch.ops import spline_gather as sg

    counters = {
        "fused_separable_correlate": fs.fused_separable_correlate,
        "fused_separable_minmax": fs.fused_separable_minmax,
        "fused_dense_correlate": fd.fused_dense_correlate,
        "fused_rank_filter": fr.fused_rank_filter,
        "spline_gather": sg,
        "fused_separable_open_close": fs.fused_separable_open_close,
        "fused_separable_morph_pair": fs.fused_separable_morph_pair,
        "fft_rows": ff.fft_rows,
        "fft_strided": ff.fft_strided,
    }
    dev = world.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(16)

    def rand(*shape):
        # the same numbers on every rank: one generator, one seed, one card
        return torch.rand(shape, generator=gen, device=dev)

    m2 = world.mesh((PARALLEL_RANKS,), ("x",))
    mb = world.mesh((1, PARALLEL_RANKS), ("batch", "x"))
    rows3, rows2 = ("x", None, None), ("x", None)
    x3 = rand(256, 256, 256)
    img = rand(4096, 4096)
    w9 = torch.randn((9, 9), generator=gen, device=dev,
                     dtype=torch.float64).cpu().numpy()
    xb = rand(4, 2048, 2048)
    k31 = rand(31, 31) - 0.5
    blobs = ndi.uniform_filter(rand(4096, 4096), 15) > 0.5
    z = torch.complex(img, rand(4096, 4096))
    k2 = rand(31, 31) - 0.5
    xe = rand(4, 1024, 1024)
    th = np.deg2rad(0.05)  # about 2.5 pixels at the corners of 4096^2
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    ctr = np.full(2, 2047.5)
    off = ctr - rot @ ctr
    rr, cc = torch.meshgrid(
        torch.arange(4096, dtype=torch.float64, device=dev),
        torch.arange(4096, dtype=torch.float64, device=dev), indexing="ij")
    coords = torch.stack([rr + 3.0 * torch.sin(cc / 131.0),
                          cc - 2.5 * torch.cos(rr / 113.0)])
    del rr, cc
    torch.cuda.synchronize()

    def count(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()
                     if c.launches}

    def of_max(scale):
        return lambda ref: scale * float(ref.abs().max())

    def block(x, spec, mesh):
        return par.distribute(x, mesh, spec).to_local()

    b1, mm = "fused_separable_correlate", "fused_separable_minmax"
    gather = {"spline_gather": 1}
    # (label, plan per rank, sharded call, single-device call, atol)
    calls = [
        ("uniform_filter 256^3 size 5", {b1: 1},
         lambda: par.sharded_uniform_filter(x3, 5, m2, rows3),
         lambda: ndi.uniform_filter(x3, 5), of_max(1e-5)),
        ("gaussian_filter 256^3 sigma 1.5", {b1: 1},
         lambda: par.sharded_gaussian_filter(x3, 1.5, m2, rows3),
         lambda: ndi.gaussian_filter(x3, 1.5), of_max(1e-5)),
        ("minimum_filter 256^3 size 5", {mm: 1},
         lambda: par.sharded_minimum_filter(x3, 5, m2, rows3),
         lambda: ndi.minimum_filter(x3, 5), None),
        ("median_filter 4096^2 5x5", {"fused_rank_filter": 1},
         lambda: par.sharded_median_filter(img, 5, m2, rows2),
         lambda: ndi.median_filter(img, 5), None),
        ("correlate 4096^2 9x9", {"fused_dense_correlate": 1},
         lambda: par.sharded_correlate(img, w9, m2, rows2),
         lambda: ndi.correlate(img, w9, dtype_mode="float"),
         lambda ref: 1e-5 * float(np.abs(w9).sum())),
        # the plan: what the single-device call launches on this block
        ("fftconvolve (4, 2048, 2048) 31x31 batch-sharded",
         lambda: count(lambda: sig.fftconvolve(
             block(xb, ("x", None, None), m2), k31[None], mode="same",
             axes=(1, 2)))[1],
         lambda: par.sharded_fftconvolve(xb, k31, m2, ("x", None, None)),
         lambda: sig.fftconvolve(xb, k31[None], mode="same", axes=(1, 2)),
         of_max(1e-4)),
        ("shift 4096^2 order 3 (1.3, -0.7)", {b1: 1, "spline_gather": 1},
         lambda: par.sharded_shift(img, (1.3, -0.7), m2, rows2, order=3),
         lambda: ndi.shift(img, (1.3, -0.7), order=3, mode="reflect"),
         lambda ref: 2e-5 * float(img.abs().max())),
        ("affine_transform 4096^2 order 1 rotation 0.05 deg", gather,
         lambda: par.sharded_affine_transform(img, rot, off, m2, rows2,
                                              order=1),
         lambda: ndi.affine_transform(img, rot, off, order=1,
                                      mode="reflect"),
         lambda ref: 2e-5 * float(img.abs().max())),
        ("map_coordinates 4096^2 order 1 displacement 3", gather,
         lambda: par.sharded_map_coordinates(img, coords, m2, rows2, 3.0,
                                             order=1),
         lambda: ndi.map_coordinates(img, coords, order=1, mode="reflect"),
         lambda ref: 2e-5 * float(img.abs().max())),
        ("binary_erosion 4096^2 blobs", {},
         lambda: par.sharded_binary_erosion(blobs, mesh=m2, spec=rows2),
         lambda: ndi.binary_erosion(blobs), None),
        ("label 4096^2 blobs", {},
         lambda: par.sharded_label(blobs, m2, rows2),
         lambda: ndi.label(blobs), None),
        ("fft2 4096^2 complex64", {},
         lambda: par.sharded_fft2(z, m2, rows2),
         lambda: torch.fft.fft2(z), of_max(1e-4)),
        ("fftconvolve2d_spatial 4096^2 31x31 same", {},
         lambda: par.sharded_fftconvolve2d_spatial(img, k2, m2, rows2),
         lambda: sig.fftconvolve(img, k2, mode="same"), of_max(1e-4)),
        ("sharded_edge_enhance (4, 1024, 1024) mesh (1, 2)", {b1: 3},
         lambda: sharded_edge_enhance(xe, mb, ("batch", "x", None)),
         lambda: torch.stack([edge_enhance_pipeline(v) for v in xe]),
         of_max(1e-5)),
    ]
    rows, path = [], {}
    for label, plan, sharded, single, atol in calls:
        if callable(plan):
            plan = plan()
        sharded()  # warm-up: libraries loaded, FFT plans made
        torch.cuda.synchronize()
        dist.barrier()
        out, got = count(sharded)
        for k, v in got.items():
            path[k] = path.get(k, 0) + v
        if got != plan:
            raise RuntimeError(f"{label}: rank {world.rank} launched {got}, "
                               f"the single-device plan on its block is "
                               f"{plan}")
        if isinstance(out, tuple):  # label: (labels, count)
            got_full = (par.full_tensor(out[0]), int(out[1]))
        else:
            got_full = par.full_tensor(out)
        check = None
        if world.rank == 0:
            ref = single()
            if isinstance(ref, tuple):
                if not (torch.equal(got_full[0], ref[0])
                        and got_full[1] == int(ref[1])):
                    raise RuntimeError(f"{label}: labels differ")
                check = f"exact, {got_full[1]} labels"
            elif atol is None:
                if not (got_full.dtype == ref.dtype
                        and torch.equal(got_full, ref)):
                    raise RuntimeError(f"{label}: differs from the "
                                       "single-device call")
                check = "exact"
            else:
                tol = atol(ref)
                err = float((got_full - ref).abs().max())
                if not (err <= tol and bool(torch.isfinite(got_full).all())):
                    raise RuntimeError(f"{label}: max_abs_err {err:.3e} "
                                       f"over {tol:.3e}")
                check = f"max_abs_err {err:.3e} (atol {tol:.3e})"
            del ref
        del out, got_full
        ms, ex = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            dist.barrier()
            par.traffic.reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sharded()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            ex.append(par.traffic.seconds * 1e3)
        rows.append({"case": label, "ms": float(np.median(ms)),
                     "exchange_ms": float(np.median(ex)),
                     "launches_per_rank": plan, "check": check,
                     "transport": world.transport})
        torch.cuda.empty_cache()

    launches = [None] * world.size
    dist.all_gather_object(launches, path)
    return {"rows": rows, "launches": launches}


GLOO_PROBES = ("all_gather", "all_to_all_single", "batch_isend_irecv",
               "DTensor.full_tensor")


def _gloo_probe_rank(world, log_path, names):
    """One rank of the gloo probe: each collective of ``names`` handed
    CUDA tensors as they are (the library never does that: it stages
    every exchange of a CUDA tensor over gloo through host memory).  Rank
    0 writes ``start <name>`` before a probe and ``<name>: <finding>``
    after it to ``log_path``, so a probe that crashes the process is
    still named."""
    import torch
    import torch.distributed as dist

    from cupyimg_tpu_torch import parallel as par

    dev = world.device
    small = torch.arange(8.0, device=dev) + world.rank
    peer = 1 - world.rank
    calls = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(small) for _ in range(world.size)], small),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(small), small),
        "batch_isend_irecv": lambda: [w.wait() for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, small, peer),
             dist.P2POp(dist.irecv, torch.empty_like(small), peer)])],
        "DTensor.full_tensor": lambda: par.distribute(
            torch.arange(16.0, device=dev),
            world.mesh((PARALLEL_RANKS,), ("x",)), ("x",)).full_tensor(),
    }

    def log(line):
        if world.rank == 0:
            with open(log_path, "a") as f:
                f.write(line + "\n")

    for name in names:
        log(f"start {name}")
        try:
            calls[name]()
            torch.cuda.synchronize()
            found = "takes CUDA tensors"
        except Exception as e:  # noqa: BLE001 -- the probe's finding
            found = f"raises {type(e).__name__}: {str(e).splitlines()[0]}"
        log(f"{name}: {found}")
        dist.barrier()


def gloo_probes():
    """Which gloo collectives take CUDA tensors as they are, probed in
    turn in a 2-rank world on the card (``_gloo_probe_rank``); a probe
    that crashes a rank ends its world and is reported as crashing, and
    the probes not yet run go on in a new world.  Returns {probe:
    finding}."""
    import shutil
    import tempfile

    from cupyimg_tpu_torch.parallel import run_world

    found, todo = {}, list(GLOO_PROBES)
    while todo:
        tmp = tempfile.mkdtemp(prefix="cupyimg_probe_")
        log_path = os.path.join(tmp, "probes.log")
        ended = None
        try:
            try:
                run_world(_gloo_probe_rank, PARALLEL_RANKS, "cuda", log_path,
                          tuple(todo), timeout=30.0)
            except RuntimeError as err:  # a crash is a finding, not a fault
                ended = str(err).splitlines()[0]
            lines = (open(log_path).read().splitlines()
                     if os.path.exists(log_path) else [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        found.update(ln.split(": ", 1) for ln in lines
                     if not ln.startswith("start "))
        for ln in lines:  # a probe started and never finished
            if ln.startswith("start ") and ln[6:] not in found:
                found[ln[6:]] = f"crashed the world ({ended})"
        if not any(name in found for name in todo):
            # the world ended before its first probe
            found.update((name, f"not run ({ended})") for name in todo)
        # a world that ended between two probes leaves the rest to a new one
        todo = [name for name in todo if name not in found]
    for name in GLOO_PROBES:
        print(f"parallel path gloo on CUDA tensors: {name}: {found[name]}")
    return found


def parallel_path(torch):
    """Phase 4, parallel path: ``run_world`` starts 2 ranks on the one
    card (gloo, the slabs staged through pinned host memory: NCCL needs a
    card a rank, which this machine does not have), after the parent has
    built every kernel (the ranks load them from ``build/kernels``).
    Each rank runs 14 sharded calls at full size (``_parallel_rank``):
    uniform, gaussian and minimum filters of 256^3, the median 5x5,
    correlate 9x9, shift (order 3), affine_transform and map_coordinates
    (order 1, bounded displacement), binary erosion, label, fft2 and the
    spatially sharded FFT convolution of 4096^2, the batch-sharded
    fftconvolve of (4, 2048, 2048) with 31x31 and sharded_edge_enhance
    of (4, 1024, 1024) on a (1, 2) mesh.  Returns the rows and the
    launches summed over the ranks."""
    from cupyimg_tpu_torch.parallel import run_world

    t0 = time.perf_counter()
    out = run_world(_parallel_rank, PARALLEL_RANKS, "cuda", timeout=90.0)
    wall = time.perf_counter() - t0
    width = max(len(r["case"]) for r in out["rows"])
    for r in out["rows"]:
        planned = " + ".join(f"{k} x{v}" for k, v in
                             r["launches_per_rank"].items()) or "no launch"
        print(f"parallel path {r['case']:{width}s} {r['ms']:10.3f} ms "
              f"(exchange {r['exchange_ms']:.3f} ms, {r['transport']}; a "
              f"rank: {planned}) vs single-device: {r['check']}")
    launches = {}
    for per_rank in out["launches"]:
        for k, v in per_rank.items():
            launches[k] = launches.get(k, 0) + v
    print(f"parallel path launches (both ranks): {json.dumps(launches)}")
    print(f"parallel path: {wall:.1f} s, spawn included")
    return out["rows"], launches, gloo_probes()


def trace_check(torch):
    """``time.trace`` around one uniform_filter of 256^3 on the card: the
    Chrome trace it writes must hold a CUDA kernel event of B1's planes
    kernel."""
    import shutil
    import tempfile

    import cupyimg_tpu_torch.scipy.ndimage as ndi
    from cupyimg_tpu_torch.time import trace

    xc3 = torch.rand(256, 256, 256, device="cuda")
    ndi.uniform_filter(xc3, 5)
    torch.cuda.synchronize()
    for attempt in range(3):
        # the profiler can lose kernel records (see kernel_ms): try again
        tmp = tempfile.mkdtemp(prefix="cupyimg_trace_")
        try:
            with trace(tmp) as log_dir:
                ndi.uniform_filter(xc3, 5)
            files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
            check(len(files) == 1, f"time.trace wrote {files}")
            with open(os.path.join(log_dir, files[0])) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        every = [e for e in events if e.get("cat") == "kernel"]
        kernels = [e for e in every
                   if "fused_separable_f32_kernel" in e.get("name", "")]
        if kernels:
            print(f"time.trace: {files[0]} holds B1's kernel "
                  f"({kernels[0]['dur']} us)")
            return
        print(f"time.trace: no kernel record of B1 among {len(events)} "
              f"events ({len(every)} kernel records); tracing again")
    check(False, "time.trace: no CUDA kernel event of B1 in three traces")


# the half types: torch dtype and the mantissa step at 1.0
HALF_TYPES = (("float16", 2.0 ** -10), ("bfloat16", 2.0 ** -7))
# mode -> (cval, taps or window on every axis) of the half kernels'
# checks: the equal, symmetric and general tap kinds, the register
# windows and the rings
HALF_MODES = {"reflect": (0.0, 5), "constant": (0.3, 9), "nearest": (0.0, 4),
              "wrap": (0.0, 3)}
HALF_KINDS = ("corr", "min", "max", "opening", "closing", "grad", "laplace")


def half_ulp(eps, magnitude):
    """One ulp of a half type (mantissa step ``eps`` at 1.0) at
    ``magnitude``."""
    return eps * 2.0 ** np.floor(np.log2(max(float(magnitude), 1e-30)))


def _half_taps(n):
    if n == 5:
        return (0.2,) * 5
    if n == 9:
        g = np.exp(-0.5 * np.arange(-4, 5) ** 2 / 4.0)
        return tuple(g / g.sum())
    if n == 4:
        return (0.1, -0.6, 0.3, 1.2)
    return (0.25, 0.5, 0.25)


def _half_kind(fs, kind, x, n, mode, cval):
    """(kernel, plain) results of one B1 kind on the CUDA tensor ``x``,
    windows or taps of ``n`` on every axis (axis 0 of a 3-D array under
    wrap unfiltered: a register window of 1)."""
    nd = x.ndim
    sizes = [n] * nd
    if nd == 3 and mode == "wrap":
        sizes[0] = 1
    modes, zeros = (mode,) * nd, (0,) * nd
    origins = tuple(1 if sz == 4 else 0 for sz in sizes)
    if kind == "corr":
        args = ([None if sz == 1 else _half_taps(sz) for sz in sizes],
                origins, modes, cval)
        return (fs.fused_separable_correlate(x, *args),
                fs.fused_separable_correlate_ref(x, *args))
    if kind in ("min", "max"):
        args = (sizes, origins, modes, cval, kind == "min")
        return (fs.fused_separable_minmax(x, *args),
                fs.fused_separable_minmax_ref(x, *args))
    if kind in ("opening", "closing"):
        args = (sizes, origins, zeros, modes, cval, kind == "opening")
        return (fs.fused_separable_open_close(x, *args),
                fs.fused_separable_open_close_ref(x, *args))
    args = (sizes, origins, modes, cval, kind)
    return (fs.fused_separable_morph_pair(x, *args),
            fs.fused_separable_morph_pair_ref(x, *args))


def half_vs_plain(fs, torch):
    """B1 on float16 and bfloat16 against its plain versions: every kind
    x both types x the rows (2-D) and planes (3-D) paths x reflect,
    constant (cval 0.3), nearest and wrap, on rows that can and cannot be
    read in 16-byte chunks; min/max/opening/closing/gradient exactly, NaN
    included, corr and laplace within 1 ulp of the type at max|plain|."""
    rng = np.random.RandomState(11)
    shapes = {"rows": ((200, 520), (201, 300)),
              "planes": ((16, 40, 136), (15, 37, 70))}
    worst = {}
    for dname, eps in HALF_TYPES:
        dtype = getattr(torch, dname)
        for path, pair in shapes.items():
            for shape in pair:
                base = rng.standard_normal(shape).astype(np.float32)
                nan = base.copy()
                nan.flat[::97] = np.nan
                for mode, (cval, n) in HALF_MODES.items():
                    for kind in HALF_KINDS:
                        exact = kind not in ("corr", "laplace")
                        x = dev(nan if exact else base).to(dtype)
                        got, ref = _half_kind(fs, kind, x, n, mode, cval)
                        torch.cuda.synchronize()
                        check(got.dtype == dtype and ref.dtype == dtype,
                              f"half {kind}: dtype {got.dtype}")
                        key = (dname, kind)
                        if exact:
                            check(same(got, ref), f"half {kind} {dname} "
                                  f"{path} {shape} {mode}: kernel differs "
                                  "from its plain version")
                            worst[key] = 0.0
                            continue
                        tol = half_ulp(eps, ref.abs().max())
                        err = float((got.float() - ref.float()).abs().max())
                        check(err <= tol, f"half {kind} {dname} {path} "
                              f"{shape} {mode}: {err:.3e} > 1 ulp {tol:.1e}")
                        worst[key] = max(worst.get(key, 0.0), err / tol)
    for (dname, kind), w in sorted(worst.items()):
        print(f"kernel-vs-plain half {dname:8s} {kind:8s} 32 cases "
              f"(2 paths x 2 row alignments x 4 modes): "
              + ("exact" if kind not in ("corr", "laplace") else
                 f"at most {w:.2f} ulp of max|plain|"))
    half_branches_vs_plain(fs, torch)


# The branches of the half types' redesigned kernels: (shape, per-axis
# taps or windows, mode, cval).  Rows of n2 % 8 == 0 (16-byte units) and
# 3 (every sample through the index map), tiles shifted off a 16-byte
# boundary, K2 of 1, 5, 17 and 64, axis-0 windows of 1, 3 and 5
# (registers) and 7 (a ring), partial edge tiles; 3-D on the planes
# paths, 2-D on the rows paths (tests/test_torch_half_precision_cuda.py:
# BRANCHES, the same cases at the same sizes).
HALF_BRANCHES = {
    "ring 7, sh 6, n2 % 8 = 0": ((7, 18, 72), (7, 3, 5), "reflect", 0.0),
    "window 3, K2 17, n2 % 8 = 3": ((6, 18, 67), (3, 5, 17), "constant",
                                     0.3),
    "window 5, K2 64, n2 % 8 = 3": ((8, 21, 131), (5, 2, 64), "nearest",
                                     0.0),
    "window 1, K2 1": ((5, 19, 64), (1, 5, 1), "wrap", 0.0),
    "rows K2 5, sh 6": ((40, 264), (17, 5), "mirror", 0.0),
    "rows K2 64, n2 % 8 = 3": ((37, 291), (3, 64), "reflect", 0.0),
    "rows K2 1": ((33, 200), (9, 1), "constant", 0.3),
}


def _branch_taps(n, rng):
    """Taps of each of the kernel's kinds by length: equal (5), symmetric
    (3, 17), general (1, 2, 7, 64)."""
    if n == 5:
        return (0.2,) * 5
    if n == 3:
        return (0.25, 0.5, 0.25)
    if n == 17:
        g = np.exp(-0.5 * (np.arange(-8, 9) / 3.0) ** 2)
        return tuple(g / g.sum())
    return tuple(rng.uniform(-1, 1, n) / n)


def half_branches_vs_plain(fs, torch):
    """Every kind x both half types x HALF_BRANCHES against the plain
    versions: exact with NaN, corr and laplace within 1 ulp of the type
    at max|plain|."""
    worst = {}
    for dname, eps in HALF_TYPES:
        dtype = getattr(torch, dname)
        for case, (shape, sizes, mode, cval) in HALF_BRANCHES.items():
            nd = len(shape)
            base = np.random.RandomState(5).standard_normal(shape).astype(
                np.float32)
            nan = base.copy()
            nan.flat[::max(1, nan.size // 7)] = np.nan
            modes, zeros = (mode,) * nd, (0,) * nd
            for kind in HALF_KINDS:
                exact = kind not in ("corr", "laplace")
                x = dev(nan if exact else base).to(dtype)
                if kind == "corr":
                    rng = np.random.RandomState(sum(sizes))
                    args = ([_branch_taps(n, rng) for n in sizes], zeros,
                            modes, cval)
                    got = fs.fused_separable_correlate(x, *args)
                    ref = fs.fused_separable_correlate_ref(x, *args)
                elif kind in ("min", "max"):
                    args = (sizes, zeros, modes, cval, kind == "min")
                    got = fs.fused_separable_minmax(x, *args)
                    ref = fs.fused_separable_minmax_ref(x, *args)
                elif kind in ("opening", "closing"):
                    args = (sizes, zeros, zeros, modes, cval,
                            kind == "opening")
                    got = fs.fused_separable_open_close(x, *args)
                    ref = fs.fused_separable_open_close_ref(x, *args)
                else:
                    args = (sizes, zeros, modes, cval, kind)
                    got = fs.fused_separable_morph_pair(x, *args)
                    ref = fs.fused_separable_morph_pair_ref(x, *args)
                torch.cuda.synchronize()
                check(got.dtype == dtype == ref.dtype
                      and got.shape == ref.shape,
                      f"half branch {case} {kind}: {got.dtype} {got.shape}")
                if exact:
                    check(same(got, ref), f"half branch {case} {kind} "
                          f"{dname}: kernel differs from its plain version")
                    worst[dname, kind] = 0.0
                    continue
                tol = half_ulp(eps, ref.abs().max())
                err = float((got.float() - ref.float()).abs().max())
                check(err <= tol, f"half branch {case} {kind} {dname}: "
                      f"{err:.3e} > 1 ulp {tol:.1e}")
                worst[dname, kind] = max(worst.get((dname, kind), 0.0),
                                         err / tol)
    for (dname, kind), w in sorted(worst.items()):
        print(f"kernel-vs-plain half {dname:8s} {kind:8s} "
              f"{len(HALF_BRANCHES)} branch cases: "
              + ("exact" if kind not in ("corr", "laplace") else
                 f"at most {w:.2f} ulp of max|plain|"))


def half_path(fs, ndi, sndi, torch, boundary):
    """The half path: B1 on float16 and bfloat16 at full size.  Its
    kernels against their plain versions first (half_vs_plain); then,
    with the counts set to 0, eight public calls in each type
    (uniform_filter, gaussian_filter, minimum_filter, grey_opening and
    morphological_gradient of 256^3, uniform_filter, sobel and
    grey_closing of 4096^2), each held to one launch of its B1 entry and
    to SciPy in float64 on the same half values (the inputs are k / 256,
    exact in both types, so one reference serves both): opening, closing
    and minimum exactly, the correlations and the gradient within 1 ulp
    at max|ref| plus 2^-24 x sum|taps| x max|x| an axis.  Then each
    call's kernel timed (``time_row``: against the plain version again,
    a copy, the bound at 2 bytes a sample, and the float32 row's library
    call in the half type, timed only) and beside it the same call's
    kernel on the same values in float32.  Returns (rows, launches, kernel
    entries)."""
    F = torch.nn.functional
    t0 = time.perf_counter()
    half_vs_plain(fs, torch)
    print(f"half path kernel-vs-plain: {time.perf_counter() - t0:.1f} s")
    counters = {"fused_separable_correlate": fs.fused_separable_correlate,
                "fused_separable_minmax": fs.fused_separable_minmax,
                "fused_separable_open_close": fs.fused_separable_open_close,
                "fused_separable_morph_pair": fs.fused_separable_morph_pair}
    rng = np.random.default_rng(17)
    v = {"3": rng.integers(0, 256, (256,) * 3).astype(np.float32) / 256,
         "2": rng.integers(0, 256, (4096, 4096)).astype(np.float32) / 256}
    u5, u9 = [0.2] * 5, [1 / 9] * 9
    g17 = np.exp(-0.5 * (np.arange(-8, 9) / 2.0) ** 2)  # sigma 2, radius 8
    g17 = tuple(g17 / g17.sum())
    s3, d3 = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    corr, mm = "fused_separable_correlate", "fused_separable_minmax"
    oc, pair = "fused_separable_open_close", "fused_separable_morph_pair"
    # (label, input, entry, call, SciPy call, taps for the tolerance or
    # None for exact)
    calls = [
        ("uniform_filter(256^3, size=5)", "3", corr,
         lambda m, x: m.uniform_filter(x, 5), [u5] * 3),
        ("gaussian_filter(256^3, sigma=2)", "3", corr,
         lambda m, x: m.gaussian_filter(x, 2), [g17] * 3),
        ("minimum_filter(256^3, 5)", "3", mm,
         lambda m, x: m.minimum_filter(x, 5), None),
        ("grey_opening(256^3, size=5)", "3", oc,
         lambda m, x: m.grey_opening(x, size=5), None),
        # max - min of half values rounded once: not exact in the type
        ("morphological_gradient(256^3, size=3)", "3", pair,
         lambda m, x: m.morphological_gradient(x, size=3), []),
        ("uniform_filter(4096^2, size=9)", "2", corr,
         lambda m, x: m.uniform_filter(x, 9), [u9] * 2),
        ("sobel(4096^2)", "2", corr, lambda m, x: m.sobel(x), [s3, d3]),
        ("grey_closing(4096^2, size=5)", "2", oc,
         lambda m, x: m.grey_closing(x, size=5), None),
    ]
    xs = {d: {k: dev(a).to(getattr(torch, d)) for k, a in v.items()}
          for d, _ in HALF_TYPES}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    results, deltas = {}, {}
    for dname, _ in HALF_TYPES:
        for label, key, entry, fn, _ in calls:
            before = {k: c.launches for k, c in counters.items()}
            results[dname, label] = fn(ndi, xs[dname][key])
            deltas[dname, label] = {k: c.launches - before[k]
                                    for k, c in counters.items()}
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"half path launches: {json.dumps(launches)}")
    for label, key, entry, fn, taps in calls:
        for dname, _ in HALF_TYPES:
            want = {k: int(k == entry) for k in counters}
            check(deltas[dname, label] == want,
                  f"half path {label} {dname} launched "
                  f"{deltas[dname, label]}, not one {entry}")
        x64 = v[key].astype(np.float64)
        ref = fn(sndi, x64)
        amax = float(np.abs(x64).max())
        for dname, eps in HALF_TYPES:
            y = results.pop((dname, label))
            check(y.dtype == getattr(torch, dname) and y.shape == ref.shape,
                  f"half path {label} {dname}: {y.dtype} {tuple(y.shape)}")
            got = y.double().cpu().numpy()
            check(np.isfinite(got).all(), f"half path {label}: non-finite")
            err = float(np.abs(got - ref).max())
            if taps is None:
                check(np.array_equal(got, ref),
                      f"half path {label} {dname}: differs from scipy "
                      f"({err:.3e})")
                note = "exact"
            else:
                tol = half_ulp(eps, np.abs(ref).max()) + sum(
                    2.0 ** -24 * float(np.abs(t).sum()) * amax for t in taps)
                check(err <= tol, f"half path {label} {dname}: {err:.3e} "
                                  f"from scipy > {tol:.2e}")
                note = f"atol {tol:.2e}"
            print(f"half path {label:40s} {dname:8s} {entry} x1 "
                  f"max_abs_err vs scipy float64 {err:.3e} ({note})")
        del ref, x64

    def pool(x, size, is_min):
        op = F.max_pool3d if x.ndim == 3 else F.max_pool2d
        y = x[None, None]
        return (-op(-y, size, stride=1) if is_min else
                op(y, size, stride=1))[0, 0]

    rows, cases = {}, []
    for dname, eps in HALF_TYPES:
        dtype = getattr(torch, dname)
        x3, x2 = xs[dname]["3"], xs[dname]["2"]

        def ulp_of(ref, eps=eps):
            return half_ulp(eps, ref.abs().max())

        def corr_row(label, x, weights, library, library_call):
            nd = x.ndim
            args = (x, weights, (0,) * nd, ("reflect",) * nd, 0.0)
            ntaps = [len(w) for w in weights]
            rows[label] = time_row(
                label, lambda: fs.fused_separable_correlate(*args),
                lambda: fs.fused_separable_correlate_ref(*args), x,
                bound(x.numel(), flops=2 * sum(ntaps), itemsize=2), ulp_of,
                (library, None), library_call, n_plain=10,
                kernel="rows_f32_kernel" if nd == 2 else
                "fused_separable_f32_kernel")

        def padded(x, sizes, mode="reflect"):
            return boundary.pad(x, [(k // 2, k - 1 - k // 2) for k in sizes],
                                mode)[None, None]

        def dense(weights):
            w = weights[0]
            for t in weights[1:]:
                w = np.multiply.outer(w, t)
            return torch.tensor(w, dtype=dtype, device="cuda")[None, None]

        def composite(xp, weights):
            ks = []
            for ax, w in enumerate(weights):
                shape = [1] * len(weights)
                shape[ax] = len(w)
                ks.append(torch.tensor(w, dtype=dtype, device="cuda")
                          .reshape(1, 1, *shape))
            conv = F.conv3d if len(weights) == 3 else F.conv2d

            def run():
                y = xp
                for k in ks:
                    y = conv(y, k)
                return y
            return run

        xp, w = padded(x3, (5,) * 3), dense([u5] * 3)
        corr_row(f"uniform_filter 256^3 size=5 {dname}", x3, (tuple(u5),) * 3,
                 lambda xp=xp, w=w: F.conv3d(xp, w),
                 f"cuDNN conv3d with the dense 5x5x5 filter in {dname} on an "
                 "input padded beforehand (pad not timed)")
        xp = padded(x3, (17,) * 3)
        corr_row(f"gaussian_filter 256^3 sigma=2 {dname}", x3, (g17,) * 3,
                 composite(xp, [g17] * 3),
                 f"composite: one 1-D cuDNN conv3d per axis in {dname} on an "
                 "input padded beforehand (pad not timed; the dense 17^3 "
                 "filter is 4913 taps)")
        xp, w = padded(x2, (9, 9)), dense([u9] * 2)
        corr_row(f"uniform_filter 4096^2 size=9 {dname}", x2, (tuple(u9),) * 2,
                 lambda xp=xp, w=w: F.conv2d(xp, w),
                 f"cuDNN conv2d with the dense 9x9 filter in {dname} on an "
                 "input padded beforehand (pad not timed)")
        xp, w = padded(x2, (3, 3)), dense([s3, d3])
        corr_row(f"sobel 4096^2 {dname}", x2, (s3, d3),
                 lambda xp=xp, w=w: F.conv2d(xp, w),
                 f"cuDNN conv2d with the dense 3x3 filter in {dname} on an "
                 "input padded beforehand (pad not timed)")
        del xp, w
        label = f"minimum_filter 256^3 size=5 {dname}"
        args = (x3, (5,) * 3, (0,) * 3, ("reflect",) * 3, 0.0, True)
        xp = padded(x3, (5,) * 3)[0, 0]
        rows[label] = time_row(
            label, lambda: fs.fused_separable_minmax(*args),
            lambda: fs.fused_separable_minmax_ref(*args), x3,
            bound(x3.numel(), minmax_ops=3 * 4, itemsize=2), 0,
            (lambda xp=xp: pool(xp, 5, True), None),
            f"torch max_pool3d stride 1 on -x in {dname}, negations timed, "
            "on an input padded beforehand (pad not timed)", n_plain=10,
            kernel="fused_separable_f32_kernel")
        for label, x, size, opening in (
                (f"grey_opening 256^3 size=5 {dname}", x3, 5, True),
                (f"grey_closing 4096^2 size=5 {dname}", x2, 5, False)):
            nd = x.ndim
            sizes, zero = (size,) * nd, (0,) * nd
            args = (x, sizes, zero, zero, ("reflect",) * nd, 0.0, opening)
            xp = boundary.pad(x, [(size - 1, size - 1)] * nd, "reflect")
            rows[label] = time_row(
                label, lambda args=args: fs.fused_separable_open_close(*args),
                lambda args=args: fs.fused_separable_open_close_ref(*args), x,
                bound(x.numel(), minmax_ops=2 * nd * (size - 1), itemsize=2),
                0, (lambda xp=xp, size=size, opening=opening: pool(
                    pool(xp, size, opening), size, not opening), None),
                f"composite: two torch max_pool{nd}d stride 1 in {dname} "
                "(min as -max_pool(-x)) on an input padded beforehand by "
                "both windows (pad not timed)", n_plain=10, kernel="morph_")
        label = f"morphological_gradient 256^3 size=3 {dname}"
        args = (x3, (3,) * 3, (0,) * 3, ("reflect",) * 3, 0.0, "grad")
        xp = padded(x3, (3,) * 3)[0, 0]
        rows[label] = time_row(
            label, lambda: fs.fused_separable_morph_pair(*args),
            lambda: fs.fused_separable_morph_pair_ref(*args), x3,
            bound(x3.numel(), minmax_ops=2 * 3 * 2 + 1, itemsize=2), 0,
            (lambda xp=xp: pool(xp, 3, False) - pool(xp, 3, True), None),
            f"composite: torch max_pool3d for the max and -max_pool3d(-x) "
            f"for the min in {dname}, then the difference, on an input "
            "padded beforehand (pad not timed)", n_plain=10, kernel="morph_")
        del xp
        torch.cuda.empty_cache()
    # each case's float32 twin, the same call on the same values in
    # float32 (kernel alone): what the half type saves or costs
    x3, x2 = dev(v["3"]), dev(v["2"])
    r3, r2, z3, z2 = ("reflect",) * 3, ("reflect",) * 2, (0,) * 3, (0, 0)
    twins = {
        "uniform_filter 256^3 size=5": lambda: fs.fused_separable_correlate(
            x3, (tuple(u5),) * 3, z3, r3, 0.0),
        "gaussian_filter 256^3 sigma=2": lambda: fs.fused_separable_correlate(
            x3, (g17,) * 3, z3, r3, 0.0),
        "uniform_filter 4096^2 size=9": lambda: fs.fused_separable_correlate(
            x2, (tuple(u9),) * 2, z2, r2, 0.0),
        "sobel 4096^2": lambda: fs.fused_separable_correlate(
            x2, (s3, d3), z2, r2, 0.0),
        "minimum_filter 256^3 size=5": lambda: fs.fused_separable_minmax(
            x3, (5,) * 3, z3, r3, 0.0, True),
        "grey_opening 256^3 size=5": lambda: fs.fused_separable_open_close(
            x3, (5,) * 3, z3, z3, r3, 0.0, True),
        "grey_closing 4096^2 size=5": lambda: fs.fused_separable_open_close(
            x2, (5,) * 2, z2, z2, r2, 0.0, False),
        "morphological_gradient 256^3 size=3":
            lambda: fs.fused_separable_morph_pair(x3, (3,) * 3, z3, r3, 0.0,
                                                  "grad"),
    }
    twin_ms = {}
    for base, launch in twins.items():
        kname = ("morph_" if base.startswith(("grey", "morph")) else
                 "rows_f32_kernel" if "4096^2" in base else
                 "fused_separable_f32_kernel")
        twin_ms[base] = kernel_ms(launch, kname)
    del x3, x2
    for label, row in rows.items():
        base, row["dtype"] = label.rsplit(" ", 1)
        row["float32_kernel_ms"] = twin_ms[base]
        print(f"half path row {label:42s} ms {row['ms']:.4f} kernel_ms "
              f"{row['kernel_ms']:.4f} (float32 {twin_ms[base]:.4f}) "
              f"bound_ms {row['bound_ms']:.4f} plain_ms "
              f"{row['plain_ms']:.3f} library_ms {row['library_ms']:.4f} "
              f"copy_ms {row['copy_ms']:.4f}")
    # the kernels line's half entries: each B1 entry in each type, its
    # headline case and every timed case of it, its launches on this path
    entries = []
    card = card_line()
    stencil = "cupyimg_tpu/ops/pallas_stencil.py"
    shift_plans = (f"{stencil}:1388, {stencil}:1451 (_make_kernel_3d and "
                   "_make_kernel_2d, the shift plans that half data takes; "
                   f"_fused_separable, {stencil}:1034)")
    per_type = len(HALF_TYPES)
    for kname, counted, prefixes in (
            ("fused_separable_correlate", (corr,),
             ("uniform_filter 256", "gaussian_filter", "uniform_filter 4096",
              "sobel")),
            ("fused_separable_minmax", (mm,), ("minimum_filter",)),
            ("fused_separable_morph", (oc, pair),
             ("grey_opening", "grey_closing", "morphological_gradient"))):
        for dname, _ in HALF_TYPES:
            mine = [r for lb, r in rows.items() if r["dtype"] == dname
                    and lb.startswith(prefixes)]
            head = mine[0]
            # one launch a call: the timed cases are this path's launches
            n = sum(launches[k] for k in counted) // per_type
            check(n == len(mine), f"{kname} {dname}: {n} launches, "
                                  f"{len(mine)} timed cases")
            entries.append({
                "name": f"{kname} ({dname})",
                "route": "cuda",
                "source": "cupyimg_tpu_torch/csrc/fused_separable.cu",
                "replaces": shift_plans,
                "launches": n,
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": head["ms"], "kernel_ms": head["kernel_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "library_call": head["library_call"],
                "copy_ms": head["copy_ms"], "shape": head["case"],
                "card": card, "dtype": dname,
                "loss_ms": sum(r["kernel_ms"] - r["bound_ms"] for r in mine),
                "loss_launches_timed": len(mine),
                "cases": [{k: r[k] for k in (
                    "case", "ms", "kernel_ms", "float32_kernel_ms", "plain_ms",
                    "copy_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")} for r in mine],
            })
    del xs
    torch.cuda.empty_cache()
    return list(rows.values()), launches, entries


def half_only(fs, ndi, sndi, torch, boundary, _build, name):
    """``--half``: the separable source's build and ptxas lines, then the
    half path alone; its kernels line, then the last line."""
    t0 = time.perf_counter()
    _build.build(("fused_separable",))
    print(f"build: {time.perf_counter() - t0:.1f} s")
    worse = ptxas_b1_lines(_build)
    _, _, entries = half_path(fs, ndi, sndi, torch, boundary)
    print(f"wall: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    check(not worse, f"ptxas: half instances spill: {worse}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


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

    if sys.argv[1:] == ["--half"]:
        return half_only(fs, ndi, sndi, torch, boundary, _build, name)
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")

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
    # the first profiler session of the process: after the later paths'
    # sessions a trace once came back with no kernel record at all
    trace_check(torch)

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
    sk_rows, sk_launches = skimage_path(all_counters, torch)
    torch.cuda.empty_cache()
    tr_rows, tr_launches = transform_path(all_counters, torch)
    for kernel in ("fused_separable_correlate", "fused_separable_minmax",
                   "spline_gather", "fft_rows", "fft_strided"):
        check(tr_launches[kernel] >= 1,
              f"{kernel} not launched on the transform path")
    torch.cuda.empty_cache()
    fi_rows, fi_launches = filters_path(all_counters, torch)
    for kernel in ("fused_separable_correlate", "fused_rank_filter",
                   "spline_gather", "fused_dense_correlate"):
        check(fi_launches[kernel] >= 1,
              f"{kernel} not launched on the filters path")
    torch.cuda.empty_cache()
    rg_rows, rg_launches = registration_path(all_counters, torch)
    for kernel in ("fused_separable_correlate", "fused_rank_filter",
                   "spline_gather"):
        check(rg_launches[kernel] >= 1,
              f"{kernel} not launched on the registration path")
    torch.cuda.empty_cache()
    par_rows, par_launches, par_probes = parallel_path(torch)
    for kernel in ("fused_separable_correlate", "fused_separable_minmax",
                   "fused_dense_correlate", "fused_rank_filter",
                   "spline_gather"):
        check(par_launches.get(kernel, 0) >= 1,
              f"{kernel} not launched on the parallel path")
    check(par_launches.get("fft_rows", 0) + par_launches.get(
        "fft_strided", 0) >= 1, "fused_fft not launched on the parallel path")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    half_rows, half_launches, half_entries = half_path(fs, ndi, sndi, torch,
                                                       boundary)
    print(f"half path: {time.perf_counter() - t0:.1f} s")
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

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
                      + meas_rows + base_rows + sk_rows,
                      "transform_path": tr_rows,
                      "filters_path": fi_rows,
                      "registration_path": rg_rows,
                      "parallel_path": par_rows,
                      "parallel_path_gloo_probes": par_probes,
                      "half_path": half_rows,
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
        # profile_line runs the gather and B1's prefilter
        if entry["name"] in ("spline_gather", "fused_separable_correlate"):
            entry["launches_skimage_path"] = sk_launches[entry["name"]]
        # the warps, pyramids, corners, peaks, daisy and match_template
        if entry["name"] in tr_launches:
            entry["launches_transform_path"] = tr_launches[entry["name"]]
        if entry["name"] == "fused_fft":
            entry["launches_transform_path"] = (tr_launches["fft_rows"]
                                                + tr_launches["fft_strided"])
        # the gaussians, median, window and Richardson-Lucy: every kernel
        # entry says how often the filters path launched it
        entry["launches_filters_path"] = {
            "fused_separable_morph": fi_launches["fused_separable_open_close"]
            + fi_launches["fused_separable_morph_pair"],
            "fused_fft": fi_launches["fft_rows"] + fi_launches["fft_strided"],
        }.get(entry["name"], fi_launches.get(entry["name"], 0))
        # the flows' warps, pyramids, window sums and medians, the
        # gaussian gradient, the pipelines and convolve_separable
        entry["launches_registration_path"] = {
            "fused_separable_morph": rg_launches["fused_separable_open_close"]
            + rg_launches["fused_separable_morph_pair"],
            "fused_fft": rg_launches["fft_rows"] + rg_launches["fft_strided"],
        }.get(entry["name"], rg_launches.get(entry["name"], 0))
        # the sharded calls' single-device calls on each rank's block,
        # summed over the two ranks
        entry["launches_parallel_path"] = {
            "fused_separable_morph": par_launches.get(
                "fused_separable_open_close", 0)
            + par_launches.get("fused_separable_morph_pair", 0),
            "fused_fft": par_launches.get("fft_rows", 0)
            + par_launches.get("fft_strided", 0),
        }.get(entry["name"], par_launches.get(entry["name"], 0))
        # the half path: the float16 and bfloat16 instances of B1, whose
        # own entries follow
        entry["launches_half_path"] = {
            "fused_separable_morph": half_launches["fused_separable_open_close"]
            + half_launches["fused_separable_morph_pair"],
        }.get(entry["name"], half_launches.get(entry["name"], 0))
    line[-1]["entries"] = [
        {k: rows[lb][k] for k in ("case", "ms", "kernel_ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "library_call", "max_abs_err")}
        for lb in fft_labels]
    line[-1]["launches_by_entry"] = {k: sig_launches[k]
                                     for k in ("fft_rows", "fft_strided")}
    line += half_entries
    print(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
