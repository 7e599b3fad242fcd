// Fused separable correlation, box minimum and box maximum of a 2-D or
// 3-D float32 array, and the grey-morphology modes built on them, for
// sm_90a.
//
// Replaces the TPU kernels of cupyimg_tpu/ops/pallas_stencil.py:
// _fused_separable (all six 'corr' plans: _make_kernel_3d_lanemm padless
// and padded, _make_kernel_3d_laneroll, _make_kernel_3d,
// _make_kernel_2d_lanemm, _make_kernel_2d; the 'min'/'max' specs of
// _make_kernel_3d_laneroll, _make_kernel_3d and _make_kernel_2d, i.e.
// fused_separable_minmax; and the two-stage specs2 and pair_combine
// modes of _make_kernel_3d and _make_kernel_2d, i.e.
// fused_separable_open_close and fused_separable_morph_pair, in the
// kernels of the second half of this file).  What they all compute, op
// by op:
//
//   corr: y[i] = sum_k w0[k0] w1[k1] w2[k2] * xe[i0+k0-lo0, ...]
//   min:  y[i] = min_k xe[i0+k0-lo0, i1+k1-lo1, i2+k2-lo2]  (max alike)
//
// where xe is x extended ONCE, each axis index mapped on its own by that
// axis's ndimage mode (map_index, boundary.cuh), and any out-of-range
// index on a constant-mode axis giving cval.  A 2-D array runs as
// (1, n0, n1).  The op is a template parameter: the loads, index maps,
// ring of K0 planes and planner are shared; only the per-axis fold
// differs (a weighted sum, or a running NaN-propagating extremum).
//
// Bound: each input read once and each output written once, 8 bytes a
// voxel, against 2 * (K0 + K1 + K2) flops a voxel; for the headline
// uniform_filter(256^3, size=5) that is 134 MB (40 us at 3.35 TB/s)
// against 0.50 GFLOP (7.5 us at 67 TFLOP/s fp32): memory-bound.
//
// What the design does about it: no pre-pad pass and no crop copy.  The
// boundary mode is applied in the load, so the array moves as one read
// (plus halo re-reads, mostly from L2) and one write; the interior of a
// row moves in 16-byte loads, and only the chunks at an edge go through
// the index maps.  Two paths:
//
// - Planes (fused_separable_f32_kernel; a 3-D array).  Each block owns
//   a (T1 x 64) column of output tiles across Z planes of axis 0 and
//   marches along axis 0: for each
//   input plane it loads the halo'd (T1+K1-1) x (64+K2-1) tile into
//   shared memory (16-byte cp.async, the next three planes in flight),
//   runs the axis-2 and axis-1 passes there, and keeps the filtered
//   plane in a ring of K0 planes; once the ring holds K0 planes, the
//   axis-0 pass over the ring gives one output plane.  So only a 2-D
//   halo is ever resident, which is what lets 64-tap halos on all three
//   axes fit in 227 KB.  For K0 of 3 or 5 (the main path's filters) the
//   ring is a thread's registers instead: the plane loop unrolled by
//   K0, no shared ring and no ring traffic.
// - Rows (rows_f32_kernel; a 2-D array, run as (1, n0, n1)).  The planes
//   path would load one halo'd tile per block and exit, re-filtering the
//   vertical halo for every 16-row tile.  Here a block owns a strip of
//   128 output columns and a run of R output rows and marches down the
//   rows, 16 a step: it loads the step's rows (W + K2 - 1 samples each,
//   prefetched into registers one step ahead, so one stage buffer
//   does), runs the horizontal pass once per input row into a ring of
//   K1 - 1 + 16 filtered rows rounded up to 16, and emits 16 output rows
//   from the ring, so the vertical halo costs (R + K1 - 1) / R.  It holds
//   no stage buffers for planes that do not exist: 55 KB for 64 taps on
//   both axes.
//
// The rows path blocks registers along each filtered axis (Fold8): a
// thread computes 8 consecutive outputs from a sliding window of
// samples, so an output reads (8 + K - 1) / 8 samples from shared memory,
// not K, and each tap load serves 8 outputs.  It stores its input rows
// deinterleaved (column c at word (c % 8) * nu + c / 8), so the lanes of
// a warp, 8 columns apart, read consecutive words.  The planes path
// computes 2 x 2 outputs a thread per pass, sharing the tap loads (a
// 4-row register window along axis 1 ran slower there).  Taps,
// window leads, modes and tile sizes are runtime arguments: one build
// serves every call.  PERF.md has the times.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "boundary.cuh"
#include "tile_load.cuh"

namespace {

constexpr int kMaxTaps = 64;
constexpr int kBX = 32;  // threads along axis 2 (contiguous)
constexpr int kBY = 8;   // threads along axis 1
static_assert(kBX == kLoadBX && kBX * kBY == kLoadThreads,
              "tile_load.cuh's block");
// output tile width along axis 2: each thread owns columns tx and tx + 32
// (ops/fused_separable.py:T2)
constexpr int kT2 = 2 * kBX;
// input planes in flight per block (ops/fused_separable.py:STAGES)
constexpr int kStages = 4;

// tap kinds, as ops/fused_separable.py:_tap_kind assigns them
constexpr int kEqual = 1;      // all taps equal: sum the window, scale once
constexpr int kSymmetric = 2;  // w[k] == w[K-1-k]: fold the pairs

struct Axis {
  float taps[kMaxTaps];
  int n;      // axis length (input and output)
  int ntaps;  // K, 1 for an axis that is not filtered (tap 1.0)
  int lo;     // output i reads input i - lo + k, k in [0, K)
  int mode;
  int kind;
};

struct Params {
  Axis ax[3];
  float cval;
  int t1;   // output tile rows along axis 1 (rows path: rows a block)
  int z;    // output planes of axis 0 per block
  int vec;  // rows may be read in 16-byte chunks (aligned base, n2 % 4 == 0)
};

// NV outputs of a thread of a 1-D correlation with taps w[0..n): get(k, j)
// is the k-th window sample of output j.  The outputs share each tap
// load and the loop.
template <int NV, class Get>
__device__ __forceinline__ void corr(const float* w, int n, int kind,
                                     Get get, float (&s)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) s[j] = 0.f;
  if (kind == kEqual) {
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int j = 0; j < NV; ++j) s[j] += get(k, j);
    }
    const float w0 = w[0];
#pragma unroll
    for (int j = 0; j < NV; ++j) s[j] *= w0;
    return;
  }
  if (kind == kSymmetric) {
    const int h = n / 2;
    if (n & 1) {
      const float wh = w[h];
#pragma unroll
      for (int j = 0; j < NV; ++j) s[j] = wh * get(h, j);
    }
#pragma unroll 4
    for (int k = 0; k < h; ++k) {
      const float wk = w[k];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        s[j] += wk * (get(k, j) + get(n - 1 - k, j));
      }
    }
    return;
  }
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float wk = w[k];
#pragma unroll
    for (int j = 0; j < NV; ++j) s[j] += wk * get(k, j);
  }
}

// the per-axis op, as ops/fused_separable.py:_OP_CODES assigns them
constexpr int kCorr = 0;
constexpr int kMin = 1;
constexpr int kMax = 2;

// The per-axis fold of op OP over a window of n samples: corr for
// kCorr; for kMin/kMax a running extremum that keeps NaN (the equal-tap
// and symmetric shortcuts of corr do not apply to it).
template <int OP, int NV, class Get>
__device__ __forceinline__ void fold(const float* w, int n, int kind,
                                     Get get, float (&s)[NV]) {
  if constexpr (OP == kCorr) {
    corr<NV>(w, n, kind, get, s);
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) s[j] = get(0, j);
#pragma unroll 4
    for (int k = 1; k < n; ++k) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        s[j] = OP == kMin ? min_nan(s[j], get(k, j))
                          : max_nan(s[j], get(k, j));
      }
    }
  }
}

// fold() over a window of KZ samples known at compile time, every tap
// unrolled (the same sums in the same order).
template <int OP, int KZ, class Get>
__device__ __forceinline__ void fold_fixed(const float* w, int kind, Get get,
                                           float (&s)[4]) {
  if constexpr (OP == kCorr) {
    if (kind == kEqual) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < KZ; ++k) a += get(k, j);
        s[j] = a * w[0];
      }
    } else if (kind == kSymmetric) {
      constexpr int h = KZ / 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = (KZ & 1) ? w[h] * get(h, j) : 0.f;
#pragma unroll
        for (int k = 0; k < h; ++k) a += w[k] * (get(k, j) + get(KZ - 1 - k, j));
        s[j] = a;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < KZ; ++k) a += w[k] * get(k, j);
        s[j] = a;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = get(0, j);
#pragma unroll
      for (int k = 1; k < KZ; ++k) {
        a = OP == kMin ? min_nan(a, get(k, j)) : max_nan(a, get(k, j));
      }
      s[j] = a;
    }
  }
}

// The planes path (see the top of the file).
template <int OP, int KZ>
__global__ void __launch_bounds__(kBX * kBY)
fused_separable_f32_kernel(const float* __restrict__ x,
                           float* __restrict__ y,
                           const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  // every scalar is read from the parameter block once, into registers
  const int n0 = p.ax[0].n, n1 = p.ax[1].n, n2 = p.ax[2].n;
  const int K0 = p.ax[0].ntaps, K1 = p.ax[1].ntaps, K2 = p.ax[2].ntaps;
  const int lo0 = p.ax[0].lo, lo1 = p.ax[1].lo, lo2 = p.ax[2].lo;
  const int mode0 = p.ax[0].mode, mode1 = p.ax[1].mode,
            mode2 = p.ax[2].mode;
  const int kind0 = p.ax[0].kind, kind1 = p.ax[1].kind,
            kind2 = p.ax[2].kind;
  const float cval = p.cval;
  const int T1 = p.t1, TT = T1 * kT2;
  const int H1 = T1 + K1 - 1;   // halo'd tile rows
  const int H2 = kT2 + K2 - 1;  // halo'd tile columns
  const int nch = (H2 + 3 + 3) >> 2;  // 16-byte chunks of a tile row
  const int H2P = 4 * nch;            // words of a tile row
  // taps in shared memory: a uniform shared load is a broadcast
  float* w0 = smem;                 // 3 x kMaxTaps taps
  float* w1 = w0 + kMaxTaps;
  float* w2 = w1 + kMaxTaps;
  // the tile's index maps (build_maps), then the tiles from a 16-byte
  // boundary on
  int* row_map = reinterpret_cast<int*>(w0 + 3 * kMaxTaps);  // H1
  int* col_map = row_map + H1;                                 // H2
  float* s_in = w0 + 3 * kMaxTaps + (H1 + H2 + 3) / 4 * 4;  // kStages tiles
  float* s_mid = s_in + kStages * H1 * H2P;  // H1 x kT2 after axis 2
  float* ring = s_mid + H1 * kT2;            // K0 planes of T1 x kT2

  const int tiles2 = (n2 + kT2 - 1) / kT2;
  const int o1 = (blockIdx.x / tiles2) * T1;
  const int o2 = (blockIdx.x % tiles2) * kT2;
  const int z0 = blockIdx.y * p.z;
  const int z1 = min(z0 + p.z, n0);
  const int nplanes = z1 - z0 + K0 - 1;
  const int xs = o2 - lo2;
  const int sh = xs - floor4(xs);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  for (int i = tid; i < 3 * kMaxTaps; i += kBX * kBY) {
    w0[i] = p.ax[i / kMaxTaps].taps[i % kMaxTaps];
  }
  build_maps(row_map, H1, o1 - lo1, n1, mode1, H2, xs, n2, mode2);
  __syncthreads();

  // Start the copies of input plane e (extended index) into its stage
  // buffer.  One commit group per plane, empty past the last plane, so
  // that a fixed wait depth works.
  auto issue = [&](int e) {
    if (e < nplanes) {
      load_plane16(x, s_in + (e % kStages) * H1 * H2P, z0 - lo0 + e, n0,
                   mode0, n1, n2, row_map, col_map, H1, H2, nch, xs, p.vec,
                   cval);
    }
    __pipeline_commit();
  };

  // kStages - 1 planes ahead of the one being filtered are in flight.
  // The buffer plane e + kStages - 1 goes to was last read by the axis-2
  // pass of plane e - 1, which every thread finished before the barrier
  // that follows that pass.
  for (int e = 0; e < kStages - 1; ++e) issue(e);
  // Plane e: wait for its tile, then the axis-2 pass into s_mid.  A thread
  // computes four outputs per call: columns tx and tx + 32 of rows r and
  // r + 8.  Where row r + 8 is past the tile (two == false) it recomputes
  // row r and stores nothing for it.
  auto front = [&](int e) {
    issue(e + kStages - 1);
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();
    const float* tile = s_in + (e % kStages) * H1 * H2P + sh;
    for (int r = ty; r < H1; r += 2 * kBY) {
      const bool two = r + kBY < H1;
      const int dr = two ? kBY : 0;
      const float* src = tile + r * H2P + tx;
      float v[4];
      fold<OP, 4>(w2, K2, kind2, [&](int k, int j) {
        return src[(j >> 1) * dr * H2P + (j & 1) * kBX + k];
      }, v);
      float* dst = s_mid + r * kT2 + tx;
      dst[0] = v[0];
      dst[kBX] = v[1];
      if (two) {
        dst[kBY * kT2] = v[2];
        dst[kBY * kT2 + kBX] = v[3];
      }
    }
    __syncthreads();
  };
  // The axis-1 pass of the thread's four cells (row r = ty, T1 <= 16).
  const int r = ty;
  const bool two = r + kBY < T1;
  const int dr = two ? kBY : 0;
  auto axis1 = [&](float (&v)[4]) {
    const float* src = s_mid + r * kT2 + tx;
    fold<OP, 4>(w1, K1, kind1, [&](int k, int j) {
      return src[((j >> 1) * dr + k) * kT2 + (j & 1) * kBX];
    }, v);
  };
  auto store = [&](int zo, const float (&out)[4]) {
    float* dst = y + ((size_t)zo * n1 + o1 + r) * n2 + o2 + tx;
    const bool c0 = o2 + tx < n2, c1 = o2 + tx + kBX < n2;
    if (o1 + r < n1) {
      if (c0) dst[0] = out[0];
      if (c1) dst[kBX] = out[1];
    }
    if (two && o1 + r + kBY < n1) {
      if (c0) dst[(size_t)kBY * n2] = out[2];
      if (c1) dst[(size_t)kBY * n2 + kBX] = out[3];
    }
  };
  if constexpr (KZ == 0) {
    // Each thread writes and reads only its own ring cells, so the ring
    // needs no barrier; the first barrier of the next plane keeps s_mid
    // from being overwritten while a thread still reads it.
    for (int e = 0; e < nplanes; ++e) {
      front(e);
      if (r >= T1) continue;
      const int slot = e % K0;
      const int first = (e + 1) % K0;  // ring slot of the window's plane 0
      const int zo = z0 + e - (K0 - 1);
      float v[4];
      axis1(v);
      float* cell = ring + r * kT2 + tx;
      cell[slot * TT] = v[0];
      cell[slot * TT + kBX] = v[1];
      if (two) {
        cell[slot * TT + kBY * kT2] = v[2];
        cell[slot * TT + kBY * kT2 + kBX] = v[3];
      }
      if (zo >= z0) {
        float out[4];
        fold<OP, 4>(w0, K0, kind0, [&](int k, int j) {
          int s = first + k;
          if (s >= K0) s -= K0;
          return cell[s * TT + (j >> 1) * dr * kT2 + (j & 1) * kBX];
        }, out);
        store(zo, out);
      }
    }
  } else {
    // K0 == KZ: the axis-0 window of the thread's four cells in
    // registers, plane e's values in hist[e % KZ]; the plane loop
    // unrolled by KZ, so that every index is a constant
    float hist[KZ][4];
    for (int e0 = 0; e0 < nplanes; e0 += KZ) {
#pragma unroll
      for (int u = 0; u < KZ; ++u) {
        const int e = e0 + u;
        if (e >= nplanes) break;  // the same for every thread
        front(e);
        if (r >= T1) continue;
        axis1(hist[u]);
        const int zo = z0 + e - (KZ - 1);
        if (zo >= z0) {
          float out[4];
          fold_fixed<OP, KZ>(w0, kind0, [&](int k, int j) {
            return hist[(u + 1 + k) % KZ][j];
          }, out);
          store(zo, out);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The rows path (see the top of the file)
// ---------------------------------------------------------------------------

constexpr int kRowW = 128;      // output columns a block (ops/fused_separable.py:ROW_W)
constexpr int kRowStep = 16;    // input rows a step (ROW_STEP)
constexpr int kRowThreads = 256;
constexpr int kRowNV = 8;       // outputs a thread computes along an axis
// 32-byte units (8 columns) a thread prefetches a step: 16 rows of at
// most 26 units (ops/fused_separable.py:_row_units)
constexpr int kRowPer = 2;
// blocks an SM holds (64 registers a thread; ops/fused_separable.py)
constexpr int kRowBlocksPerSM = 4;


// Eight consecutive outputs of a 1-D fold of op OP, tap by tap: s[j]
// is output j, v[0..6] the window of samples the next tap reads for
// outputs 0..6 (output j's tap k reads sample j + k), and step() takes
// tap k with the window's newest sample, k + 7.  A sliding window of
// registers: each sample is read once for the eight outputs, each tap
// once; EQUAL (all taps equal) sums and scales once.  The rows path
// runs the corr kinds general and equal (a
// symmetric pair fold saves no instruction here, an add replacing a
// multiply-add, and its second window would cost the registers that keep
// four blocks on an SM).
template <int OP, bool EQUAL>
struct Fold8 {
  float s[8], v[8];

  __device__ __forceinline__ Fold8() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = OP == kCorr ? 0.f : OP == kMin ? INFINITY : -INFINITY;
    }
  }

  __device__ __forceinline__ void step(float wk, float x) {
    v[7] = x;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (OP == kCorr) {
        s[j] = EQUAL ? s[j] + v[j] : s[j] + wk * v[j];
      } else if constexpr (OP == kMin) {
        s[j] = min_nan(s[j], v[j]);
      } else {
        s[j] = max_nan(s[j], v[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) v[j] = v[j + 1];
  }

  __device__ __forceinline__ void finish(const float* w, float (&out)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[j] = OP == kCorr && EQUAL ? s[j] * w[0] : s[j];
    }
  }
};

// The horizontal pass of the rows path: eight outputs from a
// deinterleaved stage row, the thread's sample m at
// rb[((sh + m) % 8) * nu + (sh + m) / 8].  Whole groups of eight taps
// read at offsets fixed for the call (off[i]) and taps as two 16-byte
// loads; the rest tap by tap.
template <int OP, bool EQUAL>
__device__ __forceinline__ void hfold8(const float* w, int n,
                                       const float* rb, int sh, int nu,
                                       float (&out)[8]) {
  Fold8<OP, EQUAL> f;
  auto at = [&](int m) {
    const int u = sh + m;
    return rb[(u & 7) * nu + (u >> 3)];
  };
#pragma unroll
  for (int j = 0; j < 7; ++j) f.v[j] = at(j);
  int k = 0;
  if (n >= 8) {
    int off[8];  // sample k + 7 + i for k a multiple of 8
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      off[i] = ((sh + 7 + i) & 7) * nu + ((sh + 7 + i) >> 3);
    }
    for (; k + 8 <= n; k += 8) {
      const float* r = rb + (k >> 3);
      float wk[8] = {};
      if constexpr (OP == kCorr && !EQUAL) {
        const float4 wa = *reinterpret_cast<const float4*>(w + k);
        const float4 wb = *reinterpret_cast<const float4*>(w + k + 4);
        wk[0] = wa.x; wk[1] = wa.y; wk[2] = wa.z; wk[3] = wa.w;
        wk[4] = wb.x; wk[5] = wb.y; wk[6] = wb.z; wk[7] = wb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) f.step(wk[i], r[off[i]]);
    }
  }
  for (; k < n; ++k) f.step(w[k], at(k + 7));
  f.finish(w, out);
}

// The vertical pass of the rows path: eight outputs of column `col` of
// the ring, sample m at col[((base + m) % ring_rows) * kRowW]; the
// window's newest sample wraps at one tap, so two runs of taps, each
// stepping a pointer.
template <int OP, bool EQUAL>
__device__ __forceinline__ void vfold8(const float* w, int n,
                                       const float* col, int base,
                                       int ring_rows, float (&out)[8]) {
  Fold8<OP, EQUAL> f;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    int r = base + j;
    if (r >= ring_rows) r -= ring_rows;
    f.v[j] = col[r * kRowW];
  }
  const int wrap = min(n, max(0, ring_rows - base - 7));
  const float* p = col + (base + 7) * kRowW;
#pragma unroll 4
  for (int k = 0; k < wrap; ++k) f.step(w[k], p[k * kRowW]);
  p -= ring_rows * kRowW;
#pragma unroll 4
  for (int k = wrap; k < n; ++k) f.step(w[k], p[k * kRowW]);
  f.finish(w, out);
}

// Block (bx, by) of a 2-D (n1, n2) array: columns [x0, x0 + 128), rows
// [r0, r0 + t1).  Shared memory: the taps of both axes, one stage buffer
// of 16 input rows, each deinterleaved by 8 (column 8u + e of the row,
// counted from floor4(x0 - lo2), at word e * nu + u; nu is 2 modulo 4,
// so the two rows a warp reads fall on disjoint banks), and a ring of
// `ring_rows` horizontally filtered rows of 128.
template <int OP>
__global__ void __launch_bounds__(kRowThreads, kRowBlocksPerSM)
rows_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float rsmem[];
  const int n1 = p.ax[1].n, n2 = p.ax[2].n;
  const int K1 = p.ax[1].ntaps, K2 = p.ax[2].ntaps;
  const int lo1 = p.ax[1].lo, lo2 = p.ax[2].lo;
  const int mode1 = p.ax[1].mode, mode2 = p.ax[2].mode;
  const bool equal1 = p.ax[1].kind == kEqual, equal2 = p.ax[2].kind == kEqual;
  const float cval = p.cval;
  const int vec = p.vec;
  // units of a stage row: samples up to 3 + 127 + K2 - 1, 2 modulo 4
  const int nu = (((K2 + 130 + 7) >> 3) + 1) / 4 * 4 + 2;
  const int lag = (K1 - 1 + kRowStep - 1) / kRowStep;  // steps, input to output
  const int ring_rows = kRowStep * (lag + 1);
  float* w1 = rsmem;
  float* w2 = w1 + kMaxTaps;
  float* stage = w2 + kMaxTaps;             // 16 x 8 nu
  float* ring = stage + kRowStep * 8 * nu;  // ring_rows x 128
  const int tid = threadIdx.x;
  const int tiles2 = (n2 + kRowW - 1) / kRowW;
  const int x0 = (blockIdx.x % tiles2) * kRowW;
  const int r0 = (blockIdx.x / tiles2) * p.t1;
  const int nrows = min(p.t1, n1 - r0);  // output rows of this block
  const int steps = (nrows + kRowStep - 1) / kRowStep + lag;
  const int xs = x0 - lo2, xa = floor4(xs), sh = xs - xa;
  if (tid < 2 * kMaxTaps) {
    rsmem[tid] = p.ax[1 + tid / kMaxTaps].taps[tid % kMaxTaps];
  }

  // unit i of a step: input row i / nu, columns 8 (i % nu) .. + 7
  float4 pre[kRowPer][2];
  auto fetch = [&](int t) {
#pragma unroll
    for (int u = 0; u < kRowPer; ++u) {
      const int i = tid + u * kRowThreads;
      if (i >= kRowStep * nu) break;
      const int rr = i / nu, ch = i - rr * nu;
      bool oob = false;
      const int m1 = map_index(r0 - lo1 + kRowStep * t + rr, n1, mode1, oob);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = xa + 8 * ch + 4 * half;
        float4 v = make_float4(cval, cval, cval, cval);
        if (!oob) {
          const float* row = x + (size_t)m1 * n2;
          if (vec && c >= 0 && c + 4 <= n2) {
            v = __ldg(reinterpret_cast<const float4*>(row + c));
          } else {
            float e4[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              bool o = false;
              const int m2 = map_index(c + e, n2, mode2, o);
              e4[e] = o ? cval : __ldg(row + m2);
            }
            v = make_float4(e4[0], e4[1], e4[2], e4[3]);
          }
        }
        pre[u][half] = v;
      }
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int u = 0; u < kRowPer; ++u) {
      const int i = tid + u * kRowThreads;
      if (i >= kRowStep * nu) break;
      const int rr = i / nu, ch = i - rr * nu;
      float* dst = stage + rr * 8 * nu + ch;
      dst[0] = pre[u][0].x;
      dst[nu] = pre[u][0].y;
      dst[2 * nu] = pre[u][0].z;
      dst[3 * nu] = pre[u][0].w;
      dst[4 * nu] = pre[u][1].x;
      dst[5 * nu] = pre[u][1].y;
      dst[6 * nu] = pre[u][1].z;
      dst[7 * nu] = pre[u][1].w;
    }
  };

  fetch(0);
  // Barriers: the stage buffer step t fills was last read by the
  // horizontal pass of step t - 1, which the second barrier of step t - 1
  // closes; the ring rows step t writes were last read by the vertical
  // pass of step t - 1, which the first barrier of step t closes.
  for (int t = 0; t < steps; ++t) {
    put();
    if (t + 1 < steps) fetch(t + 1);  // in flight during the passes
    __syncthreads();
    {
      // horizontal: row rho of the step, columns 8q .. 8q + 7
      const int rho = tid >> 4, q = tid & 15;
      const float* rb = stage + rho * 8 * nu + q;
      float v[kRowNV];
      if (OP == kCorr && equal2) {
        hfold8<OP, true>(w2, K2, rb, sh, nu, v);
      } else {
        hfold8<OP, false>(w2, K2, rb, sh, nu, v);
      }
      float* dst = ring + ((kRowStep * t + rho) % ring_rows) * kRowW + 8 * q;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    const int g = t - lag;  // the group of 16 output rows this step emits
    const int o = kRowStep * g + kRowNV * (tid / kRowW);
    if (g >= 0 && o < nrows) {
      // vertical: rows o .. o + 7 of column c
      const int c = tid % kRowW;
      float v[kRowNV];
      if (OP == kCorr && equal1) {
        vfold8<OP, true>(w1, K1, ring + c, o % ring_rows, ring_rows, v);
      } else {
        vfold8<OP, false>(w1, K1, ring + c, o % ring_rows, ring_rows, v);
      }
      if (x0 + c < n2) {
        float* dst = y + (size_t)(r0 + o) * n2 + x0 + c;
#pragma unroll
        for (int j = 0; j < kRowNV; ++j) {
          if (o + j < nrows) dst[(size_t)j * n2] = v[j];
        }
      }
    }
  }
}

template <int OP>
int launch(const float* x, float* y, const Params& p, const int* plan,
           void* stream) {
  const dim3 grid(plan[2], plan[3]);
  const int smem = plan[4];
  if (plan[5]) {
    cudaError_t err = cudaFuncSetAttribute(
        rows_f32_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    rows_f32_kernel<OP><<<grid, kRowThreads, smem, (cudaStream_t)stream>>>(
        x, y, p);
    return (int)cudaGetLastError();
  }
  // the axis-0 windows of the main path's filters (3 and 5) in registers
  const int k0 = p.ax[0].ntaps;
  auto kernel = k0 == 3   ? fused_separable_f32_kernel<OP, 3>
                : k0 == 5 ? fused_separable_f32_kernel<OP, 5>
                          : fused_separable_f32_kernel<OP, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, dim3(kBX, kBY), smem, (cudaStream_t)stream>>>(x, y, p);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// B1's morphology modes: two-stage (grey opening and closing) and pair
// (morphological gradient and laplace), over flat box windows.
//
// Bound: as the min/max op, each input read once and each output written
// once, 8 bytes a voxel (40 us for 256^3 at 3.35 TB/s), against
// 2 * sum(K - 1) min/max instructions a voxel (two stages, or two folds).
// What the design does about it: one launch where scipy's route takes
// two passes over device memory (three for the pair), and
//
// - every window fold of K >= 4 samples runs over a thread's run of L
//   consecutive outputs by van Herk / Gil-Werman (seg_fold): the samples
//   all L windows share are folded once, the rest as a suffix and a
//   prefix fold, so (K + 3L - 6) / L extremum ops an output instead of
//   K - 1 (3.4 for K = 9, L = 8), each sample read once for the run;
// - a 2-D array takes a rows path (morph_rows_f32_kernel) built on B1's:
//   a block owns a strip of output columns and marches down its rows 16
//   a step, so that each input row is read and filtered once and the
//   vertical halo costs (R + 2(K1 - 1)) / R of a block's R rows, not the
//   doubly halo'd tile of every 16 rows;
// - a 3-D array takes a planes path (morph_planes_f32_kernel) that
//   marches along axis 0 with B1's 16-byte loads, up to four planes in
//   flight, and three barriers a plane step (two for the pair); for an
//   axis-0 window of 1, 3 or 5 each thread keeps the axis-0 window of
//   each stage in registers, the plane loop unrolled by it, with no
//   shared ring; any other window keeps a ring of K0 planes in shared
//   memory, each thread reading only its own cells;
// - the runs along a row read their samples as aligned float4 chunks
//   (run4) where the tile starts on a 16-byte boundary: the planner
//   shifts the tiles (the rows path's strips always, the planes path's
//   where that adds no tile), since scalar loads by lanes four columns
//   apart conflict 4 ways in the banks.  A run may read samples past its
//   row's end (the next row or buffer, inside the block's shared
//   memory): they feed only outputs it discards.
//
// Extremum ops are min.NaN / max.NaN: associative and exact, so that the
// fold order of the runs gives the plain version's values bit for bit
// (NaN included).
// ---------------------------------------------------------------------------

// the kernels' kinds, as ops/fused_separable.py:_MORPH_KINDS assigns them
constexpr int kOpening = 0;  // min, then max
constexpr int kClosing = 1;  // max, then min
constexpr int kGrad = 2;     // max - min
constexpr int kLaplace = 3;  // max + min - 2x

// rows of a thread's axis-1 run on the planes path (ops/fused_separable.py:
// MORPH_L)
constexpr int kMorphL = 4;
static_assert(kMorphL == 4, "run4 and store4 take runs of 4");
// two-stage planes path with a register window: stage-1 axis-1 runs a
// thread holds (ops/fused_separable.py:MORPH_ITEMS)
constexpr int kMorphItems = 2;
// blocks an SM holds (ops/fused_separable.py:_MORPH_BLOCKS, the planner's
// waves), by kind: the register budgets that measured fastest on an H100
// (the two-stage planes kernel spills at three blocks)
template <int KIND> constexpr int kMorphBlocksPerSM = KIND < 2 ? 2 : 3;
template <int KIND> constexpr int kMorphRowBlocksPerSM = KIND < 2 ? 4 : 3;

struct MorphParams {
  int n[3];
  int k[3];    // window per axis (1: axis skipped), the same in both stages
  int lo1[3];  // window leads of stage 1 (and of the pair's folds)
  int lo2[3];  // window leads of stage 2
  int mode[3];
  float cval;
  int t1;      // planes: output tile rows; rows: output rows a block
  int t2;      // output columns of a tile (planes: kT2) or strip (rows)
  int z;       // planes: output planes of axis 0 a block
  int stages;  // planes: input planes in flight (4, 2 or 1)
  int vec;     // rows may be read in 16-byte chunks
  int shift;   // tiles or strips start this many columns left of column 0
};

struct MinOp {
  using T = float;
  static __device__ __forceinline__ T op(T a, T b) { return min_nan(a, b); }
  static __device__ __forceinline__ T from(float v) { return v; }
};

struct MaxOp {
  using T = float;
  static __device__ __forceinline__ T op(T a, T b) { return max_nan(a, b); }
  static __device__ __forceinline__ T from(float v) { return v; }
};

// the pair's min and max folds side by side, as (min, max)
struct MinMaxOp {
  using T = float2;
  static __device__ __forceinline__ T op(T a, T b) {
    return make_float2(min_nan(a.x, b.x), max_nan(a.y, b.y));
  }
  static __device__ __forceinline__ T from(float v) {
    return make_float2(v, v);
  }
};

// stage 1's and stage 2's folds (the pair has one stage: its Second is
// never called)
template <int KIND> struct MorphOps;
template <> struct MorphOps<kOpening> { using First = MinOp; using Second = MaxOp; };
template <> struct MorphOps<kClosing> { using First = MaxOp; using Second = MinOp; };
template <> struct MorphOps<kGrad> { using First = MinMaxOp; using Second = MinOp; };
template <> struct MorphOps<kLaplace> { using First = MinMaxOp; using Second = MinOp; };

// The Op-fold of L consecutive windows of K >= L samples, window j over
// get(j .. j + K - 1), by van Herk / Gil-Werman: the core, samples
// L - 1 .. K - 1, which every window holds, folded once; a suffix fold
// of samples 0 .. L - 2 and a prefix fold of K .. K + L - 2 give each
// window its two ends.  K + 3L - 6 ops for the L outputs, each sample
// read once.
template <class Op, int L, class Get>
__device__ __forceinline__ void seg_fold(int K, Get get,
                                         typename Op::T (&out)[L]) {
  using T = typename Op::T;
  T core = get(L - 1);
  for (int m = L; m < K; ++m) core = Op::op(core, get(m));
  T suf[L - 1];  // suf[j]: samples j .. L - 2
  suf[L - 2] = get(L - 2);
#pragma unroll
  for (int j = L - 3; j >= 0; --j) suf[j] = Op::op(get(j), suf[j + 1]);
  out[0] = Op::op(suf[0], core);
  T pre = get(K);  // samples K .. K + j - 1, for window j
#pragma unroll
  for (int j = 1; j < L - 1; ++j) {
    out[j] = Op::op(Op::op(suf[j], core), pre);
    pre = Op::op(pre, get(K + j));
  }
  out[L - 1] = Op::op(core, pre);
}

// The Op-fold of L consecutive windows of K samples, window j over
// get(j .. j + K - 1): seg_fold over the run, or over runs of 4 for
// 4 <= K < L; below 4 samples, from a register window.
template <class Op, int L, class Get>
__device__ __forceinline__ void run_fold(int K, Get get,
                                         typename Op::T (&out)[L]) {
  using T = typename Op::T;
  if (K >= L) {
    seg_fold<Op, L>(K, get, out);
  } else if (L > 4 && K >= 4) {
#pragma unroll
    for (int h = 0; h < L / 4; ++h) {
      T o[4];
      seg_fold<Op, 4>(K, [&](int m) { return get(4 * h + m); }, o);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * h + j] = o[j];
    }
  } else {
    T v[L + 2];
#pragma unroll
    for (int m = 0; m < L + 2; ++m) {
      if (m < L + K - 1) v[m] = get(m);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      T a = v[j];
      if (K > 1) a = Op::op(a, v[j + 1]);
      if (K > 2) a = Op::op(a, v[j + 2]);
      out[j] = a;
    }
  }
}

// The horizontal fold of a rows-path thread: 8 outputs of a row
// deinterleaved by 8 (B1's rows path stores them so), the thread's sample
// m at rb[(m % 8) * nu + m / 8].
template <class Op>
__device__ __forceinline__ void hfold_stage(const float* rb, int nu, int K,
                                            typename Op::T (&v)[8]) {
  run_fold<Op, 8>(K, [&](int m) {
    return Op::from(rb[(m & 7) * nu + (m >> 3)]);
  }, v);
}

// A run of 4 outputs of the Op-fold of windows of K samples along a row,
// sample m of the run at s[m]: where s is 16-byte aligned and K is 3, 5,
// 7 or 9, the samples as aligned float4 chunks into registers (a warp's
// lanes, four columns apart, read them without bank conflicts, where
// scalar loads four words apart conflict 4 ways) and the fold unrolled;
// otherwise by run_fold from shared memory.
template <class Op>
__device__ __forceinline__ void run4(int K, const float* s, bool aligned,
                                     typename Op::T (&v)[4]) {
  auto fixed = [&](auto kc) {
    constexpr int Kc = decltype(kc)::value;
    constexpr int NC = (Kc + 6) / 4;  // chunks of the K + 3 samples
    float w[4 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 f = reinterpret_cast<const float4*>(s)[c];
      w[4 * c] = f.x;
      w[4 * c + 1] = f.y;
      w[4 * c + 2] = f.z;
      w[4 * c + 3] = f.w;
    }
    run_fold<Op, 4>(Kc, [&](int m) { return Op::from(w[m]); }, v);
  };
  switch (aligned ? K : 0) {
    case 3: fixed(std::integral_constant<int, 3>{}); break;
    case 5: fixed(std::integral_constant<int, 5>{}); break;
    case 7: fixed(std::integral_constant<int, 7>{}); break;
    case 9: fixed(std::integral_constant<int, 9>{}); break;
    default:
      run_fold<Op, 4>(K, [&](int m) { return Op::from(s[m]); }, v);
  }
}

// v[0..3] to the 16-byte aligned dst, as float4 stores.
__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(float2* dst, const float2 (&v)[4]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  d[1] = make_float4(v[2].x, v[2].y, v[3].x, v[3].y);
}

// The pair's output from its (min, max) fold: each operation rounded on
// its own (no contraction into an FMA), as the plain version computes it.
template <int KIND>
__device__ __forceinline__ float combine(float2 mm, const float* x,
                                         size_t i) {
  return KIND == kGrad
             ? __fsub_rn(mm.y, mm.x)
             : __fsub_rn(__fadd_rn(mm.y, mm.x), __fmul_rn(2.0f, x[i]));
}

// The two-stage contract (ops/fused_separable.py:
// fused_separable_open_close_ref), OP1 min for an opening, max for a
// closing:
//
//   xe = x extended ONCE by both stages' windows added together;
//   s1 = the OP1 box fold of xe, over x's domain widened by stage 2's
//        window (no re-extension in between);
//   y  = the other op's box fold of s1, back to x's shape.
//
// The pair contract (fused_separable_morph_pair_ref): x extended once;
// the min and max box folds of that one extension give
//   kGrad: max - min;   kLaplace: (max + min) - 2x, x read at the output.

// The rows path, a 2-D array run as (1, n1, n2).  Block (bx): output
// columns [x0, x0 + ow), rows [r0, r0 + t1).  A horizontal pass computes
// 128 columns of 16 rows (thread: row tid / 16, columns 8 (tid % 16) on);
// a vertical pass 8 rows of 128 columns (thread: column tid % 128, rows
// 8 (tid / 128) on).  Shared memory, in words: stage buffers of 16 input
// rows, deinterleaved by 8 as B1's rows path stores them (one for the
// two-stage kernel, two for the pair), then
// - two-stage: ring1 (stage 1's horizontal fold, 16 (lag + 1) rows of
//   128), s1 (16 stage-1 rows, deinterleaved by 8) and ring2 (stage 2's
//   horizontal fold, 16 (lag + 1) rows of 128); ow = 129 - K2 rounded
//   down to a multiple of 4, so that stage 1's 128 columns hold stage 2's
//   halo; three barriers a step;
// - pair: one ring of (min, max) pairs, 16 (lag + 2) rows of 128; one
//   barrier a step.
template <int KIND>
__global__ void __launch_bounds__(kRowThreads, kMorphRowBlocksPerSM<KIND>)
morph_rows_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                      const __grid_constant__ MorphParams p) {
  constexpr bool kTwo = KIND == kOpening || KIND == kClosing;
  using Op1 = typename MorphOps<KIND>::First;
  using Op2 = typename MorphOps<KIND>::Second;
  extern __shared__ __align__(16) float msmem[];
  const int n1 = p.n[1], n2 = p.n[2];
  const int K1 = p.k[1], K2 = p.k[2];
  const int mode1 = p.mode[1], mode2 = p.mode[2];
  const float cval = p.cval;
  const int vec = p.vec;
  const int ow = p.t2;
  const int lead1 = p.lo1[1] + (kTwo ? p.lo2[1] : 0);
  const int lead2 = p.lo1[2] + (kTwo ? p.lo2[2] : 0);
  // units of a stage row: samples up to 3 + 127 + K2 - 1, 2 modulo 4
  const int nu = (((K2 + 130 + 7) >> 3) + 1) / 4 * 4 + 2;
  const int stage_words = kRowStep * 8 * nu;
  const int lag = (K1 - 1 + kRowStep - 1) / kRowStep;  // steps, a stage
  const int tid = threadIdx.x;
  // strips of ow columns (a multiple of 4) from column -a on, a = -lead2
  // modulo 4 (the planner's shift), so that every block's input strip
  // starts on a 16-byte boundary: the horizontal passes' sample offsets
  // are constants
  const int a = p.shift;
  const int tiles2 = (n2 + a + ow - 1) / ow;
  const int x0 = (blockIdx.x % tiles2) * ow - a;
  const int r0 = (blockIdx.x / tiles2) * p.t1;
  const int nrows = min(p.t1, n1 - r0);  // output rows of this block
  const int groups = (nrows + kRowStep - 1) / kRowStep;
  const int steps = groups + (kTwo ? 2 : 1) * lag;
  const int xa = x0 - lead2;  // a multiple of 4
  const int rho = tid >> 4, q = tid & 15;          // horizontal passes
  const int c = tid & (kRowW - 1), half = tid >> 7;  // vertical passes
  const bool col_out = c < ow && x0 + c >= 0 && x0 + c < n2;
  // a vertical run's sample m: the ring row base + m, which wraps only
  // past the run's first 8 rows (base is a multiple of 8, the ring of 16)
  auto ring_at = [&](const auto* ring, int ring_rows, int base, int m) {
    if (m < 8) return ring[(base + m) * kRowW + c];
    int r = base + m;
    if (r >= ring_rows) r -= ring_rows;
    return ring[r * kRowW + c];
  };

  // unit i of a step: input row i / nu, columns 8 (i % nu) .. + 7
  float4 pre[kRowPer][2];
  auto fetch = [&](int t) {
#pragma unroll
    for (int u = 0; u < kRowPer; ++u) {
      const int i = tid + u * kRowThreads;
      if (i >= kRowStep * nu) break;
      const int rr = i / nu, ch = i - rr * nu;
      bool oob = false;
      const int m1 = map_index(r0 - lead1 + kRowStep * t + rr, n1, mode1, oob);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = xa + 8 * ch + 4 * h;
        float4 v = make_float4(cval, cval, cval, cval);
        if (!oob) {
          const float* row = x + (size_t)m1 * n2;
          if (vec && col >= 0 && col + 4 <= n2) {
            v = __ldg(reinterpret_cast<const float4*>(row + col));
          } else {
            float e4[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              bool o = false;
              const int m2 = map_index(col + e, n2, mode2, o);
              e4[e] = o ? cval : __ldg(row + m2);
            }
            v = make_float4(e4[0], e4[1], e4[2], e4[3]);
          }
        }
        pre[u][h] = v;
      }
    }
  };
  auto put = [&](float* stage) {
#pragma unroll
    for (int u = 0; u < kRowPer; ++u) {
      const int i = tid + u * kRowThreads;
      if (i >= kRowStep * nu) break;
      const int rr = i / nu, ch = i - rr * nu;
      float* dst = stage + rr * 8 * nu + ch;
      dst[0] = pre[u][0].x;
      dst[nu] = pre[u][0].y;
      dst[2 * nu] = pre[u][0].z;
      dst[3 * nu] = pre[u][0].w;
      dst[4 * nu] = pre[u][1].x;
      dst[5 * nu] = pre[u][1].y;
      dst[6 * nu] = pre[u][1].z;
      dst[7 * nu] = pre[u][1].w;
    }
  };
  if constexpr (kTwo) {
    const int ring_rows = kRowStep * (lag + 1);
    // units of an s1 row: samples up to 127 + K2 - 1, 2 modulo 4
    const int nu1 = (((K2 + 134) >> 3) + 1) / 4 * 4 + 2;
    float* stage = msmem;
    float* ring1 = stage + stage_words;
    float* s1 = ring1 + ring_rows * kRowW;
    float* ring2 = s1 + kRowStep * 8 * nu1;
    // Barriers: put(t) rewrites the stage buffer after the barrier that
    // follows hfold(t - 1); ring1's rows of step t + 1 are written after
    // the barrier that follows the vertical fold of step t; s1 and ring2
    // alike; the vertical fold of stage 2 reads ring2 one step late, in
    // the interval of stage 1's horizontal fold, which writes ring1 only.
    fetch(0);
    for (int t = 0; t <= steps; ++t) {
      if (t < steps) {
        put(stage);
        if (t + 1 < steps) fetch(t + 1);  // in flight during the passes
      }
      __syncthreads();
      const int g2 = t - 1 - 2 * lag;  // output rows 16 g2 .. + 15
      if (g2 >= 0) {
        const int o = kRowStep * g2 + 8 * half;
        if (o < nrows) {
          const int base = o % ring_rows;
          float v[8];
          run_fold<Op2, 8>(K1, [&](int m) {
            return ring_at(ring2, ring_rows, base, m);
          }, v);
          if (col_out) {
            float* dst = y + (size_t)(r0 + o) * n2 + x0 + c;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (o + j < nrows) dst[(size_t)j * n2] = v[j];
            }
          }
        }
      }
      if (t == steps) break;
      {
        float v[8];
        hfold_stage<Op1>(stage + rho * 8 * nu + q, nu, K2, v);
        float* dst = ring1 + ((kRowStep * t + rho) % ring_rows) * kRowW + 8 * q;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
      const int g1 = t - lag;  // stage-1 rows 16 g1 .. + 15
      if (g1 >= 0) {
        const int base = (kRowStep * g1 + 8 * half) % ring_rows;
        float v[8];
        run_fold<Op1, 8>(K1, [&](int m) {
          return ring_at(ring1, ring_rows, base, m);
        }, v);
        float* dst = s1 + 8 * half * 8 * nu1 + (c & 7) * nu1 + (c >> 3);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j * 8 * nu1] = v[j];
      }
      __syncthreads();
      if (g1 >= 0) {
        float v[8];
        hfold_stage<Op2>(s1 + rho * 8 * nu1 + q, nu1, K2, v);
        float* dst = ring2 + ((kRowStep * g1 + rho) % ring_rows) * kRowW + 8 * q;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  } else {
    // a ring of lag + 2 groups: the horizontal fold of step t writes the
    // group the vertical fold of step t - 1, in the same interval, does
    // not read
    const int ring_rows = kRowStep * (lag + 2);
    float2* ring = reinterpret_cast<float2*>(msmem + 2 * stage_words);
    // Barriers: one a step.  put(t) fills the stage buffer hfold(t - 2)
    // read, before the barrier of step t - 1.
    fetch(0);
    for (int t = 0; t <= steps; ++t) {
      float* stage = msmem + (t & 1) * stage_words;
      if (t < steps) {
        put(stage);
        if (t + 1 < steps) fetch(t + 1);
      }
      __syncthreads();
      const int g = t - 1 - lag;  // output rows 16 g .. + 15
      if (g >= 0) {
        const int o = kRowStep * g + 8 * half;
        if (o < nrows) {
          const int base = o % ring_rows;
          float2 v[8];
          run_fold<MinMaxOp, 8>(K1, [&](int m) {
            return ring_at(ring, ring_rows, base, m);
          }, v);
          if (col_out) {
            const size_t i = (size_t)(r0 + o) * n2 + x0 + c;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (o + j < nrows) {
                y[i + (size_t)j * n2] = combine<KIND>(v[j], x, i + (size_t)j * n2);
              }
            }
          }
        }
      }
      if (t == steps) break;
      float2 v[8];
      hfold_stage<MinMaxOp>(stage + rho * 8 * nu + q, nu, K2, v);
      float2* dst = ring + ((kRowStep * t + rho) % ring_rows) * kRowW + 8 * q;
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(v[j].x, v[j].y, v[j + 1].x, v[j + 1].y);
      }
    }
  }
}

// The planes path, a 3-D array.  Block (bx, by): output planes
// [z0, z0 + z) of axis 0 over the tile [o1, o1 + T1) x [o2, o2 + 64),
// marching along axis 0 over the input planes the block's outputs need.
// Per input plane: the input tile, halo'd by both stages' windows
// (H1 x H2), arrives by 16-byte cp.async; the axis-2 fold of stage 1 (of
// the pair: both folds) over the tile's rows, in runs of 4 columns a
// thread (run_fold), goes to s_a (H1 x W2); the axis-1 fold of s_a's
// columns, in runs of 4 rows a thread, goes into the stage's axis-0
// window, and once the window holds K0 planes its fold is one stage-1
// plane (W1 x W2, still halo'd by stage 2's window) in s_p; the pair
// combines it into an output plane.  Stage 2 folds s_p alike: axis 2 in
// runs of 4 columns into s_b (W1 x 64), axis 1 in runs of 4 rows into
// its axis-0 window, whose fold is an output plane.  KZ: the axis-0 window in registers (K0 == KZ: 1, 3 or
// 5; the plane loop unrolled by KZ, so that every window index is a
// constant), or 0: rings of K0 planes in shared memory.
template <int KIND, int KZ>
__global__ void __launch_bounds__(kBX * kBY, kMorphBlocksPerSM<KIND>)
morph_planes_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                        const __grid_constant__ MorphParams p) {
  constexpr bool kTwo = KIND == kOpening || KIND == kClosing;
  using Op1 = typename MorphOps<KIND>::First;
  using Op2 = typename MorphOps<KIND>::Second;
  using T = typename Op1::T;
  constexpr int kThreads = kBX * kBY;
  constexpr int L = kMorphL;
  constexpr int NI = kTwo ? kMorphItems : 1;  // stage-1 items in registers
  constexpr int KW = KZ > 0 ? KZ : 1;
  extern __shared__ __align__(16) float smem[];
  const int n0 = p.n[0], n1 = p.n[1], n2 = p.n[2];
  const int K0 = p.k[0], K1 = p.k[1], K2 = p.k[2];
  const int T1 = p.t1;
  const int stages = p.stages;
  // stage 1's plane (the pair's output tile): W1 x W2, in rows of W2P
  // words, whole runs of L; the input tile
  const int W1 = kTwo ? T1 + K1 - 1 : T1, W2 = kTwo ? kT2 + K2 - 1 : kT2;
  const int runs2 = (W2 + L - 1) / L, W2P = L * runs2;
  const int H1 = W1 + K1 - 1, H2 = W2 + K2 - 1;
  const int nch = (H2 + 6) >> 2, H2P = 4 * nch;
  const int lead0 = p.lo1[0] + (kTwo ? p.lo2[0] : 0);
  const int lead1 = p.lo1[1] + (kTwo ? p.lo2[1] : 0);
  const int lead2 = p.lo1[2] + (kTwo ? p.lo2[2] : 0);
  int* row_map = reinterpret_cast<int*>(smem);  // H1
  int* col_map = row_map + H1;                  // H2
  float* s_in = smem + (H1 + H2 + 3) / 4 * 4;   // stages tiles, H1 x H2P
  // after axis 2: H1 rows, and L rows that runs past the end may read
  T* s_a = reinterpret_cast<T*>(s_in + stages * H1 * H2P);
  float* s_p = reinterpret_cast<float*>(s_a + (H1 + L) * W2P);  // W1 x W2P
  float* s_b = s_p + W1 * W2P;                 // (W1 + L) x kT2
  T* ring1 = kTwo ? reinterpret_cast<T*>(s_b + (W1 + L) * kT2)
                  : reinterpret_cast<T*>(s_p);  // K0 planes, W1 x W2
  float* ring2 = reinterpret_cast<float*>(ring1 + K0 * W1 * W2);  // K0 x T1 x kT2

  // tiles of kT2 columns from column -a on; where the planner can (a =
  // -lead2 modulo 4 adds no tile), every input tile starts on a 16-byte
  // boundary and a run's samples are whole float4 chunks (run4)
  const int a = p.shift;
  const int tiles2 = (n2 + a + kT2 - 1) / kT2;
  const int o1 = (blockIdx.x / tiles2) * T1;
  const int o2 = (blockIdx.x % tiles2) * kT2 - a;
  const int z0 = blockIdx.y * p.z;
  const int z1 = min(z0 + p.z, n0);
  const int nplanes = z1 - z0 + (kTwo ? 2 : 1) * (K0 - 1);
  const int xs = o2 - lead2;
  const int sh = xs - floor4(xs);  // 0 where the planner shifted the tiles
  const int tid = threadIdx.y * kBX + threadIdx.x;
  build_maps(row_map, H1, o1 - lead1, n1, p.mode[1], H2, xs, n2, p.mode[2]);
  __syncthreads();

  auto issue = [&](int e) {
    if (e < nplanes) {
      load_plane16(x, s_in + (e % stages) * H1 * H2P, z0 - lead0 + e, n0,
                   p.mode[0], n1, n2, row_map, col_map, H1, H2, nch, xs,
                   p.vec, p.cval);
    }
    __pipeline_commit();
  };
  // every thread's copies of plane e + 1 done (one commit group a plane,
  // empty past the last plane, so that a fixed depth works)
  auto wait_next = [&]() {
    if (stages == 4) {
      __pipeline_wait_prior(3);
    } else if (stages == 2) {
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
  };
  // the axis-2 fold of stage 1 (the pair: both) over the tile's rows, a
  // run of L columns a thread (run4; the run past W2 is discarded)
  auto axis2_first = [&](const float* tile) {
    const int dr = kThreads / runs2, dq = kThreads - dr * runs2;
    int r = tid / runs2, q = tid - r * runs2;
    for (int i = tid; i < H1 * runs2; i += kThreads) {
      T v[L];
      run4<Op1>(K2, tile + r * H2P + sh + L * q, sh == 0, v);
      store4(s_a + r * W2P + L * q, v);
      q += dq;
      r += dr;
      if (q >= runs2) {
        q -= runs2;
        ++r;
      }
    }
  };
  // the axis-1 fold of a run of L rows of s_a's column cc
  auto axis1_first = [&](int run, int cc, T (&v)[L]) {
    const T* s = s_a + run * L * W2P + cc;
    run_fold<Op1, L>(K1, [&](int m) { return s[m * W2P]; }, v);
  };
  // stage 2's axis-2 fold over s_p's rows, into s_b, a run of L columns
  // a thread
  auto axis2_second = [&]() {
    constexpr int kRuns = kT2 / L;
    for (int i = tid; i < W1 * kRuns; i += kThreads) {
      const int r = i / kRuns, q = i % kRuns;
      float v[L];
      run4<Op2>(K2, s_p + r * W2P + L * q, true, v);
      store4(s_b + r * kT2 + L * q, v);
    }
  };
  // an output cell (row r, column cc of the tile, output plane zo) from
  // its stage-2 (pair: (min, max)) value
  auto emit = [&](int zo, int r, int cc, auto v) {
    if (r < T1 && o1 + r < n1 && o2 + cc >= 0 && o2 + cc < n2) {
      const size_t i = ((size_t)zo * n1 + o1 + r) * n2 + o2 + cc;
      if constexpr (std::is_same<decltype(v), float>::value) {
        y[i] = v;  // stage 2's value
      } else {
        y[i] = combine<KIND>(v, x, i);  // the pair's (min, max)
      }
    }
  };

  // the thread's runs: stage 1's (of the pair: its only stage) and, for
  // the two-stage kernel, stage 2's, each (run of L rows, column)
  const int runs1 = (W1 + L - 1) / L, items1 = runs1 * W2;
  const int run2 = tid / kT2, col2 = tid % kT2;
  const bool live2 = kTwo && run2 * L < T1;  // T1 <= 16: one item a thread

  for (int e = 0; e < stages; ++e) issue(e);
  wait_next();
  __syncthreads();

  if constexpr (KZ > 0) {
    int run1[NI], col1[NI];
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      const int item = tid + it * kThreads;
      run1[it] = item < items1 ? item / W2 : runs1;  // runs1: no item
      col1[it] = item - run1[it] * W2;
    }
    T hist1[NI][KW][L];
    float hist2[KW][L];
    // plane e's values in slot e % KZ of each window: the newest
    // overwrites the oldest, and a full window is all KZ slots
    for (int e0 = 0; e0 < nplanes; e0 += KZ) {
#pragma unroll
      for (int u = 0; u < KZ; ++u) {
        const int e = e0 + u;
        if (e >= nplanes) break;  // the same for every thread
        axis2_first(s_in + (e % stages) * H1 * H2P);
        __syncthreads();
        issue(e + stages);  // into the buffer axis2_first just read
        const int p1 = e - (K0 - 1);  // stage-1 plane, once its window is full
#pragma unroll
        for (int it = 0; it < NI; ++it) {
          if (run1[it] >= runs1) continue;
          axis1_first(run1[it], col1[it], hist1[it][u]);
          if (p1 < 0) continue;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            T v = hist1[it][0][l];
#pragma unroll
            for (int k = 1; k < KZ; ++k) v = Op1::op(v, hist1[it][k][l]);
            const int r = run1[it] * L + l;
            if constexpr (kTwo) {
              if (r < W1) s_p[r * W2P + col1[it]] = v;
            } else {
              emit(z0 + p1, r, col1[it], v);
            }
          }
        }
        if constexpr (!kTwo) {
          wait_next();
          __syncthreads();
          continue;
        }
        if (p1 >= 0) {
          __syncthreads();
          axis2_second();
        }
        wait_next();
        __syncthreads();
        if (p1 < 0 || !live2) continue;
        {
          float v[L];
          run_fold<Op2, L>(K1, [&](int m) {
            return s_b[(run2 * L + m) * kT2 + col2];
          }, v);
#pragma unroll
          for (int l = 0; l < L; ++l) hist2[u][l] = v[l];
        }
        const int q = p1 - (K0 - 1);  // output plane, once its window is full
        if (q < 0) continue;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          float v = hist2[0][l];
#pragma unroll
          for (int k = 1; k < KZ; ++k) v = Op2::op(v, hist2[k][l]);
          emit(z0 + q, run2 * L + l, col2, v);
        }
      }
    }
  } else {
    // rings of K0 planes: plane e's values in slot e % K0; a thread reads
    // only the cells it writes, so the rings need no barrier
    for (int e = 0; e < nplanes; ++e) {
      axis2_first(s_in + (e % stages) * H1 * H2P);
      __syncthreads();
      issue(e + stages);
      const int p1 = e - (K0 - 1);
      T* slot1 = ring1 + (e % K0) * W1 * W2;
      for (int item = tid; item < items1; item += kThreads) {
        const int run = item / W2, cc = item - run * W2;
        T v[L];
        axis1_first(run, cc, v);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const int r = run * L + l;
          if (r >= W1) break;
          slot1[r * W2 + cc] = v[l];
          if (p1 < 0) continue;
          T w = ring1[r * W2 + cc];
          for (int k = 1; k < K0; ++k) {
            w = Op1::op(w, ring1[(k * W1 + r) * W2 + cc]);
          }
          if constexpr (kTwo) {
            s_p[r * W2P + cc] = w;
          } else {
            emit(z0 + p1, r, cc, w);
          }
        }
      }
      if constexpr (!kTwo) {
        wait_next();
        __syncthreads();
        continue;
      }
      if (p1 >= 0) {
        __syncthreads();
        axis2_second();
      }
      wait_next();
      __syncthreads();
      if (p1 < 0 || !live2) continue;
      const int q = p1 - (K0 - 1);
      float v[L];
      run_fold<Op2, L>(K1, [&](int m) {
        return s_b[(run2 * L + m) * kT2 + col2];
      }, v);
      float* slot2 = ring2 + (p1 % K0) * T1 * kT2;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int r = run2 * L + l;
        if (r >= T1) break;
        slot2[r * kT2 + col2] = v[l];
        if (q < 0) continue;
        float w = ring2[r * kT2 + col2];
        for (int k = 1; k < K0; ++k) {
          w = Op2::op(w, ring2[(k * T1 + r) * kT2 + col2]);
        }
        emit(z0 + q, r, col2, w);
      }
    }
  }
}

template <class Kernel>
int start(Kernel kernel, dim3 grid, dim3 block, int smem, void* stream,
          const float* x, float* y, const MorphParams& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(x, y, p);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_morph(const float* x, float* y, const MorphParams& p,
                 const int* plan, void* stream) {
  const dim3 grid(plan[2], plan[3]);
  const int smem = plan[4];
  if (plan[5]) {
    return start(morph_rows_f32_kernel<KIND>, grid, dim3(kRowThreads), smem,
                 stream, x, y, p);
  }
  const dim3 block(kBX, kBY);
  switch (plan[8]) {
    case 1:
      return start(morph_planes_f32_kernel<KIND, 1>, grid, block, smem,
                   stream, x, y, p);
    case 3:
      return start(morph_planes_f32_kernel<KIND, 3>, grid, block, smem,
                   stream, x, y, p);
    case 5:
      return start(morph_planes_f32_kernel<KIND, 5>, grid, block, smem,
                   stream, x, y, p);
    default:
      return start(morph_planes_f32_kernel<KIND, 0>, grid, block, smem,
                   stream, x, y, p);
  }
}

}  // namespace

// dims: n0, n1, n2.  taps: 3 x 64 floats (unused by min/max).
// axis_info: 3 x (ntaps, lo, mode, kind).  plan: t1, z, grid_x, grid_y,
// shared bytes, path (0 planes, 1 rows), vec (rows may be read in
// 16-byte chunks).  op: 0 correlate, 1 minimum, 2 maximum.
// Returns the cudaError_t of the attribute call or of the launch.
extern "C" int fused_separable_f32(const float* x, float* y, const int* dims,
                                   const float* taps, const int* axis_info,
                                   float cval, const int* plan, int op,
                                   void* stream) {
  Params p;
  for (int a = 0; a < 3; ++a) {
    Axis& ax = p.ax[a];
    for (int k = 0; k < kMaxTaps; ++k) ax.taps[k] = taps[a * kMaxTaps + k];
    ax.n = dims[a];
    ax.ntaps = axis_info[4 * a + 0];
    ax.lo = axis_info[4 * a + 1];
    ax.mode = axis_info[4 * a + 2];
    ax.kind = axis_info[4 * a + 3];
  }
  p.cval = cval;
  p.t1 = plan[0];
  p.z = plan[1];
  p.vec = plan[6];
  switch (op) {
    case kCorr: return launch<kCorr>(x, y, p, plan, stream);
    case kMin: return launch<kMin>(x, y, p, plan, stream);
    case kMax: return launch<kMax>(x, y, p, plan, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dims: n0, n1, n2.  axis_info: 3 x (window, lead of stage 1, lead of
// stage 2, mode).  plan: t1, z, grid_x, grid_y, shared bytes, path (0
// planes, 1 rows), vec (rows may be read in 16-byte chunks), stages,
// register window (1, 3 or 5; 0: rings), t2, shift.  kind: 0 opening, 1
// closing, 2 gradient, 3 laplace.  Returns the cudaError_t of the
// attribute call or of the launch.
extern "C" int fused_separable_morph_f32(const float* x, float* y,
                                         const int* dims,
                                         const int* axis_info, float cval,
                                         const int* plan, int kind,
                                         void* stream) {
  MorphParams p;
  for (int a = 0; a < 3; ++a) {
    p.n[a] = dims[a];
    p.k[a] = axis_info[4 * a + 0];
    p.lo1[a] = axis_info[4 * a + 1];
    p.lo2[a] = axis_info[4 * a + 2];
    p.mode[a] = axis_info[4 * a + 3];
  }
  p.cval = cval;
  p.t1 = plan[0];
  p.z = plan[1];
  p.vec = plan[6];
  p.stages = plan[7];
  p.t2 = plan[9];
  p.shift = plan[10];
  switch (kind) {
    case kOpening: return launch_morph<kOpening>(x, y, p, plan, stream);
    case kClosing: return launch_morph<kClosing>(x, y, p, plan, stream);
    case kGrad: return launch_morph<kGrad>(x, y, p, plan, stream);
    case kLaplace: return launch_morph<kLaplace>(x, y, p, plan, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
