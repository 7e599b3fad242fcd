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

#include "boundary.cuh"

namespace {

constexpr int kMaxTaps = 64;
constexpr int kBX = 32;  // threads along axis 2 (contiguous)
constexpr int kBY = 8;   // threads along axis 1
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

// The 16-byte chunks of a halo'd tile row: the row starts at column
// xa = xs rounded down to a multiple of 4 (xs: the first column the tile
// needs), so sample c of the tile (c >= 0 from xs) is at xs - xa + c.
__device__ __forceinline__ int floor4(int v) {
  return v >= 0 ? (v & ~3) : -((3 - v) & ~3);
}

// The source row and column of every row and column of a halo'd tile:
// row_map[i] for the h1 rows from r0 on, then (at row_map + h1) the h2
// columns from c0 on; -1 where the mode gives cval.  The same for every
// plane, so mapped once per block (mapped per sample, the modulo
// arithmetic cost more than the filter).
__device__ __forceinline__ void build_maps(int* row_map, int h1, int r0,
                                           int n1, int mode1, int h2, int c0,
                                           int n2, int mode2) {
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < h1 + h2; i += kBX * kBY) {
    bool oob = false;
    const int m = i < h1 ? map_index(r0 + i, n1, mode1, oob)
                         : map_index(c0 + i - h1, n2, mode2, oob);
    row_map[i] = oob ? -1 : m;
  }
}

// Start the copies of the halo'd tile of input plane i0 (an axis-0
// index, mapped here by mode0) into buf (h1 x h2): every in-range sample
// as an asynchronous 4-byte cp.async, every cval sample as a plain
// store.  The caller commits the group.
__device__ __forceinline__ void load_plane(const float* __restrict__ x,
                                           float* buf, int i0, int n0,
                                           int mode0, int n1, int n2,
                                           const int* row_map,
                                           const int* col_map, int h1,
                                           int h2, float cval) {
  bool oob0 = false;
  const int m0 = map_index(i0, n0, mode0, oob0);
  const float* plane = x + (size_t)m0 * n1 * n2;
  for (int r = threadIdx.y; r < h1; r += kBY) {
    const int m1 = oob0 ? -1 : row_map[r];
    const float* row = plane + (size_t)max(m1, 0) * n2;
    for (int c = threadIdx.x; c < h2; c += kBX) {
      const int m2 = col_map[c];
      if (m1 < 0 || m2 < 0) {
        buf[r * h2 + c] = cval;
      } else {
        __pipeline_memcpy_async(buf + r * h2 + c, row + m2, sizeof(float));
      }
    }
  }
}

// Start the copies of the halo'd tile of input plane i0 (an axis-0
// index, mapped here by mode0) into buf (h1 rows of 4 * nch words, row r
// from column xa = floor4(xs) on, xs the tile's first column): a 16-byte
// chunk inside the row as one cp.async where rows may be read so, every
// other sample through the column map (col_map[c] for column xs + c, -1
// for cval) as a 4-byte cp.async or a cval store.  Samples left of xs or
// right of the tile's h2 columns are never read (set to 0).  The caller
// commits the group.
__device__ __forceinline__ void load_plane16(
    const float* __restrict__ x, float* buf, int i0, int n0, int mode0,
    int n1, int n2, const int* row_map, const int* col_map, int h1, int h2,
    int nch, int xs, int vec, float cval) {
  bool oob0 = false;
  const int m0 = map_index(i0, n0, mode0, oob0);
  const float* plane = x + (size_t)m0 * n1 * n2;
  const int xa = floor4(xs);
  for (int i = threadIdx.y * kBX + threadIdx.x; i < h1 * nch;
       i += kBX * kBY) {
    const int r = i / nch, ch = i - r * nch;
    const int m1 = oob0 ? -1 : row_map[r];
    float* dst = buf + r * 4 * nch + 4 * ch;
    if (m1 < 0) {
      dst[0] = cval;
      dst[1] = cval;
      dst[2] = cval;
      dst[3] = cval;
      continue;
    }
    const float* row = plane + (size_t)m1 * n2;
    const int c = xa + 4 * ch;
    if (vec && c >= 0 && c + 4 <= n2) {
      __pipeline_memcpy_async(dst, row + c, 16);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = c + e - xs;
      const int m2 = t >= 0 && t < h2 ? col_map[t] : -2;
      if (m2 >= 0) {
        __pipeline_memcpy_async(dst + e, row + m2, sizeof(float));
      } else {
        dst[e] = m2 == -1 ? cval : 0.f;
      }
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
// two passes over device memory (three for the pair), each stage's or
// fold's intermediates kept in shared memory.  Simple first: two planes
// in flight (the doubly halo'd two-stage tile needs the room); the
// two-stage kernel computes two columns per thread and step, the pair
// kernel one; PERF.md has the times.
// ---------------------------------------------------------------------------

// input planes in flight per block in the morphology kernels
// (ops/fused_separable.py:MORPH_STAGES): two, so that the two-stage
// kernel's doubly halo'd tile leaves room for wider windows
constexpr int kMorphStages = 2;

// the kernels' kinds, as ops/fused_separable.py:_MORPH_KINDS assigns them
constexpr int kOpening = 0;  // min, then max
constexpr int kClosing = 1;  // max, then min
constexpr int kGrad = 2;     // max - min
constexpr int kLaplace = 3;  // max + min - 2x

struct MorphParams {
  int n[3];
  int k[3];    // window per axis (1: axis skipped), the same in both stages
  int lo1[3];  // window leads of stage 1 (and of the pair's folds)
  int lo2[3];  // window leads of stage 2
  int mode[3];
  float cval;
  int t1;  // output tile rows along axis 1 (the tile is kT2 wide)
  int z;   // output planes of axis 0 per block
};

template <int OP>
__device__ __forceinline__ float extremum(float a, float b) {
  return OP == kMin ? min_nan(a, b) : max_nan(a, b);
}

// dst[r * ldd + c] = the OP-fold of src[r * lds + c + k * step] over
// k in [0, K), for r < rows and c < cols.  A thread computes columns c
// and c + 32 of a row per step (where c + 32 is past the end it computes
// column c twice and stores it once), owning the same cells on every
// call.
template <int OP>
__device__ __forceinline__ void fold_plane(const float* src, int lds,
                                           int step, int K, float* dst,
                                           int ldd, int rows, int cols) {
  for (int r = threadIdx.y; r < rows; r += kBY) {
    for (int c = threadIdx.x; c < cols; c += 2 * kBX) {
      const int d = c + kBX < cols ? kBX : 0;
      const float* s = src + r * lds + c;
      float v0 = s[0], v1 = s[d];
#pragma unroll 4
      for (int k = 1; k < K; ++k) {
        v0 = extremum<OP>(v0, s[k * step]);
        v1 = extremum<OP>(v1, s[k * step + d]);
      }
      dst[r * ldd + c] = v0;
      if (d) dst[r * ldd + c + d] = v1;
    }
  }
}

// The OP-fold of a ring of K planes (each `plane` floats apart) at cell
// `at`, from slot `first` on.
template <int OP>
__device__ __forceinline__ float fold_ring(const float* ring, int plane,
                                           int at, int K, int first) {
  float v = ring[first * plane + at];
  for (int k = 1; k < K; ++k) {
    int s = first + k;
    if (s >= K) s -= K;
    v = extremum<OP>(v, ring[s * plane + at]);
  }
  return v;
}

// fold_ring at cells `at` and `at + d` at once.
template <int OP>
__device__ __forceinline__ void fold_ring2(const float* ring, int plane,
                                           int at, int d, int K, int first,
                                           float& v0, float& v1) {
  const float* p = ring + first * plane + at;
  v0 = p[0];
  v1 = p[d];
#pragma unroll 4
  for (int k = 1; k < K; ++k) {
    int s = first + k;
    if (s >= K) s -= K;
    p = ring + s * plane + at;
    v0 = extremum<OP>(v0, p[0]);
    v1 = extremum<OP>(v1, p[d]);
  }
}

// Two-stage opening (OP1 = kMin) or closing (OP1 = kMax), the contract of
// ops/fused_separable.py:fused_separable_open_close_ref:
//
//   xe = x extended ONCE by both stages' windows added together;
//   s1 = the OP1 box fold of xe, over x's domain widened by stage 2's
//        window (no re-extension in between);
//   y  = the other op's box fold of s1, back to x's shape.
//
// The block marches along axis 0 as the separable kernel does.  Its input
// tile is halo'd by both windows, (T1 + 2(K1-1)) x (64 + 2(K2-1)); stage 1
// folds axes 2 and 1 of each plane over the whole tile into a ring of K0
// planes, and once the ring is full its axis-0 fold gives one stage-1
// plane of (T1 + K1-1) x (64 + K2-1), still halo'd by stage 2's window.
// Stage 2 folds axes 2 and 1 of that plane into a second ring of K0
// planes, whose axis-0 fold gives one output plane.
template <int OP1>
__global__ void __launch_bounds__(kBX * kBY)
open_close_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                      const __grid_constant__ MorphParams p) {
  constexpr int OP2 = OP1 == kMin ? kMax : kMin;
  extern __shared__ float smem[];
  const int n0 = p.n[0], n1 = p.n[1], n2 = p.n[2];
  const int K0 = p.k[0], K1 = p.k[1], K2 = p.k[2];
  const int T1 = p.t1;
  const int W1 = T1 + K1 - 1, W2 = kT2 + K2 - 1;  // a stage-1 plane
  const int H1 = W1 + K1 - 1, H2 = W2 + K2 - 1;   // an input tile
  int* row_map = reinterpret_cast<int*>(smem);     // H1
  int* col_map = row_map + H1;                     // H2
  float* s_in = reinterpret_cast<float*>(col_map + H2);  // kMorphStages tiles
  float* s_mid = s_in + kMorphStages * H1 * H2;  // H1 x W2, after axis 2
  float* ring1 = s_mid + H1 * W2;                // K0 planes of W1 x W2
  float* s_p = ring1 + K0 * W1 * W2;             // W1 x W2, stage 1's plane
  float* s_mid2 = s_p + W1 * W2;                 // W1 x kT2, after axis 2
  float* ring2 = s_mid2 + W1 * kT2;              // K0 planes of T1 x kT2

  const int tiles2 = (n2 + kT2 - 1) / kT2;
  const int o1 = (blockIdx.x / tiles2) * T1;
  const int o2 = (blockIdx.x % tiles2) * kT2;
  const int z0 = blockIdx.y * p.z;
  const int z1 = min(z0 + p.z, n0);
  const int nplanes = z1 - z0 + 2 * (K0 - 1);
  const int lead0 = p.lo1[0] + p.lo2[0];
  build_maps(row_map, H1, o1 - p.lo1[1] - p.lo2[1], n1, p.mode[1], H2,
             o2 - p.lo1[2] - p.lo2[2], n2, p.mode[2]);
  __syncthreads();

  auto issue = [&](int e) {
    if (e < nplanes) {
      load_plane(x, s_in + (e % kMorphStages) * H1 * H2, z0 - lead0 + e, n0,
                 p.mode[0], n1, n2, row_map, col_map, H1, H2, p.cval);
    }
    __pipeline_commit();
  };

  // Barriers: the stage buffer plane e + 1 goes to was last read by the
  // axis-2 fold of plane e - 1, which a barrier follows; each of s_mid,
  // s_p and s_mid2 is written only after the barrier that follows its
  // readers of the plane before.  A thread reads only its own ring cells.
  for (int e = 0; e < kMorphStages - 1; ++e) issue(e);
  for (int e = 0; e < nplanes; ++e) {
    issue(e + kMorphStages - 1);
    __pipeline_wait_prior(kMorphStages - 1);
    __syncthreads();
    fold_plane<OP1>(s_in + (e % kMorphStages) * H1 * H2, H2, 1, K2, s_mid,
                    W2, H1, W2);
    __syncthreads();
    const int p1 = e - (K0 - 1);  // stage-1 plane, once the ring is full
    const int slot = e % K0, first = (e + 1) % K0;
    // columns c and c + 32 per thread and step, as fold_plane
    for (int r = threadIdx.y; r < W1; r += kBY) {
      for (int c = threadIdx.x; c < W2; c += 2 * kBX) {
        const int d = c + kBX < W2 ? kBX : 0;
        const float* s = s_mid + r * W2 + c;
        float v0 = s[0], v1 = s[d];
#pragma unroll 4
        for (int k = 1; k < K1; ++k) {
          v0 = extremum<OP1>(v0, s[k * W2]);
          v1 = extremum<OP1>(v1, s[k * W2 + d]);
        }
        const int at = r * W2 + c;
        ring1[slot * W1 * W2 + at] = v0;
        if (d) ring1[slot * W1 * W2 + at + d] = v1;
        if (p1 >= 0) {
          fold_ring2<OP1>(ring1, W1 * W2, at, d, K0, first, v0, v1);
          s_p[at] = v0;
          if (d) s_p[at + d] = v1;
        }
      }
    }
    if (p1 < 0) continue;  // the same for every thread of the block
    __syncthreads();
    fold_plane<OP2>(s_p, W2, 1, K2, s_mid2, kT2, W1, kT2);
    __syncthreads();
    const int zo = z0 + p1 - (K0 - 1);
    const int slot2 = p1 % K0, first2 = (p1 + 1) % K0;
    // every row of kT2 = 2 * kBX columns: both columns always exist
    for (int r = threadIdx.y; r < T1; r += kBY) {
      const int c = threadIdx.x, at = r * kT2 + c;
      const float* s = s_mid2 + at;
      float v0 = s[0], v1 = s[kBX];
#pragma unroll 4
      for (int k = 1; k < K1; ++k) {
        v0 = extremum<OP2>(v0, s[k * kT2]);
        v1 = extremum<OP2>(v1, s[k * kT2 + kBX]);
      }
      ring2[slot2 * T1 * kT2 + at] = v0;
      ring2[slot2 * T1 * kT2 + at + kBX] = v1;
      if (zo >= z0 && o1 + r < n1) {
        fold_ring2<OP2>(ring2, T1 * kT2, at, kBX, K0, first2, v0, v1);
        float* dst = y + ((size_t)zo * n1 + o1 + r) * n2 + o2 + c;
        if (o2 + c < n2) dst[0] = v0;
        if (o2 + c + kBX < n2) dst[kBX] = v1;
      }
    }
  }
}

// Pair fold, the contract of
// ops/fused_separable.py:fused_separable_morph_pair_ref: x is extended
// once; the min and max box folds of that one extension, side by side
// (two accumulators per output, a ring of (min, max) planes), give
//   kGrad:    max - min
//   kLaplace: (max + min) - 2x, x read from device memory at the output,
// each operation rounded on its own (no contraction into an FMA), as the
// plain version computes it.
template <int KIND>
__global__ void __launch_bounds__(kBX * kBY)
morph_pair_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                      const __grid_constant__ MorphParams p) {
  extern __shared__ float smem[];
  const int n0 = p.n[0], n1 = p.n[1], n2 = p.n[2];
  const int K0 = p.k[0], K1 = p.k[1], K2 = p.k[2];
  const int T1 = p.t1, TT = T1 * kT2;
  const int H1 = T1 + K1 - 1, H2 = kT2 + K2 - 1;
  int* row_map = reinterpret_cast<int*>(smem);     // H1
  int* col_map = row_map + H1;                     // H2
  float* s_in = reinterpret_cast<float*>(col_map + H2);  // kMorphStages tiles
  float* s_mn = s_in + kMorphStages * H1 * H2;  // H1 x kT2, after axis 2
  float* s_mx = s_mn + H1 * kT2;
  float* ring_mn = s_mx + H1 * kT2;  // K0 planes of T1 x kT2
  float* ring_mx = ring_mn + K0 * TT;

  const int tiles2 = (n2 + kT2 - 1) / kT2;
  const int o1 = (blockIdx.x / tiles2) * T1;
  const int o2 = (blockIdx.x % tiles2) * kT2;
  const int z0 = blockIdx.y * p.z;
  const int z1 = min(z0 + p.z, n0);
  const int nplanes = z1 - z0 + K0 - 1;
  build_maps(row_map, H1, o1 - p.lo1[1], n1, p.mode[1], H2, o2 - p.lo1[2],
             n2, p.mode[2]);
  __syncthreads();

  auto issue = [&](int e) {
    if (e < nplanes) {
      load_plane(x, s_in + (e % kMorphStages) * H1 * H2, z0 - p.lo1[0] + e,
                 n0, p.mode[0], n1, n2, row_map, col_map, H1, H2, p.cval);
    }
    __pipeline_commit();
  };

  for (int e = 0; e < kMorphStages - 1; ++e) issue(e);
  for (int e = 0; e < nplanes; ++e) {
    issue(e + kMorphStages - 1);
    __pipeline_wait_prior(kMorphStages - 1);
    __syncthreads();
    const float* tile = s_in + (e % kMorphStages) * H1 * H2;
    for (int r = threadIdx.y; r < H1; r += kBY) {
      for (int c = threadIdx.x; c < kT2; c += kBX) {
        const float* s = tile + r * H2 + c;
        float mn = s[0], mx = s[0];
        for (int k = 1; k < K2; ++k) {
          mn = min_nan(mn, s[k]);
          mx = max_nan(mx, s[k]);
        }
        s_mn[r * kT2 + c] = mn;
        s_mx[r * kT2 + c] = mx;
      }
    }
    __syncthreads();
    const int slot = e % K0, first = (e + 1) % K0;
    const int zo = z0 + e - (K0 - 1);
    for (int r = threadIdx.y; r < T1; r += kBY) {
      for (int c = threadIdx.x; c < kT2; c += kBX) {
        const int at = r * kT2 + c;
        float mn = s_mn[at], mx = s_mx[at];
        for (int k = 1; k < K1; ++k) {
          mn = min_nan(mn, s_mn[at + k * kT2]);
          mx = max_nan(mx, s_mx[at + k * kT2]);
        }
        ring_mn[slot * TT + at] = mn;
        ring_mx[slot * TT + at] = mx;
        if (zo >= z0 && o1 + r < n1 && o2 + c < n2) {
          mn = fold_ring<kMin>(ring_mn, TT, at, K0, first);
          mx = fold_ring<kMax>(ring_mx, TT, at, K0, first);
          const size_t i = ((size_t)zo * n1 + o1 + r) * n2 + o2 + c;
          y[i] = KIND == kGrad
                     ? __fsub_rn(mx, mn)
                     : __fsub_rn(__fadd_rn(mx, mn), __fmul_rn(2.0f, x[i]));
        }
      }
    }
  }
}

template <class Kernel>
int launch_morph(Kernel kernel, const float* x, float* y,
                 const MorphParams& p, const int* plan, void* stream) {
  const dim3 grid(plan[2], plan[3]);
  const int smem = plan[4];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, dim3(kBX, kBY), smem, (cudaStream_t)stream>>>(x, y, p);
  return (int)cudaGetLastError();
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
// stage 2, mode).  plan: t1, z, grid_x, grid_y, shared bytes.  kind: 0
// opening, 1 closing, 2 gradient, 3 laplace.  Returns the cudaError_t of
// the attribute call or of the launch.
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
  switch (kind) {
    case kOpening:
      return launch_morph(open_close_f32_kernel<kMin>, x, y, p, plan, stream);
    case kClosing:
      return launch_morph(open_close_f32_kernel<kMax>, x, y, p, plan, stream);
    case kGrad:
      return launch_morph(morph_pair_f32_kernel<kGrad>, x, y, p, plan,
                          stream);
    case kLaplace:
      return launch_morph(morph_pair_f32_kernel<kLaplace>, x, y, p, plan,
                          stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
