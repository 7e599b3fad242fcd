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
// boundary mode is applied in the load, so the volume moves as one read
// (plus halo re-reads, mostly from L2) and one write.  Each block owns a
// (T1 x 64) column of output tiles across Z planes of axis 0 and marches
// along axis 0: for each input plane it loads the halo'd (T1+K1-1) x
// (64+K2-1) tile into shared memory, runs the axis-2 and axis-1 passes
// there, and keeps the filtered plane in a ring of K0 planes; once the
// ring holds K0 planes, the axis-0 pass over the ring gives one output
// plane.  So only a 2-D halo is ever resident, which is what lets 64-tap
// halos on all three axes fit in 227 KB.  The tiles of the next three
// planes are in flight (cp.async into a ring of 4 buffers) while the
// current one is filtered.  Taps, window leads, modes and tile sizes are
// runtime arguments: one build serves every call.
//
// What bounds it today is the work per plane step, not bytes: on an H100
// a pass through the kernel with no taps at all (chip_smoke.py's "no
// taps" case) takes about 2.7x torch's copy_ of the same volume.  So each
// thread computes four outputs per call (two rows by two columns,
// sharing tap loads and loop overhead) and the row and column index maps
// are built once per block.  Cheaper loads (16-byte copies, fewer
// per-sample branches) and unrolled small-tap paths are the next steps;
// PERF.md has the numbers.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
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
  int t1;  // output tile rows along axis 1 (the tile is kT2 wide)
  int z;   // output planes of axis 0 per block
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

template <int OP>
__global__ void __launch_bounds__(kBX * kBY)
fused_separable_f32_kernel(const float* __restrict__ x,
                           float* __restrict__ y,
                           const __grid_constant__ Params p) {
  extern __shared__ float smem[];
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
  // taps in shared memory: a uniform shared load is a broadcast
  float* w0 = smem;                 // 3 x kMaxTaps taps
  float* w1 = w0 + kMaxTaps;
  float* w2 = w1 + kMaxTaps;
  // the tile's index maps (build_maps)
  int* row_map = reinterpret_cast<int*>(w0 + 3 * kMaxTaps);  // H1
  int* col_map = row_map + H1;                                 // H2
  float* s_in = reinterpret_cast<float*>(col_map + H2);  // kStages tiles
  float* s_mid = s_in + kStages * H1 * H2;  // H1 x kT2 after axis 2
  float* ring = s_mid + H1 * kT2;           // K0 planes of T1 x kT2

  const int tiles2 = (n2 + kT2 - 1) / kT2;
  const int o1 = (blockIdx.x / tiles2) * T1;
  const int o2 = (blockIdx.x % tiles2) * kT2;
  const int z0 = blockIdx.y * p.z;
  const int z1 = min(z0 + p.z, n0);
  const int nplanes = z1 - z0 + K0 - 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  for (int i = tid; i < 3 * kMaxTaps; i += kBX * kBY) {
    w0[i] = p.ax[i / kMaxTaps].taps[i % kMaxTaps];
  }
  build_maps(row_map, H1, o1 - lo1, n1, mode1, H2, o2 - lo2, n2, mode2);
  __syncthreads();

  // Start the copies of input plane e (extended index) into its stage
  // buffer.  One commit group per plane, empty past the last plane, so
  // that a fixed wait depth works.
  auto issue = [&](int e) {
    if (e < nplanes) {
      load_plane(x, s_in + (e % kStages) * H1 * H2, z0 - lo0 + e, n0, mode0,
                 n1, n2, row_map, col_map, H1, H2, cval);
    }
    __pipeline_commit();
  };

  // kStages - 1 planes ahead of the one being filtered are in flight.
  // The buffer plane e + kStages - 1 goes to was last read by the axis-2
  // pass of plane e - 1, which every thread finished before the barrier
  // that follows that pass.
  for (int e = 0; e < kStages - 1; ++e) issue(e);
  for (int e = 0; e < nplanes; ++e) {
    issue(e + kStages - 1);
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();
    const float* tile = s_in + (e % kStages) * H1 * H2;
    // A thread computes four outputs per call: columns tx and tx + 32 of
    // rows r and r + 8.  Where row r + 8 is past the tile (two == false)
    // it recomputes row r and stores nothing for it.
    for (int r = ty; r < H1; r += 2 * kBY) {
      const bool two = r + kBY < H1;
      const int dr = two ? kBY : 0;
      const float* src = tile + r * H2 + tx;
      float v[4];
      fold<OP, 4>(w2, K2, kind2, [&](int k, int j) {
        return src[(j >> 1) * dr * H2 + (j & 1) * kBX + k];
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
    // Each thread writes and reads only its own ring cells, so the ring
    // needs no barrier; the first barrier of the next plane keeps s_mid
    // from being overwritten while a thread still reads it.
    const int slot = e % K0;
    const int first = (e + 1) % K0;  // ring slot of the window's plane 0
    const int zo = z0 + e - (K0 - 1);
    for (int r = ty; r < T1; r += 2 * kBY) {
      const bool two = r + kBY < T1;
      const int dr = two ? kBY : 0;
      const float* src = s_mid + r * kT2 + tx;
      float v[4];
      fold<OP, 4>(w1, K1, kind1, [&](int k, int j) {
        return src[((j >> 1) * dr + k) * kT2 + (j & 1) * kBX];
      }, v);
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
      }
    }
  }
}

template <int OP>
int launch(const float* x, float* y, const Params& p, const int* plan,
           void* stream) {
  const dim3 grid(plan[2], plan[3]);
  const int smem = plan[4];
  cudaError_t err = cudaFuncSetAttribute(
      fused_separable_f32_kernel<OP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_separable_f32_kernel<OP><<<grid, dim3(kBX, kBY), smem,
                                   (cudaStream_t)stream>>>(x, y, p);
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
// shared bytes.  op: 0 correlate, 1 minimum, 2 maximum.
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
