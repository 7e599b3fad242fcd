// Fused separable correlation, box minimum and box maximum of a 2-D or
// 3-D float32 array, for sm_90a.
//
// Replaces the TPU kernels of cupyimg_tpu/ops/pallas_stencil.py:
// _fused_separable (all six 'corr' plans: _make_kernel_3d_lanemm padless
// and padded, _make_kernel_3d_laneroll, _make_kernel_3d,
// _make_kernel_2d_lanemm, _make_kernel_2d; and the 'min'/'max' specs of
// _make_kernel_3d_laneroll, _make_kernel_3d and _make_kernel_2d, i.e.
// fused_separable_minmax).  What they all compute, op by op:
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
  // the tile's source row and column of every halo'd row and column,
  // -1 where the mode gives cval: the same for every plane, so mapped
  // once (mapped per sample, the modulo arithmetic cost more than the
  // filter)
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
  for (int i = tid; i < H1 + H2; i += kBX * kBY) {
    bool oob = false;
    const int m = i < H1 ? map_index(o1 - lo1 + i, n1, mode1, oob)
                         : map_index(o2 - lo2 + i - H1, n2, mode2, oob);
    row_map[i] = oob ? -1 : m;
  }
  __syncthreads();

  // Start the copies of input plane e (extended index) into its stage
  // buffer: every in-range sample as an asynchronous 4-byte cp.async,
  // every cval sample as a plain store.  One commit group per plane,
  // empty past the last plane, so that a fixed wait depth works.
  auto issue = [&](int e) {
    if (e < nplanes) {
      float* buf = s_in + (e % kStages) * H1 * H2;
      bool oob0 = false;
      const int m0 = map_index(z0 - lo0 + e, n0, mode0, oob0);
      const float* plane = x + (size_t)m0 * n1 * n2;
      for (int r = ty; r < H1; r += kBY) {
        const int m1 = oob0 ? -1 : row_map[r];
        const float* row = plane + (size_t)max(m1, 0) * n2;
        for (int c = tx; c < H2; c += kBX) {
          const int m2 = col_map[c];
          if (m1 < 0 || m2 < 0) {
            buf[r * H2 + c] = cval;
          } else {
            __pipeline_memcpy_async(buf + r * H2 + c, row + m2,
                                    sizeof(float));
          }
        }
      }
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
