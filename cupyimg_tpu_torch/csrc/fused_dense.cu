// Dense (non-separable) correlation of a 2-D or 3-D float32 array over
// the nonzero taps of a weights array, for sm_90a.
//
// Replaces the TPU kernels of cupyimg_tpu/ops/pallas_stencil.py:
// _fused_dense (_make_dense_kernel_3d, _make_dense_kernel_2d_lanemm,
// _make_dense_kernel_2d, i.e. fused_dense_correlate).  What they compute:
//
//   y[i] = sum over nonzero taps k of w[k] * xe[i0+k0-lo0, i1+k1-lo1,
//                                              i2+k2-lo2]
//
// where xe is x extended by ONE ndimage mode on every axis (map_index,
// boundary.cuh) and cval outside a constant-mode axis.  A 2-D array runs
// as (1, n0, n1) with a (1, W0, W1) footprint.  At most 1400 taps.  A
// tap whose weight is zero is skipped, never multiplied (0 * inf would
// be NaN).  FMAs are float32, never TF32.
//
// Bound: 8 bytes a voxel against 2 flops a nonzero tap; a 9x9 footprint
// (162 flops a voxel) is bound by operations on an H100 (fp32 at 67
// TFLOP/s against 3.35 TB/s: the crossover is 160 flops a voxel), a
// 3x3x3 one by bytes.
//
// Two kernels.  ops/fused_dense.py:blocked_plan picks the first where
// it applies, else the second.
//
// - Blocked (dense_blocked_f32_kernel<K0, S, R>): a footprint whose
//   bounding box has K0 <= 5 planes, whose halo'd tile fits shared
//   memory, and whose taps are dense enough that register blocking pays
//   (ops/fused_dense.py:blocked_plan).  A thread owns R consecutive
//   rows of two columns (tx, tx + 32) of a (8R x 64) output tile, for
//   K0 output planes at once.  The footprint's rows are cut into chunks
//   of S rows (S known at compile time), and its nonzero (chunk, column)
//   pairs are the kernel's columns: for each, the thread loads the R +
//   S - 1 input samples its outputs need into registers once, then does
//   R FMAs per nonzero tap of the column (weights read as shared-memory
//   broadcasts).  So a 9x9 footprint costs 18 shared loads per 81 FMAs,
//   not 81.  A 3-D footprint marches along axis 0: each halo'd input
//   plane is loaded once (16-byte cp.async in the interior, index maps
//   at the edges; tile_load.cuh), up to four in flight, and added into
//   the K0 output planes it feeds, whose sums sit in registers (the
//   plane loop unrolled by K0); one barrier a plane.
// - Generic (fused_dense_f32_kernel): any other footprint, sparse or
//   wide.  The host (ops/fused_dense.py:group_taps) cuts the taps into
//   groups: taps of one leading offset d0, a run of rows d1 and a range
//   of columns d2 small enough that the halo'd strip of a (32 x 64)
//   output tile, (32 + rows - 1) x (64 + columns - 1) floats, fits in
//   48 KB.  Each block stages every tap's (strip offset, weight) in
//   shared memory once, then owns one output tile of one plane at a
//   time; for each group it loads the strip with the mode applied in
//   the load (an asynchronous 4-byte cp.async per in-range sample), then
//   every thread adds the group's taps to its eight outputs (rows ty +
//   8i, columns tx and tx + 32), reading each tap once for all eight:
//   one shared load of the input and one FMA per tap and output.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "boundary.cuh"
#include "tile_load.cuh"

namespace {

constexpr int kBX = 32;       // threads along axis 2 (contiguous)
constexpr int kBY = 8;        // threads along axis 1
constexpr int kRows = 4;      // output rows a thread: ty + kBY * i
constexpr int kT1 = kRows * kBY;  // output tile rows (ops/fused_dense.py:T1)
constexpr int kT2 = 2 * kBX;  // output tile columns (ops/fused_dense.py:T2)
constexpr int kGroupInts = 8;  // d0, d1, d2, h1, h2, tap_begin, tap_end, -
static_assert(kBX == kLoadBX && kBX * kBY == kLoadThreads,
              "tile_load.cuh's block");

struct Params {
  int n0, n1, n2;
  int lo0, lo1, lo2;
  int mode;
  float cval;
  int ngroups;
  int ntaps;
};

__global__ void __launch_bounds__(kBX * kBY)
fused_dense_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                       const int* __restrict__ plan,
                       const __grid_constant__ Params p) {
  // shared memory: ntaps (strip offset, weight) pairs, then the strip
  extern __shared__ float2 taps[];
  float* strip = reinterpret_cast<float*>(taps + p.ntaps);
  const int* groups = plan;
  const int* tap_off = plan + p.ngroups * kGroupInts;
  const float* tap_w = reinterpret_cast<const float*>(tap_off + p.ntaps);
  const int n0 = p.n0, n1 = p.n1, n2 = p.n2, mode = p.mode;
  const int tiles2 = (n2 + kT2 - 1) / kT2;
  const int o1 = (blockIdx.x / tiles2) * kT1;
  const int o2 = (blockIdx.x % tiles2) * kT2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int t = ty * kBX + tx; t < p.ntaps; t += kBX * kBY) {
    taps[t] = make_float2(__int_as_float(tap_off[t]), tap_w[t]);
  }
  for (int z = blockIdx.y; z < n0; z += gridDim.y) {
    float acc[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int g = 0; g < p.ngroups; ++g) {
      const int* G = groups + g * kGroupInts;
      const int h1 = G[3], h2 = G[4];
      bool oob0 = false;
      const int m0 = map_index(z + G[0] - p.lo0, n0, mode, oob0);
      const float* plane = x + (size_t)m0 * n1 * n2;
      const int r0 = o1 + G[1] - p.lo1, c0 = o2 + G[2] - p.lo2;
      __syncthreads();  // every thread is done with the previous strip
      for (int r = ty; r < h1; r += kBY) {
        bool oob1 = oob0;
        const int m1 = map_index(r0 + r, n1, mode, oob1);
        const float* row = plane + (size_t)m1 * n2;
        for (int c = tx; c < h2; c += kBX) {
          bool oob = oob1;
          const int m2 = map_index(c0 + c, n2, mode, oob);
          if (oob) {
            strip[r * h2 + c] = p.cval;
          } else {
            __pipeline_memcpy_async(strip + r * h2 + c, row + m2,
                                    sizeof(float));
          }
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      const float* base = strip + ty * h2 + tx;
      const int down = kBY * h2;
#pragma unroll 2
      for (int t = G[5]; t < G[6]; ++t) {
        const float2 tw = taps[t];
        const float* s = base + __float_as_int(tw.x);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][0] += tw.y * s[i * down];
          acc[i][1] += tw.y * s[i * down + kBX];
        }
      }
    }
    const bool c0 = o2 + tx < n2, c1 = o2 + tx + kBX < n2;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = o1 + ty + i * kBY;
      if (row < n1) {
        float* dst = y + ((size_t)z * n1 + row) * n2 + o2 + tx;
        if (c0) dst[0] = acc[i][0];
        if (c1) dst[kBX] = acc[i][1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The blocked kernel (see the top of the file)
// ---------------------------------------------------------------------------

struct BlockedParams {
  int n0, n1, n2;
  int lo0, lo1, lo2;  // window leads of the footprint's bounding box
  int mode;
  float cval;
  int w1, w2;   // the bounding box's rows and columns
  int ncols;    // (chunk, column) pairs with a nonzero tap
  int ndense;   // the first ndense pairs have no zero weight
  int z;        // output planes a block
  int stages;   // input planes in flight (K0 > 1: 4, 3 or 2)
  int vec;      // rows may be read in 16-byte chunks
};

// Block (bx, by): the output tile [o1, o1 + 8R) x [o2, o2 + 64) of
// planes [by z, by z + z) (K0 > 1), or of plane by, by + gridDim.y, ...
// (K0 == 1: one plane at a time).  plan: ncols (chunk, column) int pairs,
// then ncols x K0 x S float32 weights ([pair][d0][row of the chunk]).
// Shared memory: the pairs, the weights, the tile's index maps and
// `stages` tiles of (8R + chunks S - 1) rows of 4 nch words.
template <int K0, int S, int R>
__global__ void __launch_bounds__(kBX * kBY, K0 == 1 ? 3 : 2)
dense_blocked_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                         const int* __restrict__ plan,
                         const __grid_constant__ BlockedParams p) {
  constexpr int T1 = kBY * R;  // output tile rows (ops/fused_dense.py)
  extern __shared__ __align__(16) float dsmem[];
  const int n0 = p.n0, n1 = p.n1, n2 = p.n2;
  const int ncols = p.ncols;
  const int chunks = (p.w1 + S - 1) / S;
  const int H1 = T1 + chunks * S - 1;  // tile rows, the last chunk's too
  const int H2 = kT2 + p.w2 - 1;
  const int nch = (H2 + 6) >> 2, H2P = 4 * nch;
  int* cols = reinterpret_cast<int*>(dsmem);              // 2 ncols
  float* wts = dsmem + 2 * ncols;                          // ncols K0 S
  int* row_map = reinterpret_cast<int*>(wts + ncols * K0 * S);  // H1
  int* col_map = row_map + H1;                                  // H2
  float* s_in = dsmem + (2 * ncols + ncols * K0 * S + H1 + H2 + 3) / 4 * 4;
  const int tiles2 = (n2 + kT2 - 1) / kT2;
  const int o1 = (blockIdx.x / tiles2) * T1;
  const int o2 = (blockIdx.x % tiles2) * kT2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  const int xs = o2 - p.lo2;
  const int sh = xs - floor4(xs);
  for (int i = tid; i < ncols * (2 + K0 * S); i += kBX * kBY) {
    dsmem[i] = __int_as_float(plan[i]);  // the pairs and the weights, raw
  }
  build_maps(row_map, H1, o1 - p.lo1, n1, p.mode, H2, xs, n2, p.mode);

  // the thread's outputs: rows ty R + i, columns tx and tx + 32
  auto accumulate = [&](const float* tile, float (&acc)[K0][R][2], int u) {
    const float* base = tile + ty * R * H2P + sh + tx;
    for (int ci = 0; ci < ncols; ++ci) {
      const int chunk = cols[2 * ci], d2 = cols[2 * ci + 1];
      const float* src = base + chunk * S * H2P + d2;
      float win[R + S - 1][2];
#pragma unroll
      for (int m = 0; m < R + S - 1; ++m) {
        win[m][0] = src[m * H2P];
        win[m][1] = src[m * H2P + kBX];
      }
      const float* w = wts + ci * K0 * S;
      // a pair with no zero weight skips the test (the same for every
      // thread), the others test each weight: a zero tap is skipped
      auto taps = [&](auto checked) {
#pragma unroll
        for (int d0 = 0; d0 < K0; ++d0) {
          // input plane e feeds output plane e - d0: slot (u - d0) mod K0
          const int slot = (u - d0 + K0) % K0;
#pragma unroll
          for (int d1 = 0; d1 < S; ++d1) {
            const float wk = w[d0 * S + d1];
            if (decltype(checked)::value && wk == 0.f) continue;
#pragma unroll
            for (int i = 0; i < R; ++i) {
              acc[slot][i][0] = fmaf(wk, win[i + d1][0], acc[slot][i][0]);
              acc[slot][i][1] = fmaf(wk, win[i + d1][1], acc[slot][i][1]);
            }
          }
        }
      };
      if (ci < p.ndense) {
        taps(std::false_type{});
      } else {
        taps(std::true_type{});
      }
    }
  };
  auto store = [&](int zo, const float (&out)[R][2]) {
    const bool c0 = o2 + tx < n2, c1 = o2 + tx + kBX < n2;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = o1 + ty * R + i;
      if (row < n1) {
        float* dst = y + ((size_t)zo * n1 + row) * n2 + o2 + tx;
        if (c0) dst[0] = out[i][0];
        if (c1) dst[kBX] = out[i][1];
      }
    }
  };
  float acc[K0][R][2];
  auto clear = [&](int slot) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[slot][i][0] = acc[slot][i][1] = 0.f;
  };
  __syncthreads();

  if constexpr (K0 == 1) {
    // one plane a step, one tile buffer
    for (int zp = blockIdx.y; zp < n0; zp += gridDim.y) {
      load_plane16(x, s_in, zp - p.lo0, n0, p.mode, n1, n2, row_map,
                   col_map, H1, H2, nch, xs, p.vec, p.cval);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      clear(0);
      accumulate(s_in, acc, 0);
      store(zp, acc[0]);
      __syncthreads();  // every thread is done with the tile
    }
  } else {
    const int stages = p.stages;
    const int z0 = blockIdx.y * p.z;
    const int z1 = min(z0 + p.z, n0);
    const int nplanes = z1 - z0 + K0 - 1;
    auto issue = [&](int e) {
      if (e < nplanes) {
        load_plane16(x, s_in + (e % stages) * H1 * H2P, z0 - p.lo0 + e, n0,
                     p.mode, n1, n2, row_map, col_map, H1, H2, nch, xs,
                     p.vec, p.cval);
      }
      __pipeline_commit();
    };
    // stages - 1 planes in flight; the buffer plane e + stages - 1 goes to
    // was read by the accumulation of plane e - 1, which every thread
    // finished before the barrier of plane e
    for (int e = 0; e < stages - 1; ++e) issue(e);
#pragma unroll
    for (int s = 0; s < K0; ++s) clear(s);
    for (int e0 = 0; e0 < nplanes; e0 += K0) {
#pragma unroll
      for (int u = 0; u < K0; ++u) {
        const int e = e0 + u;
        if (e >= nplanes) break;  // the same for every thread
        if (stages == 4) {
          __pipeline_wait_prior(2);
        } else if (stages == 3) {
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();
        issue(e + stages - 1);
        accumulate(s_in + (e % stages) * H1 * H2P, acc, u);
        // output plane e - (K0 - 1) has all its planes: slot (u + 1) % K0,
        // which output plane e + 1 starts from 0
        const int slot = (u + 1) % K0;
        const int zo = z0 + e - (K0 - 1);
        if (zo >= z0) store(zo, acc[slot]);
        clear(slot);
      }
    }
  }
}

template <int K0, int S, int R>
int launch_blocked(const float* x, float* y, const int* plan,
                   const BlockedParams& p, dim3 grid, int smem,
                   void* stream) {
  auto kernel = dense_blocked_f32_kernel<K0, S, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, dim3(kBX, kBY), smem, (cudaStream_t)stream>>>(x, y, plan, p);
  return (int)cudaGetLastError();
}

// rows a thread on the blocked kernel (ops/fused_dense.py:BLOCKED_ROWS)
constexpr int kRows2D = 8;  // K0 == 1
constexpr int kRows3D = 4;  // K0 > 1

}  // namespace

// dims: n0, n1, n2.  lo: lo0, lo1, lo2.  plan: a device buffer of
// ngroups x 8 ints (ops/fused_dense.py:plan_buffer), then ntaps strip
// offsets, then ntaps float32 weights.  geom: grid_x, grid_y, shared
// bytes.  Returns the cudaError_t of the attribute call or the launch.
extern "C" int fused_dense_f32(const float* x, float* y, const int* dims,
                               const int* lo, int mode, float cval,
                               const int* plan, int ngroups, int ntaps,
                               const int* geom, void* stream) {
  Params p;
  p.n0 = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  p.lo0 = lo[0];
  p.lo1 = lo[1];
  p.lo2 = lo[2];
  p.mode = mode;
  p.cval = cval;
  p.ngroups = ngroups;
  p.ntaps = ntaps;
  const dim3 grid(geom[0], geom[1]);
  const int smem = geom[2];
  cudaError_t err = cudaFuncSetAttribute(
      fused_dense_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  fused_dense_f32_kernel<<<grid, dim3(kBX, kBY), smem,
                           (cudaStream_t)stream>>>(x, y, plan, p);
  return (int)cudaGetLastError();
}

// dims: n0, n1, n2.  lo: the window leads of the footprint's bounding box.
// box: its rows w1 and columns w2.  plan: a device buffer (ops/
// fused_dense.py:blocked_buffer) of ncols (chunk, column) pairs, then
// their K0 x S weights each, the pairs with no zero weight first.  geom:
// grid_x, grid_y, shared bytes, z, stages, vec, K0, S (an instance of
// INSTANCES there), the count of those pairs.  Returns the
// cudaError_t of the attribute call or the launch, cudaErrorInvalidValue
// for an (K0, S) with no instance.
extern "C" int fused_dense_blocked_f32(const float* x, float* y,
                                       const int* dims, const int* lo,
                                       const int* box, int mode, float cval,
                                       const int* plan, int ncols,
                                       const int* geom, void* stream) {
  BlockedParams p;
  p.n0 = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  p.lo0 = lo[0];
  p.lo1 = lo[1];
  p.lo2 = lo[2];
  p.mode = mode;
  p.cval = cval;
  p.w1 = box[0];
  p.w2 = box[1];
  p.ncols = ncols;
  p.z = geom[3];
  p.stages = geom[4];
  p.vec = geom[5];
  p.ndense = geom[8];
  const dim3 grid(geom[0], geom[1]);
  const int smem = geom[2];
  const int k0 = geom[6], s = geom[7];
#define DENSE_INSTANCE(K, SS, RR)                                          \
  if (k0 == K && s == SS) {                                                \
    return launch_blocked<K, SS, RR>(x, y, plan, p, grid, smem, stream);  \
  }
  DENSE_INSTANCE(1, 1, kRows2D)
  DENSE_INSTANCE(1, 3, kRows2D)
  DENSE_INSTANCE(1, 5, kRows2D)
  DENSE_INSTANCE(1, 7, kRows2D)
  DENSE_INSTANCE(1, 9, kRows2D)
  DENSE_INSTANCE(1, 16, kRows2D)
  DENSE_INSTANCE(2, 3, kRows3D)
  DENSE_INSTANCE(2, 5, kRows3D)
  DENSE_INSTANCE(3, 3, kRows3D)
  DENSE_INSTANCE(3, 5, kRows3D)
  DENSE_INSTANCE(4, 3, kRows3D)
  DENSE_INSTANCE(4, 5, kRows3D)
  DENSE_INSTANCE(5, 3, kRows3D)
  DENSE_INSTANCE(5, 5, kRows3D)
#undef DENSE_INSTANCE
  return (int)cudaErrorInvalidValue;
}
