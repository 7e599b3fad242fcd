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
// as (1, n0, n1) with a (1, W0, W1) footprint.  At most 1400 taps.
//
// Bound: 8 bytes a voxel against 2 flops a nonzero tap; a 9x9 footprint
// (162 flops a voxel) is bound by operations on an H100 (fp32 at 67
// TFLOP/s against 3.35 TB/s: the crossover is 160 flops a voxel), a
// 3x3x3 one by bytes.
//
// Design.  The footprint may span far more than its taps (the gate
// admits weights up to twice the array on each axis, e.g. 60^3 with
// 1400 nonzeros), so no halo of the whole footprint is ever loaded.  The
// host (ops/fused_dense.py:group_taps) cuts the taps into groups: taps
// of one leading offset d0, a run of rows d1 and a range of columns d2
// small enough that the halo'd strip of a (32 x 64) output tile, (32 +
// rows - 1) x (64 + columns - 1) floats, fits in 48 KB.  Each block
// stages every tap's (strip offset, weight) in shared memory once, then
// owns one output tile of one plane at a time; for each group it loads
// the strip into shared memory with the mode applied in the load (an
// asynchronous 4-byte cp.async per in-range sample, so that a thread
// issues all its loads before it waits: 3x3x3 on 256^3 went from 0.247
// to 0.206 ms on an H100 against a synchronous load and shared store per
// sample), then every thread adds the
// group's taps to its eight outputs (rows ty + 8i, columns tx and tx +
// 32), reading each tap once for all eight.  The sums stay in registers
// across groups.  FMAs are float32, never TF32.  Per tap and output: one
// shared load of the input and one FMA; sharing loaded inputs between
// taps in registers (register blocking) is the next step.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "boundary.cuh"

namespace {

constexpr int kBX = 32;       // threads along axis 2 (contiguous)
constexpr int kBY = 8;        // threads along axis 1
constexpr int kRows = 4;      // output rows a thread: ty + kBY * i
constexpr int kT1 = kRows * kBY;  // output tile rows (ops/fused_dense.py:T1)
constexpr int kT2 = 2 * kBX;  // output tile columns (ops/fused_dense.py:T2)
constexpr int kGroupInts = 8;  // d0, d1, d2, h1, h2, tap_begin, tap_end, -

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
