// Rank filter (the rank-th smallest value over a boolean footprint of
// 3..64 taps) of a 2-D or 3-D int32 or float32 array, for sm_90a.
//
// Replaces the TPU kernels of cupyimg_tpu/ops/pallas_stencil.py:
// _fused_rank (_make_rank_kernel_3d and _make_rank_kernel_2d, i.e.
// fused_rank_filter).  What they compute:
//
//   y[i] = the rank-th smallest of { xe[i + k - lo] : footprint[k] }
//
// where xe is x extended by ONE ndimage mode on every axis (map_index,
// boundary.cuh) and cval outside a constant-mode axis.  A 2-D array runs
// as (1, n0, n1).
//
// Bound: compare-exchanges (CEs).  A 5x5 median needs 91 CEs a pixel
// with the TPU kernel's shared presort, 2 instructions each, so about
// 0.09 ms on a 4096^2 image at the H100's non-FMA fp32 rate, above the
// 0.040 ms of its bytes.
//
// Design.  Each thread owns one output of an (8 x 32) tile and gathers
// its footprint values into K wires, wire k holding tap k in np.argwhere
// order.  The footprint may span far more than its taps
// (the gate bounds taps, not extent: a 1 x 4000 footprint with 64 ones
// is admitted), so the values come through shared memory one strip at a
// time (cp.async per in-range sample), exactly as in the dense kernel:
// the host's groups
// (ops/fused_dense.py:group_taps) each name a strip of at most 48 KB.
// Then the thread runs the rank-pruned Batcher network of
// ops/sorting_networks.py:pruned_network(K, rank), the same CE list
// that the plain version runs with torch.minimum/torch.maximum, with
// NaN-propagating min/max: the kernel and the plain version agree
// bitwise.  The CE list is staged in shared memory, each CE as the two
// wires' word offsets.  The wires are indexed at run time, so they live
// in shared memory too, wire k of thread t at word k * 256 + t (no bank
// conflicts); a per-thread array would go to local memory, and 64 wires
// a thread overflow L1 at full occupancy (a 4096^2 5x5 median took 4.3
// ms on an H100 that way, 1.5 ms this way).  A CE now costs five shared
// accesses (the CE and two wires read, two written), which by count is
// most of the 1.5 ms.  Keeping the wires in registers needs the network
// at compile time; with sharing a presort of the lane window between
// outputs, as the TPU kernel does for rectangles (5x5 median: 113 CEs
// down to 9 shared + 82), that is the next redesign.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "boundary.cuh"

namespace {

constexpr int kBX = 32;  // threads along axis 2 (contiguous)
constexpr int kBY = 8;   // threads along axis 1
constexpr int kT1 = kBY;  // output tile rows (ops/fused_rank.py:T1)
constexpr int kT2 = kBX;  // output tile columns (ops/fused_rank.py:T2)
constexpr int kThreads = kBX * kBY;
constexpr int kGroupInts = 8;  // d0, d1, d2, h1, h2, tap_begin, tap_end, -

struct Params {
  int n0, n1, n2;
  int lo0, lo1, lo2;
  int mode;
  int ngroups;
  int ntaps;
  int nces;
  int rank;
};

// Shared memory: ce_words words of packed CEs (a multiple of 4), then
// ntaps x kThreads wires, then the strip.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_rank_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const int* __restrict__ plan, T cval, int ce_words,
                  const __grid_constant__ Params p) {
  extern __shared__ int smem[];
  // CE c: word offset of wire a (a * kThreads) in the low 16 bits, of
  // wire b in the high 16 bits (64 wires x 256 threads < 2^16)
  int* ces = smem;
  T* wires = reinterpret_cast<T*>(smem + ce_words);
  T* strip = wires + p.ntaps * kThreads;
  const int* groups = plan;
  const int* tap_off = plan + p.ngroups * kGroupInts;
  const int* tap_wire = tap_off + p.ntaps;
  const int* ce_list = tap_wire + p.ntaps;  // nces pairs (a, b)
  const int n0 = p.n0, n1 = p.n1, n2 = p.n2, mode = p.mode;
  const int tiles2 = (n2 + kT2 - 1) / kT2;
  const int o1 = (blockIdx.x / tiles2) * kT1;
  const int o2 = (blockIdx.x % tiles2) * kT2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  for (int c = tid; c < p.nces; c += kThreads) {
    ces[c] = ce_list[2 * c] * kThreads |
             (ce_list[2 * c + 1] * kThreads) << 16;
  }
  T* mine = wires + tid;  // this thread's wire k is mine[k * kThreads]
  for (int z = blockIdx.y; z < n0; z += gridDim.y) {
    for (int g = 0; g < p.ngroups; ++g) {
      const int* G = groups + g * kGroupInts;
      const int h1 = G[3], h2 = G[4];
      bool oob0 = false;
      const int m0 = map_index(z + G[0] - p.lo0, n0, mode, oob0);
      const T* plane = x + (size_t)m0 * n1 * n2;
      const int r0 = o1 + G[1] - p.lo1, c0 = o2 + G[2] - p.lo2;
      __syncthreads();  // every thread is done with the previous strip
      for (int r = ty; r < h1; r += kBY) {
        bool oob1 = oob0;
        const int m1 = map_index(r0 + r, n1, mode, oob1);
        const T* row = plane + (size_t)m1 * n2;
        for (int c = tx; c < h2; c += kBX) {
          bool oob = oob1;
          const int m2 = map_index(c0 + c, n2, mode, oob);
          if (oob) {
            strip[r * h2 + c] = cval;
          } else {
            __pipeline_memcpy_async(strip + r * h2 + c, row + m2,
                                    sizeof(T));
          }
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      const T* base = strip + ty * h2 + tx;
      for (int t = G[5]; t < G[6]; ++t) {
        mine[__ldg(tap_wire + t) * kThreads] = base[__ldg(tap_off + t)];
      }
    }
    // each thread reads and writes only its own wires: no barrier
#pragma unroll 4
    for (int c = 0; c < p.nces; ++c) {
      const int ce = ces[c];
      T* wa = mine + (ce & 0xffff);
      T* wb = mine + (ce >> 16);
      const T va = *wa, vb = *wb;
      *wa = min_nan(va, vb);
      *wb = max_nan(va, vb);
    }
    if (o1 + ty < n1 && o2 + tx < n2) {
      y[((size_t)z * n1 + o1 + ty) * n2 + o2 + tx] = mine[p.rank * kThreads];
    }
  }
}

template <typename T>
int launch(const T* x, T* y, const int* dims, const int* lo, int mode,
           T cval, const int* plan, const int* counts, const int* geom,
           void* stream) {
  Params p;
  p.n0 = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  p.lo0 = lo[0];
  p.lo1 = lo[1];
  p.lo2 = lo[2];
  p.mode = mode;
  p.ngroups = counts[0];
  p.ntaps = counts[1];
  p.nces = counts[2];
  p.rank = counts[3];
  const int ce_words = (p.nces + 3) / 4 * 4;
  const dim3 grid(geom[0], geom[1]);
  const int smem = geom[2];
  cudaError_t err = cudaFuncSetAttribute(
      fused_rank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  fused_rank_kernel<T><<<grid, dim3(kBX, kBY), smem,
                         (cudaStream_t)stream>>>(x, y, plan, cval,
                                                 ce_words, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: n0, n1, n2.  lo: lo0, lo1, lo2.  plan: a device buffer of
// ngroups x 8 ints (ops/fused_dense.py:plan_buffer), ntaps strip
// offsets, ntaps wires, then nces pairs of wires.  counts: ngroups,
// ntaps, nces, rank.  geom: grid_x, grid_y, shared bytes.  Returns the
// cudaError_t of the attribute call or of the launch.
extern "C" int fused_rank_f32(const float* x, float* y, const int* dims,
                              const int* lo, int mode, float cval,
                              const int* plan, const int* counts,
                              const int* geom, void* stream) {
  return launch<float>(x, y, dims, lo, mode, cval, plan, counts, geom,
                       stream);
}

extern "C" int fused_rank_i32(const int* x, int* y, const int* dims,
                              const int* lo, int mode, int cval,
                              const int* plan, const int* counts,
                              const int* geom, void* stream) {
  return launch<int>(x, y, dims, lo, mode, cval, plan, counts, geom,
                     stream);
}
