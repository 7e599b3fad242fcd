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
// boundary.cuh) and cval outside a constant-mode axis.
//
// Bound: compare-exchanges (CEs).  A 5x5 median needs 91 CEs a pixel
// with the TPU kernel's shared presort, 2 instructions each, so about
// 0.09 ms on a 4096^2 image at the H100's non-FMA fp32 rate, above the
// 0.040 ms of its bytes.
//
// Design.  Two kinds of instance, the same networks as the plain version
// (ops/fused_rank.py:fused_rank_filter_ref), so every route agrees
// bitwise, NaN included.
//
// Compile-time instances (rank_instance_kernel) for the footprints and
// ranks of ops/fused_rank.py:INSTANCES: the networks come from
// rank_networks.cuh (generated from ops/sorting_networks.py), so after
// unrolling every wire index is a constant and the wires live in
// registers.  A block of 128 threads stages a halo'd tile of R + F0 - 1
// planes through shared memory (16-byte cp.async where a row is aligned
// and in range, the boundary map only at the edges); each thread owns R
// outputs of one column along axis 0 (a 2-D array runs as (n0, 1, n1)).
// A full rectangle shares its presort as the TPU kernel's rectangle
// route does: each lane window sorted once, each plane's rows merged once
// into a run kept in a register ring of F0 runs, and per output only the
// pruned merge of the F0 sorted runs (5x5 median: 9 + 82 CEs, 3x3x3:
// 21 + 55, against 113 and 126 unshared).  Other instance footprints
// (the 3x3 cross) gather their taps and run the pruned network.
//
// The generic instance (fused_rank_kernel) serves every other footprint
// of 3..64 taps, whatever its extent (the gate bounds taps, not extent:
// a 1 x 4000 footprint with 64 ones is admitted).  Each thread owns one
// output of an (8 x 32) tile and gathers its footprint values into K
// wires, wire k holding tap k in np.argwhere order; the values come
// through shared memory one strip at a time (cp.async per in-range
// sample), exactly as in the dense kernel: the host's groups
// (ops/fused_dense.py:group_taps) each name a strip of at most 48 KB.
// A 2-D array runs as (1, n0, n1) here.  Then the thread runs
// ops/sorting_networks.py:flat_rank_network, a CE
// list staged in shared memory, each CE as the two wires' word offsets
// (a rectangle's presort laid out flat per output, else the pruned
// Batcher network).  The wires are indexed at run time, so they live in
// shared memory too, wire k of thread t at word k * 256 + t; a CE costs
// five shared accesses.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <utility>

#include "boundary.cuh"
#include "rank_networks.cuh"

#ifndef RN_PART
#define RN_PART 0
#endif

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
  int out;  // the wire that holds the rank-th value at the end
};

#if RN_PART == 0
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
      y[((size_t)z * n1 + o1 + ty) * n2 + o2 + tx] = mine[p.out * kThreads];
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
  p.out = counts[3];
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

#endif  // RN_PART == 0

// ---------------------------------------------------------------------------
// compile-time instances
// ---------------------------------------------------------------------------

constexpr int kR = 8;  // outputs of a thread along axis 0, at least (ops/fused_rank.py:R)
constexpr int kIThreads = 128;   // ops/fused_rank.py:INSTANCE_THREADS

struct IParams {
  int n0, n1, n2;
  int lo0, lo1, lo2;
  int mode;
  int vec;  // rows may be read in 16-byte chunks (aligned base, n2 % 4 == 0)
};

__host__ __device__ constexpr int popcount64(uint64_t m) {
  int c = 0;
  for (; m; m >>= 1) c += (int)(m & 1);
  return c;
}

// the flat footprint index of tap j (np.argwhere order)
__host__ __device__ constexpr int nth_tap(uint64_t m, int j) {
  for (int i = 0; i < 64; ++i) {
    if ((m >> i) & 1) {
      if (j == 0) return i;
      --j;
    }
  }
  return -1;
}

template <uint64_t MASK, int J>
struct TapAt {
  static constexpr int value = nth_tap(MASK, J);
};

// w[j] = tap j of the footprint (F0 x F1 x F2, bit mask MASK) at `base`,
// `plane` and `row` words apart in the tile
template <int F1, int F2, uint64_t MASK, class T, int... J>
__device__ __forceinline__ void gather_taps(T* w, const T* base, int plane,
                                            int row,
                                            std::integer_sequence<int, J...>) {
  ((w[J] = base[(TapAt<MASK, J>::value / (F1 * F2)) * plane +
                (TapAt<MASK, J>::value / F2 % F1) * row +
                TapAt<MASK, J>::value % F2]),
   ...);
}

// Block (bx, by) of 128 threads over an (n0, n1, n2) array (a 2-D one as
// (n0, 1, n1)): output columns [x0, x0 + bx) of rows [y0, y0 + by) of
// planes [z0, z0 + R).  Shared memory: the halo'd tile, R + F0 - 1
// planes of by + F1 - 1 rows of `row` words, row r of the tile starting
// at the 16-byte aligned column at or before x0 - lo2.
template <typename T, int F0, int F1, int F2, uint64_t MASK, int RANK>
__global__ void __launch_bounds__(kIThreads)
rank_instance_kernel(const T* __restrict__ x, T* __restrict__ y, T cval,
                     const __grid_constant__ IParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  constexpr int K = popcount64(MASK);
  constexpr int RUN = F1 * F2;
  constexpr bool kRect = K == F0 * F1 * F2;
  // outputs of a thread along axis 0 (ops/fused_rank.py:instance_rows)
  constexpr int R = kRect ? F0 * ((kR + F0 - 1) / F0) : kR;
  constexpr int TZ = R + F0 - 1;
  static_assert(sizeof(T) == 4, "4-byte data");
  const int bx = blockDim.x, by = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * bx + tx;
  const int n0 = p.n0, n1 = p.n1, n2 = p.n2, mode = p.mode;
  const int tiles2 = (n2 + bx - 1) / bx;
  const int x0 = (blockIdx.x % tiles2) * bx;
  const int y0 = (blockIdx.x / tiles2) * by;
  const int z0 = blockIdx.y * R;
  const int TY = by + F1 - 1;
  const int nch = (bx + F2 - 1 + 3 + 3) >> 2;  // 16-byte chunks a row
  const int row = 4 * nch;
  const int xs = x0 - p.lo2;
  const int xa = xs >= 0 ? (xs & ~3) : -((3 - xs) & ~3);  // floor to 4
  const int sh = xs - xa;

  for (int i = tid; i < TZ * TY * nch; i += bx * by) {
    const int r = i / nch, ch = i - r * nch;
    const int tz = r / TY, tr = r - tz * TY;
    bool oob = false;
    const int mz = map_index(z0 - p.lo0 + tz, n0, mode, oob);
    const int my = map_index(y0 - p.lo1 + tr, n1, mode, oob);
    T* dst = tile + r * row + 4 * ch;
    const int c = xa + 4 * ch;
    if (oob) {
      dst[0] = cval;
      dst[1] = cval;
      dst[2] = cval;
      dst[3] = cval;
      continue;
    }
    const T* src = x + ((size_t)mz * n1 + my) * n2;
    if (p.vec && c >= 0 && c + 4 <= n2) {
      __pipeline_memcpy_async(dst, src + c, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool o = false;
        const int m = map_index(c + e, n2, mode, o);
        if (o) {
          dst[e] = cval;
        } else {
          __pipeline_memcpy_async(dst + e, src + m, sizeof(T));
        }
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int plane = TY * row;
  const T* base = tile + ty * row + tx + sh;
  const bool mine = x0 + tx < n2 && y0 + ty < n1;
  const int nz = min(R, n0 - z0);
  const size_t zstride = (size_t)n1 * n2;
  T* out = y + ((size_t)z0 * n1 + y0 + ty) * n2 + x0 + tx;
  if constexpr (kRect) {
    // the shared presort: plane s's sorted run goes to ring[s % F0], and
    // output o merges the runs of planes o .. o + F0 - 1.  R is a
    // multiple of F0, so a round of F0 outputs unrolled finds every ring
    // slot at a constant index (registers), and the rounds loop.
    T ring[F0][RUN];
    auto plane_run = [&](int s, T(&dst)[RUN]) {
      T m[RUN];
#pragma unroll
      for (int r = 0; r < F1; ++r) {
        T v[F2];
#pragma unroll
        for (int k = 0; k < F2; ++k) v[k] = base[s * plane + r * row + k];
        RnSort<F2>::run(v);
#pragma unroll
        for (int k = 0; k < F2; ++k) m[r * F2 + k] = v[k];
      }
      RnMerge<F2, F1>::run(m, dst);
    };
#pragma unroll
    for (int s = 0; s < F0 - 1; ++s) plane_run(s, ring[s]);
#pragma unroll 1
    for (int b = 0; b < nz; b += F0) {
#pragma unroll
      for (int u = 0; u < F0; ++u) {
        plane_run(b + u + F0 - 1, ring[(u + F0 - 1) % F0]);
        T w[F0 * RUN];
#pragma unroll
        for (int r = 0; r < F0; ++r) {
#pragma unroll
          for (int q = 0; q < RUN; ++q) w[r * RUN + q] = ring[(u + r) % F0][q];
        }
        const T v = RnPresorted<RUN, F0, RANK>::run(w);
        if (mine && b + u < nz) out[(b + u) * zstride] = v;
      }
    }
  } else {
#pragma unroll
    for (int o = 0; o < R; ++o) {
      T w[K];
      gather_taps<F1, F2, MASK>(w, base + o * plane, plane, row,
                                std::make_integer_sequence<int, K>());
      const T v = RnPruned<K, RANK>::run(w);
      if (mine && o < nz) out[o * zstride] = v;
    }
  }
}

template <typename T, int F0, int F1, int F2, uint64_t MASK, int RANK>
int launch_instance(const void* x, void* y, T cval, const IParams& p,
                    const int* geom, void* stream) {
  const dim3 grid(geom[0], geom[1]), block(geom[2], geom[3]);
  rank_instance_kernel<T, F0, F1, F2, MASK, RANK>
      <<<grid, block, geom[4], (cudaStream_t)stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), cval, p);
  return (int)cudaGetLastError();
}

#define RN_CAT2(a, b) a##b
#define RN_CAT(a, b) RN_CAT2(a, b)
#define RN_THIS_PART RN_CAT(RN_INSTANCES_, RN_PART)
// an instance on int32 or float32 data, where it is built for that type
// (TYPES: bit 0 float32, bit 1 int32)
template <int TYPES, int F0, int F1, int F2, uint64_t MASK, int RANK>
int launch_typed(int is_int, const void* x, void* y, float cval_f, int cval_i,
                 const IParams& p, const int* geom, void* stream) {
  if (is_int) {
    if constexpr ((TYPES & 2) != 0) {
      return launch_instance<int, F0, F1, F2, MASK, RANK>(x, y, cval_i, p,
                                                          geom, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if constexpr ((TYPES & 1) != 0) {
    return launch_instance<float, F0, F1, F2, MASK, RANK>(x, y, cval_f, p,
                                                          geom, stream);
  }
  return (int)cudaErrorInvalidValue;
}

#define RN_CASE(id, f0, f1, f2, mask, rank, types)                           \
  case id:                                                                  \
    return launch_typed<types, f0, f1, f2, mask, rank>(                     \
        is_int, x, y, cval_f, cval_i, p, geom, stream);

}  // namespace

#if RN_PART == 0
// dims: n0, n1, n2.  lo: lo0, lo1, lo2.  plan: a device buffer of
// ngroups x 8 ints (ops/fused_dense.py:plan_buffer), ntaps strip
// offsets, ntaps wires, then nces pairs of wires.  counts: ngroups,
// ntaps, nces, output wire.  geom: grid_x, grid_y, shared bytes.  Returns the
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
#endif  // RN_PART == 0

// Instance `id` of ops/fused_rank.py:INSTANCES (this part's), on int32
// (is_int) or float32 data (ops/fused_rank.py:INSTANCE_TYPES).  dims: n0, n1, n2 (a 2-D array as (n0, 1,
// n1)).  lo: window leads.  vec: 16-byte row loads allowed.  geom:
// grid_x, grid_y, block_x, block_y, shared bytes
// (ops/fused_rank.py:instance_geometry).  Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for an id of another part or a type
// the instance is not built for.
extern "C" int fused_rank_instance(int id, int is_int, const void* x,
                                   void* y, const int* dims, const int* lo,
                                   int mode, float cval_f, int cval_i,
                                   int vec, const int* geom, void* stream) {
  IParams p;
  p.n0 = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  p.lo0 = lo[0];
  p.lo1 = lo[1];
  p.lo2 = lo[2];
  p.mode = mode;
  p.vec = vec;
  switch (id) {
    RN_THIS_PART(RN_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
}
