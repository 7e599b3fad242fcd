// Loading a halo'd 2-D tile of one plane of an array into shared memory
// with the ndimage mode applied in the load, shared by the planes kernels
// of csrc/ (blocks of 32 x 8 threads): the interior of a row in 16-byte
// cp.async chunks, only the samples at an edge through the index maps
// (boundary.cuh).  The tile keeps the array's element type: float, or
// __half / __nv_bfloat16 (8 samples a chunk, an edge sample as a load and
// a store).  The separable planes path stages a half type's planes
// through registers instead (load_chunk8, widen8): its passes read float
// tiles, since a conversion on every read costs one instruction a tap on
// a pass that reads each sample K times.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <stddef.h>

#include <type_traits>

#include "boundary.cuh"

namespace {

// float <-> the element types, rounding to nearest even
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class E> __device__ __forceinline__ E from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two samples of a half type from one 32-bit word (sample 0 in the low
// half), as floats: exact
template <class E>
__device__ __forceinline__ float2 unpack2(unsigned w) {
  if constexpr (std::is_same<E, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
}

// the 16 bits of a sample of a half type
template <class E>
__device__ __forceinline__ unsigned short bits_of(E v) {
  return *reinterpret_cast<const unsigned short*>(&v);
}

constexpr int kLoadBX = 32;        // threads along a row of the block
constexpr int kLoadThreads = 256;  // threads of the block

// The 16-byte chunks of a halo'd tile row: the row starts at column
// xa = xs rounded down to a multiple of 4 (xs: the first column the tile
// needs), so sample c of the tile (c >= 0 from xs) is at xs - xa + c.
__device__ __forceinline__ int floor4(int v) {
  return v >= 0 ? (v & ~3) : -((3 - v) & ~3);
}

// v rounded down to a multiple of V, a power of two (floor4 for V = 4)
template <int V>
__device__ __forceinline__ int floor_to(int v) {
  return v >= 0 ? (v & ~(V - 1)) : -((V - 1 - v) & ~(V - 1));
}

// The source row and column of every row and column of a halo'd tile:
// row_map[i] for the h1 rows from r0 on, then (at row_map + h1) the h2
// columns from c0 on; -1 where the mode gives cval.  The same for every
// plane, so mapped once per block (mapped per sample, the modulo
// arithmetic cost more than the filter).
__device__ __forceinline__ void build_maps(int* row_map, int h1, int r0,
                                           int n1, int mode1, int h2, int c0,
                                           int n2, int mode2) {
  const int tid = threadIdx.y * kLoadBX + threadIdx.x;
  for (int i = tid; i < h1 + h2; i += kLoadThreads) {
    bool oob = false;
    const int m = i < h1 ? map_index(r0 + i, n1, mode1, oob)
                         : map_index(c0 + i - h1, n2, mode2, oob);
    row_map[i] = oob ? -1 : m;
  }
}

// Start the copies of the halo'd tile of input plane i0 (an axis-0
// index, mapped here by mode0) into buf (h1 rows of V * nch samples, V =
// 16 / sizeof(E) a chunk, row r from column xa = floor_to<V>(xs) on, xs
// the tile's first column): a 16-byte chunk inside the row as one
// cp.async where rows may be read so, every other sample through the
// column map (col_map[c] for column xs + c, -1 for cval) as a 4-byte
// cp.async (a 2-byte sample, which cp.async cannot copy, as a load and a
// store) or a cval store (cval converted to E once).  Samples left of xs
// or right of the tile's h2 columns are never read (set to 0).  The
// caller commits the group.
template <class E>
__device__ __forceinline__ void load_plane16(
    const E* __restrict__ x, E* buf, int i0, int n0, int mode0,
    int n1, int n2, const int* row_map, const int* col_map, int h1, int h2,
    int nch, int xs, int vec, float cval) {
  constexpr int V = 16 / sizeof(E);
  bool oob0 = false;
  const int m0 = map_index(i0, n0, mode0, oob0);
  const E* plane = x + (size_t)m0 * n1 * n2;
  const int xa = floor_to<V>(xs);
  const E cv = from_f<E>(cval);
  for (int i = threadIdx.y * kLoadBX + threadIdx.x; i < h1 * nch;
       i += kLoadThreads) {
    const int r = i / nch, ch = i - r * nch;
    const int m1 = oob0 ? -1 : row_map[r];
    E* dst = buf + r * V * nch + V * ch;
    if (m1 < 0) {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = cv;
      continue;
    }
    const E* row = plane + (size_t)m1 * n2;
    const int c = xa + V * ch;
    if (vec && c >= 0 && c + V <= n2) {
      __pipeline_memcpy_async(dst, row + c, 16);
      continue;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int t = c + e - xs;
      const int m2 = t >= 0 && t < h2 ? col_map[t] : -2;
      if (m2 >= 0) {
        if constexpr (sizeof(E) == 4) {
          __pipeline_memcpy_async(dst + e, row + m2, sizeof(E));
        } else {
          dst[e] = row[m2];
        }
      } else {
        dst[e] = m2 == -1 ? cv : from_f<E>(0.f);
      }
    }
  }
}

// The 8 samples of a half type's chunk i of a halo'd tile row (row i /
// nch, samples from column xa + 8 (i % nch) on, xa = floor_to<8>(xs)) of
// the plane at `plane` (oob0: outside a constant-mode axis 0), as raw bits
// (sample 2k in the low half of word k): one 16-byte load inside the row
// where rows may be read so, else each sample through the maps (cval, or
// 0 for a sample no pass reads), as load_plane16 maps them.  The half
// types' planes path stages its planes through registers with it.
template <class E>
__device__ __forceinline__ uint4 load_chunk8(
    const E* __restrict__ plane, bool oob0, int i, int nch, int n2,
    const int* row_map, const int* col_map, int h2, int xs, int vec,
    unsigned cvbits) {
  const int r = i / nch, ch = i - r * nch;
  const int m1 = oob0 ? -1 : row_map[r];
  if (m1 < 0) {
    const unsigned w = cvbits | cvbits << 16;
    return make_uint4(w, w, w, w);
  }
  const E* row = plane + (size_t)m1 * n2;
  const int c = floor_to<8>(xs) + 8 * ch;
  if (vec && c >= 0 && c + 8 <= n2) {
    return __ldg(reinterpret_cast<const uint4*>(row + c));
  }
  const unsigned short* rs = reinterpret_cast<const unsigned short*>(row);
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned h[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = c + 2 * k + q - xs;
      const int m2 = t >= 0 && t < h2 ? col_map[t] : -2;
      h[q] = m2 >= 0 ? (unsigned)__ldg(rs + m2) : m2 == -1 ? cvbits : 0u;
    }
    w[k] = h[0] | h[1] << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A chunk's 8 raw half samples, widened to float at dst (16-byte aligned)
// as two float4 stores.
template <class E>
__device__ __forceinline__ void widen8(uint4 b, float* dst) {
  const float2 a0 = unpack2<E>(b.x), a1 = unpack2<E>(b.y),
               a2 = unpack2<E>(b.z), a3 = unpack2<E>(b.w);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a0.x, a0.y, a1.x, a1.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(a2.x, a2.y, a3.x, a3.y);
}

}  // namespace
