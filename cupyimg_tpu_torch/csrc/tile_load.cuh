// Loading a halo'd 2-D tile of one plane of a float32 array into shared
// memory with the ndimage mode applied in the load, shared by the planes
// kernels of csrc/ (blocks of 32 x 8 threads): the interior of a row in
// 16-byte cp.async chunks, only the samples at an edge through the index
// maps (boundary.cuh).
#pragma once

#include <cuda_pipeline.h>
#include <stddef.h>

#include "boundary.cuh"

namespace {

constexpr int kLoadBX = 32;        // threads along a row of the block
constexpr int kLoadThreads = 256;  // threads of the block

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
  const int tid = threadIdx.y * kLoadBX + threadIdx.x;
  for (int i = tid; i < h1 + h2; i += kLoadThreads) {
    bool oob = false;
    const int m = i < h1 ? map_index(r0 + i, n1, mode1, oob)
                         : map_index(c0 + i - h1, n2, mode2, oob);
    row_map[i] = oob ? -1 : m;
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
  for (int i = threadIdx.y * kLoadBX + threadIdx.x; i < h1 * nch;
       i += kLoadThreads) {
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

}  // namespace
