// Compare-exchange networks of the rank kernel's compile-time
// instances (csrc/fused_rank.cu).  Generated from
// ops/sorting_networks.py by ops/fused_rank.py:write_header; do not
// edit (tests/test_torch_fused_rank.py compares it with a fresh
// copy).
#pragma once

#include "boundary.cuh"

// wire a gets the smaller value, wire b the larger; NaN reaches both
template <class T>
__device__ __forceinline__ void rn_ce(T& a, T& b) {
  const T lo = min_nan(a, b);
  b = max_nan(a, b);
  a = lo;
}

// RnSort<N>::run(v): v[0..N) ascending (Batcher)
template <int N>
struct RnSort;
// RnMerge<RUN, NRUNS>::run(v, o): o[0..RUN*NRUNS) ascending, from
// NRUNS runs each ascending (v[r * RUN + q])
template <int RUN, int NRUNS>
struct RnMerge;
// RnPresorted<RUN, NRUNS, RANK>::run(v): the RANK-th smallest of
// NRUNS ascending runs (v[r * RUN + q]); v is overwritten
template <int RUN, int NRUNS, int RANK>
struct RnPresorted;
// RnPruned<N, RANK>::run(v): the RANK-th smallest of v[0..N)
template <int N, int RANK>
struct RnPruned;

template <>
struct RnSort<3> {
  template <class T>
  __device__ static __forceinline__ void run(T* v) {
    rn_ce(v[0], v[1]);
    rn_ce(v[0], v[2]);
    rn_ce(v[1], v[2]);
  }
};

template <>
struct RnSort<5> {
  template <class T>
  __device__ static __forceinline__ void run(T* v) {
    rn_ce(v[0], v[1]);
    rn_ce(v[2], v[3]);
    rn_ce(v[0], v[2]);
    rn_ce(v[1], v[3]);
    rn_ce(v[1], v[2]);
    rn_ce(v[0], v[4]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
  }
};

template <>
struct RnSort<7> {
  template <class T>
  __device__ static __forceinline__ void run(T* v) {
    rn_ce(v[0], v[1]);
    rn_ce(v[2], v[3]);
    rn_ce(v[0], v[2]);
    rn_ce(v[1], v[3]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[5]);
    rn_ce(v[4], v[6]);
    rn_ce(v[5], v[6]);
    rn_ce(v[0], v[4]);
    rn_ce(v[2], v[6]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[5]);
    rn_ce(v[3], v[5]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
  }
};

template <>
struct RnMerge<3, 1> {
  template <class T>
  __device__ static __forceinline__ void run(T* v, T* o) {
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
  }
};

template <>
struct RnMerge<3, 3> {
  template <class T>
  __device__ static __forceinline__ void run(T* v, T* o) {
    rn_ce(v[0], v[3]);
    rn_ce(v[2], v[5]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[0], v[6]);
    rn_ce(v[3], v[6]);
    rn_ce(v[2], v[8]);
    rn_ce(v[2], v[3]);
    rn_ce(v[8], v[6]);
    rn_ce(v[1], v[7]);
    rn_ce(v[5], v[7]);
    rn_ce(v[4], v[5]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[5], v[8]);
    rn_ce(v[7], v[6]);
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
    o[3] = v[4];
    o[4] = v[3];
    o[5] = v[5];
    o[6] = v[8];
    o[7] = v[7];
    o[8] = v[6];
  }
};

template <>
struct RnMerge<5, 1> {
  template <class T>
  __device__ static __forceinline__ void run(T* v, T* o) {
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
    o[3] = v[3];
    o[4] = v[4];
  }
};

template <>
struct RnMerge<7, 1> {
  template <class T>
  __device__ static __forceinline__ void run(T* v, T* o) {
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
    o[3] = v[3];
    o[4] = v[4];
    o[5] = v[5];
    o[6] = v[6];
  }
};

template <>
struct RnPresorted<3, 3, 1> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[3]);
    rn_ce(v[2], v[5]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[0], v[6]);
    rn_ce(v[3], v[6]);
    rn_ce(v[2], v[8]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[7]);
    rn_ce(v[1], v[2]);
    return v[1];
  }
};

template <>
struct RnPresorted<3, 3, 2> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[3]);
    rn_ce(v[2], v[5]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[0], v[6]);
    rn_ce(v[3], v[6]);
    rn_ce(v[2], v[8]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[7]);
    rn_ce(v[1], v[2]);
    return v[2];
  }
};

template <>
struct RnPresorted<3, 3, 3> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[3]);
    rn_ce(v[2], v[5]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[0], v[6]);
    rn_ce(v[3], v[6]);
    rn_ce(v[2], v[8]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[7]);
    rn_ce(v[5], v[7]);
    rn_ce(v[4], v[5]);
    rn_ce(v[4], v[3]);
    return v[4];
  }
};

template <>
struct RnPresorted<3, 3, 4> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[3]);
    rn_ce(v[2], v[5]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[0], v[6]);
    rn_ce(v[3], v[6]);
    rn_ce(v[2], v[8]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[7]);
    rn_ce(v[5], v[7]);
    rn_ce(v[4], v[5]);
    rn_ce(v[4], v[3]);
    return v[3];
  }
};

template <>
struct RnPresorted<3, 3, 5> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[3]);
    rn_ce(v[2], v[5]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[0], v[6]);
    rn_ce(v[3], v[6]);
    rn_ce(v[2], v[8]);
    rn_ce(v[8], v[6]);
    rn_ce(v[1], v[7]);
    rn_ce(v[5], v[7]);
    rn_ce(v[4], v[5]);
    rn_ce(v[5], v[8]);
    return v[5];
  }
};

template <>
struct RnPresorted<3, 3, 6> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[3]);
    rn_ce(v[2], v[5]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[0], v[6]);
    rn_ce(v[3], v[6]);
    rn_ce(v[2], v[8]);
    rn_ce(v[8], v[6]);
    rn_ce(v[1], v[7]);
    rn_ce(v[5], v[7]);
    rn_ce(v[4], v[5]);
    rn_ce(v[5], v[8]);
    return v[8];
  }
};

template <>
struct RnPresorted<3, 3, 7> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[3]);
    rn_ce(v[2], v[5]);
    rn_ce(v[2], v[3]);
    rn_ce(v[1], v[4]);
    rn_ce(v[1], v[2]);
    rn_ce(v[4], v[3]);
    rn_ce(v[0], v[6]);
    rn_ce(v[3], v[6]);
    rn_ce(v[2], v[8]);
    rn_ce(v[8], v[6]);
    rn_ce(v[1], v[7]);
    rn_ce(v[5], v[7]);
    rn_ce(v[7], v[6]);
    return v[7];
  }
};

template <>
struct RnPresorted<5, 5, 1> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[8], v[5]);
    rn_ce(v[18], v[10]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[22]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[21]);
    rn_ce(v[1], v[2]);
    return v[1];
  }
};

template <>
struct RnPresorted<5, 5, 2> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[8], v[5]);
    rn_ce(v[18], v[10]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[22]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[21]);
    rn_ce(v[1], v[2]);
    return v[2];
  }
};

template <>
struct RnPresorted<5, 5, 3> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[22]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[9]);
    rn_ce(v[3], v[23]);
    rn_ce(v[3], v[6]);
    rn_ce(v[3], v[4]);
    return v[3];
  }
};

template <>
struct RnPresorted<5, 5, 4> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[22]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[9]);
    rn_ce(v[3], v[23]);
    rn_ce(v[3], v[6]);
    rn_ce(v[3], v[4]);
    return v[4];
  }
};

template <>
struct RnPresorted<5, 5, 5> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[7], v[12]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[9]);
    rn_ce(v[3], v[23]);
    rn_ce(v[3], v[6]);
    rn_ce(v[6], v[7]);
    return v[6];
  }
};

template <>
struct RnPresorted<5, 5, 6> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[7], v[12]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[9]);
    rn_ce(v[3], v[23]);
    rn_ce(v[3], v[6]);
    rn_ce(v[6], v[7]);
    return v[7];
  }
};

template <>
struct RnPresorted<5, 5, 7> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[7], v[12]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[9]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[8], v[13]);
    rn_ce(v[8], v[9]);
    rn_ce(v[8], v[5]);
    return v[8];
  }
};

template <>
struct RnPresorted<5, 5, 8> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[7], v[12]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[9]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[8], v[13]);
    rn_ce(v[8], v[9]);
    rn_ce(v[8], v[5]);
    return v[5];
  }
};

template <>
struct RnPresorted<5, 5, 9> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[7], v[12]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[9]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[8], v[13]);
    rn_ce(v[8], v[9]);
    rn_ce(v[9], v[12]);
    return v[9];
  }
};

template <>
struct RnPresorted<5, 5, 10> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[7], v[12]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[9]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[8], v[13]);
    rn_ce(v[8], v[9]);
    rn_ce(v[9], v[12]);
    return v[12];
  }
};

template <>
struct RnPresorted<5, 5, 11> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[7], v[12]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[8], v[13]);
    rn_ce(v[13], v[16]);
    rn_ce(v[13], v[14]);
    return v[13];
  }
};

template <>
struct RnPresorted<5, 5, 12> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[7], v[12]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[8], v[13]);
    rn_ce(v[13], v[16]);
    rn_ce(v[13], v[14]);
    return v[14];
  }
};

template <>
struct RnPresorted<5, 5, 13> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[17], v[15]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[8], v[13]);
    rn_ce(v[13], v[16]);
    rn_ce(v[16], v[17]);
    return v[16];
  }
};

template <>
struct RnPresorted<5, 5, 14> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[17], v[15]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[8], v[13]);
    rn_ce(v[13], v[16]);
    rn_ce(v[16], v[17]);
    return v[17];
  }
};

template <>
struct RnPresorted<5, 5, 15> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[17], v[15]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[18], v[19]);
    rn_ce(v[18], v[11]);
    rn_ce(v[18], v[10]);
    return v[18];
  }
};

template <>
struct RnPresorted<5, 5, 16> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[8], v[5]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[17], v[15]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[18], v[19]);
    rn_ce(v[18], v[11]);
    rn_ce(v[18], v[10]);
    return v[10];
  }
};

template <>
struct RnPresorted<5, 5, 17> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[24], v[20]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[17], v[15]);
    rn_ce(v[15], v[24]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[18], v[19]);
    rn_ce(v[18], v[11]);
    rn_ce(v[11], v[15]);
    return v[11];
  }
};

template <>
struct RnPresorted<5, 5, 18> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[24], v[20]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[17], v[15]);
    rn_ce(v[15], v[24]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[9], v[11]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[18], v[19]);
    rn_ce(v[18], v[11]);
    rn_ce(v[11], v[15]);
    return v[15];
  }
};

template <>
struct RnPresorted<5, 5, 19> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[24], v[20]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[17], v[15]);
    rn_ce(v[15], v[24]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[18], v[19]);
    rn_ce(v[19], v[21]);
    rn_ce(v[19], v[24]);
    return v[19];
  }
};

template <>
struct RnPresorted<5, 5, 20> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[8], v[9]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[9], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[24], v[20]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[12], v[15]);
    rn_ce(v[17], v[15]);
    rn_ce(v[15], v[24]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[18], v[19]);
    rn_ce(v[19], v[21]);
    rn_ce(v[19], v[24]);
    return v[24];
  }
};

template <>
struct RnPresorted<5, 5, 21> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[13], v[14]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[24], v[20]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[22], v[20]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[18], v[19]);
    rn_ce(v[19], v[21]);
    rn_ce(v[21], v[22]);
    return v[21];
  }
};

template <>
struct RnPresorted<5, 5, 22> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[13], v[14]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[24], v[20]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[22], v[20]);
    rn_ce(v[1], v[21]);
    rn_ce(v[11], v[21]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[13], v[19]);
    rn_ce(v[18], v[19]);
    rn_ce(v[19], v[21]);
    rn_ce(v[21], v[22]);
    return v[22];
  }
};

template <>
struct RnPresorted<5, 5, 23> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[5]);
    rn_ce(v[4], v[9]);
    rn_ce(v[4], v[5]);
    rn_ce(v[2], v[7]);
    rn_ce(v[2], v[4]);
    rn_ce(v[7], v[5]);
    rn_ce(v[1], v[6]);
    rn_ce(v[3], v[8]);
    rn_ce(v[3], v[6]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[8], v[5]);
    rn_ce(v[10], v[15]);
    rn_ce(v[14], v[19]);
    rn_ce(v[14], v[15]);
    rn_ce(v[12], v[17]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[15]);
    rn_ce(v[11], v[16]);
    rn_ce(v[13], v[18]);
    rn_ce(v[13], v[16]);
    rn_ce(v[11], v[12]);
    rn_ce(v[13], v[14]);
    rn_ce(v[16], v[17]);
    rn_ce(v[18], v[15]);
    rn_ce(v[0], v[10]);
    rn_ce(v[5], v[15]);
    rn_ce(v[5], v[10]);
    rn_ce(v[4], v[14]);
    rn_ce(v[4], v[5]);
    rn_ce(v[14], v[10]);
    rn_ce(v[2], v[12]);
    rn_ce(v[7], v[17]);
    rn_ce(v[7], v[12]);
    rn_ce(v[2], v[4]);
    rn_ce(v[12], v[14]);
    rn_ce(v[17], v[10]);
    rn_ce(v[1], v[11]);
    rn_ce(v[9], v[19]);
    rn_ce(v[9], v[11]);
    rn_ce(v[6], v[16]);
    rn_ce(v[6], v[9]);
    rn_ce(v[16], v[11]);
    rn_ce(v[3], v[13]);
    rn_ce(v[8], v[18]);
    rn_ce(v[8], v[13]);
    rn_ce(v[3], v[6]);
    rn_ce(v[13], v[16]);
    rn_ce(v[18], v[11]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[13], v[14]);
    rn_ce(v[18], v[10]);
    rn_ce(v[11], v[15]);
    rn_ce(v[0], v[20]);
    rn_ce(v[10], v[20]);
    rn_ce(v[4], v[24]);
    rn_ce(v[14], v[24]);
    rn_ce(v[24], v[20]);
    rn_ce(v[2], v[22]);
    rn_ce(v[15], v[22]);
    rn_ce(v[22], v[20]);
    rn_ce(v[3], v[23]);
    rn_ce(v[19], v[23]);
    rn_ce(v[23], v[20]);
    return v[23];
  }
};

template <>
struct RnPresorted<7, 7, 24> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[7]);
    rn_ce(v[4], v[11]);
    rn_ce(v[4], v[7]);
    rn_ce(v[2], v[9]);
    rn_ce(v[6], v[13]);
    rn_ce(v[6], v[9]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[9], v[11]);
    rn_ce(v[1], v[8]);
    rn_ce(v[5], v[12]);
    rn_ce(v[5], v[8]);
    rn_ce(v[3], v[10]);
    rn_ce(v[3], v[5]);
    rn_ce(v[10], v[8]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[10], v[7]);
    rn_ce(v[8], v[9]);
    rn_ce(v[12], v[11]);
    rn_ce(v[14], v[21]);
    rn_ce(v[18], v[25]);
    rn_ce(v[18], v[21]);
    rn_ce(v[16], v[23]);
    rn_ce(v[20], v[27]);
    rn_ce(v[20], v[23]);
    rn_ce(v[16], v[18]);
    rn_ce(v[20], v[21]);
    rn_ce(v[23], v[25]);
    rn_ce(v[15], v[22]);
    rn_ce(v[19], v[26]);
    rn_ce(v[19], v[22]);
    rn_ce(v[17], v[24]);
    rn_ce(v[17], v[19]);
    rn_ce(v[24], v[22]);
    rn_ce(v[15], v[16]);
    rn_ce(v[17], v[18]);
    rn_ce(v[19], v[20]);
    rn_ce(v[24], v[21]);
    rn_ce(v[22], v[23]);
    rn_ce(v[26], v[25]);
    rn_ce(v[28], v[35]);
    rn_ce(v[32], v[39]);
    rn_ce(v[32], v[35]);
    rn_ce(v[30], v[37]);
    rn_ce(v[34], v[41]);
    rn_ce(v[34], v[37]);
    rn_ce(v[30], v[32]);
    rn_ce(v[34], v[35]);
    rn_ce(v[37], v[39]);
    rn_ce(v[29], v[36]);
    rn_ce(v[33], v[40]);
    rn_ce(v[33], v[36]);
    rn_ce(v[31], v[38]);
    rn_ce(v[31], v[33]);
    rn_ce(v[38], v[36]);
    rn_ce(v[29], v[30]);
    rn_ce(v[31], v[32]);
    rn_ce(v[33], v[34]);
    rn_ce(v[38], v[35]);
    rn_ce(v[36], v[37]);
    rn_ce(v[40], v[39]);
    rn_ce(v[0], v[14]);
    rn_ce(v[7], v[21]);
    rn_ce(v[7], v[14]);
    rn_ce(v[4], v[18]);
    rn_ce(v[11], v[25]);
    rn_ce(v[11], v[18]);
    rn_ce(v[4], v[7]);
    rn_ce(v[11], v[14]);
    rn_ce(v[18], v[21]);
    rn_ce(v[2], v[16]);
    rn_ce(v[9], v[23]);
    rn_ce(v[9], v[16]);
    rn_ce(v[6], v[20]);
    rn_ce(v[6], v[9]);
    rn_ce(v[20], v[16]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[7]);
    rn_ce(v[9], v[11]);
    rn_ce(v[20], v[14]);
    rn_ce(v[16], v[18]);
    rn_ce(v[23], v[21]);
    rn_ce(v[1], v[15]);
    rn_ce(v[8], v[22]);
    rn_ce(v[8], v[15]);
    rn_ce(v[5], v[19]);
    rn_ce(v[13], v[27]);
    rn_ce(v[13], v[19]);
    rn_ce(v[5], v[8]);
    rn_ce(v[13], v[15]);
    rn_ce(v[19], v[22]);
    rn_ce(v[3], v[17]);
    rn_ce(v[12], v[26]);
    rn_ce(v[12], v[17]);
    rn_ce(v[10], v[24]);
    rn_ce(v[10], v[12]);
    rn_ce(v[24], v[17]);
    rn_ce(v[3], v[5]);
    rn_ce(v[10], v[8]);
    rn_ce(v[12], v[13]);
    rn_ce(v[24], v[15]);
    rn_ce(v[17], v[19]);
    rn_ce(v[26], v[22]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[10], v[7]);
    rn_ce(v[8], v[9]);
    rn_ce(v[12], v[11]);
    rn_ce(v[13], v[20]);
    rn_ce(v[24], v[14]);
    rn_ce(v[15], v[16]);
    rn_ce(v[17], v[18]);
    rn_ce(v[19], v[23]);
    rn_ce(v[26], v[21]);
    rn_ce(v[22], v[25]);
    rn_ce(v[28], v[42]);
    rn_ce(v[35], v[42]);
    rn_ce(v[32], v[46]);
    rn_ce(v[39], v[46]);
    rn_ce(v[32], v[35]);
    rn_ce(v[39], v[42]);
    rn_ce(v[30], v[44]);
    rn_ce(v[37], v[44]);
    rn_ce(v[34], v[48]);
    rn_ce(v[34], v[37]);
    rn_ce(v[48], v[44]);
    rn_ce(v[30], v[32]);
    rn_ce(v[34], v[35]);
    rn_ce(v[37], v[39]);
    rn_ce(v[48], v[42]);
    rn_ce(v[44], v[46]);
    rn_ce(v[29], v[43]);
    rn_ce(v[36], v[43]);
    rn_ce(v[33], v[47]);
    rn_ce(v[41], v[47]);
    rn_ce(v[33], v[36]);
    rn_ce(v[41], v[43]);
    rn_ce(v[31], v[45]);
    rn_ce(v[40], v[45]);
    rn_ce(v[38], v[40]);
    rn_ce(v[31], v[33]);
    rn_ce(v[38], v[36]);
    rn_ce(v[40], v[41]);
    rn_ce(v[45], v[43]);
    rn_ce(v[29], v[30]);
    rn_ce(v[31], v[32]);
    rn_ce(v[33], v[34]);
    rn_ce(v[38], v[35]);
    rn_ce(v[36], v[37]);
    rn_ce(v[40], v[39]);
    rn_ce(v[41], v[48]);
    rn_ce(v[45], v[42]);
    rn_ce(v[43], v[44]);
    rn_ce(v[47], v[46]);
    rn_ce(v[0], v[28]);
    rn_ce(v[14], v[42]);
    rn_ce(v[14], v[28]);
    rn_ce(v[7], v[35]);
    rn_ce(v[21], v[35]);
    rn_ce(v[21], v[28]);
    rn_ce(v[4], v[32]);
    rn_ce(v[18], v[46]);
    rn_ce(v[18], v[32]);
    rn_ce(v[11], v[39]);
    rn_ce(v[11], v[18]);
    rn_ce(v[18], v[21]);
    rn_ce(v[2], v[30]);
    rn_ce(v[16], v[44]);
    rn_ce(v[16], v[30]);
    rn_ce(v[9], v[37]);
    rn_ce(v[25], v[37]);
    rn_ce(v[25], v[30]);
    rn_ce(v[6], v[34]);
    rn_ce(v[23], v[34]);
    rn_ce(v[20], v[48]);
    rn_ce(v[20], v[23]);
    rn_ce(v[23], v[25]);
    rn_ce(v[23], v[21]);
    rn_ce(v[1], v[29]);
    rn_ce(v[15], v[43]);
    rn_ce(v[15], v[29]);
    rn_ce(v[8], v[36]);
    rn_ce(v[22], v[36]);
    rn_ce(v[22], v[29]);
    rn_ce(v[5], v[33]);
    rn_ce(v[19], v[33]);
    rn_ce(v[13], v[41]);
    rn_ce(v[13], v[19]);
    rn_ce(v[19], v[22]);
    rn_ce(v[3], v[31]);
    rn_ce(v[17], v[47]);
    rn_ce(v[17], v[31]);
    rn_ce(v[12], v[40]);
    rn_ce(v[27], v[40]);
    rn_ce(v[27], v[31]);
    rn_ce(v[10], v[38]);
    rn_ce(v[26], v[38]);
    rn_ce(v[24], v[45]);
    rn_ce(v[24], v[26]);
    rn_ce(v[26], v[27]);
    rn_ce(v[26], v[22]);
    rn_ce(v[26], v[21]);
    return v[21];
  }
};

template <>
struct RnPresorted<9, 3, 1> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[7], v[8]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[4], v[8]);
    rn_ce(v[2], v[20]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[19]);
    rn_ce(v[1], v[2]);
    return v[1];
  }
};

template <>
struct RnPresorted<9, 3, 2> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[7], v[8]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[4], v[8]);
    rn_ce(v[2], v[20]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[19]);
    rn_ce(v[1], v[2]);
    return v[2];
  }
};

template <>
struct RnPresorted<9, 3, 3> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[4], v[8]);
    rn_ce(v[2], v[20]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[21]);
    rn_ce(v[3], v[5]);
    rn_ce(v[3], v[4]);
    return v[3];
  }
};

template <>
struct RnPresorted<9, 3, 4> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[4], v[8]);
    rn_ce(v[2], v[20]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[21]);
    rn_ce(v[3], v[5]);
    rn_ce(v[3], v[4]);
    return v[4];
  }
};

template <>
struct RnPresorted<9, 3, 5> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[4], v[8]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[6], v[11]);
    rn_ce(v[6], v[8]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[21]);
    rn_ce(v[3], v[5]);
    rn_ce(v[5], v[6]);
    return v[5];
  }
};

template <>
struct RnPresorted<9, 3, 6> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[4], v[8]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[6], v[11]);
    rn_ce(v[6], v[8]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[21]);
    rn_ce(v[3], v[5]);
    rn_ce(v[5], v[6]);
    return v[6];
  }
};

template <>
struct RnPresorted<9, 3, 7> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[4], v[8]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[6], v[11]);
    rn_ce(v[6], v[8]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[7], v[12]);
    rn_ce(v[7], v[10]);
    rn_ce(v[7], v[8]);
    return v[7];
  }
};

template <>
struct RnPresorted<9, 3, 8> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[4], v[8]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[6], v[11]);
    rn_ce(v[6], v[8]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[7], v[12]);
    rn_ce(v[7], v[10]);
    rn_ce(v[7], v[8]);
    return v[8];
  }
};

template <>
struct RnPresorted<9, 3, 9> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[6], v[11]);
    rn_ce(v[11], v[13]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[7], v[12]);
    rn_ce(v[7], v[10]);
    rn_ce(v[10], v[11]);
    return v[10];
  }
};

template <>
struct RnPresorted<9, 3, 10> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[6], v[11]);
    rn_ce(v[11], v[13]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[7], v[12]);
    rn_ce(v[7], v[10]);
    rn_ce(v[10], v[11]);
    return v[11];
  }
};

template <>
struct RnPresorted<9, 3, 11> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[6], v[11]);
    rn_ce(v[11], v[13]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[14], v[17]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[7], v[12]);
    rn_ce(v[12], v[14]);
    rn_ce(v[12], v[13]);
    return v[12];
  }
};

template <>
struct RnPresorted<9, 3, 12> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[6], v[11]);
    rn_ce(v[11], v[13]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[14], v[17]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[7], v[12]);
    rn_ce(v[12], v[14]);
    rn_ce(v[12], v[13]);
    return v[13];
  }
};

template <>
struct RnPresorted<9, 3, 13> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[15], v[20]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[14], v[17]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[7], v[12]);
    rn_ce(v[12], v[14]);
    rn_ce(v[14], v[15]);
    return v[14];
  }
};

template <>
struct RnPresorted<9, 3, 14> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[15], v[20]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[14], v[17]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[7], v[12]);
    rn_ce(v[12], v[14]);
    rn_ce(v[14], v[15]);
    return v[15];
  }
};

template <>
struct RnPresorted<9, 3, 15> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[15], v[20]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[14], v[17]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[16], v[21]);
    rn_ce(v[16], v[17]);
    rn_ce(v[16], v[9]);
    return v[16];
  }
};

template <>
struct RnPresorted<9, 3, 16> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[15], v[20]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[14], v[17]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[16], v[21]);
    rn_ce(v[16], v[17]);
    rn_ce(v[16], v[9]);
    return v[9];
  }
};

template <>
struct RnPresorted<9, 3, 17> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[22], v[26]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[15], v[20]);
    rn_ce(v[20], v[22]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[14], v[17]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[16], v[21]);
    rn_ce(v[16], v[17]);
    rn_ce(v[17], v[20]);
    return v[17];
  }
};

template <>
struct RnPresorted<9, 3, 18> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[22], v[26]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[15], v[20]);
    rn_ce(v[20], v[22]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[10], v[17]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[14], v[17]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[16], v[21]);
    rn_ce(v[16], v[17]);
    rn_ce(v[17], v[20]);
    return v[20];
  }
};

template <>
struct RnPresorted<9, 3, 19> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[22], v[26]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[15], v[20]);
    rn_ce(v[20], v[22]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[23], v[19]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[16], v[21]);
    rn_ce(v[21], v[23]);
    rn_ce(v[21], v[22]);
    return v[21];
  }
};

template <>
struct RnPresorted<9, 3, 20> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[10], v[11]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[22], v[26]);
    rn_ce(v[2], v[20]);
    rn_ce(v[11], v[20]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[15], v[20]);
    rn_ce(v[20], v[22]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[23], v[19]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[16], v[21]);
    rn_ce(v[21], v[23]);
    rn_ce(v[21], v[22]);
    return v[22];
  }
};

template <>
struct RnPresorted<9, 3, 21> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[22], v[26]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[24], v[26]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[23], v[19]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[16], v[21]);
    rn_ce(v[21], v[23]);
    rn_ce(v[23], v[24]);
    return v[23];
  }
};

template <>
struct RnPresorted<9, 3, 22> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[22], v[26]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[24], v[26]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[23], v[19]);
    rn_ce(v[3], v[21]);
    rn_ce(v[12], v[21]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[16], v[21]);
    rn_ce(v[21], v[23]);
    rn_ce(v[23], v[24]);
    return v[24];
  }
};

template <>
struct RnPresorted<9, 3, 23> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[22], v[26]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[24], v[26]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[23], v[19]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[25], v[19]);
    rn_ce(v[25], v[26]);
    return v[25];
  }
};

template <>
struct RnPresorted<9, 3, 24> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[11], v[13]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[3], v[4]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[12], v[13]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[4], v[22]);
    rn_ce(v[13], v[22]);
    rn_ce(v[22], v[26]);
    rn_ce(v[6], v[24]);
    rn_ce(v[15], v[24]);
    rn_ce(v[24], v[26]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[23], v[19]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[25], v[19]);
    rn_ce(v[25], v[26]);
    return v[26];
  }
};

template <>
struct RnPresorted<9, 3, 25> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[9]);
    rn_ce(v[8], v[17]);
    rn_ce(v[8], v[9]);
    rn_ce(v[4], v[13]);
    rn_ce(v[4], v[8]);
    rn_ce(v[13], v[9]);
    rn_ce(v[2], v[11]);
    rn_ce(v[6], v[15]);
    rn_ce(v[6], v[11]);
    rn_ce(v[2], v[4]);
    rn_ce(v[6], v[8]);
    rn_ce(v[15], v[9]);
    rn_ce(v[1], v[10]);
    rn_ce(v[5], v[14]);
    rn_ce(v[5], v[10]);
    rn_ce(v[3], v[12]);
    rn_ce(v[7], v[16]);
    rn_ce(v[7], v[12]);
    rn_ce(v[3], v[5]);
    rn_ce(v[7], v[10]);
    rn_ce(v[12], v[14]);
    rn_ce(v[1], v[2]);
    rn_ce(v[5], v[6]);
    rn_ce(v[7], v[8]);
    rn_ce(v[14], v[15]);
    rn_ce(v[16], v[9]);
    rn_ce(v[0], v[18]);
    rn_ce(v[9], v[18]);
    rn_ce(v[8], v[26]);
    rn_ce(v[26], v[18]);
    rn_ce(v[1], v[19]);
    rn_ce(v[17], v[19]);
    rn_ce(v[5], v[23]);
    rn_ce(v[14], v[23]);
    rn_ce(v[23], v[19]);
    rn_ce(v[7], v[25]);
    rn_ce(v[16], v[25]);
    rn_ce(v[25], v[19]);
    rn_ce(v[19], v[18]);
    return v[19];
  }
};

template <>
struct RnPruned<5, 0> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[1]);
    rn_ce(v[2], v[3]);
    rn_ce(v[0], v[2]);
    rn_ce(v[0], v[4]);
    return v[0];
  }
};

template <>
struct RnPruned<5, 1> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[1]);
    rn_ce(v[2], v[3]);
    rn_ce(v[0], v[2]);
    rn_ce(v[1], v[3]);
    rn_ce(v[1], v[2]);
    rn_ce(v[0], v[4]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[2]);
    return v[1];
  }
};

template <>
struct RnPruned<5, 2> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[1]);
    rn_ce(v[2], v[3]);
    rn_ce(v[0], v[2]);
    rn_ce(v[1], v[3]);
    rn_ce(v[1], v[2]);
    rn_ce(v[0], v[4]);
    rn_ce(v[2], v[4]);
    rn_ce(v[1], v[2]);
    return v[2];
  }
};

template <>
struct RnPruned<5, 3> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[1]);
    rn_ce(v[2], v[3]);
    rn_ce(v[0], v[2]);
    rn_ce(v[1], v[3]);
    rn_ce(v[1], v[2]);
    rn_ce(v[0], v[4]);
    rn_ce(v[2], v[4]);
    rn_ce(v[3], v[4]);
    return v[3];
  }
};

template <>
struct RnPruned<5, 4> {
  template <class T>
  __device__ static __forceinline__ T run(T* v) {
    rn_ce(v[0], v[1]);
    rn_ce(v[2], v[3]);
    rn_ce(v[0], v[2]);
    rn_ce(v[1], v[3]);
    rn_ce(v[1], v[2]);
    rn_ce(v[0], v[4]);
    rn_ce(v[2], v[4]);
    rn_ce(v[3], v[4]);
    return v[4];
  }
};

// The instances: X(id, F0, F1, F2, mask, rank, types), one list a
// part; types: bit 0 float32, bit 1 int32
#define RN_NPARTS 4
#define RN_INSTANCES_0(X) \
  X(0, 3, 1, 3, 0x1ffull, 1, 3) \
  X(3, 3, 1, 3, 0x1ffull, 4, 3) \
  X(9, 5, 1, 5, 0x1ffffffull, 3, 1) \
  X(25, 5, 1, 5, 0x1ffffffull, 19, 1) \
  X(29, 5, 1, 5, 0x1ffffffull, 23, 1) \
  X(33, 3, 3, 3, 0x7ffffffull, 4, 1) \
  X(37, 3, 3, 3, 0x7ffffffull, 8, 1) \
  X(41, 3, 3, 3, 0x7ffffffull, 12, 1) \
  X(43, 3, 3, 3, 0x7ffffffull, 14, 1) \
  X(45, 3, 3, 3, 0x7ffffffull, 16, 1) \
  X(53, 3, 3, 3, 0x7ffffffull, 24, 1) \
  X(55, 7, 1, 7, 0x1ffffffffffffull, 24, 1) \
  X(57, 3, 1, 3, 0xbaull, 1, 3) \
  X(58, 3, 1, 3, 0xbaull, 2, 3)
#define RN_INSTANCES_1(X) \
  X(2, 3, 1, 3, 0x1ffull, 3, 3) \
  X(5, 3, 1, 3, 0x1ffull, 6, 3) \
  X(8, 5, 1, 5, 0x1ffffffull, 2, 1) \
  X(10, 5, 1, 5, 0x1ffffffull, 4, 1) \
  X(11, 5, 1, 5, 0x1ffffffull, 5, 1) \
  X(17, 5, 1, 5, 0x1ffffffull, 11, 1) \
  X(19, 5, 1, 5, 0x1ffffffull, 13, 1) \
  X(22, 5, 1, 5, 0x1ffffffull, 16, 1) \
  X(24, 5, 1, 5, 0x1ffffffull, 18, 1) \
  X(31, 3, 3, 3, 0x7ffffffull, 2, 1) \
  X(35, 3, 3, 3, 0x7ffffffull, 6, 1) \
  X(39, 3, 3, 3, 0x7ffffffull, 10, 1) \
  X(40, 3, 3, 3, 0x7ffffffull, 11, 1) \
  X(42, 3, 3, 3, 0x7ffffffull, 13, 1) \
  X(52, 3, 3, 3, 0x7ffffffull, 23, 1) \
  X(56, 3, 1, 3, 0xbaull, 0, 3)
#define RN_INSTANCES_2(X) \
  X(1, 3, 1, 3, 0x1ffull, 2, 3) \
  X(4, 3, 1, 3, 0x1ffull, 5, 3) \
  X(12, 5, 1, 5, 0x1ffffffull, 6, 1) \
  X(13, 5, 1, 5, 0x1ffffffull, 7, 1) \
  X(14, 5, 1, 5, 0x1ffffffull, 8, 1) \
  X(18, 5, 1, 5, 0x1ffffffull, 12, 1) \
  X(20, 5, 1, 5, 0x1ffffffull, 14, 1) \
  X(28, 5, 1, 5, 0x1ffffffull, 22, 1) \
  X(34, 3, 3, 3, 0x7ffffffull, 5, 1) \
  X(38, 3, 3, 3, 0x7ffffffull, 9, 1) \
  X(44, 3, 3, 3, 0x7ffffffull, 15, 1) \
  X(46, 3, 3, 3, 0x7ffffffull, 17, 1) \
  X(48, 3, 3, 3, 0x7ffffffull, 19, 1) \
  X(50, 3, 3, 3, 0x7ffffffull, 21, 1) \
  X(54, 3, 3, 3, 0x7ffffffull, 25, 1) \
  X(59, 3, 1, 3, 0xbaull, 3, 3)
#define RN_INSTANCES_3(X) \
  X(6, 3, 1, 3, 0x1ffull, 7, 3) \
  X(7, 5, 1, 5, 0x1ffffffull, 1, 1) \
  X(15, 5, 1, 5, 0x1ffffffull, 9, 1) \
  X(16, 5, 1, 5, 0x1ffffffull, 10, 1) \
  X(21, 5, 1, 5, 0x1ffffffull, 15, 1) \
  X(23, 5, 1, 5, 0x1ffffffull, 17, 1) \
  X(26, 5, 1, 5, 0x1ffffffull, 20, 1) \
  X(27, 5, 1, 5, 0x1ffffffull, 21, 1) \
  X(30, 3, 3, 3, 0x7ffffffull, 1, 1) \
  X(32, 3, 3, 3, 0x7ffffffull, 3, 1) \
  X(36, 3, 3, 3, 0x7ffffffull, 7, 1) \
  X(47, 3, 3, 3, 0x7ffffffull, 18, 1) \
  X(49, 3, 3, 3, 0x7ffffffull, 20, 1) \
  X(51, 3, 3, 3, 0x7ffffffull, 22, 1) \
  X(60, 3, 1, 3, 0xbaull, 4, 3)
