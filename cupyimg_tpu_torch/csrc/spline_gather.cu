// B-spline gather at per-output coordinates: scipy.ndimage interpolation
// (affine_transform, rotate, shift, zoom, map_coordinates) for 1-D to 3-D
// float32/float64 data, real or complex, orders 0-5, every ndimage mode.
//
// Replaces the TPU kernels of cupyimg_tpu's interpolation path:
//   B6 ops/gtg_interp.py:_make_kernel (affine_gtg_2d, affine_gtg_batched2d)
//   B7 ops/warp_gather.py:_make_kernel (map_gather_2d)
//   B8 ops/pallas_interp.py:_make_affine_kernel (affine_pallas)
//   B9 ops/pallas_interp.py:_make_map_kernel (map_pallas)
// The TPU needed routing plans, slabs and fixed-point tap floors to turn a
// gather into matmuls and lane moves; on Hopper a thread simply gathers.
//
// Two kernels of the same arithmetic:
//
// - spline_gather_fast<T, C, NC, Os...>: one instance per data type T,
//   coordinate type C, component count NC (1 real, 2 complex, loaded as
//   one float2/double2) and per-axis spline orders Os (the number of axes
//   is the pack's length).  Tap counts are compile-time, every loop over
//   axes and taps unrolls, and the taps, weights and flags live in
//   registers.  Indices are 32-bit (the host takes this instance only
//   below 2^31 elements).  The affine entry launches a 3-D grid: blockIdx.y
//   and .z walk the outer output axes, so no output index is unravelled by
//   division, and the coordinate's first ND-1 matrix terms (fixed along a
//   row) are summed once per row; each thread then takes kPerThread outputs
//   of the row, blockDim.x apart, adding the last term and the offset per
//   output in scipy's order (a block of a short row takes several rows,
//   blockDim.y of them).  The map entry reads its coordinates from a
//   (ND, n_out) field.  The boundary mode is a runtime value read only when
//   a coordinate or a tap leaves the domain: inside it every mode's premap
//   and tap map is the identity.  The instances compiled are the patterns
//   of SG_AFFINE_PATTERNS / SG_MAP_PATTERNS below, which
//   ops/spline_gather.py:AFFINE_PATTERNS / MAP_PATTERNS mirror; the source
//   is compiled once per (T, C, NC) part (-DSG_PART), in parallel.
// - spline_gather_kernel<T, C, kMap>: the generic instance, for any other
//   combination (mixed orders, 2^31 elements or more): runtime orders and
//   ndim (padded to three axes), 64-bit indices, one output per thread in a
//   grid-stride loop.  Built into part 0.
//
// Arithmetic, shared by both: from the coordinate each axis takes its
// taps, weights and out-of-domain flags exactly as ops/interp.py:axis_taps
// does (premap, round-half-up for order 0, the spline boundary family for
// order >= 2, per-tap cval for grid-constant), and the (order+1)^ndim taps
// are summed in the data's type, axis 0's taps slowest, as gather_general
// sums them.  An axis with order 0 and an identity matrix row reads one
// plane, which is how a volume rotate resamples every plane with the same
// 2-D affine.  Coordinates and weights are formed in C (double unless the
// caller asks for float); each tap's value is multiplied by its axes'
// weights in turn, axis 0 first, in the wider of T and C, then cast to T:
// scipy's order, which decides rounding ties of integer outputs as scipy
// does.  Built with -fmad=false so that every product and sum is rounded
// as the plain PyTorch version rounds it.
//
// Bound: bytes (one read of the input and one write of the output, plus
// the coordinate field for spline_map) when the taps hit L1/L2, else the
// float64 coordinate and weight arithmetic per output; the taps are read
// through the read-only cache (__ldg).  No shared-memory tiling.

#include <cuda_runtime.h>

#include <type_traits>

#include "boundary.cuh"

#ifndef SG_PART
#define SG_PART 0
#endif

namespace {

constexpr int kMaxDim = 3;
constexpr int kMaxTaps = 6;  // order 5
constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // outputs per thread of the fast kernel

// interpolation modes, as ops/spline_gather.py:_MODE_CODES assigns them
constexpr int kIReflect = 0;  // reflect
constexpr int kIGridMirror = 1;
constexpr int kIMirror = 2;
constexpr int kINearest = 3;
constexpr int kIWrap = 4;
constexpr int kIGridWrap = 5;
constexpr int kIConstant = 6;
constexpr int kIGridConstant = 7;
// tap map codes beyond boundary.cuh's: per-tap oob, and clamp only
constexpr int kTapGridConstant = 10;
constexpr int kTapClamp = 11;

// the order patterns with an instance of their own, per entry: every
// uniform order of 1-3 axes, and (affine) a volume rotate's patterns, one
// axis of order 0 and two of the same order
#define SG_UNIFORM_PATTERNS(X)                                              \
  X(0) X(1) X(2) X(3) X(4) X(5)                                             \
  X(0, 0) X(1, 1) X(2, 2) X(3, 3) X(4, 4) X(5, 5)                           \
  X(0, 0, 0) X(1, 1, 1) X(2, 2, 2) X(3, 3, 3) X(4, 4, 4) X(5, 5, 5)
#define SG_AFFINE_PATTERNS(X)                                               \
  SG_UNIFORM_PATTERNS(X)                                                    \
  X(0, 1, 1) X(0, 2, 2) X(0, 3, 3) X(0, 4, 4) X(0, 5, 5)                    \
  X(1, 0, 1) X(2, 0, 2) X(3, 0, 3) X(4, 0, 4) X(5, 0, 5)                    \
  X(1, 1, 0) X(2, 2, 0) X(3, 3, 0) X(4, 4, 0) X(5, 5, 0)
#define SG_MAP_PATTERNS(X) SG_UNIFORM_PATTERNS(X)

// an instance's key: the number of axes, then each axis' order, as decimal
// digits (ops/spline_gather.py:pattern_key)
template <int... Os>
constexpr int key_of() {
  int k = static_cast<int>(sizeof...(Os));
  ((k = k * 10 + Os), ...);
  return k;
}

// the float boundary premap of ops/interp.py:premap_coord
template <typename C>
__device__ __forceinline__ C premap(C c, int n, int mode) {
  if (mode == kIConstant || mode == kIGridConstant) return c;
  if (mode == kIWrap) {
    if (n == 1) return C(0);
    const C period = C(n - 1);
    if (c < C(0)) return c + period * (trunc(-c / period) + C(1));
    if (c > period) return c - period * trunc(c / period);
    return c;
  }
  if (n == 1) return C(0);
  if (mode == kINearest) return fmin(fmax(c, C(0)), C(n - 1));
  if (mode == kIGridWrap) return c - C(n) * floor(c / C(n));
  if (mode == kIMirror) {
    const C sz2 = C(2) * C(n) - C(2);
    if (c < C(0)) {
      C cn = c < -sz2 ? sz2 * trunc(-c / sz2) + c : c;
      return cn <= C(1) - C(n) ? cn + sz2 : -cn;
    }
    if (c > C(n - 1)) {
      C cp = c - sz2 * trunc(c / sz2);
      return cp >= C(n) ? sz2 - cp : cp;
    }
    return c;
  }
  // reflect, grid-mirror
  const C sz2 = C(2) * C(n);
  if (c < C(0)) {
    C cn = c < -sz2 ? sz2 * trunc(-c / sz2) + c : c;
    return cn < -C(n) ? cn + sz2 : -cn - C(1);
  }
  if (c > C(n - 1)) {
    C cp = c - sz2 * trunc(c / sz2);
    return cp >= C(n) ? sz2 - cp - C(1) : cp;
  }
  return c;
}

// the integer first tap: clamped (as a float) to a range where every tap
// of a far-out coordinate stays out of the domain, then cast
template <typename C>
__device__ __forceinline__ int first_tap(C f, int n, int order) {
  f = fmin(fmax(f, C(-(order + 3))), C(n + order + 2));
  return int(f);
}

// ops/interp.py:_map_tap
__device__ __forceinline__ int map_tap(int i, int n, int tap_mode,
                                       bool& oob) {
  if (tap_mode == kTapGridConstant) {
    if (i < 0 || i >= n) oob = true;
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
  }
  if (tap_mode == kTapClamp) return i < 0 ? 0 : (i >= n ? n - 1 : i);
  bool unused = false;
  return map_index(i, n, tap_mode, unused);
}

// tap map of order 0 and 1 for each interpolation mode
__device__ __forceinline__ int low_order_tap_mode(int mode) {
  switch (mode) {
    case kIReflect:
    case kIGridMirror: return kReflect;
    case kIMirror: return kMirror;
    case kINearest: return kNearest;
    case kIWrap:
    case kIGridWrap: return kWrap;
    case kIConstant: return kTapClamp;
    default: return kTapGridConstant;
  }
}

// tap map of order >= 2: the spline boundary family (iir.get_spline_mode)
__device__ __forceinline__ int spline_tap_mode(int mode) {
  switch (mode) {
    case kIGridConstant: return kTapGridConstant;
    case kINearest: return kNearest;
    case kIReflect:
    case kIGridMirror: return kReflect;
    case kIGridWrap: return kWrap;
    default: return kMirror;  // mirror, wrap, constant
  }
}

// ops/interp.py:spline_weights of order O >= 2, operation for operation
template <int O, typename C>
__device__ __forceinline__ void spline_weights(C t, C* w) {
  const C one = C(1);
  if constexpr (O == 2) {
    C w1 = C(0.75) - t * t;
    C y = C(0.5) - t;
    C w0 = C(0.5) * y * y;
    w[0] = w0;
    w[1] = w1;
    w[2] = one - w0 - w1;
  } else if constexpr (O == 3) {
    C y = one - t;
    C w1 = (t * t * (t - C(2)) * C(3) + C(4)) / C(6);
    C w2 = (y * y * (y - C(2)) * C(3) + C(4)) / C(6);
    C w0 = y * y * y / C(6);
    w[0] = w0;
    w[1] = w1;
    w[2] = w2;
    w[3] = one - w0 - w1 - w2;
  } else if constexpr (O == 4) {
    C y = t * t;
    C w2 = y * (y * C(0.25) - C(0.625)) + C(115.0 / 192.0);
    y = one + t;
    C w1 = y * (y * (y * (C(5) - y) / C(6) - C(1.25)) + C(5.0 / 24.0)) +
           C(55.0 / 96.0);
    y = one - t;
    C w3 = y * (y * (y * (C(5) - y) / C(6) - C(1.25)) + C(5.0 / 24.0)) +
           C(55.0 / 96.0);
    y = C(0.5) - t;
    y = y * y;
    C w0 = y * y / C(24);
    w[0] = w0;
    w[1] = w1;
    w[2] = w2;
    w[3] = w3;
    w[4] = one - w0 - w1 - w2 - w3;
  } else {  // 5
    C y = t * t;
    C w2 = y * (y * (C(0.25) - t / C(12)) - C(0.5)) + C(0.55);
    y = one - t;
    C yy = y * y;
    C w3 = yy * (yy * (C(0.25) - (one - t) / C(12)) - C(0.5)) + C(0.55);
    y = t + one;
    C w1 = y * (y * (y * (y * (y / C(24) - C(0.375)) + C(1.25)) - C(1.75)) +
                C(0.625)) +
           C(0.425);
    y = C(2) - t;
    C w4 = y * (y * (y * (y * (y / C(24) - C(0.375)) + C(1.25)) - C(1.75)) +
                C(0.625)) +
           C(0.425);
    y = one - t;
    yy = y * y;
    C w0 = (one - t) * yy * yy / C(120);
    w[0] = w0;
    w[1] = w1;
    w[2] = w2;
    w[3] = w3;
    w[4] = w4;
    w[5] = one - w0 - w1 - w2 - w3 - w4;
  }
}

// ops/interp.py:axis_taps for one coordinate of an axis of order O.  A
// coordinate inside [0, n-1] needs no premap (every mode's is the
// identity there) and taps inside [0, n) no tap map: only the others read
// `mode`.
template <int O, typename C>
__device__ __forceinline__ void axis_taps(C c, int n, int mode, int* idx,
                                          C* w, bool* oob) {
  C d = (c >= C(0) && c <= C(n - 1)) ? c : premap(c, n, mode);
#pragma unroll
  for (int k = 0; k <= O; ++k) oob[k] = false;
  int start;
  if constexpr (O == 0) {
    start = first_tap(floor(d + C(0.5)), n, 0);
  } else if constexpr (O == 1) {
    const C f = floor(d);
    w[1] = d - f;
    w[0] = C(1) - w[1];
    start = first_tap(f, n, 1);
  } else {
    if (mode == kINearest)
      d = fmin(fmax(c, C(-(O + 2))), C(n + O + 1));
    const C f = (O & 1) ? floor(d) : floor(d + C(0.5));
    spline_weights<O>(d - f, w);
    start = first_tap(f, n, O) - O / 2;
  }
  if (start >= 0 && start + O < n) {
#pragma unroll
    for (int k = 0; k <= O; ++k) idx[k] = start + k;
  } else {
    const int tm = O <= 1 ? low_order_tap_mode(mode) : spline_tap_mode(mode);
#pragma unroll
    for (int k = 0; k <= O; ++k) idx[k] = map_tap(start + k, n, tm, oob[k]);
  }
}

// the generic instance's runtime-order form of axis_taps; returns the tap
// count
template <typename C>
__device__ __forceinline__ int axis_taps_any(C c, int n, int order, int mode,
                                             int* idx, C* w, bool* oob) {
  switch (order) {
    case 0: axis_taps<0>(c, n, mode, idx, w, oob); break;
    case 1: axis_taps<1>(c, n, mode, idx, w, oob); break;
    case 2: axis_taps<2>(c, n, mode, idx, w, oob); break;
    case 3: axis_taps<3>(c, n, mode, idx, w, oob); break;
    case 4: axis_taps<4>(c, n, mode, idx, w, oob); break;
    default: axis_taps<5>(c, n, mode, idx, w, oob); break;
  }
  return order + 1;
}

// ---------------------------------------------------------------------------
// the fast instances
// ---------------------------------------------------------------------------

struct FastParams {
  int in_dims[kMaxDim];   // the first ND used
  int out_dims[kMaxDim];  // affine: the first ND used
  double matrix[kMaxDim * kMaxDim];  // ND x ND, row-major
  double offset[kMaxDim];
  double pre[kMaxDim];  // added to the output index before the matrix
  int mode;
  double cval[2];
  int n_out;
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

template <typename T, int NC>
__device__ __forceinline__ void load_sample(const T* __restrict__ x, int i,
                                            T* v) {
  if constexpr (NC == 1) {
    v[0] = __ldg(x + i);
  } else {
    const auto u = __ldg(reinterpret_cast<const typename Pair<T>::type*>(x) +
                         i);
    v[0] = u.x;
    v[1] = u.y;
  }
}

template <typename T, int NC>
__device__ __forceinline__ void store_sample(T* __restrict__ out, int i,
                                             const T* v) {
  if constexpr (NC == 1) {
    out[i] = v[0];
  } else {
    typename Pair<T>::type u;
    u.x = v[0];
    u.y = v[1];
    reinterpret_cast<typename Pair<T>::type*>(out)[i] = u;
  }
}

// the taps of the axes after axis j: tap t of an instance reads tap
// (t / tap_span(j)) % (order_j + 1) of axis j
template <int... Os>
__host__ __device__ constexpr int tap_span(int j) {
  constexpr int kOrd[] = {Os...};
  int span = 1;
  for (int i = j + 1; i < static_cast<int>(sizeof...(Os)); ++i)
    span *= kOrd[i] + 1;
  return span;
}

// axis J's taps, and whether the coordinate is outside a constant-mode
// domain; then the next axis
template <int J, typename C, int... Os>
__device__ __forceinline__ void taps_from(const C* c, const int* n, int mode,
                                          int (*idx)[kMaxTaps],
                                          C (*w)[kMaxTaps],
                                          bool (*oob)[kMaxTaps],
                                          bool& outside) {
  if constexpr (J < static_cast<int>(sizeof...(Os))) {
    constexpr int kOrd[] = {Os...};
    if (mode == kIConstant && (c[J] < C(0) || c[J] > C(n[J] - 1)))
      outside = true;
    axis_taps<kOrd[J]>(c[J], n[J], mode, idx[J], w[J], oob[J]);
    taps_from<J + 1, C, Os...>(c, n, mode, idx, w, oob, outside);
  }
}

// the sample at coordinate c (one per axis), every tap of every axis
template <typename T, typename C, int NC, int... Os>
__device__ __forceinline__ void sample(const T* __restrict__ x, const C* c,
                                       const int* n, const FastParams& p,
                                       T* acc) {
  using W = decltype(T(0) * C(0));
  constexpr int ND = sizeof...(Os);
  constexpr int kOrd[] = {Os...};
  constexpr int NT = (1 * ... * (Os + 1));
  // tap t's index on axis j is (t / kSpan[j]) % (kOrd[j] + 1)
  constexpr int kSpan[kMaxDim] = {tap_span<Os...>(0), tap_span<Os...>(1),
                                  tap_span<Os...>(2)};
  int idx[ND][kMaxTaps];
  C w[ND][kMaxTaps];
  bool oob[ND][kMaxTaps];
  bool outside = false;
  taps_from<0, C, Os...>(c, n, p.mode, idx, w, oob, outside);
#pragma unroll
  for (int q = 0; q < NC; ++q) acc[q] = T(0);
  if (outside) {
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[q] = T(p.cval[q]);
    return;
  }
  // the taps' flat offsets per axis, the axis' input stride folded in
  int stride = 1;
#pragma unroll
  for (int j = ND - 1; j >= 0; --j) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k)
      if (k <= kOrd[j]) idx[j][k] *= stride;
    stride *= n[j];
  }
  T cv[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) cv[q] = T(p.cval[q]);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    int flat = 0;
    bool out_tap = false;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int a = (t / kSpan[j]) % (kOrd[j] + 1);
      flat += idx[j][a];
      out_tap |= oob[j][a];
    }
    T v[NC];
    load_sample<T, NC>(x, flat, v);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      // the tap's value times each weighted axis' weight in turn, axis 0
      // first, in W, then cast to T: scipy's order
      W s = W(out_tap ? cv[q] : v[q]);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        if (kOrd[j] > 0) s = s * W(w[j][(t / kSpan[j]) % (kOrd[j] + 1)]);
      acc[q] = acc[q] + T(s);
    }
  }
}

// unroll a thread's outputs (for more loads in flight) only where an
// output has few taps: unrolling a large tap product multiplies the code
template <int... Os>
__host__ __device__ constexpr bool unroll_outputs() {
  return (1 * ... * (Os + 1)) <= 4;
}

// the thread's outputs of the block's run [blockIdx.x * blockDim.x *
// kPerThread, ...) below n: blockDim.x apart, kPerThread of them
template <bool kUnroll, typename F>
__device__ __forceinline__ void per_thread(int n, F&& one) {
  const int step = blockDim.x;
  const int o0 = blockIdx.x * (step * kPerThread) + threadIdx.x;
  if constexpr (kUnroll) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      if (o0 + i * step < n) one(o0 + i * step);
  } else {
#pragma unroll 1
    for (int i = 0; i < kPerThread; ++i)
      if (o0 + i * step < n) one(o0 + i * step);
  }
}

template <typename T, typename C, int NC, int... Os>
__global__ void __launch_bounds__(kThreads)
affine_fast_kernel(const T* __restrict__ x, T* __restrict__ out,
                   FastParams p) {
  constexpr int ND = sizeof...(Os);
  int n[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) n[j] = p.in_dims[j];
  const int nl = p.out_dims[ND - 1];
  const int ny = ND >= 2 ? p.out_dims[ND - 2] : 1;
  const int nz = ND >= 3 ? p.out_dims[ND - 3] : 1;
  C ml[ND], off[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    ml[j] = C(p.matrix[j * ND + ND - 1]);
    off[j] = C(p.offset[j]);
  }
  const C pre_l = C(p.pre[ND - 1]);
  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < ny;
         y += gridDim.y * blockDim.y) {
      // the matrix terms of the outer axes, summed once per row
      int oi[kMaxDim] = {0, 0, 0};
      if (ND >= 3) oi[ND >= 3 ? ND - 3 : 0] = z;
      if (ND >= 2) oi[ND >= 2 ? ND - 2 : 0] = y;
      C part[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        part[j] = C(0);
#pragma unroll
        for (int k = 0; k < ND - 1; ++k)
          part[j] = part[j] + C(p.matrix[j * ND + k]) *
                                  (C(oi[k]) + C(p.pre[k]));
      }
      const int row = (z * ny + y) * nl;
      per_thread<unroll_outputs<Os...>()>(nl, [&](int o) {
        C c[ND];
#pragma unroll
        for (int j = 0; j < ND; ++j)
          c[j] = (part[j] + ml[j] * (C(o) + pre_l)) + off[j];
        T acc[NC];
        sample<T, C, NC, Os...>(x, c, n, p, acc);
        store_sample<T, NC>(out, row + o, acc);
      });
    }
  }
}

template <typename T, typename C, int NC, int... Os>
__global__ void __launch_bounds__(kThreads)
map_fast_kernel(const T* __restrict__ x, const C* __restrict__ coords,
                T* __restrict__ out, FastParams p) {
  constexpr int ND = sizeof...(Os);
  int n[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) n[j] = p.in_dims[j];
  const int n_out = p.n_out;
  per_thread<unroll_outputs<Os...>()>(n_out, [&](int o) {
    C c[ND];
#pragma unroll
    for (int j = 0; j < ND; ++j) c[j] = __ldg(coords + j * n_out + o);
    T acc[NC];
    sample<T, C, NC, Os...>(x, c, n, p, acc);
    store_sample<T, NC>(out, o, acc);
  });
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        v <= 0)
      return 132;
    count[dev] = v;
  }
  return count[dev];
}

template <typename T, typename C, int NC, int... Os>
int launch_affine_fast(const void* x, void* out, const FastParams& p,
                       cudaStream_t stream) {
  constexpr int ND = sizeof...(Os);
  const int nl = p.out_dims[ND - 1];
  // a short row takes fewer threads a block, and the block more rows
  int tx = kThreads;
  while (tx > 32 && (tx / 2) * kPerThread >= nl) tx /= 2;
  const int ty = kThreads / tx;
  const unsigned bx = (nl + tx * kPerThread - 1) / (tx * kPerThread);
  const int ny = ND >= 2 ? p.out_dims[ND >= 2 ? ND - 2 : 0] : 1;
  const int nz = ND >= 3 ? p.out_dims[0] : 1;
  // rows and planes beyond the grid are walked by the kernel's loops
  const int rows = (ny + ty - 1) / ty;
  const unsigned by = rows < 65535 ? rows : 65535;
  const unsigned bz = nz < 65535 ? nz : 65535;
  affine_fast_kernel<T, C, NC, Os...><<<dim3(bx, by, bz), dim3(tx, ty), 0,
                                        stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C, int NC, int... Os>
int launch_map_fast(const void* x, const void* coords, void* out,
                    const FastParams& p, cudaStream_t stream) {
  const unsigned bx = (p.n_out + kThreads * kPerThread - 1) /
                      (kThreads * kPerThread);
  map_fast_kernel<T, C, NC, Os...><<<bx, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const C*>(coords),
      static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// this part's data type, coordinate type and component count
constexpr int kPartT = (SG_PART >> 2) & 1;  // 0 float32, 1 float64
constexpr int kPartC = (SG_PART >> 1) & 1;
constexpr int kPartNC = (SG_PART & 1) + 1;
using PartT = typename std::conditional<kPartT == 1, double, float>::type;
using PartC = typename std::conditional<kPartC == 1, double, float>::type;

FastParams fast_params(int ndim, const int* in_dims, int mode,
                       double cval_re, double cval_im) {
  FastParams p = {};
  for (int j = 0; j < ndim; ++j) p.in_dims[j] = in_dims[j];
  p.mode = mode;
  p.cval[0] = cval_re;
  p.cval[1] = cval_im;
  return p;
}

// ---------------------------------------------------------------------------
// the generic instance
// ---------------------------------------------------------------------------

struct Params {
  long long in_dims[kMaxDim];
  long long out_dims[kMaxDim];
  double matrix[kMaxDim * kMaxDim];
  double offset[kMaxDim];
  double pre[kMaxDim];  // added to the output index before the matrix
  int orders[kMaxDim];
  int ndim_coords;  // spline_map: axes present in the coordinate field
  int mode;
  int ncomp;        // 1 real, 2 complex (interleaved re, im)
  double cval[2];
  long long n_out;
};

template <typename T, typename C, bool kMap>
__global__ void __launch_bounds__(kThreads)
spline_gather_kernel(const T* __restrict__ x, const C* __restrict__ coords,
                     T* __restrict__ out, Params p) {
  // the wider of the data's and the coordinates' types
  using W = decltype(T(0) * C(0));
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       o < p.n_out; o += stride) {
    // the output index, axis 2 fastest
    long long oi[kMaxDim];
    long long rest = o;
    for (int j = kMaxDim - 1; j >= 0; --j) {
      oi[j] = rest % p.out_dims[j];
      rest /= p.out_dims[j];
    }
    int idx[kMaxDim][kMaxTaps];
    C w[kMaxDim][kMaxTaps];
    bool oob[kMaxDim][kMaxTaps];
    int nt[kMaxDim];
    bool outside = false;
    for (int j = 0; j < kMaxDim; ++j) {
      C c;
      if (kMap) {
        const int r = j - (kMaxDim - p.ndim_coords);
        c = r < 0 ? C(0) : __ldg(coords + (long long)r * p.n_out + o);
      } else {
        // matrix terms first, offset last (scipy's summation order)
        c = C(0);
        for (int k = 0; k < kMaxDim; ++k)
          c = c + C(p.matrix[j * kMaxDim + k]) * (C(oi[k]) + C(p.pre[k]));
        c = c + C(p.offset[j]);
      }
      const int n = (int)p.in_dims[j];
      if (p.mode == kIConstant && (c < C(0) || c > C(n - 1))) outside = true;
      nt[j] = axis_taps_any(c, n, p.orders[j], p.mode, idx[j], w[j], oob[j]);
    }
    T acc[2] = {T(0), T(0)};
    if (outside) {
      acc[0] = T(p.cval[0]);
      acc[1] = T(p.cval[1]);
    } else {
      const long long n1 = p.in_dims[1], n2 = p.in_dims[2];
      for (int a = 0; a < nt[0]; ++a) {
        for (int b = 0; b < nt[1]; ++b) {
          for (int e = 0; e < nt[2]; ++e) {
            const int t3[kMaxDim] = {a, b, e};
            bool out_tap = false;
            for (int j = 0; j < kMaxDim; ++j) out_tap |= oob[j][t3[j]];
            const long long flat =
                ((long long)idx[0][a] * n1 + idx[1][b]) * n2 + idx[2][e];
            for (int q = 0; q < p.ncomp; ++q) {
              // the tap's value times each weighted axis' weight in
              // turn, axis 0 first, in W, then cast to T: scipy's order
              W v = W(out_tap ? T(p.cval[q])
                              : __ldg(x + flat * p.ncomp + q));
              for (int j = 0; j < kMaxDim; ++j)
                if (p.orders[j] > 0) v = v * W(w[j][t3[j]]);
              acc[q] = acc[q] + T(v);
            }
          }
        }
      }
    }
    for (int q = 0; q < p.ncomp; ++q) out[o * p.ncomp + q] = acc[q];
  }
}

template <typename T, typename C, bool kMap>
int launch(const void* x, const void* coords, void* out, const Params& p,
           cudaStream_t stream) {
  long long blocks = (p.n_out + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 16;
  if (blocks > cap) blocks = cap;  // grid-stride beyond
  spline_gather_kernel<T, C, kMap><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const C*>(coords),
      static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

template <bool kMap>
int dispatch(const void* x, const void* coords, void* out, int dtype,
             int cdtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0 && cdtype == 0)
    return launch<float, float, kMap>(x, coords, out, p, stream);
  if (dtype == 0 && cdtype == 1)
    return launch<float, double, kMap>(x, coords, out, p, stream);
  if (dtype == 1 && cdtype == 0)
    return launch<double, float, kMap>(x, coords, out, p, stream);
  if (dtype == 1 && cdtype == 1)
    return launch<double, double, kMap>(x, coords, out, p, stream);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const long long* in_dims, const long long* out_dims,
                   const int* orders, int mode, int ncomp, double cval_re,
                   double cval_im) {
  Params p;
  p.n_out = 1;
  for (int j = 0; j < kMaxDim; ++j) {
    p.in_dims[j] = in_dims[j];
    p.out_dims[j] = out_dims[j];
    p.orders[j] = orders[j];
    p.offset[j] = 0.0;
    p.pre[j] = 0.0;
    p.n_out *= out_dims[j];
  }
  for (int k = 0; k < kMaxDim * kMaxDim; ++k) p.matrix[k] = 0.0;
  p.ndim_coords = kMaxDim;
  p.mode = mode;
  p.ncomp = ncomp;
  p.cval[0] = cval_re;
  p.cval[1] = cval_im;
  return p;
}

}  // namespace

// The fast instances of this part.  dtype / cdtype: 0 float32, 1 float64;
// they and ncomp must be this part's (else cudaErrorInvalidValue, as for a
// key with no instance).  key: ops/spline_gather.py:pattern_key.  ndim
// axes; the matrix is row-major ndim x ndim and the coordinate is
// matrix @ (out_index + pre) + offset.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int spline_affine_fast(const void* x, void* out, int dtype,
                                  int cdtype, int ncomp, int key, int ndim,
                                  const int* in_dims, const int* out_dims,
                                  const double* matrix, const double* offset,
                                  const double* pre, int mode, double cval_re,
                                  double cval_im, void* stream) {
  if (dtype != kPartT || cdtype != kPartC || ncomp != kPartNC || ndim < 1 ||
      ndim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  FastParams p = fast_params(ndim, in_dims, mode, cval_re, cval_im);
  for (int j = 0; j < ndim; ++j) {
    p.out_dims[j] = out_dims[j];
    p.offset[j] = offset[j];
    p.pre[j] = pre[j];
  }
  for (int k = 0; k < ndim * ndim; ++k) p.matrix[k] = matrix[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key) {
#define SG_AFFINE_CASE(...)                                          \
  case key_of<__VA_ARGS__>():                                        \
    return launch_affine_fast<PartT, PartC, kPartNC, __VA_ARGS__>(x, out, \
                                                                  p, s);
    SG_AFFINE_PATTERNS(SG_AFFINE_CASE)
#undef SG_AFFINE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// coords: (ndim, n_out), contiguous, of this part's coordinate type
extern "C" int spline_map_fast(const void* x, const void* coords, void* out,
                               int dtype, int cdtype, int ncomp, int key,
                               int ndim, const int* in_dims, int n_out,
                               int mode, double cval_re, double cval_im,
                               void* stream) {
  if (dtype != kPartT || cdtype != kPartC || ncomp != kPartNC || ndim < 1 ||
      ndim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  FastParams p = fast_params(ndim, in_dims, mode, cval_re, cval_im);
  p.n_out = n_out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key) {
#define SG_MAP_CASE(...)                                                    \
  case key_of<__VA_ARGS__>():                                               \
    return launch_map_fast<PartT, PartC, kPartNC, __VA_ARGS__>(x, coords,   \
                                                               out, p, s);
    SG_MAP_PATTERNS(SG_MAP_CASE)
#undef SG_MAP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#if SG_PART == 0
// The generic instance.  dtype / cdtype: 0 float32, 1 float64.  Dims are
// padded to three axes (leading axes of length 1, order 0); the matrix is
// row-major 3x3, and the coordinate is matrix @ (out_index + pre) + offset.
// Returns the CUDA error of the launch (0 on success).
extern "C" int spline_affine(const void* x, void* out, int dtype, int cdtype,
                             int ncomp, const long long* in_dims,
                             const long long* out_dims, const double* matrix,
                             const double* offset, const double* pre,
                             const int* orders, int mode, double cval_re,
                             double cval_im, void* stream) {
  Params p = make_params(in_dims, out_dims, orders, mode, ncomp, cval_re,
                         cval_im);
  for (int k = 0; k < kMaxDim * kMaxDim; ++k) p.matrix[k] = matrix[k];
  for (int j = 0; j < kMaxDim; ++j) {
    p.offset[j] = offset[j];
    p.pre[j] = pre[j];
  }
  return dispatch<false>(x, nullptr, out, dtype, cdtype, p,
                         static_cast<cudaStream_t>(stream));
}

// coords: (ndim_coords, *out_shape), contiguous, of type cdtype
extern "C" int spline_map(const void* x, const void* coords, void* out,
                          int dtype, int cdtype, int ncomp, int ndim_coords,
                          const long long* in_dims, const long long* out_dims,
                          const int* orders, int mode, double cval_re,
                          double cval_im, void* stream) {
  Params p = make_params(in_dims, out_dims, orders, mode, ncomp, cval_re,
                         cval_im);
  p.ndim_coords = ndim_coords;
  return dispatch<true>(x, coords, out, dtype, cdtype, p,
                        static_cast<cudaStream_t>(stream));
}
#endif
