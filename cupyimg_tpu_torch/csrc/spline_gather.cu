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
// One thread per output sample (grid-stride loop, consecutive threads on
// consecutive outputs, so the writes coalesce).  spline_affine computes
// the thread's input coordinate as matrix @ (out_index + pre) + offset
// (pre is 0.5 for a grid_mode zoom, else 0); spline_map
// reads it from a (ndim, *out_shape) field.  From the coordinate each axis
// takes its taps, weights and out-of-domain flags exactly as
// ops/interp.py:axis_taps does (premap, round-half-up for order 0, the
// spline boundary family for order >= 2, per-tap cval for grid-constant),
// and the (order+1)^ndim taps are summed in the data's type, axis 0's taps
// slowest, as gather_general sums them.  Each axis has its own order: an
// axis with order 0 and an identity matrix row reads one plane, which is
// how a volume rotate resamples every plane with the same 2-D affine.
// Coordinates and weights are formed in the coordinate type C (double
// unless the caller asks for float); each tap's value is multiplied by its
// axes' weights in turn, axis 0 first, in the wider of T and C, then cast
// to the data type T: scipy's order, which decides rounding ties of
// integer outputs as scipy does.  Built with -fmad=false so that every
// product and sum is rounded as the plain PyTorch version rounds it.
//
// Bound: bytes (one read of the input and one write of the output, plus
// the coordinate field for spline_map) when the taps hit L1/L2; the taps
// are read through the read-only cache (__ldg).  No shared-memory tiling.

#include <cuda_runtime.h>

#include "boundary.cuh"

namespace {

constexpr int kMaxDim = 3;
constexpr int kMaxTaps = 6;  // order 5

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

// ops/interp.py:spline_weights, operation for operation
template <typename C>
__device__ __forceinline__ void spline_weights(C t, int order, C* w) {
  const C one = C(1);
  if (order == 1) {
    w[0] = one - t;
    w[1] = t;
  } else if (order == 2) {
    C w1 = C(0.75) - t * t;
    C y = C(0.5) - t;
    C w0 = C(0.5) * y * y;
    w[0] = w0;
    w[1] = w1;
    w[2] = one - w0 - w1;
  } else if (order == 3) {
    C y = one - t;
    C w1 = (t * t * (t - C(2)) * C(3) + C(4)) / C(6);
    C w2 = (y * y * (y - C(2)) * C(3) + C(4)) / C(6);
    C w0 = y * y * y / C(6);
    w[0] = w0;
    w[1] = w1;
    w[2] = w2;
    w[3] = one - w0 - w1 - w2;
  } else if (order == 4) {
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

// ops/interp.py:axis_taps for one coordinate; returns the tap count
template <typename C>
__device__ __forceinline__ int axis_taps(C c, int n, int order, int mode,
                                         int* idx, C* w, bool* oob) {
  C d = premap(c, n, mode);
  for (int k = 0; k < kMaxTaps; ++k) oob[k] = false;
  if (order == 0) {
    idx[0] = map_tap(first_tap(floor(d + C(0.5)), n, 0), n,
                     low_order_tap_mode(mode), oob[0]);
    return 1;
  }
  if (order == 1) {
    const C f = floor(d);
    w[1] = d - f;
    w[0] = C(1) - w[1];
    const int i0 = first_tap(f, n, 1);
    const int tm = low_order_tap_mode(mode);
    idx[0] = map_tap(i0, n, tm, oob[0]);
    idx[1] = map_tap(i0 + 1, n, tm, oob[1]);
    return 2;
  }
  if (mode == kINearest)
    d = fmin(fmax(c, C(-(order + 2))), C(n + order + 1));
  const C f = (order & 1) ? floor(d) : floor(d + C(0.5));
  spline_weights(d - f, order, w);
  const int start = first_tap(f, n, order) - order / 2;
  const int tm = spline_tap_mode(mode);
  for (int k = 0; k <= order; ++k) idx[k] = map_tap(start + k, n, tm, oob[k]);
  return order + 1;
}

template <typename T, typename C, bool kMap>
__global__ void __launch_bounds__(256)
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
      nt[j] = axis_taps(c, n, p.orders[j], p.mode, idx[j], w[j], oob[j]);
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
  const int threads = 256;
  long long blocks = (p.n_out + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond
  spline_gather_kernel<T, C, kMap><<<(unsigned)blocks, threads, 0, stream>>>(
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

// dtype / cdtype: 0 float32, 1 float64.  Dims are padded to three axes
// (leading axes of length 1, order 0); the matrix is row-major 3x3, and
// the coordinate is matrix @ (out_index + pre) + offset.
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
