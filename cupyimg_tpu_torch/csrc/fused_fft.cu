// One FFT of one axis of complex64 data in one pass over device memory:
// the transforms under scipy.signal's fftconvolve / oaconvolve / convolve /
// correlate (method "fft") on float32 data.
//
// Replaces the TPU kernels of cupyimg_tpu/ops/pallas_fft.py (one
// pallas_call, :478, two kernel makers):
//   B4 _kernel_last (:309, via _fft_last)  -> fft_rows: the contiguous last
//      axis of an (R, n) array, a block taking `tile` whole rows;
//   B5 _kernel_first (:395, via _fft_first, fft2) -> fft_strided: the middle
//      axis of an (L, n, C) view, a block taking `tile` neighbouring columns
//      of one l, its loads and stores coalesced along C.
// The TPU kernels run a four-step split n = a*b as bf16 hi/lo matmuls on the
// MXU and leave the spectrum in a permuted order; here each block runs a
// mixed-radix (4, 2, 3, 5) Stockham autosort FFT in shared memory, two
// buffers ping-ponged stage by stage, so the spectrum is in natural order.
// Stage s of radix R with Ns = product of the earlier radices: butterfly j
// (of n/R) reads x[j + r*n/R], multiplies input r by w^(r*(j%Ns)*n/(Ns*R))
// (w = exp(-2 pi i/n), one host-made table of n complex64 values, read
// through the read-only cache), takes the length-R DFT and writes output r
// to (j - j%Ns)*R + j%Ns + r*Ns.  The inverse is the forward transform of
// the conjugate, conjugated, folded into the load and the store.
//
// Folded into the pass as in the JAX kernels: a real input (float32, the
// imaginary part read as 0), a product by a second complex operand before
// the transform (broadcast over the leading axis when its stride is 0),
// a constant scale at the store (the inverse's 1/n or 1/(n0*n1)), and a real
// output (float32, the real part only).
//
// Bound: bytes (one read of each operand, one write) at these sizes; the
// 5 n log2 n flops per transform are a fifth of that time at n = 4320.  A
// block holds its sequences whole (2 * 8 * n * tile bytes of shared memory,
// at most 227 KB: n <= 14528 for one column), so every value is read and
// written once; the strided entry's column tile is what coalesces its
// loads.  A first, simple kernel: no register-resident radix passes, no TMA.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 16;

struct Plan {
  int n;
  int nstages;
  int radix[kMaxStages];
  int inverse;
  int real_in;
  int real_out;
  float scale;
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 rmul(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}
// -i * a, exactly
__device__ __forceinline__ float2 mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// the radix-3 and radix-5 constants, float32 literals of the double values
constexpr float kC3 = -0.5f;
constexpr float kS3 = 0.866025403784438647f;
constexpr float kC51 = 0.309016994374947424f;
constexpr float kS51 = 0.951056516295153572f;
constexpr float kC52 = -0.809016994374947424f;
constexpr float kS52 = 0.587785252292473129f;

// forward DFT of length R in place (ops/fused_fft.py:_butterfly)
template <int R>
__device__ __forceinline__ void dft(float2* a);

template <>
__device__ __forceinline__ void dft<2>(float2* a) {
  const float2 y0 = cadd(a[0], a[1]);
  a[1] = csub(a[0], a[1]);
  a[0] = y0;
}

template <>
__device__ __forceinline__ void dft<4>(float2* a) {
  const float2 t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
  const float2 t2 = cadd(a[1], a[3]), t3 = mi(csub(a[1], a[3]));
  a[0] = cadd(t0, t2);
  a[1] = cadd(t1, t3);
  a[2] = csub(t0, t2);
  a[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<3>(float2* a) {
  const float2 s = cadd(a[1], a[2]);
  const float2 t = cadd(a[0], rmul(kC3, s));
  const float2 u = mi(rmul(kS3, csub(a[1], a[2])));
  a[0] = cadd(a[0], s);
  a[1] = cadd(t, u);
  a[2] = csub(t, u);
}

template <>
__device__ __forceinline__ void dft<5>(float2* a) {
  const float2 b1 = cadd(a[1], a[4]), b2 = cadd(a[2], a[3]);
  const float2 d1 = csub(a[1], a[4]), d2 = csub(a[2], a[3]);
  const float2 t1 = cadd(cadd(a[0], rmul(kC51, b1)), rmul(kC52, b2));
  const float2 t2 = cadd(cadd(a[0], rmul(kC52, b1)), rmul(kC51, b2));
  const float2 u1 = mi(cadd(rmul(kS51, d1), rmul(kS52, d2)));
  const float2 u2 = mi(csub(rmul(kS52, d1), rmul(kS51, d2)));
  a[0] = cadd(cadd(a[0], b1), b2);
  a[1] = cadd(t1, u1);
  a[2] = cadd(t2, u2);
  a[3] = csub(t2, u2);
  a[4] = csub(t1, u1);
}

// One Stockham stage of radix R over `ncol` sequences of length n; element
// (col, j) of a sequence lies at buf[col * cs + j * js].  `col_fastest`
// puts neighbouring threads on neighbouring columns (strided layout), else
// on neighbouring j (rows layout).
template <int R>
__device__ void stage(const float2* __restrict__ src, float2* __restrict__ dst,
                      const float2* __restrict__ tw, int n, int ns, int ncol,
                      int cs, int js, bool col_fastest) {
  const int nb = n / R;
  const int stride = n / (ns * R);
  const int total = ncol * nb;
  for (int item = threadIdx.x; item < total; item += blockDim.x) {
    int col, j;
    if (col_fastest) {
      col = item % ncol;
      j = item / ncol;
    } else {
      col = item / nb;
      j = item - col * nb;
    }
    const int k = j % ns;
    const float2* s = src + col * cs;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[(j + r * nb) * js];
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(&tw[r * k * stride]));
    }
    dft<R>(v);
    float2* d = dst + col * cs;
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) d[(base + r * ns) * js] = v[r];
  }
}

// every stage of the plan; returns the buffer that holds the result
__device__ float2* run_stages(float2* a, float2* b, const Plan& p,
                              const float2* __restrict__ tw, int ncol, int cs,
                              int js, bool col_fastest) {
  int ns = 1;
  for (int s = 0; s < p.nstages; ++s) {
    const int r = p.radix[s];
    switch (r) {
      case 4: stage<4>(a, b, tw, p.n, ns, ncol, cs, js, col_fastest); break;
      case 2: stage<2>(a, b, tw, p.n, ns, ncol, cs, js, col_fastest); break;
      case 3: stage<3>(a, b, tw, p.n, ns, ncol, cs, js, col_fastest); break;
      default: stage<5>(a, b, tw, p.n, ns, ncol, cs, js, col_fastest); break;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    ns *= r;
  }
  return a;
}

__device__ __forceinline__ float2 load(const void* x, long long i,
                                       const float2* mul, long long mi_,
                                       const Plan& p) {
  float2 v = p.real_in
                 ? make_float2(__ldg(static_cast<const float*>(x) + i), 0.0f)
                 : __ldg(static_cast<const float2*>(x) + i);
  if (mul != nullptr) v = cmul(v, __ldg(mul + mi_));
  if (p.inverse) v.y = -v.y;
  return v;
}

__device__ __forceinline__ void store(void* out, long long i, float2 v,
                                      const Plan& p) {
  if (p.inverse) v.y = -v.y;
  v = rmul(p.scale, v);
  if (p.real_out) {
    static_cast<float*>(out)[i] = v.x;
  } else {
    static_cast<float2*>(out)[i] = v;
  }
}

// rows entry: block b transforms rows b*tile .. b*tile+tile-1 of (R, n);
// row g of the block at smem[g*n ..]
__global__ void fft_rows_kernel(const void* __restrict__ x,
                                const float2* __restrict__ mul,
                                void* __restrict__ out,
                                const float2* __restrict__ tw, long long rows,
                                long long mul_rstride, int tile, Plan p) {
  extern __shared__ float2 smem[];
  const int n = p.n;
  const long long row0 = static_cast<long long>(blockIdx.x) * tile;
  const int nrow = static_cast<int>(min(static_cast<long long>(tile),
                                        rows - row0));
  float2* a = smem;
  float2* b = smem + static_cast<long long>(tile) * n;
  for (int item = threadIdx.x; item < nrow * n; item += blockDim.x) {
    const int g = item / n;
    const int j = item - g * n;
    const long long row = row0 + g;
    a[item] = load(x, row * n + j, mul, row * mul_rstride + j, p);
  }
  __syncthreads();
  const float2* res = run_stages(a, b, p, tw, nrow, n, 1, false);
  for (int item = threadIdx.x; item < nrow * n; item += blockDim.x) {
    const int g = item / n;
    const int j = item - g * n;
    store(out, (row0 + g) * n + j, res[item], p);
  }
}

// strided entry: block (l, t) transforms columns t*tile .. of the (n, C)
// plane l; column c of the block at smem[j*ncol + c]
__global__ void fft_strided_kernel(const void* __restrict__ x,
                                   const float2* __restrict__ mul,
                                   void* __restrict__ out,
                                   const float2* __restrict__ tw, long long C,
                                   long long mul_lstride, int tile, int tiles,
                                   Plan p) {
  extern __shared__ float2 smem[];
  const int n = p.n;
  const long long l = blockIdx.x / tiles;
  const long long c0 = static_cast<long long>(blockIdx.x % tiles) * tile;
  const int ncol = static_cast<int>(min(static_cast<long long>(tile), C - c0));
  float2* a = smem;
  float2* b = smem + static_cast<long long>(tile) * n;
  const long long plane = l * n * C;
  for (int item = threadIdx.x; item < n * ncol; item += blockDim.x) {
    const int j = item / ncol;
    const int c = item - j * ncol;
    const long long off = static_cast<long long>(j) * C + c0 + c;
    a[item] = load(x, plane + off, mul, l * mul_lstride + off, p);
  }
  __syncthreads();
  const float2* res = run_stages(a, b, p, tw, ncol, 1, ncol, true);
  for (int item = threadIdx.x; item < n * ncol; item += blockDim.x) {
    const int j = item / ncol;
    const int c = item - j * ncol;
    store(out, plane + static_cast<long long>(j) * C + c0 + c, res[item], p);
  }
}

Plan make_plan(int n, int nstages, const int* radices, int inverse,
               int real_in, int real_out, double scale) {
  Plan p;
  p.n = n;
  p.nstages = nstages;
  for (int s = 0; s < kMaxStages; ++s) p.radix[s] = s < nstages ? radices[s] : 1;
  p.inverse = inverse;
  p.real_in = real_in;
  p.real_out = real_out;
  p.scale = static_cast<float>(scale);
  return p;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// x: (rows, n) float32 (real_in) or complex64; mul: complex64 or null, row r
// at mul + r*mul_rstride; out: (rows, n) float32 (real_out) or complex64.
extern "C" int fft_rows(const void* x, const void* mul, void* out,
                        const void* tw, long long rows, long long mul_rstride,
                        int n, int tile, int threads, int nstages,
                        const int* radices, int inverse, int real_in,
                        int real_out, double scale, void* stream) {
  if (nstages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n, nstages, radices, inverse, real_in, real_out,
                           scale);
  const size_t smem = 2 * sizeof(float2) * static_cast<size_t>(n) * tile;
  int err = set_smem(fft_rows_kernel, smem);
  if (err != 0) return err;
  const long long blocks = (rows + tile - 1) / tile;
  fft_rows_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float2*>(mul), out, static_cast<const float2*>(tw),
      rows, mul_rstride, tile, p);
  return static_cast<int>(cudaGetLastError());
}

// x: (L, n, C) float32 (real_in) or complex64; mul: complex64 (n, C) planes
// or null, plane l at mul + l*mul_lstride; out: (L, n, C).
extern "C" int fft_strided(const void* x, const void* mul, void* out,
                           const void* tw, long long L, long long C,
                           long long mul_lstride, int n, int tile,
                           int threads, int nstages, const int* radices,
                           int inverse, int real_in, int real_out,
                           double scale, void* stream) {
  if (nstages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n, nstages, radices, inverse, real_in, real_out,
                           scale);
  const size_t smem = 2 * sizeof(float2) * static_cast<size_t>(n) * tile;
  int err = set_smem(fft_strided_kernel, smem);
  if (err != 0) return err;
  const int tiles = static_cast<int>((C + tile - 1) / tile);
  const long long blocks = L * tiles;
  fft_strided_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float2*>(mul), out, static_cast<const float2*>(tw),
      C, mul_lstride, tile, tiles, p);
  return static_cast<int>(cudaGetLastError());
}
