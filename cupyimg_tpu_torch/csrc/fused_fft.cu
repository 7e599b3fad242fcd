// One FFT of one axis of complex64 data over device memory: the transforms
// under scipy.signal's fftconvolve / oaconvolve / convolve / correlate
// (method "fft") on float32 data.
//
// Replaces the TPU kernels of cupyimg_tpu/ops/pallas_fft.py (one
// pallas_call, :478, two kernel makers):
//   B4 _kernel_last (:309, via _fft_last)  -> fft_rows: the contiguous last
//      axis of an (R, n) array, a block taking `tile` whole rows;
//   B5 _kernel_first (:395, via _fft_first, fft2) -> fft_strided: one step
//      of a four-step split n = n1 * n2 of the middle axis of an (L, n, C)
//      view (ops/fused_fft.py runs two), a block taking `tile` (16)
//      neighbouring columns, every load and store a 16-value row segment.
// The TPU kernels run a four-step split n = a*b as bf16 hi/lo matmuls on the
// MXU and leave the spectrum in a permuted order; here each sequence runs a
// Stockham autosort FFT of few passes, so the spectrum is in natural order.
//
// A block stages its sequences in shared memory with coalesced loads
// (consecutive threads on consecutive elements of a row, or on
// neighbouring columns), runs the passes, and stores the result's window
// the same way.  A pass of radix R (up to 32; ops/fused_fft.py:passes picks
// at most three for n <= 14400, so two exchanges between passes) is one
// butterfly per thread in registers: butterfly j (of n/R) reads
// x[j + r*n/R], multiplies input r by w^(r*(j%Ns)*n/(Ns*R)) (w =
// exp(-2 pi i/n), Ns the product of the earlier radices), takes the
// length-R DFT and writes output r to (j - j%Ns)*R + j%Ns + r*Ns, from one
// shared buffer to the other.  A composite R = A*B is split inside the
// thread (A-point DFTs of the inputs B apart, the constants
// exp(-2 pi i j2 k1/R) from constant memory, B-point DFTs; output
// k1 + A*k2).  A butterfly's twiddles are w^(k*stride) from two entries of
// a table staged in shared memory (ops/fused_fft.py:twiddle_tables: e mod
// 128 and 128*(e div 128)) and its powers by products, refreshed from the
// table every eighth.  The kernel is built per bucket of the largest
// radix.  The inverse is the forward transform of the conjugate,
// conjugated, folded into the load and the store.
//
// Folded into the loads and stores: a zero pad (the input's axis may be
// shorter than n), a real input (float32, the imaginary part read as 0), a
// product by a second complex operand before the transform (broadcast over
// the leading axis when its stride is 0), the four-step twiddle
// w_n^(j2*k1) at the first strided step's store, the second step's output
// row k1 + n1*k2, a constant scale (the inverse's 1/n or 1/(n0*n1)), a real
// output (float32, the real part only) and a crop (only the outputs
// [start, start + length) of the axis are written).
//
// Bound: bytes (one read of each operand, one write; the strided entry's
// two steps move its data twice) at these sizes; the 5 n log2 n flops per
// transform are a fifth of the byte time at n = 4320.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxPasses = 4;
constexpr int kMaxRadix = 32;
constexpr int kTwSplit = 128;  // twiddle exponent e = 128 * hi + lo
constexpr int kTwShift = 7;
constexpr int kMaxThreads = 512;

// launch flags (ops/fused_fft.py:_REAL_IN ...)
constexpr int kRealIn = 1;
constexpr int kConjIn = 2;
constexpr int kConjOut = 4;
constexpr int kRealOut = 8;

// exp(-2 pi i m / R) at [R * kMaxRadix + m]: a composite butterfly's
// constants, float64 rounded once (ops/fused_fft.py:_inner_twiddles)
__constant__ float2 kInner[(kMaxRadix + 1) * kMaxRadix];

struct Params {
  int m;  // sequence length
  int npasses;
  unsigned radices;  // pass s's radix in bits 8s..8s+7 (no dynamic
                     // indexing: the parameters stay in constant memory)
  int flags;
  float scale;
  int tile;  // rows: sequences per block; strided: columns per block
  long long count;      // rows: rows; strided: planes
  long long m_in;       // rows: input row length (<= m, the rest is 0)
  int M;                // strided: columns of a plane's row
  long long extent;     // strided: input elements of a plane
  int in_rows;          // strided: input rows of the transformed axis;
  int in_mult;          // element e of column c is row e*in_mult + c/tw_div
                        // (in_mult > 1) or e, read if below in_rows
  long long mul_stride; // rows: per row; strided: per plane; 0 broadcast
  int P;                // strided: output row k1 + P*e of plane l*P + k1
  int tw_n;             // strided: the store's twiddle length, 0 for none
  int tw_div;           // its j2 = column / tw_div
  int start, length;    // the output window along the axis
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

template <int R>
__host__ __device__ constexpr int first_factor() {
  return R % 4 == 0 ? 4 : (R % 2 == 0 ? 2 : (R % 3 == 0 ? 3 : 5));
}

// forward DFT of length R in place (ops/fused_fft.py:_butterfly)
template <int R>
__device__ __forceinline__ void dft(float2* a) {
  if constexpr (R == 2) {
    const float2 y0 = cadd(a[0], a[1]);
    a[1] = csub(a[0], a[1]);
    a[0] = y0;
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
    const float2 t2 = cadd(a[1], a[3]), t3 = mi(csub(a[1], a[3]));
    a[0] = cadd(t0, t2);
    a[1] = cadd(t1, t3);
    a[2] = csub(t0, t2);
    a[3] = csub(t1, t3);
  } else if constexpr (R == 3) {
    const float2 s = cadd(a[1], a[2]);
    const float2 t = cadd(a[0], rmul(kC3, s));
    const float2 u = mi(rmul(kS3, csub(a[1], a[2])));
    a[0] = cadd(a[0], s);
    a[1] = cadd(t, u);
    a[2] = csub(t, u);
  } else if constexpr (R == 5) {
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
  } else {
    // R = A * B: input B*j1 + j2 -> A-point DFTs over j1, the constant
    // w_R^(j2*k1), B-point DFTs over j2; output k1 + A*k2
    constexpr int A = first_factor<R>();
    constexpr int B = R / A;
    float2 u[R];
#pragma unroll
    for (int j2 = 0; j2 < B; ++j2) {
      float2 t[A];
#pragma unroll
      for (int j1 = 0; j1 < A; ++j1) t[j1] = a[B * j1 + j2];
      dft<A>(t);
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1) {
        const int e = (j2 * k1) % R;
        u[k1 * B + j2] = e == 0 ? t[k1] : cmul(t[k1], kInner[R * kMaxRadix + e]);
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      dft<B>(u + k1 * B);
#pragma unroll
      for (int k2 = 0; k2 < B; ++k2) a[k1 + A * k2] = u[k1 * B + k2];
    }
  }
}

// the twiddle w^e of a staged table pair
__device__ __forceinline__ float2 twiddle(const float2* t, int e) {
  return cmul(t[e & (kTwSplit - 1)], t[kTwSplit + (e >> kTwShift)]);
}

// where a block's sequence g and its element e are read and written: the
// sequence's first input and output addresses, 32-bit strides from the
// launch's parameters
template <bool kRows>
struct Block {
  const float* in_real;
  const float2* in;
  const float2* mul;
  float* out_real;
  float2* out;
  int lim;   // elements e < lim are read, the rest are 0
  int k1;    // strided: the second step's row offset
  int j2;    // strided: the column's twiddle index
  bool valid;

  __device__ Block(const Params& p, const void* x, const float2* mul_,
                   void* out_) {
    long long in_off, mul_off, out_off;
    if constexpr (kRows) {
      const long long row = (long long)blockIdx.x * p.tile + threadIdx.y;
      valid = row < p.count;
      in_off = row * p.m_in;
      mul_off = row * p.mul_stride;
      out_off = row * p.length - p.start;
      lim = static_cast<int>(p.m_in);
      k1 = 0;
      j2 = 0;
    } else {
      // 32-bit divisions only: the grid, a row and P stay below 2^31
      const unsigned tiles = (p.M + p.tile - 1) / p.tile;
      const unsigned plane = blockIdx.x / tiles;
      const int col = (blockIdx.x - plane * tiles) * p.tile + threadIdx.x;
      valid = col < p.M;
      in_off = plane * p.extent + col;
      mul_off = plane * p.mul_stride + col;
      const unsigned l = plane / p.P;
      k1 = static_cast<int>(plane - l * p.P);
      out_off = ((long long)l * p.length - p.start) * p.M + col;
      j2 = col / p.tw_div;
      // the elements read: row e*in_mult + j2 (or e) below in_rows
      lim = p.in_mult > 1 ? (p.in_rows - j2 + p.in_mult - 1) / p.in_mult
                          : p.in_rows;
    }
    in_real = static_cast<const float*>(x) + in_off;
    in = static_cast<const float2*>(x) + in_off;
    mul = mul_ == nullptr ? nullptr : mul_ + mul_off;
    out_real = static_cast<float*>(out_) + out_off;
    out = static_cast<float2*>(out_) + out_off;
  }

  // element e of the sequence, with the load's folds
  __device__ __forceinline__ float2 load(const Params& p, int e) const {
    if (e >= lim) return make_float2(0.f, 0.f);
    const long long i = kRows ? e : (long long)e * p.M;
    float2 v = (p.flags & kRealIn) ? make_float2(__ldg(in_real + i), 0.f)
                                   : __ldg(in + i);
    if (mul != nullptr) v = cmul(v, __ldg(mul + i));
    if (p.flags & kConjIn) v.y = -v.y;
    return v;
  }

  // output e of the sequence (already multiplied by any twiddle), with
  // the store's folds
  __device__ __forceinline__ void store(const Params& p, int e,
                                        float2 v) const {
    const int row = kRows ? e : k1 + p.P * e;
    if (row < p.start || row >= p.start + p.length) return;
    if (p.flags & kConjOut) v.y = -v.y;
    v = rmul(p.scale, v);
    const long long i = kRows ? row : (long long)row * p.M;
    if (p.flags & kRealOut) {
      out_real[i] = v.x;
    } else {
      out[i] = v;
    }
  }
};

// one Stockham pass of radix R over the block's sequences, from src to
// dst in shared memory: element e of sequence g at g*m + e (rows) or
// e*tile + g (strided, neighbouring threads on neighbouring columns).
// With `twist` (the strided entry's first step, last pass) output e of
// column g is multiplied by w_tw_n^(j2*e) before it is stored.
template <int R, bool kRows>
__device__ __forceinline__ void pass(const Params& p, const Block<kRows>& b,
                                     const float2* src, float2* dst,
                                     const float2* tw, const float2* tw_e,
                                     int ns, bool twist) {
  const int m = p.m;
  const int nb = m / R;
  const int stride = m / (ns * R);
  const int g = kRows ? threadIdx.y : threadIdx.x;
  const int j0 = kRows ? threadIdx.x : threadIdx.y;
  const int dj = kRows ? blockDim.x : blockDim.y;
  const int gs = kRows ? m : 1;
  const int es = kRows ? 1 : p.tile;
  for (int j = j0; j < nb; j += dj) {
    float2 v[R];
    const int k = j % ns;
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[g * gs + (j + r * nb) * es];
    if (k != 0) {
      // w^(r*k*stride): from the table for r = 1, 9, 17, 25, else the
      // previous one times w^(k*stride), at most seven products deep
      const float2 w1 = twiddle(tw, k * stride);
      float2 wr = w1;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        if (r > 1) wr = r % 8 == 1 ? twiddle(tw, r * k * stride)
                                   : cmul(wr, w1);
        v[r] = cmul(v[r], wr);
      }
    }
    dft<R>(v);
    const int base = (j - k) * R + k;
    if (twist) {
      // the four-step twiddle w^(j2*e) of e = base + r*ns: from the
      // table for r = 0, 8, 16, 24, else the previous one times w^(j2*ns)
      const float2 step = twiddle(tw_e, b.j2 * ns);
      float2 t = make_float2(1.f, 0.f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        t = r % 8 == 0 ? twiddle(tw_e, b.j2 * (base + r * ns))
                       : cmul(t, step);
        v[r] = cmul(v[r], t);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dst[g * gs + (base + r * ns) * es] = v[r];
  }
}

__host__ __device__ constexpr int table_entries(int n) {
  return kTwSplit + (n + kTwSplit - 1) / kTwSplit;
}

// The kernels are built per radix bucket (the largest radix of a launch),
// so that a launch of small radices holds only their registers; the strided
// entry's short sequences of radices up to 16 are held to 64 registers (two
// blocks of 512 threads an SM), the rows entry's up to radix 20 to 96.
__host__ __device__ constexpr int bucket_of(int maxr) {
  return maxr <= 10 ? 10 : (maxr <= 16 ? 16 : (maxr <= 20 ? 20 : 32));
}
// the rows entry's threads a block up to radix 20, two blocks an SM: this
// bound holds it to 96 registers; unbounded, ptxas picks more, and the
// pass runs slower at the same two blocks an SM (PERF.md, section 6)
__host__ __device__ constexpr int rows_threads(int bucket) {
  return bucket <= 20 ? 320 : kMaxThreads;
}

template <bool kRows, int kMaxR>
__device__ __forceinline__ void fft_body(const void* __restrict__ x,
                                         const float2* __restrict__ mul,
                                         void* __restrict__ out,
                                         const float2* __restrict__ tables,
                                         const float2* __restrict__ tables_e,
                                         const Params& p) {
  extern __shared__ float2 smem[];
  const int m = p.m;
  const int seq = p.tile * m;
  float2* src = smem;
  float2* dst = smem + seq;
  float2* tw = smem + 2 * seq;
  float2* tw_e = tw + table_entries(m);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < table_entries(m); i += nthreads) tw[i] = tables[i];
  if (p.tw_n)
    for (int i = tid; i < table_entries(p.tw_n); i += nthreads)
      tw_e[i] = tables_e[i];
  const Block<kRows> b(p, x, mul, out);
  // the block's sequences into shared memory, coalesced: consecutive
  // threads on consecutive elements (rows) or columns (strided)
  const int g = kRows ? threadIdx.y : threadIdx.x;
  const int e0 = kRows ? threadIdx.x : threadIdx.y;
  const int de = kRows ? blockDim.x : blockDim.y;
  const int gs = kRows ? m : 1;
  const int es = kRows ? 1 : p.tile;
#pragma unroll 4
  for (int e = e0; e < m; e += de)
    src[g * gs + e * es] = b.valid ? b.load(p, e) : make_float2(0.f, 0.f);
  __syncthreads();
  int ns = 1;
  for (int s = 0; s < p.npasses; ++s) {
    const bool twist = !kRows && p.tw_n && s == p.npasses - 1;
    const int radix = (p.radices >> (8 * s)) & 255;
    switch (radix) {
#define FFT_PASS(R)                                                     \
  case R:                                                               \
    if constexpr (R <= kMaxR)                                           \
      pass<R, kRows>(p, b, src, dst, tw, tw_e, ns, twist);             \
    break;
      FFT_PASS(2) FFT_PASS(3) FFT_PASS(4) FFT_PASS(5) FFT_PASS(6)
      FFT_PASS(8) FFT_PASS(9) FFT_PASS(10) FFT_PASS(12) FFT_PASS(15)
      FFT_PASS(16) FFT_PASS(18) FFT_PASS(20) FFT_PASS(24) FFT_PASS(25)
      FFT_PASS(27) FFT_PASS(30) FFT_PASS(32)
#undef FFT_PASS
      default: break;
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
    ns *= radix;
  }
  // the window of the result to device memory, coalesced as the loads
  if (!b.valid) return;
  if (kRows) {
#pragma unroll 4
    for (int e = p.start + e0; e < p.start + p.length; e += de)
      b.store(p, e, src[g * gs + e * es]);
  } else {
#pragma unroll 4
    for (int e = e0; e < m; e += de) b.store(p, e, src[g * gs + e * es]);
  }
}

template <int kMaxR>
__global__ void __launch_bounds__(rows_threads(kMaxR), kMaxR <= 20 ? 2 : 1)
fft_rows_kernel(const void* __restrict__ x, const float2* __restrict__ mul,
                void* __restrict__ out, const float2* __restrict__ tables,
                const float2* __restrict__ tables_e, Params p) {
  fft_body<true, kMaxR>(x, mul, out, tables, tables_e, p);
}

template <int kMaxR>
__global__ void __launch_bounds__(kMaxThreads, kMaxR <= 16 ? 2 : 1)
fft_strided_kernel(const void* __restrict__ x,
                   const float2* __restrict__ mul, void* __restrict__ out,
                   const float2* __restrict__ tables,
                   const float2* __restrict__ tables_e, Params p) {
  fft_body<false, kMaxR>(x, mul, out, tables, tables_e, p);
}

bool radix_ok(int r) {
  switch (r) {
    case 2: case 3: case 4: case 5: case 6: case 8: case 9: case 10:
    case 12: case 15: case 16: case 18: case 20: case 24: case 25: case 27:
    case 30: case 32: return true;
    default: return false;
  }
}

// the composite butterflies' constants, once per device; and the largest
// dynamic shared memory each kernel was allowed so far, per device
template <typename K>
int prepare(const Params& p, size_t smem, K kernel, int* allowed,
            cudaStream_t stream) {
  if (p.npasses < 1 || p.npasses > kMaxPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  int prod = 1;
  for (int s = 0; s < p.npasses; ++s) {
    const int r = (p.radices >> (8 * s)) & 255;
    if (!radix_ok(r)) return static_cast<int>(cudaErrorInvalidValue);
    prod *= r;
  }
  if (prod != p.m) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static bool inner_done[64] = {false};
  if (!inner_done[dev]) {
    static float2 host[(kMaxRadix + 1) * kMaxRadix];
    for (int r = 1; r <= kMaxRadix; ++r)
      for (int e = 0; e < kMaxRadix; ++e) {
        const double a = -2.0 * 3.14159265358979323846 * e / r;
        host[r * kMaxRadix + e] = make_float2(static_cast<float>(std::cos(a)),
                                              static_cast<float>(std::sin(a)));
      }
    err = cudaMemcpyToSymbolAsync(kInner, host, sizeof(host), 0,
                                  cudaMemcpyHostToDevice, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    inner_done[dev] = true;
  }
  if (smem > 48 * 1024 && static_cast<int>(smem) > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = static_cast<int>(smem);
  }
  return 0;
}

size_t smem_of(const Params& p) {
  const size_t seqs = 2 * sizeof(float2) * p.tile * p.m;
  return seqs + sizeof(float2) * (table_entries(p.m) +
                                  (p.tw_n ? table_entries(p.tw_n) : 0));
}

// launch the kernel of the bucket of the plan's largest radix
template <bool kRows, int kMaxR>
int run_bucket(const void* x, const float2* mul, void* out,
               const float2* tables, const float2* tables_e, const Params& p,
               unsigned blocks, dim3 block, cudaStream_t s) {
  static int allowed[64] = {0};
  if (static_cast<int>(block.x * block.y) >
      (kRows ? rows_threads(kMaxR) : kMaxThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of(p);
  const auto kernel = kRows ? fft_rows_kernel<kMaxR>
                            : fft_strided_kernel<kMaxR>;
  const int err = prepare(p, smem, kernel, allowed, s);
  if (err != 0) return err;
  kernel<<<blocks, block, smem, s>>>(x, mul, out, tables, tables_e, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRows>
int run(const void* x, const void* mul, void* out, const void* tables,
        const void* tables_e, const Params& p, long long blocks, dim3 block,
        cudaStream_t s) {
  if (p.npasses < 1 || p.npasses > kMaxPasses || blocks < 1 ||
      blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int maxr = 1;
  for (int i = 0; i < p.npasses; ++i) {
    const int r = (p.radices >> (8 * i)) & 255;
    maxr = r > maxr ? r : maxr;
  }
  const auto* m = static_cast<const float2*>(mul);
  const auto* t = static_cast<const float2*>(tables);
  const auto* te = static_cast<const float2*>(tables_e);
  const unsigned nb = static_cast<unsigned>(blocks);
  switch (bucket_of(maxr)) {
    case 10: return run_bucket<kRows, 10>(x, m, out, t, te, p, nb, block, s);
    case 16: return run_bucket<kRows, 16>(x, m, out, t, te, p, nb, block, s);
    case 20: return run_bucket<kRows, 20>(x, m, out, t, te, p, nb, block, s);
    default: return run_bucket<kRows, 32>(x, m, out, t, te, p, nb, block, s);
  }
}

Params make_params(int m, int npasses, const int* radices, int flags,
                   double scale, int tile, int start, int length) {
  Params p = {};
  p.m = m;
  p.npasses = npasses;
  for (int s = 0; s < npasses && s < kMaxPasses; ++s)
    p.radices |= static_cast<unsigned>(radices[s] & 255) << (8 * s);
  p.flags = flags;
  p.scale = static_cast<float>(scale);
  p.tile = tile;
  p.start = start;
  p.length = length;
  p.P = 1;
  return p;
}


}  // namespace

// x: (rows, m_in) float32 (kRealIn) or complex64, transformed at length n
// (zeros beyond m_in); mul: complex64 (rows, n) or null, row r at
// mul + r*mul_rstride; tables: ops/fused_fft.py:twiddle_tables(n);
// out: (rows, length) float32 (kRealOut) or complex64, outputs
// [start, start + length) of each row.
extern "C" int fft_rows(const void* x, const void* mul, void* out,
                        const void* tables, long long rows, long long m_in,
                        long long mul_rstride, int n, int start, int length,
                        int tile, int threads, int npasses,
                        const int* radices, int flags, double scale,
                        void* stream) {
  if (npasses < 1 || npasses > kMaxPasses || m_in > n || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(n, npasses, radices, flags, scale, tile, start,
                         length);
  p.count = rows;
  p.m_in = m_in;
  p.mul_stride = mul_rstride;
  return run<true>(x, mul, out, tables, nullptr, p, (rows + tile - 1) / tile,
                   dim3(threads, tile), static_cast<cudaStream_t>(stream));
}

// One step of the strided entry over `planes` planes of rows of M columns,
// transformed along the planes' rows at length m: element e of column c of
// plane q at x + q*extent + e*M + c, read where its row of the original
// axis, e*in_mult + c/tw_div (in_mult > 1) or e, is below in_rows, else 0;
// mul:
// complex64 at mul + q*mul_pstride + e*M + c, or null; tables:
// twiddle_tables(m); tables_e: twiddle_tables(tw_n) when tw_n > 0, which
// multiplies output e of column c by w_tw_n^((c / tw_div) * e).  Output e of
// plane q = l*P + k1 is row k1 + P*e of plane l of out, (L, length, M),
// stored if inside [start, start + length).
extern "C" int fft_strided(const void* x, const void* mul, void* out,
                           const void* tables, const void* tables_e,
                           long long planes, long long M, long long extent,
                           long long mul_pstride, int m, int in_rows,
                           int in_mult, int P, int tw_n, int tw_div,
                           int start, int length, int tile,
                           int threads, int npasses, const int* radices,
                           int flags, double scale, void* stream) {
  if (npasses < 1 || npasses > kMaxPasses || P < 1 || planes % P != 0 ||
      tile < 1 || M < 1 || M > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(m, npasses, radices, flags, scale, tile, start,
                         length);
  p.count = planes;
  p.M = static_cast<int>(M);
  p.extent = extent;
  p.in_rows = in_rows;
  p.in_mult = in_mult;
  p.mul_stride = mul_pstride;
  p.P = P;
  p.tw_n = tw_n;
  p.tw_div = tw_div > 0 ? tw_div : 1;
  return run<false>(x, mul, out, tables, tables_e, p,
                    planes * ((M + tile - 1) / tile), dim3(tile, threads),
                    static_cast<cudaStream_t>(stream));
}
