// The eight ndimage boundary modes as an index map, shared by every
// kernel of csrc/ so that all of them extend an array identically
// (core/boundary.py is the PyTorch statement of the same map).
#pragma once

// mode codes, as ops/fused_separable.py:_MODE_CODES assigns them
constexpr int kReflect = 0;   // reflect, grid-mirror
constexpr int kMirror = 1;
constexpr int kNearest = 2;
constexpr int kWrap = 3;      // wrap, grid-wrap
// 4: constant, grid-constant

// Map an index of an axis of length n onto [0, n).  Sets oob for an
// out-of-range index of a constant-mode axis (the sample is cval).
__device__ __forceinline__ int map_index(int i, int n, int mode, bool& oob) {
  if ((unsigned)i < (unsigned)n) return i;
  switch (mode) {
    case kReflect: {
      if (n == 1) return 0;
      const int p = 2 * n;
      int m = i % p;
      if (m < 0) m += p;
      return m < n ? m : p - 1 - m;
    }
    case kMirror: {
      if (n == 1) return 0;
      const int p = 2 * n - 2;
      int m = i % p;
      if (m < 0) m += p;
      return m < n ? m : p - m;
    }
    case kNearest:
      return i < 0 ? 0 : n - 1;
    case kWrap: {
      int m = i % n;
      if (m < 0) m += n;
      return m;
    }
    default:
      oob = true;
      return i < 0 ? 0 : n - 1;
  }
}

// min and max that return NaN when either operand is NaN, as
// torch.minimum/torch.maximum do (fminf/fmaxf would drop the NaN).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int min_nan(int a, int b) { return min(a, b); }
__device__ __forceinline__ int max_nan(int a, int b) { return max(a, b); }
