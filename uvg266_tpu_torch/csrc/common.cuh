// Shared helpers of the port's kernels. Each kernel source is built into a
// shared library of its own with a plain C interface (see kernels/__init__.py);
// every entry enqueues on the caller's stream and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace uvg {

constexpr int REF_LEN = 195;          // 3 * 64 + 3, ops/intra_batch.py REF_LEN
constexpr int NREF = 4 * REF_LEN;     // [top | left | ftop | fleft]
constexpr int NUM_MODES = 67;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// int32 arithmetic that wraps like the reference's (x64 off: its int64
// casts are int32): done in uint32, whose overflow is defined
__device__ __forceinline__ int wrap_mul_add(int a, int b, int c) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b) +
                          static_cast<uint32_t>(c));
}

inline int grid_for(long long n, int threads, int cap = 132 * 32) {
  long long g = (n + threads - 1) / threads;
  return static_cast<int>(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace uvg

#define UVG_ERROR_ENTRY(name)                                     \
  extern "C" const char* name##_error(int e) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(e));       \
  }
