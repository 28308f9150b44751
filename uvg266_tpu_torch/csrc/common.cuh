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

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<int16_t>(v));
}

__device__ __forceinline__ int clip16(int v) { return clampi(v, -32768, 32767); }

inline int grid_for(long long n, int threads, int cap = 132 * 32) {
  long long g = (n + threads - 1) / threads;
  return static_cast<int>(g < 1 ? 1 : (g > cap ? cap : g));
}

inline int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// --- the RD tail's constants, K4 (rd_cost.cu), K6 (rd_cost_pred.cu) and
// K11 (mts_search.cu) ------------------------------------------------------
// The shifts and quantiser constants of one block's transform -> int16 ->
// transform -> int16 -> quant -> dequant -> inverse -> reconstruction ->
// SSD (rd_tail.cuh states the steps; ops/rd_cost.py make_rd_cost_fn /
// make_rd_cost_pred_fn / make_mts_search_fn).

struct RdTail {
  int s1, s2, si1, si2, q_bits, scale, add, iscale, dq_shift, max_pix;
};

inline RdTail rd_tail_params(int w, int h, int bitdepth, int q_bits, int scale,
                             int add, int iscale, int dq_shift) {
  // transforms.py fwd_shifts / inv_shifts
  return RdTail{log2i(w) - 1 + bitdepth - 8, log2i(h) - 1 + 7, 7, 20 - bitdepth,
                q_bits, scale, add, iscale, dq_shift, (1 << bitdepth) - 1};
}

// the bits estimate from the RD tail's bucket counts, order-free float32
__device__ __forceinline__ float bucket_bits(const int* cnt, const float* wts) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(cnt[0]), wts[0]),
                          __fmul_rn(__int2float_rn(cnt[1]), wts[1])),
                __fmul_rn(__int2float_rn(cnt[2]), wts[2])),
      __fmul_rn(__int2float_rn(cnt[3]), wts[3]));
}

}  // namespace uvg

#define UVG_ERROR_ENTRY(name)                                     \
  extern "C" const char* name##_error(int e) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(e));       \
  }
