// K14 quant_levels / dequant_levels: the scalar quantiser and dequantiser
// of coefficient blocks, elementwise.
//
// Replaces: uvg266_tpu/ops/quant.py:153 make_quant_fn (entry quant_levels)
// and :174 make_dequant_fn (entry dequant_levels). The wrapper computes the
// scalars from qp_scaled, the block shape and the bit depth as the
// reference does; per element, in int32 that wraps as the reference's
// (done in uint32):
//   quant    level = (|c| * scale + add) >> q_bits   (|INT32_MIN| wraps to
//                                                     itself, as in XLA)
//            q     = clip16(sign(c) * level)
//   dequant  c     = clip16((q * scale + add) >> shift)
//
// Bound on this card: bytes (an int32 read and written per element against
// about six integer operations). Design: one thread per element,
// grid-stride, at most 32 thread blocks of 256 per SM.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void quant_kernel(const int* __restrict__ coef, long long n,
                             int scale, int add, int q_bits,
                             int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int c = coef[i];
    const int a = c < 0 ? uvg::wrap_mul_add(c, -1, 0) : c;
    const int level = uvg::wrap_mul_add(a, scale, add) >> q_bits;
    const int q = c < 0 ? uvg::wrap_mul_add(level, -1, 0) : (c > 0 ? level : 0);
    out[i] = uvg::clip16(q);
  }
}

__global__ void dequant_kernel(const int* __restrict__ q, long long n,
                               int scale, int add, int shift,
                               int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = uvg::clip16(uvg::wrap_mul_add(q[i], scale, add) >> shift);
}

}  // namespace

extern "C" int quant_levels(const void* coef, long long n, int scale, int add,
                            int q_bits, void* out, void* stream) {
  if (n < 0 || q_bits < 0 || q_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  quant_kernel<<<uvg::grid_for(n, THREADS), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(coef), n, scale, add, q_bits,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequant_levels(const void* q, long long n, int scale, int add,
                              int shift, void* out, void* stream) {
  if (n < 0 || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  dequant_kernel<<<uvg::grid_for(n, THREADS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), n, scale, add, shift,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(quant_levels)
UVG_ERROR_ENTRY(dequant_levels)
