// K6 rd_cost_pred: rate-distortion cost of one given prediction per block.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:24 make_rd_cost_pred_fn (the inter
// path's cost, quant rounding 85, and the rough intra search's RD tail,
// rounding 171: the wrapper passes the rounding in `add`). Per block:
//   bits, ssd = the RD tail (rd_tail.cuh, DCT2 both ways) of pred
//   rd        = float(ssd) + lam * (bits + extra_bits[b])
// with the same int32 wrapping, IEEE float rounding and order-free bits
// estimate as K4 (rd_cost.cu), which is this kernel with a mode argmin
// before the tail.
//
// Bound on this card: bytes (the prediction and the source block read
// once, one float in and one out per block), with the operations of the
// four transform passes as partial butterflies close behind (they lead at
// 64x64 alone). Design: K4's, on the RD tail of rd_tail.cuh: templates
// over (w, h) for the 25 shapes in {4, 8, 16, 32, 64}^2, so every index
// and shift count of the layout is a constant expression; w*h/4 threads a
// block and 256 / (w*h/4) blocks a thread block below 32x32, so a thread
// block has at least 256 threads at every size and each thread four
// samples; one int4 load of the prediction and one of the source per
// thread; each 1-D pass an even/odd partial butterfly over the matrix
// pairs in shared memory (half the multiply-adds of the matrix product);
// the bucket counts in registers, reduced once per thread with
// shared-memory atomics.

#include "rd_tail.cuh"

namespace {

template <int W, int H>
__global__ void __launch_bounds__(uvg::RdGeo<W, H>::NT)
    rd_cost_pred_kernel(const int* __restrict__ preds, const int* __restrict__ src,
                        const float* __restrict__ extra_bits,
                        const int8_t* __restrict__ mat_w,
                        const int8_t* __restrict__ mat_h,
                        const float* __restrict__ wts, uvg::RdTail p, int B,
                        float lam, float* __restrict__ rd_out) {
  using G = uvg::RdGeo<W, H>;
  extern __shared__ int4 smem4[];
  const uvg::RdShared<W, H> sh(smem4);
  __shared__ int cnt[G::U][4];
  __shared__ unsigned ssd_s[G::U];

  const int tid = threadIdx.x;
  const int u = tid / G::T, lt = tid % G::T;
  const int cu = blockIdx.x * G::U + u;
  const bool valid = cu < B;

  sh.load(mat_w, mat_h, tid);
  if (lt == 0) {
    ssd_s[u] = 0u;
    cnt[u][0] = cnt[u][1] = cnt[u][2] = cnt[u][3] = 0;
  }
  const long long off = static_cast<long long>(valid ? cu : 0) * G::HW;
  uvg::rd_tail<W, H>(sh, preds + off, src + off, valid, p, u, lt, cnt[u], &ssd_s[u]);
  if (lt == 0 && valid) {
    const float bits = uvg::bucket_bits(cnt[u], wts);
    const float ssd_f = __int2float_rn(static_cast<int>(ssd_s[u]));
    rd_out[cu] = __fadd_rn(ssd_f, __fmul_rn(lam, __fadd_rn(bits, extra_bits[cu])));
  }
}

template <int W, int H>
int launch(const void* preds, const void* src, const void* extra_bits, int B,
           const void* mat_w, const void* mat_h, const void* wts,
           const uvg::RdTail& p, float lam, void* rd, cudaStream_t stream) {
  using G = uvg::RdGeo<W, H>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      rd_cost_pred_kernel<W, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (B + G::U - 1) / G::U;
  rd_cost_pred_kernel<W, H><<<grid, G::NT, G::SMEM, stream>>>(
      static_cast<const int*>(preds), static_cast<const int*>(src),
      static_cast<const float*>(extra_bits), static_cast<const int8_t*>(mat_w),
      static_cast<const int8_t*>(mat_h), static_cast<const float*>(wts), p, B,
      lam, static_cast<float*>(rd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// preds and src must be 16-byte aligned (one int4 load of each a thread)
extern "C" int rd_cost_pred(const void* preds, const void* src,
                            const void* extra_bits, int B, int w, int h,
                            const void* mat_w, const void* mat_h,
                            const void* wts, int bitdepth, int q_bits,
                            int scale, int add, int iscale, int dq_shift,
                            float lam, void* rd, void* stream) {
  const uvg::RdTail p = uvg::rd_tail_params(w, h, bitdepth, q_bits, scale, add,
                                            iscale, dq_shift);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(preds) % 16 || reinterpret_cast<uintptr_t>(src) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UVG_RDP(WW, HH)                                                           \
  if (w == WW && h == HH)                                                        \
    return launch<WW, HH>(preds, src, extra_bits, B, mat_w, mat_h, wts, p, lam, rd, \
                          st);
#define UVG_RDP_ROW(WW) UVG_RDP(WW, 4) UVG_RDP(WW, 8) UVG_RDP(WW, 16) UVG_RDP(WW, 32) UVG_RDP(WW, 64)
  UVG_RDP_ROW(4) UVG_RDP_ROW(8) UVG_RDP_ROW(16) UVG_RDP_ROW(32) UVG_RDP_ROW(64)
#undef UVG_RDP_ROW
#undef UVG_RDP
  return static_cast<int>(cudaErrorInvalidValue);
}

UVG_ERROR_ENTRY(rd_cost_pred)
