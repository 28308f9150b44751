// K6 rd_cost_pred: rate-distortion cost of one given prediction per block.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:24 make_rd_cost_pred_fn (the inter
// path's cost, quant rounding 85, and the rough intra search's RD tail,
// rounding 171: the wrapper passes the rounding in `add`). Per block:
//   bits, ssd = the RD tail (common.cuh rd_tail_block) of pred
//   rd        = float(ssd) + lam * (bits + extra_bits[b])
// with the same int32 wrapping, IEEE float rounding and order-free bits
// estimate as K4 (rd_cost.cu), whose device code it shares.
//
// Bound on this card: bytes and operations about even (four w*h*max(w,h)
// integer multiply-add passes per block against two int32 blocks read;
// operations lead at 32x32, bytes at 16x16 and 8x8). Design: K4's,
// without the mode argmin: one thread block per block, everything in
// shared memory.

#include "common.cuh"

namespace {

__global__ void rd_cost_pred_kernel(const int* __restrict__ preds,
                                    const int* __restrict__ src,
                                    const float* __restrict__ extra_bits,
                                    const int8_t* __restrict__ mat_w,
                                    const int8_t* __restrict__ mat_h,
                                    const float* __restrict__ wts,
                                    uvg::RdTail p, float lam,
                                    float* __restrict__ rd_out) {
  extern __shared__ int smem[];
  __shared__ int cnt[4];
  __shared__ unsigned ssd_s;
  const int cu = blockIdx.x;
  const int hw = p.w * p.h;
  if (threadIdx.x == 0) {
    ssd_s = 0u;
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
  }
  __syncthreads();
  uvg::rd_tail_block(preds + static_cast<long long>(cu) * hw,
                     src + static_cast<long long>(cu) * hw, mat_w, mat_h, p,
                     smem, cnt, &ssd_s);
  if (threadIdx.x == 0) {
    const float bits = uvg::bucket_bits(cnt, wts);
    const float ssd_f = __int2float_rn(static_cast<int>(ssd_s));
    rd_out[cu] = __fadd_rn(ssd_f, __fmul_rn(lam, __fadd_rn(bits, extra_bits[cu])));
  }
}

}  // namespace

extern "C" int rd_cost_pred(const void* preds, const void* src,
                            const void* extra_bits, int B, int w, int h,
                            const void* mat_w, const void* mat_h,
                            const void* wts, int bitdepth, int q_bits,
                            int scale, int add, int iscale, int dq_shift,
                            float lam, void* rd, void* stream) {
  const uvg::RdTail p = uvg::rd_tail_params(w, h, bitdepth, q_bits, scale, add,
                                            iscale, dq_shift);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  rd_cost_pred_kernel<<<B, 256, uvg::rd_tail_smem(w, h),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(preds), static_cast<const int*>(src),
      static_cast<const float*>(extra_bits), static_cast<const int8_t*>(mat_w),
      static_cast<const int8_t*>(mat_h), static_cast<const float*>(wts), p, lam,
      static_cast<float*>(rd));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(rd_cost_pred)
